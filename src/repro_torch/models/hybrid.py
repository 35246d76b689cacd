"""Zamba2-style hybrid: a Mamba2 backbone with one *shared* attention block
applied every ``hybrid_attn_every`` mamba layers [arXiv:2411.15242]; the
port of ``repro/models/hybrid.py``.

Structure: ``n_sites`` super-blocks of (every x mamba2) each followed by
the shared attention + MLP block, then a tail of the remaining mamba
layers.  The shared block is one set of weights, one leaf per weight in
the tree, passed to every site (never copied), so its gradient is the sum
over the sites.  As in the reference, the shared block runs on the
residual stream directly (the released model's embedding concatenation and
per-site LoRA deltas are left out).
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.params import stacked


def sites_of(cfg):
    n_sites = cfg.num_layers // cfg.hybrid_attn_every
    tail = cfg.num_layers % cfg.hybrid_attn_every
    assert n_sites >= 1, "hybrid needs at least one shared-attn site"
    return n_sites, tail


def schema(cfg, *, shards: int = 16):
    n_sites, tail = sites_of(cfg)
    sch = {
        "embed": L.embedding_schema(cfg.padded_vocab, cfg.d_model,
                                    tie=cfg.tie_embeddings),
        "sites": stacked(stacked(M.block_schema(cfg), cfg.hybrid_attn_every),
                         n_sites),
        "shared_attn": T.block_schema(cfg, shards=shards),
        "ln_f": L.rmsnorm_schema(cfg.d_model),
    }
    if tail:
        sch["tail"] = stacked(M.block_schema(cfg), tail)
    return sch


def forward(params, tokens, cfg, *, caches=None, kv_chunk: int = 1024, **_):
    """Returns (logits (B, S, V) float32, new_caches)."""
    n_sites, tail = sites_of(cfg)
    x = L.embed(params["embed"], tokens)
    mspec = L.AttnMaskSpec(causal=True)
    decode = caches is not None and tokens.shape[1] == 1

    positions = None
    if caches is not None:
        positions = caches["attn"]["len"][0] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]

    shared = params["shared_attn"]
    sites = T._per_layer(params["sites"], n_sites)
    if caches is None:
        mamba_caches = attn_caches = [None] * n_sites
    else:
        mamba_caches = T._per_layer(caches["mamba"], n_sites)
        attn_caches = T._per_layer(caches["attn"], n_sites)
    new_mamba, new_attn = [], []
    for p_site, m_cache, a_cache in zip(sites, mamba_caches, attn_caches):
        x, m_new = M.mamba_stack(p_site, x, cfg, m_cache, decode=decode)
        x, a_new = T.transformer_block(
            shared, x, cfg, mspec=mspec, positions=positions, cache=a_cache,
            kv_chunk=kv_chunk,
        )
        new_mamba.append(m_new)
        new_attn.append(a_new)

    new_tail = None
    if tail:
        x, new_tail = M.mamba_stack(
            params["tail"], x, cfg, None if caches is None else caches["tail"],
            decode=decode)

    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, tie=cfg.tie_embeddings)
    if caches is None:
        return logits, None

    def stack(trees):
        return tree_lib.tree_map(lambda *ts: torch.stack(ts), *trees)

    new_caches = {"mamba": stack(new_mamba), "attn": stack(new_attn)}
    if tail:
        new_caches["tail"] = new_tail
    return logits, new_caches


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], cfg, **kw)
    return L.cross_entropy(logits, batch["labels"], vocab_size=cfg.vocab_size)


def init_cache(cfg, batch: int, max_len: int, *, shards: int = 16,
               device=None):
    n_sites, tail = sites_of(cfg)
    mamba_one = M.init_state(cfg, batch, device=device)
    attn_one = L.init_attn_cache(cfg, batch, max_len, shards=shards,
                                 device=device)
    caches = {
        "mamba": M._repeat(M._repeat(mamba_one, cfg.hybrid_attn_every),
                           n_sites),
        "attn": M._repeat(attn_one, n_sites),
    }
    if tail:
        caches["tail"] = M._repeat(mamba_one, tail)
    return caches


def decode_step(params, caches, tokens, cfg, *, kv_chunk: int = 4096):
    return forward(params, tokens, cfg, caches=caches, kv_chunk=kv_chunk)
