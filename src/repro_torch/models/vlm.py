"""Llama-3.2-Vision-style VLM backbone: a dense decoder LM with gated
cross-attention image layers every ``cross_attn_every`` layers
(hf:meta-llama/Llama-3.2-11B-Vision); the port of ``repro/models/vlm.py``.

The vision tower is a stub, as in the reference: ``img_feats`` arrive as
pre-projected patch embeddings (B, num_image_tokens, d_model), which the
server and the trainer draw as bf16 normals.  The backbone is the
language side: sites of ``cross_attn_every - 1`` self-attention layers
followed by one tanh-gated cross-attention layer.  The gates start at 0,
so at init every cross layer is the identity, as in the paper.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamSpec, stacked


def sites_of(cfg):
    every = cfg.cross_attn_every
    assert every and cfg.num_layers % every == 0
    return cfg.num_layers // every, every - 1


def cross_block_schema(cfg, *, shards: int = 16):
    return {
        "ln_q": L.rmsnorm_schema(cfg.d_model),
        "ln_kv": L.rmsnorm_schema(cfg.d_model),
        "attn": L.attention_schema(cfg, shards=shards),
        "gate_attn": ParamSpec((), (), init="zeros"),
        "ln2": L.rmsnorm_schema(cfg.d_model),
        "mlp": L.mlp_schema(cfg.d_model, cfg.d_ff),
        "gate_mlp": ParamSpec((), (), init="zeros"),
    }


def schema(cfg, *, shards: int = 16):
    n_sites, self_per = sites_of(cfg)
    return {
        "embed": L.embedding_schema(cfg.padded_vocab, cfg.d_model,
                                    tie=cfg.tie_embeddings),
        "self_layers": stacked(stacked(T.block_schema(cfg, shards=shards),
                                       self_per), n_sites),
        "cross_layers": stacked(cross_block_schema(cfg, shards=shards),
                                n_sites),
        "ln_f": L.rmsnorm_schema(cfg.d_model),
    }


def _gate(g, like):
    """tanh of a scalar gate in float32, cast to the activations' dtype."""
    return torch.tanh(g.to(torch.float32)).to(like.dtype)


def cross_block(p, x, img, cfg, *, kv_chunk):
    h, _ = L.attention_block(
        p["attn"], L.rmsnorm(p["ln_q"], x, cfg.norm_eps), cfg,
        mask_spec=L.AttnMaskSpec(causal=False),
        kv_source=L.rmsnorm(p["ln_kv"], img, cfg.norm_eps),
        kv_chunk=kv_chunk,
    )
    # the gated product is rounded to bf16; its sum reaches ln2 unrounded
    x, normed = L.add_norm(x, _gate(p["gate_attn"], x) * h, p["ln2"],
                           cfg.norm_eps)
    m = L.mlp_block(p["mlp"], normed)
    return x + _gate(p["gate_mlp"], x) * m


def forward(params, tokens, cfg, *, img_feats, caches=None,
            kv_chunk: int = 1024, **_):
    """Returns (logits (B, S, V) float32, new_caches (n_sites, self_per,
    ...) or None)."""
    x = L.embed(params["embed"], tokens)
    mspec = L.AttnMaskSpec(causal=True)
    positions = None
    if caches is not None:
        positions = caches["len"][0, 0] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]
    n_sites, self_per = sites_of(cfg)
    site_self = T._per_layer(params["self_layers"], n_sites)
    site_cross = T._per_layer(params["cross_layers"], n_sites)
    site_caches = ([None] * n_sites if caches is None
                   else T._per_layer(caches, n_sites))
    new_caches = []
    for p_self, p_cross, cache_stack in zip(site_self, site_cross,
                                            site_caches):
        layer_caches = ([None] * self_per if cache_stack is None
                        else T._per_layer(cache_stack, self_per))
        site_new = []
        for p_layer, cache in zip(T._per_layer(p_self, self_per),
                                  layer_caches):
            x, new_cache = T.transformer_block(
                p_layer, x, cfg, mspec=mspec, positions=positions,
                cache=cache, kv_chunk=kv_chunk,
            )
            site_new.append(new_cache)
        x = cross_block(p_cross, x, img_feats, cfg, kv_chunk=kv_chunk)
        new_caches.append(site_new)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, tie=cfg.tie_embeddings)
    if caches is None:
        return logits, None
    stack = lambda *cs: torch.stack(cs)   # noqa: E731
    return logits, tree_lib.tree_map(
        stack, *[tree_lib.tree_map(stack, *site) for site in new_caches])


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], cfg,
                        img_feats=batch["img_feats"], **kw)
    return L.cross_entropy(logits, batch["labels"], vocab_size=cfg.vocab_size)


def init_cache(cfg, batch: int, max_len: int, *, shards: int = 16,
               device=None):
    """Self-attention caches stacked over (n_sites, self_per)."""
    n_sites, self_per = sites_of(cfg)
    one = L.init_attn_cache(cfg, batch, max_len, shards=shards, device=device)
    return tree_lib.tree_map(
        lambda x: x[None, None].expand(n_sites, self_per, *x.shape).clone(),
        one)


def decode_step(params, caches, tokens, cfg, *, img_feats,
                kv_chunk: int = 4096):
    return forward(params, tokens, cfg, img_feats=img_feats, caches=caches,
                   kv_chunk=kv_chunk)
