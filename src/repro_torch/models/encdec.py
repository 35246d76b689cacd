"""Encoder-decoder transformer for the audio arch (the SeamlessM4T
backbone, arXiv:2308.11596): the port of ``repro/models/encdec.py``.

The codec / mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``enc_feats`` (B, S_enc, d_model), which the
server and the trainer draw as bf16 normals.  Encoder: a bidirectional
self-attention stack (``transformer.transformer_block`` with a non-causal
mask).  Decoder: causal self-attention, cross-attention to the encoder
output and a SwiGLU MLP.  Decoding caches the decoder's self-attention K
and V; the encoder output is computed once (:func:`encode`) and passed to
every step, whose cross layers recompute its K and V.  The reference's
``jax.checkpoint`` and ``unroll`` only steer XLA and have no counterpart
here.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamSpec, stacked


def dec_block_schema(cfg, *, shards: int = 16):
    return {
        "ln1": L.rmsnorm_schema(cfg.d_model),
        "self_attn": L.attention_schema(cfg, shards=shards),
        "ln_x": L.rmsnorm_schema(cfg.d_model),
        "cross_attn": L.attention_schema(cfg, shards=shards),
        "ln2": L.rmsnorm_schema(cfg.d_model),
        "mlp": L.mlp_schema(cfg.d_model, cfg.d_ff),
    }


def schema(cfg, *, shards: int = 16):
    return {
        "enc_in": ParamSpec((cfg.d_model, cfg.d_model), ("embed", None)),
        "encoder": stacked(T.block_schema(cfg, shards=shards),
                           cfg.encoder_layers),
        "enc_ln": L.rmsnorm_schema(cfg.d_model),
        "embed": L.embedding_schema(cfg.padded_vocab, cfg.d_model,
                                    tie=cfg.tie_embeddings),
        "decoder": stacked(dec_block_schema(cfg, shards=shards),
                           cfg.num_layers),
        "ln_f": L.rmsnorm_schema(cfg.d_model),
    }


def encode(params, enc_feats, cfg, *, kv_chunk: int = 1024, **_):
    """enc_feats (B, S_enc, D) stub frame embeddings -> the encoder output
    (B, S_enc, D) bf16: the bf16 input projection, the bidirectional
    stack, ``enc_ln``."""
    x = torch.einsum("bsd,de->bse", enc_feats.to(L.COMPUTE_DTYPE),
                     params["enc_in"].to(L.COMPUTE_DTYPE))
    mspec = L.AttnMaskSpec(causal=False)
    positions = torch.arange(enc_feats.shape[1], device=enc_feats.device)
    n = cfg.encoder_layers
    for p_layer in T._per_layer(params["encoder"], n):
        x, _ = T.transformer_block(p_layer, x, cfg, mspec=mspec,
                                   positions=positions, cache=None,
                                   kv_chunk=kv_chunk)
    return L.rmsnorm(params["enc_ln"], x, cfg.norm_eps)


def decoder_block(p, x, enc_out, cfg, *, positions, cache, kv_chunk):
    h, new_cache = L.attention_block(
        p["self_attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
        mask_spec=L.AttnMaskSpec(causal=True), positions=positions,
        cache=cache, kv_chunk=kv_chunk,
    )
    x, normed = L.add_norm(x, h, p["ln_x"], cfg.norm_eps)
    h, _ = L.attention_block(
        p["cross_attn"], normed, cfg, mask_spec=L.AttnMaskSpec(causal=False),
        kv_source=enc_out, kv_chunk=kv_chunk,
    )
    x, normed = L.add_norm(x, h, p["ln2"], cfg.norm_eps)
    x = x + L.mlp_block(p["mlp"], normed)
    return x, new_cache


def forward(params, tokens, cfg, *, enc_feats=None, enc_out=None,
            caches=None, kv_chunk: int = 1024, **_):
    """Returns (logits (B, S, V) float32, new_caches); ``enc_out`` (the
    encoder output) or ``enc_feats`` (encoded here) is the memory."""
    if enc_out is None:
        enc_out = encode(params, enc_feats, cfg, kv_chunk=kv_chunk)
    x = L.embed(params["embed"], tokens)
    positions = None
    if caches is not None:
        positions = caches["len"][0] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]
    n = cfg.num_layers
    layer_params = T._per_layer(params["decoder"], n)
    layer_caches = [None] * n if caches is None else T._per_layer(caches, n)
    new_caches = []
    for p_layer, cache in zip(layer_params, layer_caches):
        x, new_cache = decoder_block(p_layer, x, enc_out, cfg,
                                     positions=positions, cache=cache,
                                     kv_chunk=kv_chunk)
        new_caches.append(new_cache)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, tie=cfg.tie_embeddings)
    if caches is None:
        return logits, None
    return logits, tree_lib.tree_map(lambda *cs: torch.stack(cs), *new_caches)


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], cfg,
                        enc_feats=batch["enc_feats"], **kw)
    return L.cross_entropy(logits, batch["labels"], vocab_size=cfg.vocab_size)


def init_cache(cfg, batch: int, max_len: int, *, shards: int = 16,
               device=None):
    """The decoder's self-attention caches, stacked over its layers."""
    return T.init_cache(cfg, batch, max_len, shards=shards, device=device)


def decode_step(params, caches, tokens, cfg, *, enc_out,
                kv_chunk: int = 4096):
    """One-token decode with the precomputed encoder output ``enc_out``
    (run :func:`encode` once at prefill)."""
    return forward(params, tokens, cfg, enc_out=enc_out, caches=caches,
                   kv_chunk=kv_chunk)
