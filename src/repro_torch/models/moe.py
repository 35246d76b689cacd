"""Mixture-of-experts decoder (mixtral, llama4-scout): the port of
``repro/models/moe.py``.

GShard dispatch as the reference writes it: tokens are grouped
(``MOE_GROUP`` to a group), the router picks each token's top-k experts by
repeated ``argmax`` over the masked probabilities, each expert processes a
buffer of ``int(group * k * capacity_factor / e) + 1`` slots, and a token
whose expert's buffer is full drops to the residual path.  A rank's slots
are offset by the earlier ranks' counts (``taken``), so a token's second
choice never lands in the slot of another token's first.  Dispatch and
combine are the reference's one-hot einsums: dispatch in bf16 (exact, each
slot holds at most one token), combine weights in float32 rounded to bf16
for the product.  The routing is discrete and equals the reference's: the
expert ids, slots, kept and dropped tokens.

llama4-scout: top-1 routing, an always-on shared expert, block-local
attention.  mixtral: top-2 routing, sliding-window attention.
:func:`forward` returns the reference's three values, (logits, caches,
aux), the aux being the Switch-style load-balance loss averaged over the
layers; :func:`loss_fn` adds it with ``aux_coef``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamSpec, stacked

MOE_GROUP = 2048  # tokens per dispatch group (bounds the one-hot memory)


def moe_schema(cfg):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    sch = {
        "router": ParamSpec((d, e), ("embed", "expert_in")),
        "wi_gate": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, f), ("expert", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.moe_shared_expert:
        sch["shared"] = L.mlp_schema(d, f)
    return sch


def block_schema(cfg, *, shards: int = 16):
    return {
        "ln1": L.rmsnorm_schema(cfg.d_model),
        "attn": L.attention_schema(cfg, shards=shards),
        "ln2": L.rmsnorm_schema(cfg.d_model),
        "moe": moe_schema(cfg),
    }


def schema(cfg, *, shards: int = 16):
    return {
        "embed": L.embedding_schema(cfg.padded_vocab, cfg.d_model,
                                    tie=cfg.tie_embeddings),
        "layers": stacked(block_schema(cfg, shards=shards), cfg.num_layers),
        "ln_f": L.rmsnorm_schema(cfg.d_model),
    }


def route(probs: torch.Tensor, k: int, cap: int):
    """The reference's top-k capacity routing of (g, t, e) float32 router
    probabilities.  Returns (dispatch (g, t, e, cap) float32 0/1, combine
    (g, t, e, cap) float32, expert_mass (g, e)): token t of group g sits in
    slot c of expert x where ``dispatch[g, t, x, c] == 1``; tokens past an
    expert's capacity have no slot."""
    g, t, e = probs.shape
    dev = probs.device
    slots = torch.arange(cap, device=dev)
    dispatch = torch.zeros((g, t, e, cap), dtype=torch.float32, device=dev)
    combine = torch.zeros((g, t, e, cap), dtype=torch.float32, device=dev)
    expert_mass = torch.zeros((g, e), dtype=torch.float32, device=dev)
    taken = torch.zeros((g, 1, e), dtype=torch.float32, device=dev)
    masked = probs
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                         # (g, t)
        onehot = torch.nn.functional.one_hot(idx, e).to(torch.float32)
        w = torch.sum(masked * onehot, dim=-1)                     # (g, t)
        # each token's position in its expert's buffer, after the slots
        # the earlier ranks took
        pos = (torch.cumsum(onehot, dim=1) + taken) * onehot - 1.0
        keep = (pos >= 0) & (pos < cap)
        # one_hot of an out-of-range position is all zeros, as jax's
        hit = pos.to(torch.int32)[..., None] == slots
        slot = (hit & keep[..., None]).to(torch.float32)           # (g,t,e,c)
        dispatch = dispatch + slot
        combine = combine + slot * w[:, :, None, None]
        expert_mass = expert_mass + torch.mean(onehot, dim=1)
        taken = taken + torch.sum(onehot, dim=1, keepdim=True)
        masked = masked * (1.0 - onehot)
    return dispatch, combine, expert_mass


def moe_block(p, x, cfg):
    """x: (B, S, D) -> (out, aux_loss)."""
    b, s, d = x.shape
    e = cfg.num_experts
    k = cfg.experts_per_token
    group = min(MOE_GROUP, s)
    g = (b * s) // group
    xg = x.reshape(g, group, d)
    bf = L.COMPUTE_DTYPE

    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                          # (g, t, e)
    cap = int(group * k * cfg.capacity_factor / e) + 1
    dispatch, combine, expert_mass = route(probs, k, cap)

    # Switch-style load-balance loss: E * <fraction> . <probability mass>
    frac = expert_mass / torch.full_like(expert_mass, k)
    mean_prob = torch.mean(probs, dim=1)
    aux = e * torch.mean(torch.sum(frac * mean_prob, dim=-1))

    xin = torch.einsum("gtd,gtec->gecd", xg.to(bf), dispatch.to(bf))
    gate = torch.einsum("gecd,edf->gecf", xin, p["wi_gate"].to(bf))
    up = torch.einsum("gecd,edf->gecf", xin, p["wi_up"].to(bf))
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(bf) * up
    eout = torch.einsum("gecf,efd->gecd", act, p["wo"].to(bf))
    y = torch.einsum("gecd,gtec->gtd", eout, combine.to(bf))

    out = y.reshape(b, s, d).to(x.dtype)
    if cfg.moe_shared_expert:
        out = out + L.mlp_block(p["shared"], x)
    return out, aux


def moe_transformer_block(p, x, cfg, *, mspec, positions, cache, kv_chunk):
    h, new_cache = L.attention_block(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
        mask_spec=mspec, positions=positions, cache=cache, kv_chunk=kv_chunk,
    )
    # the residual add feeds the next norm unrounded, as in the dense
    # family's block (transformer.transformer_block)
    s = x.to(torch.float32) + h.to(torch.float32)
    x = s.to(x.dtype)
    normed = L.rmsnorm(p["ln2"], s, cfg.norm_eps).to(x.dtype)
    y, aux = moe_block(p["moe"], normed, cfg)
    return x + y, new_cache, aux


def forward(
    params,
    tokens: torch.Tensor,               # (B, S)
    cfg,
    *,
    caches: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    kv_chunk: int = 1024,
):
    """Returns (logits (B, S, V) float32, new_caches, aux), aux the
    load-balance loss averaged over the layers."""
    x = L.embed(params["embed"], tokens)
    mspec = T.mask_spec(cfg)
    n = cfg.num_layers
    if positions is None and caches is not None:
        positions = caches["len"][0] + torch.arange(
            tokens.shape[1], device=tokens.device)[None, :]
    layer_params = T._per_layer(params["layers"], n)
    layer_caches = [None] * n if caches is None else T._per_layer(caches, n)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for p_layer, cache in zip(layer_params, layer_caches):
        x, new_cache, aux = moe_transformer_block(
            p_layer, x, cfg, mspec=mspec, positions=positions, cache=cache,
            kv_chunk=kv_chunk,
        )
        aux_sum = aux_sum + aux
        new_caches.append(new_cache)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, tie=cfg.tie_embeddings)
    stacked_caches = None if caches is None else tree_lib.tree_map(
        lambda *cs: torch.stack(cs), *new_caches)
    # tensor by tensor: the correctly rounded quotient
    return logits, stacked_caches, aux_sum / torch.full_like(aux_sum, n)


def loss_fn(params, batch, cfg, *, aux_coef: float = 0.01, **kw):
    logits, _, aux = forward(params, batch["tokens"], cfg, **kw)
    ce = L.cross_entropy(logits, batch["labels"], vocab_size=cfg.vocab_size)
    return ce + aux_coef * aux


init_cache = T.init_cache


def decode_step(params, caches, tokens, cfg, *, kv_chunk: int = 4096):
    logits, new_caches, _ = forward(params, tokens, cfg, caches=caches,
                                    kv_chunk=kv_chunk)
    return logits, new_caches
