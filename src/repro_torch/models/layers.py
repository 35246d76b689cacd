"""Shared neural building blocks (plain functions over param dicts): the
port of ``repro/models/layers.py``.

Conventions, the reference's:
  * activations are (B, S, ...) with heads as (B, S, H, D);
  * every matmul parameter is float32 and cast to bf16 for the product;
    norms, softmax statistics and the loss are float32;
  * attention never materializes (S, S): an online softmax over KV chunks
    (:func:`chunked_attention`), its accumulator kept in bf16 and its
    running max and normalizer in float32, as the reference's ``lax.scan``
    body keeps them.

What the reference adds only to steer XLA has no counterpart here: the
optimization barrier that pins the embedding table's bf16 convert before
the gather (its batching rule and ``_grad_safe_barrier``) — torch converts
where the code says, so :func:`embed` converts the table first.

The activation-sharding hook (:func:`set_activation_sharding`,
:func:`constrain`) sits at the reference's call sites: the q, k and v
projections ("heads"), the attention and MLP outputs and the embedding
("residual"), and the transformer block's two residual sums.  The three
row-parallel sites (the attention and MLP outputs and the vocab-sharded
embedding gather) say that their output is a partial sum over the model
axis.  With no hook it is the identity; the dry-run
(``launch/dryrun.py``) installs one that counts the tensor-parallel
all-reduces those sites imply.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import ParamSpec

COMPUTE_DTYPE = torch.bfloat16

# --------------------------------------------------------------------------
# Activation-sharding hook (set by a launcher; the identity without one).
# Kinds: "residual" for (B, S, D) activations, "heads" for (B, S, H, D).
# --------------------------------------------------------------------------

_ACT_SHARDING_HOOK = None


def set_activation_sharding(hook):
    """hook: callable(x, kind, partial_sum) -> x, kind in {"residual",
    "heads"}, ``partial_sum`` true at a row-parallel site (its output is
    summed over the model axis); ``None`` removes it."""
    global _ACT_SHARDING_HOOK
    _ACT_SHARDING_HOOK = hook


def constrain(x, kind: str, *, partial_sum: bool = False):
    if _ACT_SHARDING_HOOK is None:
        return x
    return _ACT_SHARDING_HOOK(x, kind, partial_sum)

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_schema(d: int):
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _rms(x, p["scale"], eps)


def add_norm(x: torch.Tensor, h: torch.Tensor, p, eps: float):
    """(x + h rounded to x's dtype, the norm ``p`` of the unrounded float32
    sum, in x's dtype): the reference's compiled layer bodies fuse a
    residual add into the next norm's float32 convert and feed the norm
    the unrounded sum, while the residual stream carries it rounded."""
    s = x.to(torch.float32) + h.to(torch.float32)
    return s.to(x.dtype), rmsnorm(p, s, eps).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D), positions: (B, S) or (S,); rotates the two halves
    of the head dimension, cos and sin in float32."""
    d = x.shape[-1]
    half = d // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=x.device) / half
    # theta enters as a float32 scalar, as JAX's weak-typed power takes it
    freq = torch.div(1.0, torch.pow(float(theta), exponent))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.to(torch.float32)[:, :, None] * freq[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Chunked (online-softmax) attention
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnMaskSpec:
    causal: bool = True
    window: Optional[int] = None        # sliding-window attention (mixtral)
    block_local: Optional[int] = None   # llama4 chunked-local attention


def _mask_block(q_pos, k_pos, spec: AttnMaskSpec):
    """(Sq, Sk) bool mask block from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if spec.causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if spec.window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < spec.window
    if spec.block_local is not None:
        m &= (torch.div(q_pos[:, None], spec.block_local, rounding_mode="floor")
              == torch.div(k_pos[None, :], spec.block_local,
                           rounding_mode="floor"))
    return m


def chunked_attention(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,            # (B, Sk, Hkv, D)
    *,
    mask_spec: AttnMaskSpec,
    q_offset=0,
    kv_chunk: int = 1024,
    kv_valid_len=None,          # decode: number of valid cache slots
) -> torch.Tensor:
    """Grouped-query online-softmax attention, O(Sq * chunk) memory.

    Q is viewed as (B, Sq, Hkv, G, D), so KV heads are never repeated.
    K and V are padded up to a multiple of ``kv_chunk`` and visited one
    chunk at a time; the scores of a chunk are its bf16 product taken to
    float32 and scaled, masked slots get -inf and exactly zero weight, the
    running max ``m`` and normalizer ``l`` are float32, and the output
    accumulator ``acc`` and its correction factor are bf16.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    qf = q.reshape(b, sq, hkv, g, d).to(COMPUTE_DTYPE)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))   # float32

    n_chunks = (sk + kv_chunk - 1) // kv_chunk
    pad = n_chunks * kv_chunk - sk
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).to(COMPUTE_DTYPE)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).to(COMPUTE_DTYPE)
    kc = kp.reshape(b, n_chunks, kv_chunk, hkv, d)
    vc = vp.reshape(b, n_chunks, kv_chunk, hkv, d)

    q_pos = q_offset + torch.arange(sq, device=dev)
    limit = sk if kv_valid_len is None else kv_valid_len

    m_run = torch.full((b, hkv, g, sq), -math.inf, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=COMPUTE_DTYPE, device=dev)
    for idx in range(n_chunks):
        k_blk, v_blk = kc[:, idx], vc[:, idx]            # (B, C, Hkv, D)
        k_pos = idx * kv_chunk + torch.arange(kv_chunk, device=dev)
        # scores (B, Hkv, G, Sq, C): the bf16 product, then float32
        s = torch.einsum("bqhgd,bchd->bhgqc", qf, k_blk).to(
            torch.float32) * scale
        mask = _mask_block(q_pos, k_pos, mask_spec) & (k_pos < limit)[None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        # rows with every slot masked keep m = -inf: exp(-inf - -inf) = nan
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isneginf(m_run), 0.0,
                           torch.exp(m_run - m_safe))
        l_run = l_run * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(COMPUTE_DTYPE), v_blk)
        acc = acc * corr[..., None].to(COMPUTE_DTYPE) + pv
        m_run = m_new
    denom = torch.where(l_run > 0, l_run, 1.0)[..., None]
    out = (acc.to(torch.float32) / denom).to(COMPUTE_DTYPE)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)   # (B,Sq,H,D)


# --------------------------------------------------------------------------
# Attention block (projections + rope + qk-norm + cache handling)
# --------------------------------------------------------------------------

def attention_schema(cfg, *, d_model=None, shards: int = 16):
    d = d_model or cfg.d_model
    h = cfg.padded_heads(shards)
    hkv = cfg.padded_kv_heads(shards)
    hd = cfg.resolved_head_dim
    sch = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "kv")),
        "wk": ParamSpec((d, hkv, hd), ("embed", "heads", "kv")),
        "wv": ParamSpec((d, hkv, hd), ("embed", "heads", "kv")),
        "wo": ParamSpec((h, hd, d), ("heads", "kv", "embed")),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamSpec((h, hd), ("heads", "kv"), init="zeros")
        sch["bk"] = ParamSpec((hkv, hd), ("heads", "kv"), init="zeros")
        sch["bv"] = ParamSpec((hkv, hd), ("heads", "kv"), init="zeros")
    if cfg.qk_norm:
        sch["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        sch["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return sch


def _qk_head_norm(x, scale, eps):
    return _rms(x, scale, eps)


def _proj(x, w):
    """(B, S, D) x (D, H, K) -> (B, S, H, K) in bf16."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(COMPUTE_DTYPE))


def attention_block(
    p,
    x: torch.Tensor,                  # (B, S, D)
    cfg,
    *,
    mask_spec: AttnMaskSpec,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,     # {"k","v": (B, Smax, Hkv, hd), "len"}
    kv_chunk: int = 1024,
    kv_source: Optional[torch.Tensor] = None,   # cross-attention memory
):
    """Returns (out (B, S, D), new_cache).

    With a self-attention ``cache`` the step's K and V are written at slot
    ``cache["len"]`` (a 0-d integer tensor, read on the host) and the
    queries attend to the valid slots of the whole cache.

    With ``kv_source`` (B, Sm, D), cross-attention: K and V are projected
    from the memory, neither side is rotated, every memory slot is visible
    (the mask is non-causal whatever ``mask_spec`` says) and a ``cache``
    comes back unchanged, so the memory's K and V are recomputed at every
    decode step, as the reference does."""
    xc = x.to(COMPUTE_DTYPE)
    src = xc if kv_source is None else kv_source.to(COMPUTE_DTYPE)
    q = constrain(_proj(xc, p["wq"]), "heads")
    k = constrain(_proj(src, p["wk"]), "heads")
    v = constrain(_proj(src, p["wv"]), "heads")
    if cfg.qkv_bias:
        q = q + p["bq"].to(COMPUTE_DTYPE)
        k = k + p["bk"].to(COMPUTE_DTYPE)
        v = v + p["bv"].to(COMPUTE_DTYPE)
    if cfg.qk_norm:
        q = _qk_head_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_head_norm(k, p["k_norm"], cfg.norm_eps)

    if kv_source is None:       # no rope on cross-attention memories
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        mask_spec = AttnMaskSpec(causal=False)

    new_cache = None
    q_offset = 0
    kv_valid = None
    if cache is not None:
        if "k" in cache and kv_source is None:
            idx = int(cache["len"])
            ck, cv = cache["k"].clone(), cache["v"].clone()
            ck[:, idx:idx + x.shape[1]] = k.to(ck.dtype)
            cv[:, idx:idx + x.shape[1]] = v.to(cv.dtype)
            k, v = ck, cv
            kv_valid = idx + x.shape[1]
            q_offset = idx
            new_cache = {"k": ck, "v": cv, "len": torch.full_like(
                cache["len"], kv_valid)}
        else:
            new_cache = cache

    out = chunked_attention(
        q, k, v,
        mask_spec=mask_spec,
        q_offset=q_offset, kv_chunk=kv_chunk, kv_valid_len=kv_valid,
    )
    y = constrain(torch.einsum("bshk,hkd->bsd", out,
                               p["wo"].to(COMPUTE_DTYPE)), "residual",
                  partial_sum=True)
    return y.to(x.dtype), new_cache


def init_attn_cache(cfg, batch: int, max_len: int, *, shards: int = 16,
                    device=None):
    device = resolve_device(device)
    hkv = cfg.padded_kv_heads(shards)
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, hkv, hd), dtype=COMPUTE_DTYPE,
                         device=device),
        "v": torch.zeros((batch, max_len, hkv, hd), dtype=COMPUTE_DTYPE,
                         device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU) and embeddings
# --------------------------------------------------------------------------

def mlp_schema(d: int, d_ff: int):
    return {
        "wi_gate": ParamSpec((d, d_ff), ("embed", "mlp")),
        "wi_up": ParamSpec((d, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d), ("mlp", "embed")),
    }


def mlp_block(p, x):
    xc = x.to(COMPUTE_DTYPE)
    gate = torch.einsum("bsd,df->bsf", xc, p["wi_gate"].to(COMPUTE_DTYPE))
    up = torch.einsum("bsd,df->bsf", xc, p["wi_up"].to(COMPUTE_DTYPE))
    act = torch.nn.functional.silu(gate.to(torch.float32)).to(
        COMPUTE_DTYPE) * up
    out = torch.einsum("bsf,fd->bsd", act, p["wo"].to(COMPUTE_DTYPE))
    return constrain(out, "residual", partial_sum=True).to(x.dtype)


def embedding_schema(vocab: int, d: int, *, tie: bool):
    sch = {"tokens": ParamSpec((vocab, d), ("vocab", "embed"), init="embed")}
    if not tie:
        sch["unembed"] = ParamSpec((d, vocab), ("embed", "vocab"))
    return sch


def embed(p, tokens):
    """The bf16 rows of the table: the table is converted before the
    gather, as the reference pins it."""
    table = p["tokens"].to(COMPUTE_DTYPE)
    return constrain(table[tokens.to(torch.int64)], "residual",
                     partial_sum=True)


def unembed(p, x, *, tie: bool):
    """Float32 logits of the bf16 product with the (tied) table."""
    xc = x.to(COMPUTE_DTYPE)
    if tie:
        w = p["tokens"].to(COMPUTE_DTYPE).T
    else:
        w = p["unembed"].to(COMPUTE_DTYPE)
    return torch.einsum("bsd,dv->bsv", xc, w).to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  vocab_size: int):
    """Mean NLL over positions with label >= 0; padded vocab columns are
    excluded (set to -1e9).  The max is a constant to the gradient, the
    gold logit is an iota match summed over the vocab (not a gather), and
    the mean divides by max(#valid, 1), so an all-padding batch has loss 0
    and an exactly-zero gradient."""
    logits = logits.to(torch.float32)
    v = logits.shape[-1]
    vocab_pos = torch.arange(v, dtype=torch.int32, device=logits.device)
    if v > vocab_size:
        logits = torch.where(vocab_pos < vocab_size, logits, -1e9)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    logz = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    hit = vocab_pos == torch.clamp_min(labels, 0)[..., None]
    gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    nll = logz - gold
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
