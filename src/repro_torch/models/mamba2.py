"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060]: the port of
``repro/models/mamba2.py``.

The chunked SSD algorithm: within a chunk a quadratic, attention-like
product, across chunks a linear state recurrence.  Decode is the O(1)
per-token recurrence ``h <- h * exp(dt * A) + dt * B x;  y = C.h + D * x``.

Layout: d_inner = expand * d_model is split into H = d_inner / P heads
(P = ``ssm_head_dim``); B and C are shared by the heads of a group (G
groups).  A depthwise causal convolution (width W) runs over
concat(x, B, C), as in Mamba2.  The decay, its cumsum and ``exp(segsum)``
(``-inf`` above the diagonal) stay float32, as the reference keeps them;
the SSD products take their operands in ``einsum_dtype`` (bf16 under
``cfg.ssm_bf16``) and accumulate in float32, the reference's
``preferred_element_type``.  A full-sequence block pads S up to a multiple
of ``cfg.ssm_chunk`` with zeros, as the reference does.

The reference's ``jax.checkpoint`` and ``unroll`` only steer XLA and have
no counterpart; its forward without caches also returns the stacked final
states, which nothing reads: here it returns ``None`` for them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamSpec, stacked

SSD_CHUNK = 128
F32 = torch.float32


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


def block_schema(cfg):
    d = cfg.d_model
    d_in, h, p_, g, n = dims(cfg)
    conv_dim = d_in + 2 * g * n
    return {
        "ln": L.rmsnorm_schema(d),
        "in_x": ParamSpec((d, d_in), ("embed", "mlp")),
        "in_z": ParamSpec((d, d_in), ("embed", "mlp")),
        "in_b": ParamSpec((d, g * n), ("embed", None)),
        "in_c": ParamSpec((d, g * n), ("embed", None)),
        "in_dt": ParamSpec((d, h), ("embed", "heads")),
        "dt_bias": ParamSpec((h,), ("heads",), init="zeros"),
        "a_log": ParamSpec((h,), ("heads",), init="ssm_a"),
        "d_skip": ParamSpec((h,), ("heads",), init="ones"),
        "conv_w": ParamSpec((cfg.ssm_conv_width, conv_dim), (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "norm_gate": ParamSpec((d_in,), ("mlp",), init="ones"),
        "out": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def schema(cfg, *, shards: int = 16):
    return {
        "embed": L.embedding_schema(cfg.padded_vocab, cfg.d_model,
                                    tie=cfg.tie_embeddings),
        "layers": stacked(block_schema(cfg), cfg.num_layers),
        "ln_f": L.rmsnorm_schema(cfg.d_model),
    }


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """segsum(x)[..., i, j] = sum_{j < k <= i} x_k; -inf above the
    diagonal."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def _mm(spec: str, *ops) -> torch.Tensor:
    """A product of ``einsum_dtype`` operands accumulated in float32 (the
    reference's ``preferred_element_type=float32``): bf16 operands are
    exact in float32."""
    return torch.einsum(spec, *(o.to(F32) for o in ops))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int = SSD_CHUNK,
                init_state=None, einsum_dtype=F32):
    """Chunked SSD scan.

    x: (B, S, H, P), dt: (B, S, H), a_log: (H,), b and c: (B, S, G, N)
    (H a multiple of G; head h reads group h // (H / G)).  Returns
    (y (B, S, H, P) float32, final_state (B, H, P, N) float32)."""
    bsz, s, h, p_ = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    ed = einsum_dtype
    a = -torch.exp(a_log.to(F32))                                # (H,)
    da = dt.to(F32) * a[None, None, :]                           # (B,S,H)
    xd = x.to(F32) * dt.to(F32)[..., None]

    dac = da.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)      # (B,H,C,L)
    xc = xd.to(ed).reshape(bsz, nc, chunk, h, p_)
    rep = h // g
    bh = b.to(ed).reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    ch = c.to(ed).reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da_cs = torch.cumsum(dac, dim=-1)                            # (B,H,C,L)
    lmat = torch.exp(_segsum(dac)).to(ed)                        # (B,H,C,L,L)

    # "bclhn,bcshn,bhcls,bcshp->bclhp": C.B^T, masked by the decay, times x
    scores = _mm("bclhn,bcshn->bhcls", ch, bh) * lmat.to(F32)
    y_diag = _mm("bhcls,bcshp->bclhp", scores, xc)

    decay_states = torch.exp(da_cs[..., -1:] - da_cs).to(ed)     # (B,H,C,L)
    states = _mm("bclhn,bhcl,bclhp->bchpn", bh, decay_states, xc)

    if init_state is None:
        init_state = torch.zeros((bsz, h, p_, n), dtype=F32, device=x.device)

    # the across-chunk recurrence (sequential; nc is small)
    chunk_decay = torch.exp(da_cs[..., -1])                      # (B,H,C)
    prev = init_state
    prevs = []
    for i in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, :, i, None, None] + states[:, i]
    final = prev
    prev_states = torch.stack(prevs, dim=1)                      # (B,C,H,P,N)

    state_decay_out = torch.exp(da_cs).to(ed)                    # (B,H,C,L)
    y_off = _mm("bclhn,bchpn,bhcl->bclhp", ch, prev_states.to(ed),
                state_decay_out)

    y = (y_diag + y_off).reshape(bsz, s, h, p_)
    return y, final


def ssd_step(state, x_t, dt_t, a_log, b_t, c_t):
    """The O(1) decode recurrence.  state (B, H, P, N); x_t (B, H, P);
    dt_t (B, H); b_t and c_t (B, G, N)."""
    h = x_t.shape[1]
    g = b_t.shape[1]
    rep = h // g
    a = -torch.exp(a_log.to(F32))
    dec = torch.exp(dt_t.to(F32) * a[None, :])                   # (B,H)
    bh = b_t.to(F32).repeat_interleave(rep, dim=1)               # (B,H,N)
    ch = c_t.to(F32).repeat_interleave(rep, dim=1)
    xd = x_t.to(F32) * dt_t.to(F32)[..., None]
    new = state * dec[..., None, None] + xd[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new, ch)
    return y, new


# --------------------------------------------------------------------------
# Mamba2 block (conv + gating + SSD)
# --------------------------------------------------------------------------

def _causal_conv(u, w, bias):
    """Depthwise causal convolution.  u: (B, S, C), w: (W, C); float32,
    the taps summed in order."""
    width = w.shape[0]
    up = torch.nn.functional.pad(u, (0, 0, width - 1, 0))
    out = torch.zeros(u.shape, dtype=F32, device=u.device)
    for i in range(width):
        out = out + up[:, i:i + u.shape[1], :].to(F32) * w[i][None, None, :] \
            .to(F32)
    return out + bias.to(F32)


def _conv_step(conv_state, u_t, w, bias):
    """conv_state: (B, W-1, C) past inputs; u_t: (B, C)."""
    window = torch.cat([conv_state, u_t[:, None, :].to(conv_state.dtype)],
                       dim=1)                                    # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window.to(F32), w.to(F32))
    return out + bias.to(F32), window[:, 1:, :]


def _gated_norm(y, z, scale, eps):
    yf = y.to(F32) * _silu(z.to(F32))
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * scale.to(F32)


def _in_proj(p, xc, spec):
    bf = L.COMPUTE_DTYPE
    return [torch.einsum(spec, xc, p[name].to(bf))
            for name in ("in_x", "in_z", "in_b", "in_c", "in_dt")]


def mamba_block(p, x, cfg, *, state=None):
    """Full-sequence Mamba2 block.  x: (B, S, D).

    state: ``None`` (training, or a prefill from scratch) or
    ``{"ssm": (B, H, P, N), "conv": (B, W-1, conv_dim)}``.  Returns (out,
    new_state); with a state, new_state keeps the last W-1 convolution
    inputs for the decode that follows."""
    d_in, h, p_, g, n = dims(cfg)
    bsz, s, _ = x.shape
    xin = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    xc = xin.to(L.COMPUTE_DTYPE)

    xs, z, bproj, cproj, dt_raw = _in_proj(p, xc, "bsd,di->bsi")
    dt = _softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))

    conv_in = torch.cat([xs, bproj, cproj], dim=-1)
    conv_out = _silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs = conv_out[..., :d_in].reshape(bsz, s, h, p_)
    bmat = conv_out[..., d_in:d_in + g * n].reshape(bsz, s, g, n)
    cmat = conv_out[..., d_in + g * n:].reshape(bsz, s, g, n)

    chunk = cfg.ssm_chunk
    pad = (-s) % chunk
    if pad:
        xs_p = torch.nn.functional.pad(xs, (0, 0, 0, 0, 0, pad))
        dt_p = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b_p = torch.nn.functional.pad(bmat, (0, 0, 0, 0, 0, pad))
        c_p = torch.nn.functional.pad(cmat, (0, 0, 0, 0, 0, pad))
    else:
        xs_p, dt_p, b_p, c_p = xs, dt, bmat, cmat
    init_ssm = None if state is None else state["ssm"]
    y, final = ssd_chunked(
        xs_p, dt_p, p["a_log"], b_p, c_p, chunk=chunk, init_state=init_ssm,
        einsum_dtype=L.COMPUTE_DTYPE if cfg.ssm_bf16 else F32)
    y = y[:, :s]
    y = y + p["d_skip"].to(F32)[None, None, :, None] * xs.to(F32)
    y = y.reshape(bsz, s, d_in)

    y = _gated_norm(y, z, p["norm_gate"], cfg.norm_eps).to(L.COMPUTE_DTYPE)
    out = torch.einsum("bsi,id->bsd", y, p["out"].to(L.COMPUTE_DTYPE))
    new_state = {"ssm": final, "conv": None}
    if state is not None:
        width = cfg.ssm_conv_width
        tail = torch.cat([state["conv"], conv_in.to(F32)],
                         dim=1)[:, -(width - 1):, :]
        new_state = {"ssm": final, "conv": tail}
    return out.to(x.dtype), new_state


def mamba_decode_step(p, x, cfg, state):
    """One-token step.  x: (B, 1, D); state: ``{"ssm", "conv"}``."""
    d_in, h, p_, g, n = dims(cfg)
    bsz = x.shape[0]
    xin = L.rmsnorm(p["ln"], x, cfg.norm_eps)[:, 0]
    xc = xin.to(L.COMPUTE_DTYPE)
    xs, z, bproj, cproj, dt_raw = _in_proj(p, xc, "bd,di->bi")
    dt = _softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))

    conv_in = torch.cat([xs, bproj, cproj], dim=-1)              # (B, conv)
    conv_out, new_conv = _conv_step(state["conv"], conv_in, p["conv_w"],
                                    p["conv_b"])
    conv_out = _silu(conv_out)
    x_t = conv_out[:, :d_in].reshape(bsz, h, p_)
    b_t = conv_out[:, d_in:d_in + g * n].reshape(bsz, g, n)
    c_t = conv_out[:, d_in + g * n:].reshape(bsz, g, n)

    y, new_ssm = ssd_step(state["ssm"], x_t, dt, p["a_log"], b_t, c_t)
    y = y + p["d_skip"].to(F32)[None, :, None] * x_t.to(F32)
    y = y.reshape(bsz, d_in)
    y = _gated_norm(y, z, p["norm_gate"], cfg.norm_eps).to(L.COMPUTE_DTYPE)
    out = (y @ p["out"].to(L.COMPUTE_DTYPE)).to(x.dtype)
    return out[:, None, :], {"ssm": new_ssm, "conv": new_conv}


def init_state(cfg, batch: int, *, device=None):
    device = resolve_device(device)
    d_in, h, p_, g, n = dims(cfg)
    conv_dim = d_in + 2 * g * n
    return {
        "ssm": torch.zeros((batch, h, p_, n), dtype=F32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=F32, device=device),
    }


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------

def mamba_stack(layers, x, cfg, caches, *, decode: bool):
    """The residual stack over stacked (L, ...) layer parameters: each
    layer's block (or decode step) added to the stream.  Returns (x, the
    stacked new states, or ``None`` without caches)."""
    n = tree_lib.tree_flatten(layers)[0][0].shape[0]
    layer_params = T._per_layer(layers, n)
    layer_caches = [None] * n if caches is None else T._per_layer(caches, n)
    new_states = []
    for p_layer, st in zip(layer_params, layer_caches):
        if decode:
            y, new_st = mamba_decode_step(p_layer, x, cfg, st)
        else:
            y, new_st = mamba_block(p_layer, x, cfg, state=st)
        x = x + y
        new_states.append(new_st)
    if caches is None:
        return x, None
    return x, tree_lib.tree_map(lambda *ss: torch.stack(ss), *new_states)


def forward(params, tokens, cfg, *, caches: Optional[dict] = None, **_):
    """Returns (logits (B, S, V) float32, new_caches).  A one-token call
    with caches is a decode step; otherwise every layer runs its
    full-sequence block (a prefill when caches are given).  Attention
    keywords (``kv_chunk``) are accepted and unused, as the reference's
    are."""
    x = L.embed(params["embed"], tokens)
    decode = caches is not None and tokens.shape[1] == 1
    x, new_caches = mamba_stack(params["layers"], x, cfg, caches,
                                decode=decode)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x, tie=cfg.tie_embeddings)
    return logits, new_caches


def loss_fn(params, batch, cfg, **kw):
    logits, _ = forward(params, batch["tokens"], cfg, **kw)
    return L.cross_entropy(logits, batch["labels"], vocab_size=cfg.vocab_size)


def _repeat(tree, n: int):
    return tree_lib.tree_map(lambda x: x[None].expand(n, *x.shape).clone(),
                             tree)


def init_cache(cfg, batch: int, max_len: int, *, shards: int = 16,
               device=None):
    return _repeat(init_state(cfg, batch, device=device), cfg.num_layers)


def decode_step(params, caches, tokens, cfg, **_):
    return forward(params, tokens, cfg, caches=caches)
