"""DoReFa-style adaptive gradient quantization (paper §II-B, Eq. 7), in torch.

    q(pi) = (1/a) * round(a * pi),   a = 2^b - 1

Bit-width adaptation (paper §II-B): device k scheduled with rate R_k may push
``c_k = R_k * B * t`` bits in its slot.  With a full-precision payload of I
bits, the compression ratio is r_k = max(I / c_k, 1) and the quantization
bit-length b_k = floor(32 / r_k), clamped to [1, 32].

The functions take tensors on any device and compute in float32, as the
reference's batched engine does (its bit budgets enter the jitted round as
float32), so bits and ratios equal the reference's exactly.  Two details
keep them exact:

  * a Python number divided by a tensor (``x / t``) is computed by torch as
    ``t.reciprocal() * x``, which is not the correctly rounded quotient;
    every such division here divides two tensors instead;
  * ``torch.round`` rounds half to even, as ``jnp.round`` does.

The quantize-dequantize functions (:func:`quantize`, :func:`dequantize_int`,
:func:`quantize_batched`, :func:`quantize_tree`) follow the reference's
eager op order, ``rint(a * xn) / a * scale`` with a true division by ``a``:
that is how the legacy round calls them (``encode_decode_tree`` outside any
jit), and how a jit with traced bits compiles them.  A jit with static
bits folds ``/ a`` into a product with ``fl(1/a)`` and gives other bits on
about half the elements, within one ulp (``kernels/ref.py`` follows that
form, as the reference's ops do).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.kernels import dorefa
from repro_torch.kernels.ops import max_abs_scale


def _full_like(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(x, float(value), dtype=torch.float32)


def dorefa_levels(bits: torch.Tensor) -> torch.Tensor:
    """a = 2^b - 1 (number of quantization intervals), float32."""
    b = torch.as_tensor(bits).to(torch.float32)
    return torch.pow(_full_like(b, 2.0), b) - 1.0


def compression_ratio(payload_bits, budget_bits: torch.Tensor) -> torch.Tensor:
    """r = max(I / c, 1) (paper §II-B), float32."""
    c = torch.as_tensor(budget_bits).to(torch.float32)
    r = _full_like(c, payload_bits) / torch.clamp_min(c, 1e-9)
    return torch.clamp_min(r, 1.0)


def adaptive_bits(payload_bits, budget_bits: torch.Tensor) -> torch.Tensor:
    """b = floor(32 / r), clamped to [1, 32]; int32."""
    r = compression_ratio(payload_bits, budget_bits)
    b = torch.floor(_full_like(r, 32.0) / r)
    return torch.clamp(b, 1.0, 32.0).to(torch.int32)


def quantize_codes_batched(flat: torch.Tensor, bits_k: torch.Tensor, *,
                           scales=None):
    """Per-client DoReFa codes for a client-stacked (K, N) matrix (Eq. 7).

    Row k is quantized to ``bits_k[k]`` bits with its own max-abs scale (or
    a caller-supplied (K,) ``scales`` vector, e.g. ones for the paper-exact
    fixed [-1, 1] range).  Codes are float32-held: b = 32 means
    a = 2^32 - 1 levels, which overflows int32.

    Returns ``(codes, scales, levels)``, what the fused dequant+aggregate
    consumers need.
    """
    a = dorefa_levels(bits_k)
    xf = flat.to(torch.float32)
    if scales is None:
        scales = torch.clamp_min(torch.amax(torch.abs(xf), dim=1), 1e-12)
    codes = torch.round(
        a[:, None] * torch.clamp(xf / scales[:, None], -1.0, 1.0)
    )
    return codes, scales, a


def _levels(x: torch.Tensor, bits) -> torch.Tensor:
    """a = 2^b - 1 as a float32 tensor on x's device: a tensor ``bits``
    through :func:`dorefa_levels`, a Python int as the float32 constant
    (filled on the device, no host-to-device copy)."""
    if isinstance(bits, torch.Tensor):
        return dorefa_levels(bits).to(x.device)
    return torch.full((), dorefa.levels(bits), dtype=torch.float32,
                      device=x.device)


def _scale_tensor(xf: torch.Tensor, scale) -> torch.Tensor:
    """The per-tensor max-abs scale floored at 1e-12, or the caller's
    ``scale`` (a number or tensor) as a float32 tensor on xf's device."""
    if scale is None:
        return max_abs_scale(xf)
    if isinstance(scale, torch.Tensor):
        return scale.to(device=xf.device, dtype=torch.float32)
    return torch.full((), float(scale), dtype=torch.float32, device=xf.device)


def quantize(x: torch.Tensor, bits, *, scale=None) -> torch.Tensor:
    """Quantize-dequantize x to b bits (Eq. 7); ``bits`` a Python int or a
    0-dim tensor.  With ``scale`` (per-tensor max-abs by default) values are
    normalized into [-1, 1] first; ``scale=1.0`` is the paper-exact codec.
    b >= 32 passes x through exactly."""
    xf = x.to(torch.float32)
    a = _levels(xf, bits)
    s = _scale_tensor(xf, scale)
    q = torch.round(a * torch.clamp(xf / s, -1.0, 1.0)) / a
    out = q * s
    full = torch.as_tensor(bits, device=xf.device) >= 32
    return torch.where(full, xf, out).to(x.dtype)


def quantize_int(x: torch.Tensor, bits: int, *, scale=None):
    """Integer codes in [-a, a] (int32, saturating) and the scale; static
    ``bits``."""
    xf = x.to(torch.float32)
    s = _scale_tensor(xf, scale)
    return dorefa.saturating_int32(dorefa.rounded_levels(xf, s, bits)), s


def dequantize_int(codes: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """(codes / a) * scale in float32, the eager op order."""
    cf = codes.to(torch.float32)
    return (cf / _levels(cf, bits)) * _scale_tensor(cf, scale)


def quantize_batched(x: torch.Tensor, bits_k: torch.Tensor, *,
                     scale=None) -> torch.Tensor:
    """Per-client DoReFa over a client-stacked (K, ...) tensor: row k at
    ``bits_k[k]`` bits with its own max-abs scale (``scale=1.0`` for the
    paper-exact range), b >= 32 rows passed through exactly."""
    k = x.shape[0]
    flat = x.to(torch.float32).reshape(k, -1)
    bits_k = torch.as_tensor(bits_k).to(flat.device)
    svec = (None if scale is None
            else _scale_tensor(flat, scale).expand(k).contiguous())
    codes, scales, a = quantize_codes_batched(flat, bits_k, scales=svec)
    q = (codes / a[:, None]) * scales[:, None]
    out = torch.where(bits_k.reshape(k, 1) >= 32, flat, q)
    return out.reshape(x.shape).to(x.dtype)


def quantize_tree(grads, bits, *, paper_exact: bool = False):
    """Quantize-dequantize every leaf of a nested-dict tree to ``bits``: a
    Python int or 0-dim tensor (every leaf alike) or a (K,) tensor, when
    every leaf carries a leading client axis of length K
    (:func:`quantize_batched`).  ``paper_exact`` uses the fixed [-1, 1]
    range of Eq. (7); otherwise each leaf (or client row) carries its own
    max-abs scale."""
    scale = 1.0 if paper_exact else None
    if isinstance(bits, torch.Tensor) and bits.dim() == 1:
        return tree_lib.tree_map(
            lambda g: quantize_batched(g, bits, scale=scale), grads)
    return tree_lib.tree_map(lambda g: quantize(g, bits, scale=scale), grads)


def quantization_error(x: torch.Tensor, bits) -> torch.Tensor:
    """RMS quantization error."""
    return torch.sqrt(torch.mean(torch.square(x - quantize(x, bits))))
