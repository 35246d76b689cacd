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
"""
from __future__ import annotations

import torch


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
