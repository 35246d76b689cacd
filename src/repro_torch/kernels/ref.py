"""Plain tensor oracles behind ``ops.*(use_pallas=False)``.

The port of ``repro/kernels/ref.py``.  Each function computes what the
reference's oracle computes as ``repro/kernels/ops.py`` calls it, inside a
``jax.jit`` with a static bit width.  There ``a = 2^b - 1`` is a constant,
and XLA compiles ``codes / a * scale`` to ``codes * (scale * fl(1/a))``
(the float32 reciprocal, reassociated): that is the form written here, and
it differs from the source text's ``codes / a * scale`` by an ulp on most
elements.  The division by the scale, a traced value, stays a true
division (a tensor divided by a tensor).  Codes pass through a saturating
int32 cast, as the reference's ``astype(jnp.int32)`` does, also inside
:func:`quantize_dequantize_ref` (so at b = 32 it differs from the fused
kernel, which never casts).

``flash_decode_ref`` is the decode-attention oracle as the source writes
it: one float32 softmax over every position, ``-inf`` at positions >=
``valid_len`` (so ``valid_len = 0`` gives NaN, as in the reference).
"""
from __future__ import annotations

import torch

from repro_torch.core import rates_device
from repro_torch.kernels import dorefa


def quantize_codes_ref(x: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """DoReFa integer codes: rint(a * clip(x/scale, -1, 1)) as int32 (the
    scale is not floored here, the kernel floors it)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return dorefa.saturating_int32(dorefa.rounded_levels(x, s, bits))


def dequantize_codes_ref(codes: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """codes * (scale * fl(1/a)) in float32 (the compiled form of
    ``codes / a * scale``): the dequantize kernel's arithmetic."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    return dorefa.dequantize_codes_plain(codes, s, bits).reshape(codes.shape)


def quantize_dequantize_ref(x: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """Fused q->dq through int32 codes, cast back to x's type."""
    return dequantize_codes_ref(
        quantize_codes_ref(x, bits, scale), bits, scale
    ).to(x.dtype)


def weighted_aggregate_ref(codes: torch.Tensor, scales: torch.Tensor,
                           weights: torch.Tensor, bits: int) -> torch.Tensor:
    """Server-side fused dequant + weighted sum: sum_k w_k dq(codes_k) over
    (K, N) codes -> (N,) float32."""
    step = scales.to(torch.float32) * dorefa.inv_levels(bits)
    deq = codes.to(torch.float32) * step[:, None]
    return torch.sum(weights.to(torch.float32)[:, None] * deq, dim=0)


def flash_decode_ref(q, k, v, valid_len) -> torch.Tensor:
    """One-token GQA decode oracle. q: (B, H, G, D); k, v: (B, S, H, D)
    -> (B, H, G, D) in q's type.  The scale divides by the float32
    ``sqrt(D)``, tensor by tensor, as the reference's ``/ jnp.sqrt(d)``."""
    d = q.shape[-1]
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32),
                     k.to(torch.float32))
    s = s / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                    device=q.device))
    pos = torch.arange(k.shape[1], device=q.device)
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.to(q.device)
    s = torch.where(pos < valid_len, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p,
                        v.to(torch.float32)).to(q.dtype)


def sic_weighted_rates_ref(powers_vk, gains_vk, weights_vk, noise_power):
    """Batched SIC weighted sum-rate oracle: (V, K) -> (V,), float32.

    The port's sorted SIC engine (:mod:`repro_torch.core.rates_device`) at
    the kernels' float32 working precision, as the reference delegates to
    ``rates_jax``: decode order descending receive power, ties to the lower
    index; the interference tail is the shifted suffix sum."""
    return rates_device.batched_weighted_rates(
        torch.as_tensor(powers_vk).to(torch.float32),
        torch.as_tensor(gains_vk).to(torch.float32),
        torch.as_tensor(weights_vk).to(torch.float32),
        noise_power,
    )
