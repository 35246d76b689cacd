"""Public wrappers around the port's kernels, with the oracle path beside.

The port of ``repro/kernels/ops.py``, with its public layout:
:func:`quantize_pack` returns int32 codes shaped ``(R, 128)`` with ``R`` a
multiple of 256 (the reference's tile grid), the pad coded 0, and its
scale; :func:`unpack_dequantize` takes them back to ``size`` float32
values.  ``use_pallas`` (the reference's name) selects the hand-written
kernel path — on a CUDA tensor the kernel, on a CPU tensor its plain
version — and otherwise the oracles of :mod:`repro_torch.kernels.ref`.
Both paths give the same bits as the reference's jitted ``ops.*``; at
b = 32 ``quantize_dequantize``'s oracle goes through saturating int32
codes and the fused kernel does not, as in the reference.

The kernel path makes no padded copy of its input: the quantize kernel
writes the pad's zero codes itself, and the dequantize kernel reads only
the first ``size`` codes.

:func:`flash_decode` is one-token grouped-query decode attention: its
kernel path is the flash-decode kernel
(:mod:`repro_torch.kernels.flash_decode`, zeros at ``valid_len = 0``), its
oracle ``ref.flash_decode_ref`` (NaN there), as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import dorefa, ref
from repro_torch.kernels.aggregate import weighted_aggregate as _aggregate
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode
from repro_torch.kernels.sic_rates import sic_weighted_rates as _sic_rates

LANE = 128          # the reference's tile: (BLOCK_ROWS, LANE)
BLOCK_ROWS = 256
TILE = BLOCK_ROWS * LANE


def padded_size(n: int) -> int:
    """n rounded up to the reference's (256, 128) tile grid."""
    return -(-int(n) // TILE) * TILE


def max_abs_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor max-abs scale, floored at 1e-12 (float32, 0-dim)."""
    return torch.clamp_min(torch.amax(torch.abs(x.to(torch.float32))),
                           dorefa.SCALE_FLOOR)


def quantize_pack(flat: torch.Tensor, bits: int, *, use_pallas: bool = False):
    """Flat vector -> (int32 codes (R, 128), scale).  Static ``bits``."""
    flat = flat.reshape(-1)
    scale = max_abs_scale(flat)
    n_out = padded_size(flat.numel())
    if use_pallas:
        codes = dorefa.quantize_codes(flat, scale, bits, n_out)
    else:
        x = F.pad(flat.to(torch.float32), (0, n_out - flat.numel()))
        codes = ref.quantize_codes_ref(x, bits, scale)
    return codes.reshape(-1, LANE), scale


def unpack_dequantize(codes2d: torch.Tensor, scale: torch.Tensor, bits: int,
                      size: int, *, use_pallas: bool = False) -> torch.Tensor:
    """(R, 128) codes -> the first ``size`` values, float32."""
    codes = codes2d.reshape(-1)[:int(size)]
    if use_pallas:
        return dorefa.dequantize_codes(codes, scale, bits)
    return ref.dequantize_codes_ref(codes, bits, scale)


def quantize_dequantize(x: torch.Tensor, bits: int, *,
                        use_pallas: bool = False) -> torch.Tensor:
    """Fused uplink simulation for one tensor (any shape), in x's type."""
    flat = x.reshape(-1)
    scale = max_abs_scale(flat)
    if use_pallas:
        out = dorefa.quantize_dequantize(flat, scale, bits)
    else:
        out = ref.quantize_dequantize_ref(flat, bits, scale)
    return out.reshape(x.shape).to(x.dtype)


def weighted_aggregate(codes, scales, weights, bits: int, *,
                       use_pallas: bool = False) -> torch.Tensor:
    """sum_k w_k * scale_k * codes_k / a over (K, ...) codes, shaped like
    ``codes[0]``; the kernel path is the aggregation kernel
    (:mod:`repro_torch.kernels.aggregate`)."""
    if use_pallas:
        return _aggregate(codes, scales, weights, bits)
    k = codes.shape[0]
    return ref.weighted_aggregate_ref(
        codes.reshape(k, -1), scales, weights, bits
    ).reshape(codes.shape[1:])


def sic_weighted_rates(powers_vk, gains_vk, weights_vk, noise_power: float,
                       *, use_pallas: bool = False) -> torch.Tensor:
    """Batched NOMA SIC group scoring: (V, K) rows -> (V,) weighted rates;
    the kernel path is the SIC scorer kernel
    (:mod:`repro_torch.kernels.sic_rates`)."""
    if use_pallas:
        return _sic_rates(powers_vk, gains_vk, weights_vk, noise_power)
    return ref.sic_weighted_rates_ref(powers_vk, gains_vk, weights_vk,
                                      noise_power)


def flash_decode(q, k, v, valid_len, *, use_pallas: bool = False,
                 block_s: int = 256):
    """One-token GQA decode attention over a cache (serving hot loop).

    q: (B, Hkv, G, D); k, v: (B, S, Hkv, D); valid_len: an int or a 0-d
    integer tensor.  ``use_pallas`` selects the flash-decode kernel path
    (``S % block_s == 0``)."""
    if use_pallas:
        return _flash_decode(q, k, v, valid_len, block_s=block_s)
    return ref.flash_decode_ref(q, k, v, valid_len)
