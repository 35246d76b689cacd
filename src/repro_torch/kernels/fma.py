"""Exactly rounded float32 fused multiply-adds in plain tensor ops.

The reference's float32 reductions over the client axis are fused
multiply-adds as XLA compiles them on the CPU: the Pallas aggregation
kernels' ``acc + x * c`` and the FL round's ``einsum("k,kn->n", w, x)``
alike are ``fma(w_k, x_k, acc)`` for k = 0, 1, ... in order, from zero.
The CUDA kernels take ``__fmaf_rn``; the plain versions take
:func:`fma_f32`, which gives the same single rounding on any device.
"""
from __future__ import annotations

import torch


def fma_f32(acc: torch.Tensor, x: torch.Tensor, c: torch.Tensor):
    """``acc + x * c`` in float32 with one rounding, as a fused
    multiply-add gives it (CUDA's ``__fmaf_rn``).

    The product of two float32 values is exact in float64; the float64 sum
    ``s`` is rounded to odd (an inexact sum whose last bit is even moves
    one float64 ulp toward the exact sum, whose side the TwoSum error ``e``
    gives), and a round-to-odd value with 53 bits rounds to the 24 of
    float32 exactly as the exact sum would."""
    a = acc.to(torch.float64)
    # x is rounded to float32 first, as the kernels' int -> float
    # conversion rounds an int32 code above 2^24: then the product is exact
    p = x.to(torch.float32).to(torch.float64) * c.to(torch.float64)
    s = a + p
    bv = s - a
    e = (a - (s - bv)) + (p - bv)                       # exact: a + p = s + e
    bits = s.view(torch.int64)
    odd = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((e > 0) == (s > 0), 1, -1)       # toward s + e
    return (bits + torch.where(odd, step, 0)).view(torch.float64) \
        .to(torch.float32)


def fma_dot(w: torch.Tensor, x: torch.Tensor, acc=None) -> torch.Tensor:
    """acc + sum_k w[k] * x[k] over a (K, N) matrix -> (N,) float32, as K
    fused multiply-adds in order, from ``acc`` (default zero): XLA's
    float32 ``k,kn->n`` contraction on the CPU, to the bit.  XLA folds an
    addend ``y + einsum(...)`` into the chain as its starting value."""
    if acc is None:
        acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for k in range(x.shape[0]):
        acc = fma_f32(acc, x[k], w[k])
    return acc
