"""Fused dequant + weighted server aggregation (paper Algorithm 1 line 10).

The PS update is the weighted sum of K dequantized client payloads,

    out[n] = sum_k codes[k, n] * scale_k * w_k / a_k,

fused so that the dequantized per-client tensors are never materialized.
It replaces the Pallas kernel
``repro/kernels/aggregate.py:weighted_aggregate_pallas``; the Hopper kernel
is ``csrc/aggregate.cu`` (CUDA C++, built by :mod:`cuda_build`, loaded with
``ctypes``).  Beside it sits :func:`weighted_aggregate_plain`, the plain
PyTorch version of the same function.

Dispatch is by the device of ``codes``: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel.  On a CUDA tensor the wrapper
launches the kernel or raises — a failed build or launch is an error, never
a quiet fall back to the plain version.  ``weighted_aggregate.launches``
counts the kernel's launches (plain-version calls do not count).

The divisor a_k comes from exactly one of a static ``bits`` (all clients
alike) or a per-client ``levels`` vector; codes may be int32 or
float32-held (b = 32 gives 2^32 - 1 levels, beyond int32).  K = 0 or an
empty payload gives zeros without a launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build
from repro_torch.kernels.fma import fma_dot

KERNEL = "aggregate"

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        for fn in (lib.weighted_aggregate_f32, lib.weighted_aggregate_i32):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.aggregate_error_string.argtypes = [ctypes.c_int]
        lib.aggregate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def coefficients(scales, weights, levels) -> torch.Tensor:
    """coeff_k = scale_k * w_k / a_k in float32, the reference's op order."""
    return (
        scales.to(torch.float32) * weights.to(torch.float32)
        / levels.to(torch.float32)
    )


def weighted_aggregate_plain(codes: torch.Tensor, coeff: torch.Tensor):
    """Plain PyTorch version: (K, N) codes, (K,) coeff -> (N,) float32.

    Sums k = 0..K-1 in order from zero, one fused multiply-add per client:
    the Pallas kernel's ``acc + c * coeff`` as XLA compiles it in the
    reference's jitted round, and the CUDA kernel's ``__fmaf_rn``, so the
    three agree to the bit."""
    return fma_dot(coeff, codes)


def _launch(flat: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on a contiguous (K, N) CUDA matrix."""
    lib = _library()    # a failed build raises here, before any launch
    if flat.dtype == torch.float32:
        fn_name = "weighted_aggregate_f32"
    elif flat.dtype == torch.int32:
        fn_name = "weighted_aggregate_i32"
    else:
        raise TypeError(f"codes must be float32 or int32, got {flat.dtype}")
    k, n = flat.shape
    coeff = coeff.to(device=flat.device, dtype=torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=flat.device)
    vectorized = int(
        n % 4 == 0 and flat.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    )
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        status = getattr(lib, fn_name)(
            flat.data_ptr(), coeff.data_ptr(), out.data_ptr(), k, n,
            vectorized, stream,
        )
    if status != 0:
        reason = lib.aggregate_error_string(status).decode()
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name=fn_name, reason=reason)
        )
    weighted_aggregate.launches += 1
    return out


def weighted_aggregate(codes, scales, weights, bits=None, *, levels=None):
    """sum_k w_k * scale_k * codes_k / a_k, shaped like ``codes[0]``.

    Exactly one of ``bits`` (static, shared by all clients) or ``levels``
    (per-client (K,) tensor) selects the dequant divisor.
    """
    if (bits is None) == (levels is None):
        raise ValueError("pass exactly one of bits= or levels=")
    k = codes.shape[0]
    out_shape = codes.shape[1:]
    n = 1
    for d in out_shape:
        n *= int(d)
    if k == 0 or n == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=codes.device)
    if levels is None:
        levels = torch.full(
            (k,), float(2 ** int(bits) - 1), dtype=torch.float32,
            device=codes.device,
        )
    coeff = coefficients(scales, weights, levels)
    flat = codes.reshape(k, n)
    if codes.device.type == "cpu":
        out = weighted_aggregate_plain(flat, coeff)
    elif codes.device.type == "cuda":
        out = _launch(flat.contiguous(), coeff)
    else:
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(codes.device)))
    return out.reshape(out_shape)


weighted_aggregate.launches = 0
