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
a quiet fall back to the plain version.

:func:`weighted_aggregate_group` reduces a list of such matrices (every
leaf of an FL round) in one launch of the grouped kernel, up to
``MAX_SEGMENTS`` matrices per launch; :func:`weighted_aggregate` is its
one-matrix case.  ``weighted_aggregate.launches`` counts the kernel's
launches through either wrapper (plain-version calls do not count).

The divisor a_k comes from exactly one of a static ``bits`` (all clients
alike) or a per-client ``levels`` vector; codes may be int32 or
float32-held (b = 32 gives 2^32 - 1 levels, beyond int32).  K = 0 or an
empty payload gives zeros without a launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build
from repro_torch.kernels.fma import fma_dot

KERNEL = "aggregate"
MAX_SEGMENTS = 16       # csrc/aggregate.cu kMaxSegments: matrices per launch
CODE_DTYPES = (torch.float32, torch.int32)


class _Segment(ctypes.Structure):
    """csrc/aggregate.cu ``Segment``: one (K, N) matrix of a group."""
    _fields_ = [("codes", ctypes.c_void_p), ("coeff", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("k", ctypes.c_int), ("vectorized", ctypes.c_int)]


class _Group(ctypes.Structure):
    """csrc/aggregate.cu ``Group``, handed to the kernel by value."""
    _fields_ = [("seg", _Segment * MAX_SEGMENTS),
                ("first_block", ctypes.c_int * (MAX_SEGMENTS + 1)),
                ("count", ctypes.c_int)]


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        lib.weighted_aggregate_group.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.weighted_aggregate_group.restype = ctypes.c_int
        lib.aggregate_attributes.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.aggregate_attributes.restype = ctypes.c_int
        lib.aggregate_error_string.argtypes = [ctypes.c_int]
        lib.aggregate_error_string.restype = ctypes.c_char_p
        layout = (lib.aggregate_max_segments(), lib.aggregate_group_bytes())
        if layout != (MAX_SEGMENTS, ctypes.sizeof(_Group)):
            raise RuntimeError(
                f"csrc/aggregate.cu's group table (segments, bytes) {layout} "
                f"!= the wrapper's {(MAX_SEGMENTS, ctypes.sizeof(_Group))}")
        _lib = lib
    return _lib


def attributes(dtype) -> dict:
    """Registers, shared and local bytes and CTAs per SM of the grouped
    kernel for ``dtype`` (float32 or int32) codes."""
    return cuda_build.read_attributes(
        _library().aggregate_attributes, int(dtype == torch.int32))


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


def _launch_group(flats, coeffs):
    """Run the grouped kernel over contiguous (K, N) CUDA matrices of one
    dtype with K, N > 0, one launch per ``MAX_SEGMENTS``; returns the (N,)
    outputs, views of one buffer at 16-byte aligned offsets."""
    lib = _library()    # a failed build raises here, before any launch
    dev = flats[0].device
    starts = [0]
    for flat in flats:
        starts.append(starts[-1] + -(-flat.shape[1] // 4) * 4)
    buf = torch.empty(starts[-1], dtype=torch.float32, device=dev)
    outs = [buf[a:a + flat.shape[1]] for a, flat in zip(starts, flats)]
    int32 = int(flats[0].dtype == torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first in range(0, len(flats), MAX_SEGMENTS):
            group = _Group()
            part = range(first, min(first + MAX_SEGMENTS, len(flats)))
            for j, i in enumerate(part):
                k, n = flats[i].shape
                group.seg[j] = _Segment(
                    flats[i].data_ptr(), coeffs[i].data_ptr(),
                    outs[i].data_ptr(), n, k,
                    int(n % 4 == 0 and flats[i].data_ptr() % 16 == 0
                        and outs[i].data_ptr() % 16 == 0),
                )
            group.count = len(part)
            status = lib.weighted_aggregate_group(ctypes.byref(group), int32,
                                                  stream)
            if status != 0:
                reason = lib.aggregate_error_string(status).decode()
                raise RuntimeError(errors.ERR_KERNEL_LAUNCH.format(
                    name="weighted_aggregate_group", reason=reason))
            weighted_aggregate.launches += 1
    return outs


def _launch(flat: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Run the kernel on one contiguous (K, N) CUDA matrix, K, N > 0, and
    its contiguous float32 (K,) coeff on the same card."""
    return _launch_group([flat], [coeff])[0]


def weighted_aggregate_group(codes_list, coeff_list) -> list:
    """``[sum_k coeff[k] * codes[k] for codes, coeff in zip(...)]``: each
    codes (K, ...) of one dtype (float32 or int32) on one device, each
    coeff (K,) float32; each result shaped like ``codes[0]``, float32.

    On the CPU each matrix goes through :func:`weighted_aggregate_plain`;
    on a CUDA device the non-empty ones go through the grouped kernel, one
    launch per ``MAX_SEGMENTS`` of them (none if all are empty).
    """
    if len(codes_list) != len(coeff_list):
        raise ValueError(f"{len(codes_list)} code matrices but "
                         f"{len(coeff_list)} coefficient vectors")
    if not codes_list:
        return []
    dtype, dev = codes_list[0].dtype, codes_list[0].device
    for codes, coeff in zip(codes_list, coeff_list):
        if codes.dtype != dtype or codes.dtype not in CODE_DTYPES:
            raise TypeError(f"codes must all be float32 or all int32, got "
                            f"{[c.dtype for c in codes_list]}")
        if codes.device != dev:
            raise ValueError(f"codes on {codes.device} and {dev}")
        if codes.dim() < 1 or tuple(coeff.shape) != (codes.shape[0],):
            raise ValueError(f"coeff {tuple(coeff.shape)} does not match "
                             f"codes {tuple(codes.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(dev)))
    work = [i for i, codes in enumerate(codes_list)
            if codes.shape[0] and math.prod(codes.shape[1:])]  # non-empty
    if work and dev.type == "cuda":
        _library()      # a failed build raises here, before any device work
    flats = [codes_list[i].reshape(codes_list[i].shape[0], -1) for i in work]
    coeffs = [coeff_list[i].to(device=dev, dtype=torch.float32) for i in work]
    if dev.type == "cpu":
        done = [weighted_aggregate_plain(f, c) for f, c in zip(flats, coeffs)]
    else:
        done = _launch_group([f.contiguous() for f in flats],
                             [c.contiguous() for c in coeffs]) if work else []
    done = dict(zip(work, done))
    return [done[i].reshape(codes.shape[1:]) if i in done else
            torch.zeros(codes.shape[1:], dtype=torch.float32, device=dev)
            for i, codes in enumerate(codes_list)]


def weighted_aggregate(codes, scales, weights, bits=None, *, levels=None):
    """sum_k w_k * scale_k * codes_k / a_k, shaped like ``codes[0]``.

    Exactly one of ``bits`` (static, shared by all clients) or ``levels``
    (per-client (K,) tensor) selects the dequant divisor.  The one-matrix
    case of :func:`weighted_aggregate_group`.
    """
    if (bits is None) == (levels is None):
        raise ValueError("pass exactly one of bits= or levels=")
    if levels is None:
        levels = torch.full(
            (codes.shape[0],), float(2 ** int(bits) - 1), dtype=torch.float32,
            device=codes.device,
        )
    return weighted_aggregate_group(
        [codes], [coefficients(scales, weights, levels)])[0]


weighted_aggregate.launches = 0
