"""Threefry-2x32 draws on the card: jax.random's uniforms, normals and
truncated normals in one kernel launch.

:mod:`repro_torch.core.prng` recomputes the reference's streams in integer
and float64 tensor ops, bit for bit on any device (its :func:`draw_plain
<repro_torch.core.prng.draw_plain>` is this kernel's plain version), but
one normal draw takes about 1,300 of those ops.  On the card the same
function is ``csrc/threefry.cu`` (CUDA C++, built by :mod:`cuda_build`,
loaded with ``ctypes``): one launch, the same bits.  The draw's device
code lives in ``csrc/threefry.cuh``, which the keyed OTA reduction
(:func:`repro_torch.kernels.ota_aggregate.ota_aggregate_keyed`) includes
too, so it forms the same normals in its own registers.  ``prng.draw``
(and so ``prng.uniform``, ``normal`` and ``truncated_normal``) sends a
CUDA device here and a CPU device to the plain version; this wrapper
launches or raises, never falls back.  ``threefry_draw.launches`` counts
its launches.  It replaces no Pallas kernel: the reference draws with
``jax.random`` under XLA.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build
from repro_torch.utils import sanitizers

KERNEL = "threefry"
MASK32 = 0xFFFFFFFF

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        lib.threefry_draw_f32.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.threefry_draw_f32.restype = ctypes.c_int
        lib.threefry_normal_bf16.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.threefry_normal_bf16.restype = ctypes.c_int
        lib.threefry_error_string.argtypes = [ctypes.c_int]
        lib.threefry_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


MODES = ("uniform", "normal", "bf16")


def attributes(mode: str, n: int) -> dict:
    """Registers, shared and local bytes, CTA size and CTAs per SM of the
    kernel that draws ``n`` values of ``mode`` (one of :data:`MODES`), and
    ``values_per_thread``, the values its threads draw as one group."""
    lib = _library()
    which = MODES.index(mode)
    lib.threefry_attributes.argtypes = [ctypes.c_int, ctypes.c_int64,
                                        ctypes.c_void_p]
    lib.threefry_attributes.restype = ctypes.c_int
    lib.threefry_group.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.threefry_group.restype = ctypes.c_int
    out = cuda_build.read_attributes(lib.threefry_attributes, which, n)
    out["values_per_thread"] = lib.threefry_group(which, n)
    return out


def uniform_bounds(minval: float, maxval: float):
    """(lo, span) as the kernels take a uniform's bounds: ``minval`` in
    float32 and ``maxval - minval`` rounded to float32, as jax.random
    forms them."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), float(hi - lo)


def threefry_draw(key, n: int, minval: float, maxval: float, *,
                  normal: bool = False, clip=None, dtype=torch.float32,
                  device) -> torch.Tensor:
    """(n,) float32 on the CUDA ``device``: ``jax.random.uniform(key, (n,),
    float32, minval, maxval)``, or with ``normal`` ``sqrt(2) * erf_inv`` of
    that uniform clamped to ``clip = (lo, hi)`` (``None``: unclamped).
    With ``dtype=torch.bfloat16`` (a normal on ``[nextafter(-1, 0), 1)``,
    unclamped, only): ``jax.random.normal(key, (n,), bfloat16)``, (n,)
    bfloat16 (``prng.normal_bf16_plain`` is its plain version)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(device)))
    bf16 = dtype == torch.bfloat16
    if bf16 and not (normal and clip is None):
        raise ValueError("the bfloat16 mode draws unclamped normals only")
    lib = _library()    # a failed build raises here, before any launch
    n = int(n)
    out = torch.empty(n, dtype=dtype, device=device)
    if n == 0:
        return out
    lo, span = uniform_bounds(minval, maxval)
    clip_lo, clip_hi = (-np.inf, np.inf) if clip is None else clip
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if bf16:
            status = lib.threefry_normal_bf16(k0, k1, n, out.data_ptr(),
                                              stream)
        else:
            status = lib.threefry_draw_f32(
                k0, k1, n, int(bool(normal)), lo, span, float(clip_lo),
                float(clip_hi), out.data_ptr(), stream,
            )
    if status != 0:
        reason = lib.threefry_error_string(status).decode()
        name = "threefry_normal_bf16" if bf16 else "threefry_draw_f32"
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name=name, reason=reason)
        )
    threefry_draw.launches += 1
    if sanitizers.NAN_CHECK:
        sanitizers.check_kernel_outputs("threefry_draw", out)
    return out


threefry_draw.launches = 0
