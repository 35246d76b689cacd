"""DoReFa uplink quantizer kernels (paper §II-B, Eq. 7).

Three elementwise kernels, given a per-tensor scale ``s`` and a static bit
width ``b`` (``a = 2^b - 1``):

  * :func:`quantize_codes`: ``int32(rint(a * clip(x / max(s, 1e-12), -1, 1)))``,
    saturating at the int32 range;
  * :func:`dequantize_codes`: ``f32(c) * (s * fl(1/a))``;
  * :func:`quantize_dequantize`: ``rint(a * clip(x / s', -1, 1)) *
    (s' * fl(1/a))``, ``s' = max(s, 1e-12)``, in the input's type; and
    its float32 mode :func:`quantize_dequantize_residual`, which also
    writes the error-feedback residual ``fma(c, -(s' * fl(1/a)), x)`` (``c``
    the rounded level), the one rounding XLA's CPU contracts the
    reference's ``adj - q`` to, in the same pass.

They replace the Pallas kernels ``repro/kernels/dorefa.py:
quantize_codes_pallas``, ``dequantize_codes_pallas`` and
``quantize_dequantize_pallas``; the Hopper kernels are
``csrc/dorefa.cu`` (CUDA C++, built by :mod:`cuda_build`, loaded with
``ctypes``).  The op order is the one XLA compiles the Pallas kernels to:
with a static ``b``, ``a`` is a constant, and XLA turns ``x / a`` into a
product with the float32 reciprocal ``fl(1/a)`` and reassociates
``(r * fl(1/a)) * s`` into ``r * (s * fl(1/a))``.  The division by the
scale, a traced value, stays a true division.  Following the source text
instead (``c * (s / a)``) is one ulp off on most elements.

Beside each kernel sits its plain PyTorch version (``*_plain``), which
divides a tensor by a tensor and multiplies in the same order: on the CUDA
card torch computes ``tensor / python_float`` as a product with the
reciprocal, so no Python number is ever a divisor here.  Before the int32
cast the plain version clamps to the int32 range itself and maps NaN to 0,
as XLA's convert does, since torch's cast of such a float is undefined.
NaN passes through the scale floor and the clamp, as in the reference: a
NaN element or scale gives a NaN output and code 0.

Dispatch is by the device of the input: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which launches or raises — never a
quiet fall back.  ``<wrapper>.launches`` counts each wrapper's kernel
launches (plain-version calls do not count).  The kernels use no TPU
tiling: a 1-D grid over the ``n`` elements; :func:`quantize_codes` also
writes the zero codes of a caller's padding (``n_out > n``), so no padded
copy of ``x`` is made.  All three read their input in 16-byte vectors and
store their outputs as 16-byte vectors (``int4`` codes, values of x's
type, or ``float4`` dequantized values); an input at any element offset is
taken as it is, its unaligned head and ragged tail element by element
inside the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build
from repro_torch.kernels.fma import fma_f32

KERNEL = "dorefa"

INPUT_DTYPES = (torch.float32, torch.bfloat16)
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
SCALE_FLOOR = 1e-12

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        lib.dorefa_quantize_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.dorefa_dequantize_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.dorefa_quantize_dequantize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.dorefa_quantize_dequantize_residual.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        for fn in (lib.dorefa_quantize_codes, lib.dorefa_dequantize_codes,
                   lib.dorefa_quantize_dequantize,
                   lib.dorefa_quantize_dequantize_residual):
            fn.restype = ctypes.c_int
        for fn in (lib.dorefa_quantize_codes_attributes,
                   lib.dorefa_quantize_dequantize_attributes):
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.dorefa_dequantize_codes_attributes,
                   lib.dorefa_quantize_dequantize_residual_attributes):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.dorefa_error_string.argtypes = [ctypes.c_int]
        lib.dorefa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def levels(bits: int) -> float:
    """a = 2^b - 1 rounded to float32, as XLA holds the static constant."""
    return float(np.float32(2 ** int(bits) - 1))


def inv_levels(bits: int) -> float:
    """fl(1/a) in float32: the reciprocal XLA folds ``x / a`` into."""
    return float(np.float32(1.0) / np.float32(levels(bits)))


def saturating_int32(r: torch.Tensor) -> torch.Tensor:
    """Integer-valued float32 -> int32 as XLA's convert gives it: clamped
    to the int32 range (values up to 2^32 are exact in int64, so the clamp
    happens there) and NaN -> 0 (torch's cast of a NaN is undefined)."""
    r = torch.where(torch.isnan(r), 0.0, r)
    return r.to(torch.int64).clamp_(INT32_MIN, INT32_MAX).to(torch.int32)


def _floored(scale: torch.Tensor) -> torch.Tensor:
    """max(s, 1e-12); a NaN scale stays NaN (clamp_min propagates it)."""
    return torch.clamp_min(scale.to(torch.float32), SCALE_FLOOR)


def rounded_levels(x: torch.Tensor, s: torch.Tensor, bits: int):
    """rint(a * clip(x / s, -1, 1)) in float32, ``s`` a tensor on x's
    device: the quantizer's core."""
    xn = torch.clamp(x.to(torch.float32) / s, -1.0, 1.0)
    return torch.round(xn * levels(bits))


def quantize_codes_plain(x: torch.Tensor, scale: torch.Tensor, bits: int,
                         n_out: "int | None" = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_codes`: flat ``x`` (n,)
    -> (n_out,) int32 codes, zeros past n."""
    flat = x.reshape(-1)
    n = flat.numel()
    n_out = n if n_out is None else int(n_out)
    codes = torch.zeros(n_out, dtype=torch.int32, device=flat.device)
    codes[:n] = saturating_int32(rounded_levels(flat, _floored(scale), bits))
    return codes


def dequantize_codes_plain(codes: torch.Tensor, scale: torch.Tensor,
                           bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`dequantize_codes`: (n,) int32 ->
    (n,) float32.  The scale is not floored (the Pallas kernel does not)."""
    step = scale.to(torch.float32) * inv_levels(bits)
    return codes.reshape(-1).to(torch.float32) * step


def quantize_dequantize_plain(x: torch.Tensor, scale: torch.Tensor,
                              bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`quantize_dequantize`: flat ``x``
    (n,) float32 or bfloat16 -> (n,) of the same type."""
    flat = x.reshape(-1)
    s = _floored(scale)
    out = rounded_levels(flat, s, bits) * (s * inv_levels(bits))
    return out.to(flat.dtype)


def quantize_dequantize_residual_plain(x: torch.Tensor, scale: torch.Tensor,
                                       bits: int):
    """Plain PyTorch version of :func:`quantize_dequantize_residual`: flat
    float32 ``x`` (n,) -> ((n,) ``quantize_dequantize_plain(x, scale,
    bits)``, (n,) residual ``fma(c, -(s * fl(1/a)), x)``) from one pass of
    the rounded levels ``c``."""
    flat = x.reshape(-1)
    s = _floored(scale)
    c = rounded_levels(flat, s, bits)
    step = s * inv_levels(bits)
    return c * step, fma_f32(flat, c, -step)


# --------------------------------------------------------------------------
# The kernels
# --------------------------------------------------------------------------

def quantize_codes_attributes(dtype) -> dict:
    """Registers, shared and local bytes and CTAs per SM of the
    quantize_codes kernel for ``dtype`` input."""
    return cuda_build.read_attributes(
        _library().dorefa_quantize_codes_attributes,
        int(dtype == torch.bfloat16))


def quantize_dequantize_residual_attributes() -> dict:
    """The same for the quantize_dequantize kernel's residual mode."""
    return cuda_build.read_attributes(
        _library().dorefa_quantize_dequantize_residual_attributes)


def dequantize_codes_attributes() -> dict:
    """The same for the dequantize_codes kernel (int32 codes)."""
    return cuda_build.read_attributes(
        _library().dorefa_dequantize_codes_attributes)


def quantize_dequantize_attributes(dtype) -> dict:
    """The same for the quantize_dequantize kernel."""
    return cuda_build.read_attributes(
        _library().dorefa_quantize_dequantize_attributes,
        int(dtype == torch.bfloat16))


def _check_launch(lib, status: int, fn_name: str):
    if status != 0:
        reason = lib.dorefa_error_string(status).decode()
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name=fn_name, reason=reason)
        )


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_operands(x: torch.Tensor, scale: torch.Tensor, dtypes, what: str):
    """The kernels take a dense CUDA input of one of ``dtypes`` and a
    one-element float32 scale on the same card."""
    if x.dtype not in dtypes:
        raise TypeError(f"{what} must be one of {dtypes}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if (scale.device != x.device or scale.dtype != torch.float32
            or scale.numel() != 1):
        raise ValueError(
            f"scale must be one float32 value on {x.device}, got "
            f"{tuple(scale.shape)} {scale.dtype} on {scale.device}"
        )


def _quantize_codes_launch(flat, scale, bits, n_out):
    lib = _library()    # a failed build raises here, before any launch
    _check_operands(flat, scale, INPUT_DTYPES, "x")
    codes = torch.empty(n_out, dtype=torch.int32, device=flat.device)
    if n_out == 0:
        return codes
    with torch.cuda.device(flat.device):
        status = lib.dorefa_quantize_codes(
            flat.data_ptr(), int(flat.dtype == torch.bfloat16), flat.numel(),
            n_out, scale.data_ptr(), levels(bits), codes.data_ptr(),
            _stream(flat.device),
        )
    _check_launch(lib, status, "dorefa_quantize_codes")
    quantize_codes.launches += 1
    return codes


def _dequantize_codes_launch(flat, scale, bits):
    lib = _library()
    _check_operands(flat, scale, (torch.int32,), "codes")
    out = torch.empty(flat.numel(), dtype=torch.float32, device=flat.device)
    if flat.numel() == 0:
        return out
    with torch.cuda.device(flat.device):
        status = lib.dorefa_dequantize_codes(
            flat.data_ptr(), flat.numel(), scale.data_ptr(), inv_levels(bits),
            out.data_ptr(), _stream(flat.device),
        )
    _check_launch(lib, status, "dorefa_dequantize_codes")
    dequantize_codes.launches += 1
    return out


def _quantize_dequantize_launch(flat, scale, bits):
    lib = _library()
    _check_operands(flat, scale, INPUT_DTYPES, "x")
    out = torch.empty_like(flat)
    if flat.numel() == 0:
        return out
    with torch.cuda.device(flat.device):
        status = lib.dorefa_quantize_dequantize(
            flat.data_ptr(), int(flat.dtype == torch.bfloat16), flat.numel(),
            scale.data_ptr(), levels(bits), inv_levels(bits), out.data_ptr(),
            _stream(flat.device),
        )
    _check_launch(lib, status, "dorefa_quantize_dequantize")
    quantize_dequantize.launches += 1
    return out


def _quantize_dequantize_residual_launch(flat, scale, bits):
    lib = _library()
    _check_operands(flat, scale, (torch.float32,), "x")
    out = torch.empty_like(flat)
    res = torch.empty_like(flat)
    if flat.numel() == 0:
        return out, res
    with torch.cuda.device(flat.device):
        status = lib.dorefa_quantize_dequantize_residual(
            flat.data_ptr(), flat.numel(), scale.data_ptr(), levels(bits),
            inv_levels(bits), out.data_ptr(), res.data_ptr(),
            _stream(flat.device),
        )
    _check_launch(lib, status, "dorefa_quantize_dequantize_residual")
    quantize_dequantize.launches += 1
    return out, res


def _dispatch(x, plain, launch, *args):
    if x.device.type == "cpu":
        return plain(x, *args)
    if x.device.type != "cuda":
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(x.device)))
    return launch(x.reshape(-1), *args)


def quantize_codes(x: torch.Tensor, scale: torch.Tensor, bits: int,
                   n_out: "int | None" = None) -> torch.Tensor:
    """DoReFa codes of the flattened ``x`` (float32 or bfloat16) at a static
    ``bits``: (n_out,) int32, ``n_out`` (default n) >= n, zeros past n."""
    n = x.numel()
    n_out = n if n_out is None else int(n_out)
    if n_out < n:
        raise ValueError(f"n_out={n_out} is below the {n} input elements")
    return _dispatch(x, quantize_codes_plain, _quantize_codes_launch,
                     scale, int(bits), n_out)


def dequantize_codes(codes: torch.Tensor, scale: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """Float32 values of the flattened int32 ``codes`` at a static ``bits``:
    (n,) float32."""
    return _dispatch(codes, dequantize_codes_plain, _dequantize_codes_launch,
                     scale, int(bits))


def quantize_dequantize(x: torch.Tensor, scale: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """Fused quantize -> dequantize of the flattened ``x`` (float32 or
    bfloat16) at a static ``bits``: (n,) of x's type."""
    return _dispatch(x, quantize_dequantize_plain,
                     _quantize_dequantize_launch, scale, int(bits))


def quantize_dequantize_residual(x: torch.Tensor, scale: torch.Tensor,
                                 bits: int):
    """:func:`quantize_dequantize` of the flattened float32 ``x`` with the
    error-feedback residual ``x - q`` as one fused multiply-add, both in
    one pass: ((n,) float32, (n,) float32).  Its launch is #5's and counts
    in ``quantize_dequantize.launches``."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32, got {x.dtype}")
    return _dispatch(x, quantize_dequantize_residual_plain,
                     _quantize_dequantize_residual_launch, scale, int(bits))


quantize_codes.launches = 0
dequantize_codes.launches = 0
quantize_dequantize.launches = 0
