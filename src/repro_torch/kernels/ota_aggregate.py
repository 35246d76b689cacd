"""Over-the-air receiver reduction (core/ota.py signal model).

The PS receives the noisy analog sum of the scheduled clients' raw updates,

    out[n] = noise[n] + sum_k coeff_k * deltas[k, n],

with the masked FedAvg weights coeff_k = w_k / sum_A(w) and the receiver
noise already scaled by 1 / (sqrt(eta) * sum_A(w)).  It replaces the Pallas
kernel ``repro/kernels/aggregate.py:ota_aggregate_pallas``; the Hopper
kernel is ``csrc/ota_aggregate.cu`` (CUDA C++, built by :mod:`cuda_build`,
loaded with ``ctypes``).  Beside it sits :func:`ota_aggregate_plain`, the
plain PyTorch version of the same function.

Dispatch is by the device of ``deltas``: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which launches or raises — a failed
build or launch is an error, never a quiet fall back to the plain version.
``ota_aggregate.launches`` counts the kernel's launches (plain-version
calls do not count).  K = 0 returns the noise and an empty payload returns
zeros, both without a launch.

The kernel reads four elements per thread as 16-byte vectors when every
row starts on a 16-byte boundary: the rows' stride a multiple of 4 and the
buffers aligned.  :func:`row_buffer` gives the (K, N) payload that layout
(the OTA path builds its payload there); other layouts are read one
element per thread.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build
from repro_torch.kernels.fma import fma_f32

KERNEL = "ota_aggregate"

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        lib.ota_aggregate_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ota_aggregate_f32.restype = ctypes.c_int
        lib.ota_aggregate_error_string.argtypes = [ctypes.c_int]
        lib.ota_aggregate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def row_buffer(k: int, n: int, *, device) -> torch.Tensor:
    """An uninitialised (K, N) float32 matrix whose row stride is N rounded
    up to a multiple of 4, so that every row starts on a 16-byte boundary:
    the layout in which the kernel takes its 16-byte loads."""
    ld = -(-n // 4) * 4
    return torch.empty(k, ld, dtype=torch.float32, device=device)[:, :n]


def ota_aggregate_plain(flat: torch.Tensor, coeff: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (K, N) float32 updates, (K,) coeff, (N,)
    noise -> (N,) float32.

    Starts from the noise and adds k = 0..K-1 in order, each as one fused
    multiply-add: the CUDA kernel's arithmetic and the Pallas kernel's as
    XLA compiles it on the CPU (it contracts ``acc + x * c``), so the
    three agree to the bit."""
    acc = noise.to(torch.float32).clone()
    for k in range(flat.shape[0]):
        acc = fma_f32(acc, flat[k].to(torch.float32), coeff[k])
    return acc


def _launch(flat: torch.Tensor, coeff: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel on a (K, N) float32 CUDA matrix with unit
    element stride (rows may be spaced further apart, as
    :func:`row_buffer` spaces them)."""
    lib = _library()    # a failed build raises here, before any launch
    if flat.dtype != torch.float32:
        raise TypeError(f"deltas must be float32 on the card, got {flat.dtype}")
    k, n = flat.shape
    if n > 1 and flat.stride(1) != 1:
        raise ValueError(
            f"deltas rows must be dense, got strides {flat.stride()}"
        )
    ld = flat.stride(0)
    for name, t, size in (("coeff", coeff, k), ("noise", noise, n)):
        if t.device != flat.device or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 on {flat.device}, got {t.dtype} "
                f"on {t.device}"
            )
        if t.shape != (size,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous ({size},) vector, got "
                f"{tuple(t.shape)}"
            )
    out = torch.empty(n, dtype=torch.float32, device=flat.device)
    vectorized = int(
        ld % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (flat, noise, out))
    )
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        status = lib.ota_aggregate_f32(
            flat.data_ptr(), ld, coeff.data_ptr(), noise.data_ptr(),
            out.data_ptr(), k, n, vectorized, stream,
        )
    if status != 0:
        reason = lib.ota_aggregate_error_string(status).decode()
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name="ota_aggregate_f32",
                                            reason=reason)
        )
    ota_aggregate.launches += 1
    return out


def ota_aggregate(deltas, coeff, noise):
    """sum_k coeff_k * deltas_k + noise, shaped like ``deltas[0]``.

    ``deltas``: (K, ...) float32 raw client updates; ``coeff``: (K,)
    float32; ``noise``: the scaled receiver noise, flattened to the
    payload length."""
    k = deltas.shape[0]
    out_shape = deltas.shape[1:]
    n = 1
    for d in out_shape:
        n *= int(d)
    if n == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=deltas.device)
    noise = noise.reshape(-1).to(torch.float32)
    if k == 0:
        return noise[:n].clone().reshape(out_shape)
    flat = deltas.reshape(k, n)
    if deltas.device.type == "cpu":
        out = ota_aggregate_plain(flat, coeff.to(torch.float32), noise)
    elif deltas.device.type == "cuda":
        if n > 1 and flat.stride(1) != 1:
            flat = flat.contiguous()
        out = _launch(flat, coeff.to(torch.float32).contiguous(),
                      noise.contiguous())
    else:
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(deltas.device)))
    return out.reshape(out_shape)


ota_aggregate.launches = 0
