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

:func:`ota_aggregate` takes the noise as a strip, as the Pallas kernel
does.  :func:`ota_aggregate_keyed`, which the OTA round runs, takes the
round key and the noise scale instead: on the card the same kernel forms
``scale * normal(key)[n]`` in the registers of the thread that adds it
(``csrc/threefry.cuh``, the Threefry draw's own device code), so no strip
is drawn, scaled or read back, and the sum has the same bits.  Its plain
version, :func:`ota_aggregate_keyed_plain`, is exactly the strip
composition ``ota_aggregate_plain(flat, coeff, scale * prng.normal(key,
n))``.  Both count in ``ota_aggregate.launches``.  The keyed wrapper
launches also at K = 0 (the result is ``scale * z``: there is no strip to
return); an empty payload returns zeros without a launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import errors, prng
from repro_torch.kernels import cuda_build
from repro_torch.kernels.fma import fma_f32
from repro_torch.kernels.threefry import MASK32, uniform_bounds

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
        lib.ota_aggregate_keyed_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        for fn in (lib.ota_aggregate_f32, lib.ota_aggregate_keyed_f32):
            fn.restype = ctypes.c_int
        lib.ota_aggregate_keyed_attributes.argtypes = [ctypes.c_void_p]
        lib.ota_aggregate_keyed_attributes.restype = ctypes.c_int
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


def ota_aggregate_keyed_plain(flat: torch.Tensor, coeff: torch.Tensor,
                              key, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the keyed kernel: (K, N) float32 updates,
    (K,) coeff, a (2,) uint32 round key and the float32 noise scale ->
    (N,) float32.  Exactly the strip composition: the reference's normals
    of ``key`` drawn on ``flat``'s device (:func:`prng.normal`), scaled in
    one rounding, then :func:`ota_aggregate_plain`."""
    noise = scale * prng.normal(key, flat.shape[1], device=flat.device)
    return ota_aggregate_plain(flat, coeff, noise)


def keyed_attributes() -> dict:
    """Registers, shared and local bytes and CTAs per SM of the keyed
    vector kernel (the one the OTA path runs)."""
    return cuda_build.read_attributes(
        _library().ota_aggregate_keyed_attributes)


def _check_operands(flat: torch.Tensor, vectors):
    """The kernel takes a (K, N) float32 CUDA matrix with unit element
    stride (rows may be spaced further apart, as :func:`row_buffer` spaces
    them) and float32 vectors of the given sizes on the same card."""
    if flat.dtype != torch.float32:
        raise TypeError(f"deltas must be float32 on the card, got {flat.dtype}")
    if flat.shape[1] > 1 and flat.stride(1) != 1:
        raise ValueError(
            f"deltas rows must be dense, got strides {flat.stride()}"
        )
    for name, t, shape in vectors:
        if t.device != flat.device or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 on {flat.device}, got {t.dtype} "
                f"on {t.device}"
            )
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {shape} tensor, got "
                f"{tuple(t.shape)}"
            )


def _run(lib, entry: str, flat: torch.Tensor, args, strip=None):
    """Launch ``entry`` (x, ld, ``args``, out, k, n, vectorized, stream;
    tensors in ``args`` passed by address) over ``flat`` into a new (N,)
    float32 output, with the 16-byte kernel where the rows, the output and
    the noise ``strip`` allow it; raises on a failed launch, else counts
    it."""
    k, n = flat.shape
    out = torch.empty(n, dtype=torch.float32, device=flat.device)
    rows = k == 0 or (flat.stride(0) % 4 == 0 and flat.data_ptr() % 16 == 0)
    vectorized = int(rows and all(t.data_ptr() % 16 == 0 for t in (out, strip)
                                  if t is not None))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        status = getattr(lib, entry)(
            flat.data_ptr(), flat.stride(0), *ptrs, out.data_ptr(), k, n,
            vectorized, stream,
        )
    if status != 0:
        reason = lib.ota_aggregate_error_string(status).decode()
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name=entry, reason=reason)
        )
    ota_aggregate.launches += 1
    return out


def _launch(flat: torch.Tensor, coeff: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """Run the strip kernel on a (K, N) float32 CUDA matrix."""
    lib = _library()    # a failed build raises here, before any launch
    k, n = flat.shape
    _check_operands(flat, (("coeff", coeff, (k,)), ("noise", noise, (n,))))
    return _run(lib, "ota_aggregate_f32", flat, (coeff, noise), strip=noise)


def _launch_keyed(flat: torch.Tensor, coeff: torch.Tensor, key,
                  scale: torch.Tensor) -> torch.Tensor:
    """Run the keyed kernel on a (K, N) float32 CUDA matrix: the noise of
    ``key`` (the reference's normals) times ``scale`` (one float32 on the
    card, never read on the host)."""
    lib = _library()
    k, _ = flat.shape
    _check_operands(flat, (("coeff", coeff, (k,)), ("scale", scale, ())))
    lo, span = uniform_bounds(prng.NORMAL_LO, 1.0)
    return _run(lib, "ota_aggregate_keyed_f32", flat,
                (coeff, int(key[0]) & MASK32, int(key[1]) & MASK32, lo, span,
                 scale))


def _dispatch(deltas, coeff, plain, launch, *args, k0_result=None):
    """Flatten ``deltas`` to (K, N) and run ``plain`` on a CPU tensor or
    ``launch`` on a CUDA one, shaped like ``deltas[0]``; an empty payload
    gives zeros, and K = 0 gives ``k0_result(n)`` where one is given."""
    k = deltas.shape[0]
    out_shape = deltas.shape[1:]
    n = 1
    for d in out_shape:
        n *= int(d)
    if n == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=deltas.device)
    if k == 0 and k0_result is not None:
        return k0_result(n).reshape(out_shape)
    flat = deltas.reshape(k, n)
    coeff = coeff.to(torch.float32)
    if deltas.device.type == "cpu":
        out = plain(flat, coeff, *args)
    elif deltas.device.type == "cuda":
        if n > 1 and flat.stride(1) != 1:
            flat = flat.contiguous()
        out = launch(flat, coeff.contiguous(), *args)
    else:
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(deltas.device)))
    return out.reshape(out_shape)


def ota_aggregate(deltas, coeff, noise):
    """sum_k coeff_k * deltas_k + noise, shaped like ``deltas[0]``.

    ``deltas``: (K, ...) float32 raw client updates; ``coeff``: (K,)
    float32; ``noise``: the scaled receiver noise, flattened to the
    payload length.  K = 0 returns the noise without a launch."""
    noise = noise.reshape(-1).to(torch.float32).contiguous()
    return _dispatch(deltas, coeff, ota_aggregate_plain, _launch, noise,
                     k0_result=lambda n: noise[:n].clone())


def ota_aggregate_keyed(deltas, coeff, key, scale):
    """sum_k coeff_k * deltas_k + scale * normal(key), shaped like
    ``deltas[0]``: :func:`ota_aggregate` with the receiver noise formed
    inside the kernel on the card instead of drawn as a strip.

    ``key``: the round's (2,) uint32 receiver-noise key (host);
    ``scale``: the float32 noise scale, a 0-d tensor on ``deltas``'
    device."""
    return _dispatch(deltas, coeff, ota_aggregate_keyed_plain, _launch_keyed,
                     key, scale.reshape(()).to(torch.float32))


ota_aggregate.launches = 0
