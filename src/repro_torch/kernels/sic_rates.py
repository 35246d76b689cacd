"""Batched SIC weighted-sum-rate scoring (paper §III-A, Eq. 2-4).

For V candidate NOMA groups of K <= 8 devices, (V, K) powers, gains and
weights map to the (V,) float32 weighted sum rates

    sum_i w_i * log2(1 + rx_i / (tail_i + noise)),   rx = p * g * g,
    tail_i = sum_j rx_j * [rx_j < rx_i or (rx_j == rx_i and j > i)],

where tail_i is the receive power decoded after user i under the
descending-rx, ties-to-the-lower-index SIC order, written as an O(K^2)
comparison matrix instead of a sort.  It is the vertex scorer of the
device-resident MWIS greedy (``rates_device._score_vertices``,
``scorer="pallas"``).

It replaces the Pallas kernel
``repro/kernels/sic_rates.py:sic_weighted_rates_pallas``; the Hopper kernel
is ``csrc/sic_rates.cu`` (CUDA C++, built by :mod:`cuda_build`, loaded
with ``ctypes``).  Beside it sits :func:`sic_weighted_rates_plain`, the
plain PyTorch version of the same arithmetic in the same order: ``rx`` is
formed as ``(p * g) * g`` in the input type and then cast to float32, the
weights and the noise are cast to float32, ``tail_i`` sums j = 0..K-1 in
order and the result sums i = 0..K-1 in order.

Dispatch is by the device of the inputs: CPU tensors go to the plain
version, CUDA tensors to the kernel, which launches or raises — never a
quiet fall back.  ``sic_weighted_rates.launches`` counts the kernel's
launches.  K > 8 raises ``ValueError``; V = 0 gives an empty result
without a launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build
from repro_torch.utils import sanitizers

KERNEL = "sic_rates"
K_MAX = 8
DTYPES = (torch.float32, torch.float64)

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        for fn in (lib.sic_weighted_rates_f32, lib.sic_weighted_rates_f64):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.sic_rates_error_string.argtypes = [ctypes.c_int]
        lib.sic_rates_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cmp_weighted_sum(rx, w, noise_power) -> torch.Tensor:
    """Weighted SIC sum rate from receive powers, (..., K) -> (...), in
    ``rx``'s dtype: the kernel's loop, K unrolled.

    Interference for user i is the receive power decoded after it,

        tail_i = sum_j rx_j * [rx_j < rx_i or (rx_j == rx_i and j > i)],

    summed for j in input order, and the rates are summed for i in order.
    """
    k = rx.shape[-1]
    acc = torch.zeros(rx.shape[:-1], dtype=rx.dtype, device=rx.device)
    for i in range(k):
        rxi = rx[..., i]
        tail = torch.zeros_like(rxi)
        for j in range(k):
            if j == i:
                continue
            rxj = rx[..., j]
            decoded_after = (rxj < rxi) | ((rxj == rxi) & (j > i))
            tail = tail + torch.where(decoded_after, rxj, 0.0)
        acc = acc + w[..., i] * torch.log2(1.0 + rxi / (tail + noise_power))
    return acc


def sic_weighted_rates_plain(powers_vk, gains_vk, weights_vk, noise_power):
    """Plain PyTorch version: (V, K) -> (V,) float32, the kernel's
    arithmetic in the kernel's order."""
    rx = (powers_vk * gains_vk * gains_vk).to(torch.float32)
    # the noise as a Python scalar: torch rounds it to the float32 operation
    # type, as the kernel's float argument is rounded, and no host-to-device
    # copy (which would synchronise) is made
    return cmp_weighted_sum(rx, weights_vk.to(torch.float32),
                            float(noise_power))


def _launch(p, g, w, noise_power) -> torch.Tensor:
    """Run the CUDA kernel on contiguous (V, K) CUDA tensors of one type."""
    lib = _library()    # a failed build raises here, before any launch
    fn_name = ("sic_weighted_rates_f32" if p.dtype == torch.float32
               else "sic_weighted_rates_f64")
    v, k = p.shape
    out = torch.empty(v, dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        status = getattr(lib, fn_name)(
            p.data_ptr(), g.data_ptr(), w.data_ptr(), float(noise_power),
            out.data_ptr(), k, v, stream,
        )
    if status != 0:
        reason = lib.sic_rates_error_string(status).decode()
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name=fn_name, reason=reason)
        )
    sic_weighted_rates.launches += 1
    if sanitizers.NAN_CHECK:
        sanitizers.check_kernel_outputs("sic_weighted_rates", out)
    return out


def sic_weighted_rates(powers_vk, gains_vk, weights_vk, noise_power):
    """(V, K) powers / gains / weights -> (V,) float32 weighted SIC sum
    rates.  The three inputs share one shape, one dtype (float32 or
    float64) and one device."""
    if powers_vk.dim() != 2 or not (
        powers_vk.shape == gains_vk.shape == weights_vk.shape
    ):
        raise ValueError(
            f"powers, gains and weights must share one (V, K) shape, got "
            f"{tuple(powers_vk.shape)}, {tuple(gains_vk.shape)}, "
            f"{tuple(weights_vk.shape)}"
        )
    v, k = powers_vk.shape
    if k > K_MAX:
        raise ValueError(errors.ERR_SIC_GROUP_TOO_LARGE.format(k_max=K_MAX, k=k))
    if powers_vk.dtype not in DTYPES or not (
        powers_vk.dtype == gains_vk.dtype == weights_vk.dtype
    ):
        raise TypeError(
            f"powers, gains and weights must share one dtype of {DTYPES}, got "
            f"{powers_vk.dtype}, {gains_vk.dtype}, {weights_vk.dtype}"
        )
    dev = powers_vk.device
    if not dev == gains_vk.device == weights_vk.device:
        raise ValueError("powers, gains and weights must be on one device")
    if dev.type == "cpu":
        return sic_weighted_rates_plain(powers_vk, gains_vk, weights_vk,
                                        noise_power)
    if dev.type != "cuda":
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(dev)))
    if v == 0 or k == 0:
        return torch.zeros(v, dtype=torch.float32, device=dev)
    if not (powers_vk.is_contiguous() and gains_vk.is_contiguous()
            and weights_vk.is_contiguous()):
        raise ValueError("the SIC kernel takes contiguous (V, K) tensors")
    return _launch(powers_vk, gains_vk, weights_vk, noise_power)


sic_weighted_rates.launches = 0
