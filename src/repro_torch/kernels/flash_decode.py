"""One-token grouped-query decode attention over a KV cache.

For every batch row b and kv-head h, the G query heads that share h attend
over the cache positions below ``valid_len``::

    out[b, h, g] = softmax_s(q[b, h, g] . k[b, s, h] / sqrt(D)) @ v[b, :, h]

with q (B, H, G, D) and k, v (B, S, H, D), float32 or bfloat16, computed
in float32 and returned in q's type.  It replaces the Pallas kernel
``repro/kernels/flash_decode.py:flash_decode_pallas``; the Hopper kernel is
``csrc/flash_decode.cu`` (CUDA C++, built by :mod:`cuda_build`, loaded with
``ctypes``).  Beside it sits :func:`flash_decode_plain`, the Pallas
kernel's own arithmetic in plain PyTorch: an online softmax over blocks of
``block_s`` positions (m, l and acc in float32), ``NEG_INF`` scores and
zero weights at positions >= ``valid_len``, the denominator floored at
1e-30 (so ``valid_len = 0`` gives zeros, where the oracle
``ref.flash_decode_ref`` gives NaN).  The CUDA kernels visit the positions
in another order and take their exponentials in base 2, so they agree with
the plain version within the reference's tolerance (1e-5 in float32), not
to the bit; in bfloat16 within one rounding of the output.  The bfloat16
kernel runs q.k and p.v on the tensor cores (``mma.sync``, float32
accumulation) with q unscaled and p split into three bfloat16 parts that
sum to it exactly, the float32 kernel on the CUDA cores (see
``csrc/flash_decode.cu``).

Dispatch is by the device of ``q``: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which launches or raises — never a
quiet fall back.  ``flash_decode.launches`` counts the kernel's launches.
``valid_len`` is a Python int or a 0-d integer tensor; on the card the
kernel reads it from device memory, so a tensor there costs no host sync.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core import errors
from repro_torch.kernels import cuda_build

KERNEL = "flash_decode"

BLOCK_S = 256
NEG_INF = -1e30
DENOM_FLOOR = 1e-30
HEAD_DIMS = (64, 128)      # the kernel's D
MAX_GROUP = 8              # the kernel's largest G
INPUT_DTYPES = (torch.float32, torch.bfloat16)

_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(KERNEL)
        lib.flash_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.flash_decode.restype = ctypes.c_int
        lib.flash_decode_attributes.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.flash_decode_attributes.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_shapes(q, k, v, block_s: int):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be (B, H, G, D) and k, v (B, S, H, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, _, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(
            f"k, v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    s = k.shape[1]
    if s % block_s != 0:       # the reference asserts it too
        raise ValueError(f"cache length {s} is not a multiple of "
                         f"block_s={block_s}")


def flash_decode_plain(q, k, v, valid_len, *, block_s: int = BLOCK_S):
    """Plain PyTorch version: the Pallas kernel's arithmetic, block by
    block; blocks wholly past ``valid_len`` are skipped (``valid_len`` is
    read on the host, a card-resident one with a sync)."""
    _check_shapes(q, k, v, block_s)
    b, h, g, d = q.shape
    vl = int(valid_len)
    n_blocks = min(k.shape[1] // block_s, max(0, -(-vl // block_s)))
    qf = q.to(torch.float32)
    scale = 1.0 / (d ** 0.5)
    m = torch.full((b, h, g), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, h, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, g, d), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        start = i * block_s
        kb = k[:, start:start + block_s].to(torch.float32)
        vb = v[:, start:start + block_s].to(torch.float32)
        s = torch.einsum("bhgd,bshd->bhgs", qf, kb) * scale
        valid = (start + torch.arange(block_s, device=q.device)) < vl
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgs,bshd->bhgd", p, vb)
        m = m_new
    return (acc / torch.clamp_min(l_sum, DENOM_FLOOR)[..., None]).to(q.dtype)


def _device_valid_len(valid_len, device) -> torch.Tensor:
    """``valid_len`` as one int32 on the card: a tensor there is converted
    on the card; a host value is written by a fill, not a copy."""
    if isinstance(valid_len, torch.Tensor) and valid_len.device == device:
        return valid_len.reshape(1).to(torch.int32).contiguous()
    return torch.full((1,), int(valid_len), dtype=torch.int32, device=device)


def _launch(q, k, v, valid_len, block_s: int):
    """Run the CUDA kernel on dense CUDA tensors of one type."""
    lib = _library()    # a failed build raises here, before any launch
    _check_shapes(q, k, v, block_s)
    b, h, g, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in INPUT_DTYPES or t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share one type of "
                            f"{INPUT_DTYPES}, got {name} {t.dtype}")
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a dense 16-byte aligned "
                             f"tensor on {q.device}")
    if d not in HEAD_DIMS or not 1 <= g <= MAX_GROUP:
        raise ValueError(f"the kernel takes D in {HEAD_DIMS} and "
                         f"1 <= G <= {MAX_GROUP}, got D={d}, G={g}")
    vl = _device_valid_len(valid_len, q.device)
    out = torch.empty_like(q)
    qscale = float(np.float32(math.log2(math.e) / math.sqrt(d)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vl.data_ptr(),
            int(q.dtype == torch.bfloat16), b, k.shape[1], h, g, d, qscale,
            out.data_ptr(), stream,
        )
    if status != 0:
        reason = lib.flash_decode_error_string(status).decode()
        raise RuntimeError(
            errors.ERR_KERNEL_LAUNCH.format(name="flash_decode",
                                            reason=reason)
        )
    flash_decode.launches += 1
    return out


def kernel_attributes(dtype, d: int, g: int) -> dict:
    """Registers, shared and local bytes and CTAs per SM of the kernel
    that takes ``dtype`` at head width ``d`` and group ``g``."""
    return cuda_build.read_attributes(
        _library().flash_decode_attributes, int(dtype == torch.bfloat16),
        d, g)


def flash_decode(q, k, v, valid_len, *, block_s: int = BLOCK_S):
    """Decode attention of q (B, H, G, D) over k, v (B, S, H, D) below
    ``valid_len``: (B, H, G, D) in q's type.  ``S % block_s == 0``."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, valid_len, block_s=block_s)
    if q.device.type != "cuda":
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(q.device)))
    return _launch(q, k, v, valid_len, block_s)


flash_decode.launches = 0
