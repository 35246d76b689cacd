"""Counter-based Threefry-2x32 random numbers in integer tensor ops.

The reference draws its channels, its initial weights and the OTA receiver
noise with ``jax.random`` (default ``threefry2x32`` implementation,
``jax_threefry_partitionable=True``, no x64).  This module recomputes the
same streams with torch, bit for bit, on any device:

  * a key is a pair of 32-bit words ``(k0, k1)``; ``prng_key(seed)`` is
    ``(0, seed mod 2^32)``, as ``jax.random.PRNGKey`` builds it without x64;
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
  * ``split(key, n)[i]`` is the hash of the counter pair ``(i >> 32,
    i & M)``, both words kept;
  * ``random_bits(key, n)`` hashes the same counter pairs of the flat
    indices i < n and returns ``x0 ^ x1`` per index;
  * ``uniform(key, n, lo, hi)`` puts 23 random mantissa bits under the
    exponent of 1.0, subtracts 1 and returns ``max(lo, f * (hi - lo) +
    lo)``, the multiply-add fused as XLA compiles it on the CPU;
  * ``normal(key, n)`` is ``sqrt(2) * erf_inv(u)`` of a uniform on
    ``[nextafter(-1, 0), 1)`` (in bfloat16 the same of a bf16 uniform
    made from the low byte of the bits, :func:`normal_bf16_plain`), and
    ``truncated_normal`` the same of a uniform on ``[erf(lower / sqrt 2),
    erf(upper / sqrt 2)]``, clipped inside the open interval.

:func:`erf_inv` is XLA's float32 ``ErfInv`` (Giles' single-precision
polynomial, branch at w = 5) as XLA compiles it for the CPU: ``log1p``
is XLA's own expansion (a rational approximation below |x| = 0.4142, a
Cephes-style ``log`` above), and the x86 back end contracts most
multiply-adds of both into fused multiply-adds.  Each one is taken here
with :func:`repro_torch.kernels.fma.fma_f32` where the compiled code has
it, and every other step is one float32 operation, so the normals equal
``jax.random.normal``'s to the bit (tests/test_torch_draws.py sweeps
every float32 input the normal draw can produce).

The words are int64 tensors masked to 32 bits (torch's uint32 support is
partial), so the streams are the same on CPU and CUDA tensors.  That plain
version (:func:`draw_plain`) takes about 1,300 tensor ops for one normal
draw; on a CUDA device :func:`uniform`, :func:`normal` and
:func:`truncated_normal` launch the kernel of
:mod:`repro_torch.kernels.threefry` instead, once per draw, with the same
bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fma import fma_f32
from repro_torch.kernels.threefry import threefry_draw

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

F32 = np.float32
SQRT2 = float(F32(np.sqrt(2.0)))                # 1.41421354
NORMAL_LO = float(np.nextafter(F32(-1.0), F32(0.0)))
# erf(-3 * fl(1/sqrt 2)) and erf(3 * fl(1/sqrt 2)) as XLA's float32 erf
# computes them: the bounds of truncated_normal(key, -3, 3, ...)
ERF_BOUNDS = {(-3.0, 3.0): (float.fromhex("-0x1.fe9e22p-1"),
                            float.fromhex("0x1.fe9e22p-1"))}

# XLA's log_f32 (Cephes logf) and log1p rational approximation, as the
# float32 constants of the compiled code
_FLT_MIN = float.fromhex("0x1p-126")
_SQRTHF = float.fromhex("0x1.6a09e6p-1")
_LOG_P = [float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4",        # p1 = x * c0 + c1
    "-0x1.fcba9ep-4", "0x1.23d37ep-3",       # p2
    "0x1.de4a34p-4", "-0x1.555ca0p-3",       # q1 = p1 * x + c4, q2
    "0x1.999d58p-3", "-0x1.fffff8p-3",       # p3
    "0x1.555554p-2",                         # q3
)]
_LOG_Q1 = float.fromhex("-0x1.bd0106p-13")   # e * q1 + e * q2 = e * ln 2
_LOG_Q2 = float.fromhex("0x1.63p-1")
_LOG1P_SMALL = float.fromhex("0x1.a8279ap-2")
_LOG1P_DEN = [float.fromhex(h) for h in (
    "0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7", "0x1.351946p+8",
    "0x1.b0db14p+7", "0x1.e0f304p+5")]
_LOG1P_NUM = [float.fromhex(h) for h in (
    "0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4",
    "0x1.e798ecp+5", "0x1.c8e75ap+5", "0x1.40a202p+4")]
# Giles' erf_inv coefficients, highest degree first: w < 5 and w >= 5
_ERFINV_LT5 = [float(F32(c)) for c in (
    "2.81022636e-08", "3.43273939e-07", "-3.5233877e-06", "-4.39150654e-06",
    "0.00021858087", "-0.00125372503", "-0.00417768164", "0.246640727",
    "1.50140941")]
_ERFINV_GE5 = [float(F32(c)) for c in (
    "-0.000200214257", "0.000100950558", "0.00134934322", "-0.00367342844",
    "0.00573950773", "-0.0076224613", "0.00943887047", "1.00167406",
    "2.83297682")]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key = (k0, k1)`` (Python ints); words are int64 tensors in
    [0, 2^32).  Returns the two hashed words."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without x64: (2,) uint32."""
    return np.array([0, int(seed) & MASK32], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: (2,) uint32, the hash of the
    counter pair ``(0, data)``."""
    y0, y1 = threefry2x32(
        key, torch.zeros(1, dtype=torch.int64),
        torch.tensor([int(data) & MASK32], dtype=torch.int64),
    )
    return np.array([int(y0), int(y1)], dtype=np.uint32)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: (n, 2) uint32 keys."""
    y0, y1 = threefry2x32(key, *_counters(int(n), "cpu"))
    return torch.stack([y0, y1], dim=1).numpy().astype(np.uint32)


def random_bits(key, n: int, *, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as an (n,) int64 tensor of
    values in [0, 2^32) on ``device``."""
    b0, b1 = threefry2x32(key, *_counters(n, device))
    return b0 ^ b1


def draw_plain(key, n: int, minval: float, maxval: float, *,
               normal: bool = False, clip=None, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` on
    ``device``, or with ``normal`` ``sqrt(2) * erf_inv`` of that uniform
    clamped to ``clip = (lo, hi)`` (``None``: unclamped): the plain
    version of the card's kernel (:mod:`repro_torch.kernels.threefry`)."""
    bits = random_bits(key, n, device=device)
    # 23 random mantissa bits under the exponent of 1.0: a float in [1, 2)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = F32(minval), F32(maxval)
    u = torch.clamp_min(_fma(f, float(hi - lo), float(lo)), float(lo))
    if not normal:
        return u
    z = erf_inv(u) * SQRT2
    return z if clip is None else torch.clamp(z, *clip)


def draw(key, n: int, minval: float, maxval: float, *, normal: bool = False,
         clip=None, device) -> torch.Tensor:
    """:func:`draw_plain`'s function, by device: the plain version on the
    CPU, the kernel (one launch) on a CUDA device."""
    if torch.device(device).type == "cuda":
        return threefry_draw(key, n, minval, maxval, normal=normal, clip=clip,
                             device=device)
    return draw_plain(key, n, minval, maxval, normal=normal, clip=clip,
                      device=device)


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0, *,
            device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: (n,)
    float32 on ``device``."""
    return draw(key, n, minval, maxval, device=device)


def _full(like: torch.Tensor, value) -> torch.Tensor:
    """``value`` broadcast to ``like``'s shape on its device: a tensor as it
    is, a float as a fill (no host-to-device copy, so no host sync)."""
    if isinstance(value, torch.Tensor):
        return value.expand_as(like)
    return like.new_full((), float(value), dtype=torch.float32) \
        .expand_as(like)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c with one rounding (float32); b and c tensors or floats."""
    return fma_f32(_full(a, c), a, _full(a, b))


def _log_f32(a: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` of a > 0 (Cephes logf), as compiled on the
    CPU; a <= 0 gives NaN, 0 gives -inf and inf gives inf."""
    bits = torch.clamp_min(a, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    low = m < _SQRTHF
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = torch.where(low, e - 1.0, e)
    z = x * x
    zx = z * x
    c = _LOG_P
    p1 = _fma(_fma(x, c[0], c[1]), x, c[4])
    p2 = _fma(_fma(x, c[2], c[3]), x, c[5])
    r1 = _fma(p1, zx, p2)
    p3 = _fma(_fma(x, c[6], c[7]), x, c[8])
    r2 = _fma(r1, zx, p3)
    y = _fma(r2, zx, e * _LOG_Q1)
    h = x - z * 0.5                 # a fused x - z * 0.5: the product is exact
    out = _fma(e, _LOG_Q2, h + y)
    # NaN where a < 0, made from a itself: sqrt of a negative (no NaN
    # constant, which nan_guard would flag on every call)
    out = torch.where(a < 0, torch.sqrt(torch.clamp_max(a, 0.0)), out)
    out = torch.where(a == 0, float("-inf"), out)
    return torch.where(a == float("inf"), float("inf"), out)


def _log1p_f32(t: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` as compiled on the CPU: a rational
    approximation for |t| < 0.4142, ``log(1 + t)`` above."""
    t2 = t * t
    den = torch.ones_like(t)
    for c in _LOG1P_DEN:
        den = _fma(den, t, c)
    num = torch.full_like(t, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, t, c)
    small = t + ((t * t2) * (num / den) - t2 * 0.5)
    return torch.where(torch.abs(t) < _LOG1P_SMALL, small,
                       _log_f32(t + 1.0))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's ``sqrt`` gives
    it: taken in float64 and rounded once (exact for a float32 input).
    ``torch.sqrt`` of a float32 CPU tensor is not correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` as compiled on the CPU: float32 in and
    out, any device."""
    x = x.to(torch.float32)
    lp = _log1p_f32(x * -x)                  # -w
    lt5 = lp > -5.0
    w = torch.where(lt5, -2.5 - lp, sqrt_f32(-lp) + -3.0)

    def coeff(i):
        return torch.where(lt5, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = _fma(w, coeff(0), coeff(1))
    for i in range(2, 9):
        p = _fma(w, p, coeff(i))
    p = torch.where(torch.abs(x) == 1.0, float("inf"), p)
    return x * p


def normal(key, n: int, *, device, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, (n,), dtype)``: (n,) on ``device``, for
    ``dtype`` float32 or bfloat16 (:func:`normal_bf16_plain`); on a CUDA
    device either is one Threefry launch."""
    if dtype == torch.bfloat16:
        if torch.device(device).type == "cuda":
            return threefry_draw(key, n, NORMAL_LO, 1.0, normal=True,
                                 dtype=torch.bfloat16, device=device)
        return normal_bf16_plain(key, n, device=device)
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    return draw(key, n, NORMAL_LO, 1.0, normal=True, device=device)


# jax.random's bfloat16 uniform on [nextafter(-1, 0), 1): bf16 has 7
# mantissa bits (fewer than 8), so it draws 8-bit words (the low byte of
# x0 ^ x1), shifts them right by one under the exponent of 1.0 and forms
# f * span + lo in bf16, where span = bf16(1 - lo) rounds to 2 and every
# step is exact: u = k / 64 - 255 / 256 for the 7-bit k.  The normal is
# bf16(bf16(erf_inv(u)) * bf16(sqrt 2)): XLA takes the bf16 erf_inv as the
# float32 one of the widened input, rounded to bf16, and the product in
# bf16 with the constant sqrt(2) rounded to bf16 (1.4140625).
BF16_LO = -255.0 / 256.0
BF16_SQRT2 = 1.4140625


def bf16_normal_table(device) -> torch.Tensor:
    """The 128 values of jax.random's bfloat16 normal, by the 7-bit k
    (float32 holding bf16 values)."""
    k = torch.arange(128, dtype=torch.float32, device=device)
    u = torch.clamp_min(k / 64.0 + BF16_LO, BF16_LO)      # exact
    e = erf_inv(u).to(torch.bfloat16).to(torch.float32)
    return (e * BF16_SQRT2).to(torch.bfloat16).to(torch.float32)


def normal_bf16_plain(key, n: int, *, device) -> torch.Tensor:
    """``jax.random.normal(key, (n,), bfloat16)`` in tensor ops: the
    7-bit k = (x0 ^ x1) & 0xFF >> 1 of each index looks its value up in
    :func:`bf16_normal_table` (the table is the formula at every k): the
    plain version of the Threefry kernel's bf16 mode."""
    k = (random_bits(key, n, device=device) & 0xFF) >> 1
    return bf16_normal_table(device)[k].to(torch.bfloat16)


def truncated_normal(key, lower: float, upper: float, n: int, *,
                     device) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, (n,), float32)``
    for the bounds of :data:`ERF_BOUNDS`: (n,) float32 on ``device``."""
    try:
        a, b = ERF_BOUNDS[(float(lower), float(upper))]
    except KeyError:
        raise ValueError(
            f"truncated_normal is ported for the bounds {list(ERF_BOUNDS)}, "
            f"got ({lower}, {upper})"
        ) from None
    clip = (float(np.nextafter(F32(lower), F32(np.inf))),
            float(np.nextafter(F32(upper), F32(-np.inf))))
    return draw(key, n, a, b, normal=True, clip=clip, device=device)


def randint(key, shape, minval: int, maxval: int, *, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): two
    32-bit draws per value under the two keys of ``split(key)``, reduced
    modulo the span as jax.random reduces them (``2^32 mod span`` formed
    as ``(2^16 mod span)^2 mod span``, every product wrapping at 2^32, as
    jax.random's uint32 products do).
    An int32 tensor of ``shape`` on ``device``."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape)) if shape else 1
    lo, hi = int(minval), int(maxval)
    span = (hi - lo) & MASK32 if hi > lo else 1
    k1, k2 = split(key)
    higher = random_bits(k1, n, device=device)
    lower = random_bits(k2, n, device=device)
    multiplier = ((((1 << 16) % span) ** 2) & MASK32) % span
    offset = (((higher % span) * multiplier) & MASK32) + (lower % span)
    offset = (offset & MASK32) % span
    return (lo + offset).to(torch.int32).reshape(shape)
