"""Counter-based Threefry-2x32 random numbers in integer tensor ops.

The reference draws the OTA receiver noise with ``jax.random`` (default
``threefry2x32`` implementation, ``jax_threefry_partitionable=True``, no
x64).  This module recomputes the same streams with torch, so the port
draws the reference's noise on any device:

  * a key is a pair of 32-bit words ``(k0, k1)``; ``prng_key(seed)`` is
    ``(0, seed mod 2^32)``, as ``jax.random.PRNGKey`` builds it without x64;
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
  * ``random_bits(key, n)`` hashes the counter pairs ``(i >> 32, i & M)`` of
    the flat indices i < n and returns ``x0 ^ x1`` per index;
  * ``normal(key, n)`` maps those bits to a uniform on
    ``[nextafter(-1, 0), 1)`` and returns ``sqrt(2) * erfinv(u)``.

The words are int64 tensors masked to 32 bits (torch's uint32 support is
partial), so the integer stream is the same on CPU and CUDA tensors and
equals JAX's bit for bit.  The normals go through ``torch.erfinv``, which
is not XLA's float32 ``erf_inv`` polynomial: they agree with
``jax.random.normal`` to within a few 1e-5 in absolute value (the bound is
measured in tests/test_torch_ota.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


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


def random_bits(key, n: int, *, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as an (n,) int64 tensor of
    values in [0, 2^32) on ``device``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK32)
    return b0 ^ b1


def normal(key, n: int, *, device) -> torch.Tensor:
    """Standard normals from the bits of ``jax.random.normal(key, (n,),
    float32)``: (n,) float32 on ``device``."""
    bits = random_bits(key, n, device=device)
    # 23 random mantissa bits under the exponent of 1.0: a float in [1, 2)
    one = 0x3F800000
    u = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = np.float32(1.0) - lo          # rounds to 2.0 in float32
    u = torch.clamp_min(u * float(span) + float(lo), float(lo))
    return torch.erfinv(u) * float(np.float32(math.sqrt(2.0)))
