"""NOMA uplink with successive interference cancellation (paper §II-A), and
the TDMA baseline rates (paper §IV, Fig. 5): each device alone in its slot.

The port's copy of ``repro/core/noma.py``.  The PS decodes the K superposed
signals strongest received power first; user k's SINR (Eq. 5) is
``p_k h_k^2 / (sum of the later-decoded users' p h^2 + sigma^2)`` and its
rate ``log2(1 + SINR)`` (Eq. 6).  :func:`sinr`, :func:`rates` and
:func:`bit_budget` take float32 tensors and compute in float32, as the
reference's jnp functions do without x64 (``launch/train.py`` reads
:func:`bit_budget`); their logs follow the rule of :func:`tdma_rates`
below.  The reference's ``sic_order`` and ``weighted_sum_rate`` have no
caller in the port yet.

``tdma_rates`` is the port's copy of ``repro.core.noma.tdma_rates``.  The
reference computes it with jnp ops outside any jit and without x64, so in
float32:
``snr = p * g^2 / N0`` (each step rounded to float32), then ``log2(1 +
snr)``, which XLA lowers to ``log(x) * 1.44269502f``.  Here the same
float32 steps run in numpy, or in torch on the run's device for the
scanned online horizon's in-round rates; the natural log is taken in
float64 and rounded to float32 (correctly rounded, the same on every host),
then multiplied by the float32 constant as XLA does.  XLA's own float32
``log`` is not correctly rounded, so the rates agree with the reference's
to within 2 ulp, not bit for bit (ROADMAP.md queue 3).
"""
from __future__ import annotations

import numpy as np
import torch

_INV_LN2 = np.float32(1.44269502)    # XLA's log2 constant, 1 / ln 2


def _log2_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log2``: the natural log (here taken in float64 and
    rounded) times the float32 constant 1 / ln 2."""
    return torch.log(x.to(torch.float64)).to(torch.float32) * float(_INV_LN2)


def _f32(x, like=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32)
    return t if like is None else t.to(like.device)


def sinr(powers, gains, noise_power: float) -> torch.Tensor:
    """Per-user SINR under SIC decoding, in the input user order, float32
    (K,): each user is interfered only by the users decoded after it."""
    powers = _f32(powers)
    gains = _f32(gains, powers)
    rx = powers * (gains * gains)
    order = torch.argsort(-rx, stable=True)
    rx_sorted = rx[order]
    tail = torch.flip(torch.cumsum(torch.flip(rx_sorted, (0,)), 0), (0,)) \
        - rx_sorted
    # tensor by tensor: the reference's quotient, correctly rounded
    sinr_sorted = rx_sorted / (tail + torch.full_like(tail, noise_power))
    out = torch.zeros_like(sinr_sorted)
    out[order] = sinr_sorted
    return out


def rates(powers, gains, noise_power: float) -> torch.Tensor:
    """Spectral efficiency per user (bit/s/Hz), input order (Eq. 6)."""
    return _log2_f32(1.0 + sinr(powers, gains, noise_power))


def bit_budget(powers, gains, noise_power: float, bandwidth_hz: float,
               slot_seconds: float) -> torch.Tensor:
    """Allowable transmission bits c_k = R_k * B * t for each user (§II-B),
    the two products in float32."""
    r = rates(powers, gains, noise_power)
    return r * float(np.float32(bandwidth_hz)) * float(np.float32(
        slot_seconds))


def tdma_rates(powers, gains, noise_power: float):
    """Interference-free rates log2(1 + p g^2 / N0), float32 (..., K): a
    numpy array from array-likes, a tensor on their device from float32
    tensors."""
    if isinstance(powers, torch.Tensor):
        g = gains
        # tensor by tensor: torch divides by a Python number through its
        # reciprocal on the card, which is not the correctly rounded quotient
        snr = powers * (g * g) / torch.full_like(powers, noise_power)
        return _log2_f32(1.0 + snr)
    p = np.asarray(powers, dtype=np.float32)
    g = np.asarray(gains, dtype=np.float32)
    snr = p * (g * g) / np.float32(noise_power)
    ln = np.log((np.float32(1.0) + snr).astype(np.float64)).astype(np.float32)
    return ln * _INV_LN2
