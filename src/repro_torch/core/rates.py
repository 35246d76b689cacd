"""Batched SIC rate engine (paper Eq. 2-4): the host control plane's hot path.

A float64 numpy copy of ``repro.core.rates`` (the port keeps its own copy
and imports nothing of the JAX package).  Every scheduler scores candidate
NOMA groups by their weighted sum rate under successive interference
cancellation, decoding in descending receive-power order with each device
seeing only the not-yet-decoded tail as interference:

    R_k = log2(1 + p_k h_k^2 / (sum_{j decoded after k} p_j h_j^2 + sigma^2))

``sic_rates`` broadcasts over arbitrary leading axes;
``batched_weighted_rates`` is the (V, K) -> (V,) scorer the MWIS schedulers
use.  Ties in receive power are broken by input index (stable sort).  The
arithmetic is the reference's op for op, so schedules, powers and rates are
bit-identical to it (tests/test_torch_control_plane.py).
"""
from __future__ import annotations

import numpy as np


def sic_rates(powers, gains, noise_power: float) -> np.ndarray:
    """Per-device SIC spectral efficiencies, input order.

    powers, gains: (..., K) arrays (any matching leading batch axes).
    Returns (..., K) rates with decode order = descending receive power,
    ties broken by lower input index first (stable sort).
    """
    p = np.asarray(powers, dtype=np.float64)
    g = np.asarray(gains, dtype=np.float64)
    rx = p * g * g
    order = np.argsort(-rx, axis=-1, kind="stable")
    rx_s = np.take_along_axis(rx, order, axis=-1)
    # Suffix sum over the decode axis: interference seen by sorted pos i is
    # the sum of receive powers decoded after it.
    suffix = np.cumsum(rx_s[..., ::-1], axis=-1)[..., ::-1]
    tail = np.concatenate([suffix[..., 1:], np.zeros_like(suffix[..., :1])], axis=-1)
    rates_sorted = np.log2(1.0 + rx_s / (tail + noise_power))
    out = np.empty_like(rates_sorted)
    np.put_along_axis(out, order, rates_sorted, axis=-1)
    return out


def batched_weighted_rates(powers_vk, gains_vk, weights_vk, noise_power: float) -> np.ndarray:
    """Weighted sum rate of V candidate groups in one shot: (V, K) -> (V,).

    powers_vk / gains_vk / weights_vk are per-group rows; the reduction over
    K is done in input order (matching the scalar ``power.weighted_rate``).
    """
    w = np.asarray(weights_vk, dtype=np.float64)
    return np.sum(w * sic_rates(powers_vk, gains_vk, noise_power), axis=-1)


def weighted_rate(powers, gains, weights, noise_power: float) -> float:
    """Scalar convenience wrapper: one group's weighted sum rate."""
    return float(
        batched_weighted_rates(
            np.atleast_2d(np.asarray(powers, dtype=np.float64)),
            np.atleast_2d(np.asarray(gains, dtype=np.float64)),
            np.atleast_2d(np.asarray(weights, dtype=np.float64)),
            noise_power,
        )[0]
    )
