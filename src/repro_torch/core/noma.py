"""TDMA baseline rates (paper §IV, Fig. 5): each device alone in its slot.

The port's copy of ``repro.core.noma.tdma_rates``.  The reference computes
it with jnp ops outside any jit and without x64, so in float32:
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


def tdma_rates(powers, gains, noise_power: float):
    """Interference-free rates log2(1 + p g^2 / N0), float32 (..., K): a
    numpy array from array-likes, a tensor on their device from float32
    tensors."""
    if isinstance(powers, torch.Tensor):
        g = gains
        # tensor by tensor: torch divides by a Python number through its
        # reciprocal on the card, which is not the correctly rounded quotient
        snr = powers * (g * g) / torch.full_like(powers, noise_power)
        ln = torch.log((1.0 + snr).to(torch.float64)).to(torch.float32)
        return ln * float(_INV_LN2)
    p = np.asarray(powers, dtype=np.float32)
    g = np.asarray(gains, dtype=np.float32)
    snr = p * (g * g) / np.float32(noise_power)
    ln = np.log((np.float32(1.0) + snr).astype(np.float64)).astype(np.float32)
    return ln * _INV_LN2
