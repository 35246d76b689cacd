"""Wireless channel model (paper §II-A).

Channel gain of device k at round t:  h_k^t = L_k * |h0^t|
  - L_k : large-scale free-space path loss
        L = sqrt(delta) * lambda / (4 pi d^(alpha/2))
  - h0^t : small-scale Rayleigh fading, h0 ~ CN(0, 1), drawn anew each round.

The reference draws positions and fading with ``jax.random``; the port's
samplers draw from a seeded ``torch.Generator`` on the CPU, so a run gives
the same channels whichever device trains.  The two generators give
different numbers from one seed, so a caller that wants the reference's
exact system injects a :class:`ChannelBundle` of its draws
(``fl.run_federated_learning(..., channels=...)``).

Types follow the reference: distances, gains and large-scale gains are
float32 (the reference's ``jax.random`` draws are), and everything the
control plane derives from them is float64 numpy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# Speed of light (m/s).
_C = 299_792_458.0


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Static description of the cell (paper §IV settings by default)."""

    num_devices: int = 300          # M
    cell_radius_m: float = 500.0    # PS cell size
    min_distance_m: float = 10.0    # keep devices out of the antenna near field
    carrier_hz: float = 2.4e9       # typical ISM carrier (paper does not state one)
    path_loss_exp: float = 3.0      # alpha
    antenna_gain: float = 1.0       # delta (unit gain)
    bandwidth_hz: float = 4e6       # uplink bandwidth B
    noise_dbm_per_hz: float = -174.0
    max_power_w: float = 0.01       # p^max
    slot_seconds: float = 0.2       # uplink slot t
    downlink_bandwidth_hz: float = 10e6
    downlink_power_w: float = 0.2

    @property
    def wavelength_m(self) -> float:
        return _C / self.carrier_hz

    @property
    def noise_power_w(self) -> float:
        """Total noise power over the uplink band: sigma^2 = N0 * B (watts)."""
        n0_w_per_hz = 10.0 ** (self.noise_dbm_per_hz / 10.0) * 1e-3
        return n0_w_per_hz * self.bandwidth_hz


@dataclasses.dataclass(frozen=True)
class ChannelBundle:
    """Every channel draw one run consumes (all float32 numpy).

    distances: (M,) metres; gains: (T, M) amplitude gains per round;
    dl_gains: (M,) large-scale gains, which set the downlink broadcast time.
    """

    distances: np.ndarray
    gains: np.ndarray
    dl_gains: np.ndarray


def large_scale_gain(distances_m, cfg: CellConfig) -> np.ndarray:
    """Free-space path-loss amplitude gain L_k, float32 like the reference.

    The power ``d^(alpha/2)`` is the correctly rounded float32 value; XLA's
    float32 ``pow`` on the CPU differs from it in the last bit for a few in
    ten thousand distances, so a parity test injects the reference's own
    large-scale gains rather than expecting bit equality here.
    """
    d = np.asarray(distances_m, np.float32)
    num = np.float32(math.sqrt(cfg.antenna_gain)) * np.float32(cfg.wavelength_m)
    powd = (d.astype(np.float64) ** (cfg.path_loss_exp / 2.0)).astype(np.float32)
    den = np.float32(4.0 * math.pi) * powd
    return num / den


def sample_positions(gen: torch.Generator, cfg: CellConfig) -> np.ndarray:
    """Uniform device positions over the cell disk: (M,) float32 distances."""
    u = torch.rand(cfg.num_devices, generator=gen, dtype=torch.float32)
    r = cfg.cell_radius_m * torch.sqrt(u)
    return torch.clamp_min(r, cfg.min_distance_m).numpy()


def sample_round_channels(
    gen: torch.Generator, distances_m, cfg: CellConfig, num_rounds: int
) -> np.ndarray:
    """(T, M) float32 gains h = L * |h0|, h0 ~ CN(0, 1), block fading."""
    ls = torch.from_numpy(large_scale_gain(distances_m, cfg))
    shape = (num_rounds, len(ls))
    re = torch.randn(shape, generator=gen, dtype=torch.float32) * math.sqrt(0.5)
    im = torch.randn(shape, generator=gen, dtype=torch.float32) * math.sqrt(0.5)
    return (ls[None, :] * torch.sqrt(re * re + im * im)).numpy()


def sample_channels(seed: int, cfg: CellConfig, num_rounds: int) -> ChannelBundle:
    """The port's own channel draws for one run, from ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    dist = sample_positions(gen, cfg)
    gains = sample_round_channels(gen, dist, cfg, num_rounds)
    return ChannelBundle(dist, gains, large_scale_gain(dist, cfg))


def downlink_time_seconds(model_bits: float, gains, cfg: CellConfig) -> float:
    """Broadcast time T_d = max_k I / (B_d log2(1 + p_d * gamma_k)) (paper §IV).

    gamma_k is the received downlink SNR at device k, computed in float64
    with ``log1p`` as the reference does.  A device with zero gain (the
    broadcast would never complete) raises.
    """
    n0_w_per_hz = 10.0 ** (cfg.noise_dbm_per_hz / 10.0) * 1e-3
    noise = n0_w_per_hz * cfg.downlink_bandwidth_hz
    g = np.asarray(gains, np.float64)
    snr = cfg.downlink_power_w * g * g / noise
    if not np.all(np.isfinite(snr)):
        raise ValueError(
            "non-finite downlink SNR: some channel gain is NaN/inf; check "
            "the upstream gain computation"
        )
    if not np.all(snr > 0.0):
        raise ValueError(
            "zero downlink SNR: some device has zero channel gain, so the "
            "broadcast never completes (T_d = inf); check the cell geometry"
        )
    rate = cfg.downlink_bandwidth_hz * np.log1p(snr) / np.log(2.0)
    return float(np.max(model_bits / rate))
