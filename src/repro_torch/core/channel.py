"""Wireless channel model (paper §II-A).

Channel gain of device k at round t:  h_k^t = L_k * |h0|
  - L_k : large-scale free-space path loss
        L = sqrt(delta) * lambda / (4 pi d^(alpha/2))
  - h0^t : small-scale Rayleigh fading, h0 ~ CN(0, 1), drawn anew each round.

The samplers draw what the reference draws from the same keys
(:mod:`repro_torch.core.prng`, the reference's Threefry streams), in the
reference's op order, so ``sample_channels(seed, ...)`` returns the
reference's channels for that seed bit for bit.  The streams give the same
bits on the CPU and on the card; a run draws them on the host, so it gives
the same channels whichever device trains.

Types follow the reference: distances, gains and large-scale gains are
float32 (the reference's ``jax.random`` draws are), and everything the
control plane derives from them is float64 numpy.  ``d^(alpha/2)`` is the
C library's ``powf``, the function XLA's float32 ``pow`` calls on the CPU
(it is not correctly rounded: one ulp off on about 0.05% of distances).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses

import numpy as np
import torch

from repro_torch.core import prng

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


_libm = None


def _powf(x: np.ndarray, y: float) -> np.ndarray:
    """Elementwise float32 ``powf(x, y)`` of the C library: what XLA's
    float32 ``pow`` calls on the CPU."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.powf.restype = ctypes.c_float
        _libm = lib
    x = np.asarray(x, np.float32)
    y = float(np.float32(y))
    return np.array([_libm.powf(float(v), y) for v in x.reshape(-1)],
                    np.float32).reshape(x.shape)


def large_scale_gain(distances_m, cfg: CellConfig) -> np.ndarray:
    """Free-space path-loss amplitude gain L_k, float32, in the reference's
    op order: ``sqrt(delta) * lambda / (4 pi * powf(d, alpha / 2))``."""
    d = np.asarray(distances_m, np.float32)
    num = np.sqrt(np.float32(cfg.antenna_gain)) * np.float32(cfg.wavelength_m)
    den = np.float32(4.0 * np.pi) * _powf(d, cfg.path_loss_exp / 2.0)
    return num / den


def sample_positions(key, cfg: CellConfig, *, device="cpu") -> np.ndarray:
    """Uniform device positions over the cell disk: (M,) float32 distances
    (the reference draws ``uniform`` under the first key of
    ``split(key)``, then ``max(R * sqrt(u), d_min)``), drawn on
    ``device``."""
    k1 = prng.split(key)[0]
    u = prng.uniform(k1, cfg.num_devices, device=device)
    r = prng.sqrt_f32(u) * float(np.float32(cfg.cell_radius_m))
    return torch.clamp_min(r, float(np.float32(cfg.min_distance_m))).cpu() \
        .numpy()


def sample_small_scale(key, n: int, *, device="cpu") -> torch.Tensor:
    """|h0| with h0 ~ CN(0, 1): (n,) float32 on ``device``, the real and
    imaginary parts drawn under the two keys of ``split(key)``."""
    kr, ki = prng.split(key)
    half = float(np.sqrt(np.float32(0.5)))
    re = prng.normal(kr, n, device=device) * half
    im = prng.normal(ki, n, device=device) * half
    return prng.sqrt_f32(re * re + im * im)


def sample_channel_gains(key, distances_m, cfg: CellConfig, *,
                         device="cpu") -> np.ndarray:
    """Per-device amplitude channel gain h_k = L_k * |h0| for one round."""
    ls = torch.from_numpy(large_scale_gain(distances_m, cfg)).to(device)
    return (ls * sample_small_scale(key, ls.shape[0], device=device)) \
        .cpu().numpy()


def sample_round_channels(key, distances_m, cfg: CellConfig,
                          num_rounds: int, *, device="cpu") -> np.ndarray:
    """(T, M) float32 gains, block fading: round t draws under the t-th key
    of ``split(key, T)``."""
    keys = prng.split(key, num_rounds)
    m = np.asarray(distances_m).shape[0]
    if num_rounds == 0:
        return np.zeros((0, m), np.float32)
    return np.stack([sample_channel_gains(k, distances_m, cfg, device=device)
                     for k in keys])


def sample_channels(seed: int, cfg: CellConfig, num_rounds: int, *,
                    device="cpu") -> ChannelBundle:
    """The reference's channel draws for one run from ``seed``: positions
    under ``fold_in(PRNGKey(seed), 1)``, fading under ``fold_in(..., 2)``
    (``repro/core/fl.py``).  The streams are drawn on ``device`` (the
    host by default: the control plane is host numpy), with the same bits
    on either."""
    key = prng.prng_key(seed)
    dist = sample_positions(prng.fold_in(key, 1), cfg, device=device)
    gains = sample_round_channels(prng.fold_in(key, 2), dist, cfg,
                                  num_rounds, device=device)
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
