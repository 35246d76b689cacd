"""Over-the-air (OTA) analog aggregation physics (Bereyhi et al. 2206.06679).

The port of ``repro.core.ota``.  Every scheduled device transmits its *raw*
model update at once over the shared slot, scaled so that the channel
itself computes the FedAvg sum; the PS receives

    y = sum_{k in A} h_k b_k delta_k + n,        n ~ N(0, sigma_ota^2 I)

and never decodes a per-device payload (``FLConfig`` rejects quantization
and top-k under OTA).  Truncated channel inversion, ``b_k = sqrt(eta) * w_k
/ h_k``, makes participant k contribute ``sqrt(eta) * w_k * delta_k``; the
participation set A keeps devices with ``h_k >= threshold * max_j h_j``;
the per-device power budget pins

    eta = min_{k in A} pmax * h_k^2 / (w_k^2 * ||delta_k||^2),

and the PS estimate is ``(sum_{k in A} w_k delta_k + n / sqrt(eta)) /
sum_{k in A} w_k``.  At ``noise_std = 0`` and ``threshold = 0`` that is
the weighted FedAvg aggregate.

The receiver noise is the reference's own stream: per-round keys
``fold_in(PRNGKey(seed + 29), t)`` (:func:`horizon_keys`) and
``jax.random.normal`` recomputed by :mod:`repro_torch.core.prng` on the
run's device.  Under ``use_pallas`` (the reference's name for its fused
kernel path) the weighted reduction runs through the hand-written kernel
(:func:`repro_torch.kernels.ota_aggregate.ota_aggregate_keyed`), which on
the card forms that noise itself from the round key, so no noise strip is
drawn; otherwise the noise is drawn and added to an einsum, as the
reference's XLA path does.  Both give the reference's noise to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import errors, prng
from repro_torch.core import tree as tree_lib
from repro_torch.kernels.ota_aggregate import ota_aggregate_keyed, row_buffer

UPLINK_MODES = ("noma", "tdma", "ota")
# the reference's uplink modes: "noma"/"tdma" are the paper's digital §IV
# uplinks, "ota" the analog superposition of this module

OTA_SEED_OFFSET = 29
# the reference's offset of the receiver-noise stream from FLConfig.seed

_TINY = 1e-30   # divide guard; far below any realized f32 weight sum


def check_uplink(uplink: str, *, compression: str, topk: float,
                 power_mode: str) -> None:
    """Raise ValueError with the pinned messages on incoherent combos."""
    if uplink not in UPLINK_MODES:
        raise ValueError(
            errors.ERR_UNKNOWN_UPLINK.format(uplink=uplink, modes=UPLINK_MODES)
        )
    if uplink == "ota":
        if topk < 1.0:
            raise ValueError(errors.ERR_OTA_TOPK)
        if compression != "none":
            raise ValueError(errors.ERR_OTA_COMPRESSION)
        if power_mode == "mapel":
            raise ValueError(errors.ERR_OTA_MAPEL)
    elif power_mode == "ota-align":
        raise ValueError(errors.ERR_OTA_ALIGN_UPLINK)


def horizon_keys(seed: int, num_rounds: int) -> np.ndarray:
    """(T, 2) uint32 per-round receiver-noise keys, computed on the host:
    ``fold_in(PRNGKey(seed + OTA_SEED_OFFSET), t)``, equal to the
    reference's."""
    base = prng.prng_key(int(seed) + OTA_SEED_OFFSET)
    return np.stack([prng.fold_in(base, t) for t in range(num_rounds)]
                    ).reshape(num_rounds, 2)


def _f32(ref: torch.Tensor, value: float) -> torch.Tensor:
    """A float32 scalar tensor on ``ref``'s device, made without a
    host-to-device copy (an operand, so divisions by it are correctly
    rounded, not a reciprocal times the number)."""
    return torch.full((), float(value), dtype=torch.float32, device=ref.device)


def superpose_flat(flat, gains_k, agg_w, key, *, pmax: float,
                   noise_std: float, threshold: float,
                   use_pallas: bool = False) -> torch.Tensor:
    """The OTA receiver estimate for one round; returns the (P,) update.

    flat: (K, P) raw client update rows; gains_k: (K,) channel amplitudes;
    agg_w: (K,) FedAvg weights (0 marks padding rows); key: (2,) uint32
    receiver-noise key (host).  The reference's op order, in float32:
    participation mask, energies, eta, coefficients, noise scale, then the
    keyed kernel (``use_pallas``: noise formed from ``key`` inside it) or
    the einsum plus the drawn noise.  A round with no participant
    returns exactly zero plus zero-scaled noise.
    """
    k, p = flat.shape
    flat = flat.to(torch.float32)
    h = gains_k.to(torch.float32)
    w = agg_w.to(torch.float32)
    zero = _f32(flat, 0.0)
    inf = _f32(flat, float("inf"))

    cand = w > 0.0
    hmax = torch.cat([torch.where(cand, h, zero), zero.reshape(1)]).amax()
    mask = cand & (h > 0.0) & (h >= _f32(flat, threshold) * hmax)

    energy = torch.sum(flat * flat, dim=1)               # (K,) ||delta_k||^2
    # per-participant eta cap; a zero-energy delta imposes none
    den = w * w * energy
    cap = torch.where(
        mask & (den > 0.0),
        _f32(flat, pmax) * h * h / torch.clamp_min(den, _TINY),
        inf,
    )
    eta = torch.cat([cap, inf.reshape(1)]).amin()

    wm = torch.where(mask, w, zero)
    wsum = zero
    for i in range(k):      # in order, as XLA's reduce of K values adds
        wsum = wsum + wm[i]
    wsafe = torch.clamp_min(wsum, _TINY)
    coeff = wm / wsafe                                   # (K,)

    # eta = inf (no participant caps the budget) means the update is the
    # noiseless sum
    scale = torch.where(
        torch.isfinite(eta) & (eta > 0.0),
        _f32(flat, noise_std) / (torch.sqrt(eta) * wsafe),
        zero,
    )
    if use_pallas:
        # the noise is formed inside the kernel from the round key: no strip
        return ota_aggregate_keyed(flat, coeff, key, scale)
    noise = scale * prng.normal(key, p, device=flat.device)
    return torch.einsum("k,kn->n", coeff, flat) + noise


def superpose_tree(deltas, gains_k, agg_w, key, *, pmax: float,
                   noise_std: float, threshold: float,
                   use_pallas: bool = False):
    """OTA aggregation of a client-stacked nested dict of deltas (leaves
    (K, ...)); returns the update dict (leaves without the K axis).

    eta depends on the whole payload's energy, so the leaves are flattened
    into one (K, P) matrix first, in the reference's leaf order (sorted
    keys: ``fc1/b`` before ``fc1/w``), which decides which parameter each
    noise coordinate lands on."""
    leaves, treedef = tree_lib.tree_flatten(deltas)
    k = leaves[0].shape[0]
    sizes = [int(np.prod(leaf.shape[1:])) for leaf in leaves]
    # rows spaced for the kernel's 16-byte loads (kernels/ota_aggregate.py)
    flat = torch.cat(
        [leaf.reshape(k, -1).to(torch.float32) for leaf in leaves], dim=1,
        out=row_buffer(k, sum(sizes), device=leaves[0].device),
    )
    out = superpose_flat(
        flat, gains_k, agg_w, key, pmax=pmax, noise_std=noise_std,
        threshold=threshold, use_pallas=use_pallas,
    )
    return tree_lib.tree_unflatten(treedef, [
        part.reshape(leaf.shape[1:])
        for part, leaf in zip(torch.split(out, sizes), leaves)
    ])
