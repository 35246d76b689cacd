"""Non-iid device partitioning (paper §IV: "sizes and distributions both
differ"): Dirichlet(alpha) class mixtures with log-normal size jitter.

A numpy copy of ``repro.data.partition``, bit-exact to it."""
from __future__ import annotations

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_devices: int,
    *,
    alpha: float = 0.5,
    size_sigma: float = 0.4,
    min_per_device: int = 8,
    seed: int = 0,
):
    """Return list[num_devices] of index arrays into the dataset.

    Each device's class distribution ~ Dirichlet(alpha); device sizes are
    log-normal-jittered around the uniform share. Every sample is assigned to
    exactly one device, and every *realized* shard meets ``min_per_device``
    (clamped to ``len(labels) // num_devices`` when the floor is infeasible).
    """
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for idx in by_class:
        rng.shuffle(idx)

    sizes = rng.lognormal(0.0, size_sigma, num_devices)
    sizes = np.maximum(
        (sizes / sizes.sum() * len(labels)).astype(int), min_per_device
    )
    mixes = rng.dirichlet(np.full(num_classes, alpha), num_devices)

    cursor = np.zeros(num_classes, dtype=int)
    shards = []
    for d in range(num_devices):
        want = np.round(mixes[d] * sizes[d]).astype(int)
        take = []
        for c in range(num_classes):
            avail = len(by_class[c]) - cursor[c]
            n = min(want[c], avail)
            take.append(by_class[c][cursor[c] : cursor[c] + n])
            cursor[c] += n
        shards.append(np.concatenate(take) if take else np.empty(0, int))
    # Distribute any leftovers round-robin so every sample lands somewhere.
    leftovers = np.concatenate(
        [by_class[c][cursor[c] :] for c in range(num_classes)]
    )
    for i, s in enumerate(np.array_split(leftovers, num_devices)):
        shards[i] = np.concatenate([shards[i], s])
    # Enforce the floor on *realized* shards: the size clamp above applies to
    # target sizes before class pools are exhausted, and the leftover
    # round-robin only tops up the first devices, so late devices could come
    # out below ``min_per_device``.  Rebalance from the largest shards until
    # every device meets the (realizable) floor; donors never drop below it.
    floor = min(min_per_device, len(labels) // max(num_devices, 1))
    lengths = np.array([len(s) for s in shards])
    for d in range(num_devices):
        while lengths[d] < floor:
            donor = int(np.argmax(lengths))
            take = min(floor - lengths[d], lengths[donor] - floor)
            if take <= 0:
                break  # unreachable given floor <= len(labels) // num_devices
            shards[d] = np.concatenate([shards[d], shards[donor][-take:]])
            shards[donor] = shards[donor][:-take]
            lengths[d] += take
            lengths[donor] -= take
    for d in range(num_devices):
        rng.shuffle(shards[d])
    return shards
