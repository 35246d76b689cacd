"""The scheduler's vertex axis across cards.

The port of ``repro.sharding.vertex``.  The device-resident MWIS greedy
(:mod:`repro_torch.core.rates_device`) scores a (T, V, K) tensor of
(round, candidate-subset) vertices per step; the V axis is embarrassingly
parallel, and the reference shards it over a 1-D JAX mesh with an in-mesh
argmax combine.  The port runs the greedy on one card: ``shards=N`` is
clamped to :func:`max_vertex_shards` and the enumeration is padded to a
multiple of it (:func:`pad_rows_to_multiple`), but every row is scored on
the run's device.  The split across cards and its combine are not ported
(``ROADMAP.md`` queue 1 item 3), so every ``shards`` value gives the
unsharded schedule.
"""
from __future__ import annotations

import torch


def max_vertex_shards(device) -> int:
    """Upper bound on useful vertex shards: the CUDA card count on
    ``cuda``, 1 on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def pad_rows_to_multiple(rows: int, shards: int) -> int:
    """Rows of padding needed so ``rows`` divides evenly across ``shards``."""
    return (-rows) % shards
