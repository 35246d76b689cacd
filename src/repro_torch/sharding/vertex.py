"""The scheduler's vertex axis across cards.

The port of ``repro.sharding.vertex``.  The device-resident MWIS greedy
(:mod:`repro_torch.core.rates_device`) scores a (T, V, K) tensor of
(round, candidate-subset) vertices per step; the V axis is embarrassingly
parallel.  The reference shards it over a 1-D JAX mesh and combines the
per-shard argmaxes in the mesh (``pmax`` on the score, ``pmin`` on the
t-major global index, a ``psum`` gather of the ids).  The port runs the
same split in one process over a list of devices: each shard scores its
contiguous slice of the enumeration on its own device, and the combine
(:func:`repro_torch.core.rates_device.greedy_rounds_fused`) keeps the
numpy path's earliest-round / lexicographically-first tie-break.

``shards=N`` is clamped to :func:`max_vertex_shards` (the card count on
``cuda``, 1 on the CPU) and placed on :func:`vertex_devices`; a sequence
of devices is taken as given (one shard per entry, repeats allowed), which
is how the CPU tests and a one-card host reach the split.
"""
from __future__ import annotations

import torch

VERTEX_AXIS = "v"


def max_vertex_shards(device) -> int:
    """Upper bound on useful vertex shards: the CUDA card count on
    ``cuda``, 1 on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def vertex_devices(shards: int, device) -> list:
    """The devices of ``shards`` vertex shards: the first ``shards`` cards
    (``cuda:0`` .. ``cuda:shards-1``) on ``cuda``, the CPU once per shard
    on the CPU.  The counterpart of the reference's ``vertex_mesh``:
    ``shards`` must be in [1, :func:`max_vertex_shards`]; callers clamp."""
    n = max_vertex_shards(device)
    if not 1 <= shards <= n:
        raise ValueError(
            f"vertex_devices needs 1 <= shards <= {n} local devices "
            f"(got {shards})"
        )
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(shards)]
    return [dev] * shards


def shard_devices(shards, device) -> list:
    """The devices a ``shards`` argument asks for: an int is clamped to
    [1, :func:`max_vertex_shards`] and placed by :func:`vertex_devices`;
    a sequence of devices is taken as given."""
    if isinstance(shards, (list, tuple)):
        if not shards:
            raise ValueError("an explicit shard device list must not be empty")
        return [torch.device(d) for d in shards]
    n = max(1, min(int(shards), max_vertex_shards(device)))
    return vertex_devices(n, device)


def pad_rows_to_multiple(rows: int, shards: int) -> int:
    """Rows of padding needed so ``rows`` divides evenly across ``shards``."""
    return (-rows) % shards
