"""Production meshes: the port of ``repro/launch/mesh.py``.

Functions, not module constants: importing this module touches no process
group.  Single pod: (data=16, model=16) = 256 cards.  Multi-pod: (pod=2,
data=16, model=16) = 512 cards; the leading "pod" axis carries the
cross-pod data-parallel (gradient all-reduce) traffic.  The meshes are
torch ``DeviceMesh``es with the reference's axis names.

A mesh needs a default process group of its size.  Where none is
initialised, :func:`ensure_world` starts one in this process: for one
rank, a ``gloo`` group over an in-process ``HashStore``; for more, torch's
fake group (``FakeStore``), whose collectives do nothing, so that a
256- or 512-card mesh can be built and its placements read on one host
(the dry-run's counterpart of the reference's 512 fake XLA devices).
:func:`release_world` takes down a group that :func:`ensure_world` started.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.sharding.rules import CELL_AXIS
from repro_torch.sharding.vertex import max_vertex_shards

_STARTED = {"world": None}


def ensure_world(size: int) -> None:
    """A default process group of ``size`` ranks (this process rank 0):
    the one already initialised if it has that size, else a new one (a
    previous group started here is taken down first)."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        if _STARTED["world"] is None:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"initialised; a mesh of {size} cards needs {size}")
        release_world()
    if size == 1:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    _STARTED["world"] = size


def release_world() -> None:
    """Destroy the process group :func:`ensure_world` started, if any."""
    if _STARTED["world"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _STARTED["world"] = None


def _mesh(device_type: str, shape, names):
    size = 1
    for s in shape:
        size *= s
    ensure_world(size)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 ("data", "model") mesh, or 2x16x16 ("pod", "data",
    "model") with ``multi_pod``, of CPU ranks: the dry-run places and
    counts on it and launches nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("cpu", shape, axes)


def make_smoke_mesh():
    """1-rank mesh with the same axis names."""
    return _mesh("cpu", (1, 1), ("data", "model"))


def cell_mesh(shards: int, *, device=None):
    """1-D mesh of ``shards`` cards over the FL simulator's cell axis
    (:data:`repro_torch.sharding.rules.CELL_AXIS`).

    The range check uses the card count on ``device`` (``None`` means
    ``cuda``; 1 on the CPU), the bound ``sharding/cells.py`` clamps a
    sweep's ``cell_shards`` to."""
    dev = torch.device("cuda" if device is None else device)
    n = max_vertex_shards(dev)
    if not 1 <= shards <= n:
        raise ValueError(
            f"cell_mesh needs 1 <= shards <= {n} "
            f"local devices (got {shards})"
        )
    return _mesh(dev.type, (shards,), (CELL_AXIS,))
