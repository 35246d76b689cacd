"""The cell axis of a sweep across cards.

The port of ``repro.launch.mesh.cell_mesh``'s clamp.  The reference shards
a (C, S) grid of independent simulations over a 1-D mesh of local devices
(``cell_shards``, clamped to the device count).  The port clamps the shard
count to the card count as
:func:`repro_torch.sharding.vertex.max_vertex_shards` does for the greedy.
On one card, or on the CPU, the clamp gives one shard, and
:func:`repro_torch.core.fl.run_cell_sweep` runs the reference's one-device
path: one horizon per instance.  Running shards on several cards, and the
padding of C to a multiple of them that such a split needs, are not ported
(``ROADMAP.md`` item 4's residue, beside item 3's).
"""
from __future__ import annotations

from repro_torch.sharding.vertex import max_vertex_shards


def cell_shards(requested, device) -> int:
    """The shard count a cell sweep would split into: ``requested``
    (``None`` means 1) clamped to [1, the card count on ``device``]."""
    if requested is None:
        return 1
    return max(1, min(int(requested), max_vertex_shards(device)))
