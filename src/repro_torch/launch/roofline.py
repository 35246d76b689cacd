"""Roofline terms of a counted step: the port of
``repro/launch/roofline.py``, with the H100's constants.

Three terms per (arch x shape x mesh), in per-card seconds:

    compute    = flops / PEAK_FLOPS
    memory     = hbm_bytes / HBM_BW
    collective = collective_bytes / LINK_BW

The numerators are per card: the dry-run (``launch/dryrun.py``) counts a
step's work on fake tensors and divides it evenly over the mesh (the
reference's per-partition HLO numbers are the same quantity when the work
is balanced), and it counts the collective bytes from the placements, as
output-shape bytes, the measure the reference's ``parse_collectives``
takes from the optimized HLO.  ``parse_collectives`` and ``_shape_bytes``
read XLA's HLO text and have no counterpart here: a torch step has no HLO.

Hardware constants, NVIDIA H100 SXM5 80 GB (NVIDIA's H100 datasheet):
989e12 dense bf16 FLOP/s on the tensor cores, 67e12 float32 FLOP/s outside
them, 3.35e12 B/s of HBM3.  Collectives: 50e9 B/s per card, the 400 Gb/s
NDR InfiniBand port each H100 of a DGX/HGX node has to the other nodes.
A node holds 8 cards on NVLink 4 (450e9 B/s per direction), but both axes
of the 16x16 mesh are 16 wide, so every collective of a 256- or 512-card
mesh crosses nodes, and its slowest hop is that port.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12       # bf16 dense, tensor cores, per card
PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores, per card
HBM_BW = 3.35e12          # bytes/s per card (HBM3)
LINK_BW = 50e9            # bytes/s per card across nodes (NDR 400 Gb/s)

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def empty_collectives() -> CollectiveStats:
    return CollectiveStats({k: 0 for k in COLLECTIVES},
                           {k: 0 for k in COLLECTIVES})


@dataclasses.dataclass
class Roofline:
    flops: float               # per-card FLOPs
    hbm_bytes: float           # per-card bytes accessed
    collective_bytes: float    # per-card bytes through collectives
    collectives: CollectiveStats
    model_flops: float         # 6 * N_active * tokens (useful-work reference)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: attention and dispatch work beyond
        the 6ND estimate."""
        return self.model_flops / max(self.flops, 1.0)

    def summary(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "collective_breakdown": dict(self.collectives.bytes_by_kind),
            "collective_counts": dict(self.collectives.count_by_kind),
            "model_flops_per_chip": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg, shape, *, n_chips: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), per card.

    For decode shapes D = global_batch tokens (one step); train includes the
    3x of backward (6 = 2 fwd + 4 bwd per param-token)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_chips
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens / n_chips
