"""Logical-axis -> mesh placement translation: the port of
``repro/sharding/rules.py``.

Parameters carry logical axis names (``repro_torch.models.params``).
Physical mapping:

    embed   -> "data"   (FSDP: weights reduce-scattered over the data axis)
    mlp     -> "model"  (tensor parallel: d_ff, d_inner)
    heads   -> "model"  (tensor parallel: attention / SSM heads)
    vocab   -> "model"
    expert  -> "model"  (expert parallel, when num_experts divides the axis)
    kv / layers / expert_in / None -> replicated

Safety valves, applied per tensor and in order:
  1. a physical axis is used at most once per tensor (first dim wins);
  2. a dim not divisible by the axis size falls back to replicated
     (mixtral's 8 experts on a 16-way model axis -> experts replicated,
     d_ff sharded instead).

Every function returns a :class:`ShardSpec`: one entry per tensor dim, a
mesh axis name, a tuple of names or ``None``, as the reference's
``PartitionSpec`` holds them, and :meth:`ShardSpec.placements` gives the
DTensor placements (one ``Shard(dim)`` or ``Replicate()`` per mesh dim).
A ``mesh`` is a torch ``DeviceMesh`` (``repro_torch.launch.mesh``) or any
object whose ``shape`` maps axis names to sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AxisRules:
    table: dict

    def physical(self, logical: Optional[str]):
        return self.table.get(logical)


DEFAULT_RULES = AxisRules(
    {
        "embed": "data",
        "mlp": "model",
        "heads": "model",
        "vocab": "model",
        "expert": "model",
    }
)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of a ``shape`` dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


class ShardSpec(tuple):
    """Per tensor dim: the mesh axis (or tuple of axes) it is split over,
    or ``None``.  A one-axis tuple is held as the axis name, as JAX's
    ``PartitionSpec`` holds it."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self):
        return f"ShardSpec{tuple(self)!r}"

    def axes_of(self, dim: int) -> tuple:
        entry = self[dim]
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def shard_factor(self, mesh) -> int:
        """How many pieces the tensor is cut into across the mesh."""
        sizes = axis_sizes(mesh)
        n = 1
        for d in range(len(self)):
            for a in self.axes_of(d):
                n *= sizes[a]
        return n

    def placements(self, mesh) -> tuple:
        """DTensor placements, one per mesh dim in the mesh's order."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in axis_sizes(mesh):
            dims = [d for d in range(len(self)) if name in self.axes_of(d)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def _axis_size(sizes: dict, name: str) -> int:
    return sizes[name] if name in sizes else 0


def translate(axes, shape, mesh, rules: AxisRules = DEFAULT_RULES) -> ShardSpec:
    """Logical axes tuple (len == ndim) -> :class:`ShardSpec` for this mesh.

    Embedding/unembedding tensors (any tensor with a "vocab" axis) shard
    only the vocab dim: FSDP-sharding their "embed" dim would put the
    unembed contraction over a sharded dim, and a (B, S, V) float32
    partial-sum all-reduce with it."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    vocab_tensor = "vocab" in axes
    for dim, logical in zip(shape, axes):
        phys = rules.physical(logical)
        if vocab_tensor and logical == "embed":
            phys = None
        if (
            phys is None
            or phys in used
            or phys not in sizes
            or dim % _axis_size(sizes, phys) != 0
        ):
            out.append(None)
        else:
            out.append(phys)
            used.add(phys)
    return ShardSpec(*out)


def param_pspecs(logical_tree, abstract_tree, mesh,
                 rules: AxisRules = DEFAULT_RULES):
    """Tree of :class:`ShardSpec` matching the parameter tree (nested dicts
    whose leaves are logical-axis tuples and abstract parameters)."""
    if isinstance(logical_tree, dict):
        return {k: param_pspecs(v, abstract_tree[k], mesh, rules)
                for k, v in logical_tree.items()}
    return translate(logical_tree, abstract_tree.shape, mesh, rules)


def batch_axes(mesh):
    """Physical axes carrying the batch dim: ("pod","data") when multi-pod."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def batch_shard(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def activation_specs(mesh, batch: int, *, extra_dims: int = 1) -> ShardSpec:
    """Spec for (B, S, ...) activations/token batches."""
    ba = batch_axes(mesh)
    if batch % batch_shard(mesh) == 0:
        return ShardSpec(ba, *([None] * extra_dims))
    return ShardSpec(*([None] * (1 + extra_dims)))


def cache_pspec(mesh, cache_shape, *, stacked_dims: int = 1) -> ShardSpec:
    """Spec for a stacked KV cache (L..., B, S, H, D).

    Prefers batch -> (pod?,data), heads -> model.  When the batch is too
    small (long_500k: B=1) the *sequence* dim shards over the data axes
    instead (the flash-decode layout)."""
    sizes = axis_sizes(mesh)
    lead = [None] * stacked_dims
    b, s, h, d = cache_shape[stacked_dims:]
    ba = batch_axes(mesh)
    model_ok = "model" in sizes and h % sizes["model"] == 0
    hspec = "model" if model_ok else None
    if b % batch_shard(mesh) == 0:
        return ShardSpec(*lead, ba, None, hspec, None)
    if s % batch_shard(mesh) == 0:
        return ShardSpec(*lead, None, ba, hspec, None)
    return ShardSpec(*lead, None, None, hspec, None)


# --------------------------------------------------------------------------
# FL simulator cell axis (the scheduler's vertex-mesh sibling).  The
# reference's shard_map specs of the cell sweep (``cell_sweep_*_specs``)
# come with the multi-card sweep (ROADMAP.md item 4's residue).
# --------------------------------------------------------------------------

CELL_AXIS = "cell"
