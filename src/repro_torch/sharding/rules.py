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


def named(mesh, spec) -> tuple:
    """The reference's ``NamedSharding(mesh, spec)``: the ``(mesh,
    placements)`` pair that ``torch.distributed.tensor.distribute_tensor``
    takes.  ``spec`` is a :class:`ShardSpec` or a tuple of placements, one
    per mesh dim (a single placement for a 1-D mesh)."""
    if isinstance(spec, ShardSpec):
        return mesh, spec.placements(mesh)
    return mesh, tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)


# --------------------------------------------------------------------------
# FL simulator cell axis (the scheduler's vertex split's sibling)
# --------------------------------------------------------------------------

CELL_AXIS = "cell"
# The multi-cell FL sweep's axis (repro_torch.launch.mesh.cell_mesh):
# whole independent simulations, their per-instance stacks (C, S, ...),
# are cut into one block of cells per card; cells never communicate.  The
# four tuples below are the split's positional contracts, one placement
# over CELL_AXIS per argument: ``Shard(0)`` cuts the leading cell axis into
# blocks (concatenated back on return), ``Replicate()`` passes the whole
# argument to every card (repro_torch.sharding.cells.cut_blocks reads
# them).


def _cell_placements():
    from torch.distributed.tensor import Replicate, Shard

    return Shard(0), Replicate()


def cell_sweep_in_specs() -> tuple:
    """Placements of ``fl_engine.run_horizon_sharded``'s arguments.

    Positional contract: (params_cs, dev, budgets, agg_w, gains,
    noise_keys, eval_mask, eval_idx, xb, yb, xe, ye): the per-instance
    stacks (the OTA channel gains and receiver-noise keys among them) are
    cut along their leading cell axis; the eval cadence mask, the client
    bank and the test set go whole to every card.
    """
    c, r = _cell_placements()
    return (c, c, c, c, c, c, r, c, r, r, r, r)


def cell_sweep_out_specs() -> tuple:
    """Placements of its results: (final params, bits, kept, accuracies),
    all cell-stacked."""
    c, _ = _cell_placements()
    return (c, c, c, c)


def cell_sweep_online_in_specs() -> tuple:
    """Placements of ``fl_engine.run_horizon_online_sharded``'s arguments.

    Positional contract: (params_cs, solo, gains, noise_keys, eval_mask,
    eval_idx, weights_m, sizes_m, xb, yb, xe, ye): the per-instance stacks
    (model inits, solo-rate tables, channel rows, noise keys, eval plans)
    are cut along their leading cell axis; the eval cadence mask, the
    shared data weights and sizes, the client bank and the test set go
    whole to every card.
    """
    c, r = _cell_placements()
    return (c, c, c, c, r, c, r, r, r, r, r, r)


def cell_sweep_online_out_specs() -> tuple:
    """Placements of its results: (final params, device ids, validity
    masks, bits, kept, accuracies), all cell-stacked."""
    c, _ = _cell_placements()
    return (c, c, c, c, c, c)
