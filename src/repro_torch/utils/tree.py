"""Parameter-tree utilities over :mod:`repro_torch.core.tree`'s nested
dicts: the port's copy of ``repro.utils.tree``.

Leaves are anything with ``numel()`` or ``size`` and a dtype: tensors,
numpy arrays, or the shape-only stand-ins of
:func:`repro_torch.models.params.abstract_params`.  Leaf order is the
reference's (dict keys sorted at every level).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree as tree_lib


def _size(leaf) -> int:
    return int(leaf.numel()) if isinstance(leaf, torch.Tensor) else int(
        np.prod(leaf.shape))


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def tree_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(_size(x) for x in tree_lib.tree_flatten(tree)[0])


def tree_bytes(tree) -> int:
    """Total bytes of a tree of arrays."""
    return sum(_size(x) * _itemsize(x) for x in tree_lib.tree_flatten(tree)[0])


def tree_zeros_like(tree):
    """A tree of zero tensors shaped as ``tree``'s, each leaf keeping its
    dtype and device."""
    return tree_lib.tree_map(torch.zeros_like, tree)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = tree_lib.tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def tree_flatten_with_paths(tree):
    """(path_string, leaf) pairs with '/'-joined keys, in leaf order."""
    if not isinstance(tree, dict):
        return [("", tree)]
    out = []
    for key in sorted(tree):
        for path, leaf in tree_flatten_with_paths(tree[key]):
            out.append((f"{key}/{path}" if path else str(key), leaf))
    return out
