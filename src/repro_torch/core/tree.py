"""Nested-dict parameter trees: flatten, unflatten and leafwise map.

The port's stand-in for ``jax.tree_util`` over the trees it meets: nested
dicts of any depth whose leaves are tensors (or arrays).  Leaves come out
in JAX's order, dict keys sorted at every level, so a flattened tree lines
up with the reference's ``tree_flatten`` leaf for leaf.  The tree
definition is the same nesting with ``None`` at every leaf.
"""
from __future__ import annotations


def tree_flatten(tree):
    """-> (leaves in sorted-key order, tree definition)."""
    if isinstance(tree, dict):
        leaves, treedef = [], {}
        for key in sorted(tree):
            sub_leaves, treedef[key] = tree_flatten(tree[key])
            leaves.extend(sub_leaves)
        return leaves, treedef
    return [tree], None


def tree_unflatten(treedef, leaves):
    """Rebuild a tree of ``treedef``'s nesting from leaves in order."""
    it = iter(leaves)

    def build(d):
        if isinstance(d, dict):
            return {key: build(d[key]) for key in sorted(d)}
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(
        treedef, [fn(*args) for args in zip(leaves, *others)]
    )
