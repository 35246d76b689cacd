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


def tree_slots(tree):
    """The (dict, key) that holds each leaf of the nested-dict ``tree``, in
    :func:`tree_flatten`'s order: where a leaf can be replaced in place."""
    if not isinstance(tree, dict):
        raise TypeError("a leaf is replaced in place only inside a dict")
    slots = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            slots.extend(tree_slots(tree[key]))
        else:
            slots.append((tree, key))
    return slots


def tree_map_(fn, tree, *rest):
    """:func:`tree_map` in place: each of ``tree``'s leaves is replaced by
    ``fn(leaf, *others)`` in its own dict as soon as that exists, so the
    old leaf is released there unless something else holds it.  Returns
    ``tree``."""
    others = [tree_flatten(t)[0] for t in rest]
    for i, (box, key) in enumerate(tree_slots(tree)):
        box[key] = fn(box[key], *(leaves[i] for leaves in others))
    return tree
