"""Parameter conversion between the JAX package's trees and the port's.

Both packages hold LeNet as a nested dict ``{"fc1": {"w": (in, out),
"b": (out,)}, ...}``.  The reference's leaves are JAX arrays; the tests hand
them over as numpy arrays (``np.asarray`` of each leaf), and this module
moves them into torch tensors on a device and back, so that both packages
compute from identical weights.  :func:`encoded_tree_from_jax` does the
same for a packed payload of ``repro.core.compression.encode_tree``, so a
tree encoded by the JAX package decodes in the port.  Nothing here imports
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compression, tree as tree_lib
from repro_torch.device import resolve_device


def params_from_jax(tree, *, device=None):
    """Nested dict of array-likes (e.g. numpy leaves of a JAX parameter
    tree) -> the port's nested dict of float32 tensors on ``device``
    (``None`` means ``cuda``, which raises without CUDA: pass ``"cpu"``)."""
    return _params_to_torch(tree, resolve_device(device))


def _params_to_torch(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _params_to_torch(v, device) for k, v in tree.items()}
    arr = np.array(tree, dtype=np.float32, copy=True)
    return torch.from_numpy(arr).to(device)


def params_to_jax(params):
    """The port's parameters -> nested dict of float32 numpy leaves, which
    ``jax.numpy.asarray`` (or ``jax.tree_util.tree_map``) takes as is."""
    if isinstance(params, dict):
        return {k: params_to_jax(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()


def encoded_tree_from_jax(enc, structure, *, device=None):
    """The reference's ``EncodedTree`` -> the port's
    :class:`~repro_torch.core.compression.EncodedTree` on ``device``.

    ``enc`` carries ``codes`` and ``scales`` (one array-like per leaf, in
    the reference's leaf order), ``bits``, ``shapes`` and ``total_bits``;
    its JAX tree definition is not read.  ``structure`` is any nested dict
    with the encoded tree's keys (the tree itself will do): the port's
    leaf order is the same sorted-key order, so the codes line up."""
    dev = resolve_device(device)
    leaves, treedef = tree_lib.tree_flatten(structure)
    if len(leaves) != len(enc.codes):
        raise ValueError(
            f"structure has {len(leaves)} leaves, the encoding "
            f"{len(enc.codes)}"
        )
    codes = [torch.from_numpy(np.array(c, dtype=np.int32, copy=True)).to(dev)
             for c in enc.codes]
    scales = [torch.from_numpy(np.array(s, dtype=np.float32, copy=True)
                               .reshape(())).to(dev) for s in enc.scales]
    return compression.EncodedTree(
        codes=codes, scales=scales, bits=int(enc.bits), treedef=treedef,
        shapes=[tuple(int(d) for d in shape) for shape in enc.shapes],
        total_bits=int(enc.total_bits),
    )
