"""Parameter conversion between the JAX package's trees and the port's.

Both packages hold LeNet as a nested dict ``{"fc1": {"w": (in, out),
"b": (out,)}, ...}``.  The reference's leaves are JAX arrays; the tests hand
them over as numpy arrays (``np.asarray`` of each leaf), and this module
moves them into torch tensors on a device and back, so that both packages
compute from identical weights.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

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
