"""Parameter initialization: the reference's draws, from the reference's
keys.

``repro/models/params.py:init_params`` over LeNet's schema: each leaf gets
the key ``fold_in(key, crc32(keystr(path)) % 2^31)``, where ``keystr`` is
JAX's path string (``"['fc1']['w']"``); weights are a truncated normal on
[-3, 3] times the fan-in standard deviation ``1 / sqrt(fan_in)`` (float32),
biases are zero.  The draws are :mod:`repro_torch.core.prng`'s, which equal
``jax.random``'s bit for bit, so ``init_lenet(seed)`` returns the
reference's ``LenetFLModel().init(PRNGKey(seed))``.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import lenet


def leaf_key(key, path: str) -> np.ndarray:
    """The key of the leaf at JAX path string ``path`` (e.g.
    ``"['fc1']['w']"``): ``fold_in(key, crc32(path) % 2^31)``."""
    return prng.fold_in(key, zlib.crc32(path.encode()) % (2 ** 31))


def init_lenet(seed: int, *, device=None):
    """Fresh LeNet parameters (nested dict of float32 tensors) drawn on
    ``device`` from ``PRNGKey(seed)`` (``None`` means ``cuda``, which raises
    without CUDA: pass ``"cpu"``); the same bits on either."""
    device = resolve_device(device)
    key = prng.prng_key(seed)
    params = {}
    for name, fan_in, fan_out in lenet.LAYERS:
        std = np.float32(1.0 / np.sqrt(fan_in))
        w = prng.truncated_normal(leaf_key(key, f"['{name}']['w']"), -3, 3,
                                  fan_in * fan_out, device=device)
        params[name] = {
            "w": (w * float(std)).reshape(fan_in, fan_out),
            "b": torch.zeros(fan_out, dtype=torch.float32, device=device),
        }
    return params
