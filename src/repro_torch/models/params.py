"""Parameter schemas and their initialization: the reference's draws, from
the reference's keys.

The port of ``repro/models/params.py``.  A model describes its parameters
as a nested dict of :class:`ParamSpec` (shape + logical axis names +
initializer); from that one schema come

  * :func:`init_params` — the float32 parameter tree on a device;
  * :func:`logical_specs` — the same tree of logical-axis tuples, which
    ``repro_torch.sharding.rules`` maps onto a mesh;
  * :func:`abstract_params` — shapes and dtypes only, no allocation.

Each leaf is drawn from the key ``fold_in(key, crc32(keystr(path)) %
2^31)``, where ``keystr`` is JAX's path string (``"['layers']['attn']
['wq']"``), which :func:`keystr` rebuilds from the dict keys.  The
default initializer is a truncated normal on [-3, 3] times ``1 /
sqrt(fan_in)`` with the reference's fan-in (every axis but the last, the
stacked layer axis and the head axis included); ``"embed"`` is a normal
times 0.02, ``"ssm_a"`` the log of a uniform on [1, 16).  The draws are
:mod:`repro_torch.core.prng`'s, which equal ``jax.random``'s bit for bit,
so ``init_params(schema, prng_key(seed))`` is the reference's
``init_params(schema, PRNGKey(seed))``, and ``init_lenet(seed)`` its
``LenetFLModel().init(PRNGKey(seed))``.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import lenet


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                     # logical names, len == len(shape)
    init: str = "normal"            # normal | zeros | ones | embed | ssm_a
    scale: Optional[float] = None   # stddev override for "normal"
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


@dataclasses.dataclass(frozen=True)
class AbstractParam:
    """A leaf's shape and dtype without its values (``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: np.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _map_specs(fn, schema):
    if isinstance(schema, dict):
        return {k: _map_specs(fn, v) for k, v in schema.items()}
    return fn(schema)


def _fan_in(shape) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])


def keystr(path) -> str:
    """JAX's ``keystr`` of a path of dict keys: ``"['a']['b']"``."""
    return "".join(f"[{key!r}]" for key in path)


def leaf_key(key, path: str) -> np.ndarray:
    """The key of the leaf at JAX path string ``path`` (e.g.
    ``"['fc1']['w']"``): ``fold_in(key, crc32(path) % 2^31)``."""
    return prng.fold_in(key, zlib.crc32(path.encode()) % (2 ** 31))


def _materialize(spec: ParamSpec, key, device) -> torch.Tensor:
    n = int(np.prod(spec.shape))
    dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "ssm_a":
        # Mamba2's A: -uniform(1, 16), stored as its log
        u = prng.uniform(key, n, 1.0, 16.0, device=device)
        return prng._log_f32(u).reshape(spec.shape).to(dtype)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 0.02
        x = prng.normal(key, n, device=device)
    else:
        # default: truncated normal with the fan-in scaling
        std = spec.scale if spec.scale is not None else 1.0 / np.sqrt(
            max(_fan_in(spec.shape), 1))
        x = prng.truncated_normal(key, -3, 3, n, device=device)
    # the standard deviation enters as a float32, as JAX's float32
    # product takes it
    return (x * float(np.float32(std))).reshape(spec.shape).to(dtype)


def init_params(schema, key, *, device=None):
    """Materialize a schema on ``device`` (``None`` means ``cuda``, which
    raises without CUDA: pass ``"cpu"``); each leaf drawn from its
    path-derived key (:func:`leaf_key`), the same bits on either device."""
    device = resolve_device(device)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        return _materialize(node, leaf_key(key, keystr(path)), device)

    return build(schema, ())


def logical_specs(schema):
    """The tree of logical-axis tuples matching the parameter tree."""
    return _map_specs(lambda s: s.axes, schema)


def abstract_params(schema):
    """The tree of :class:`AbstractParam` (shapes and dtypes, no
    allocation)."""
    return _map_specs(lambda s: AbstractParam(tuple(s.shape),
                                              np.dtype(s.dtype)), schema)


def stacked(schema, n: int):
    """Prepend a stacked layer axis of ``n`` to every spec of the subtree."""
    return _map_specs(lambda s: dataclasses.replace(
        s, shape=(n, *s.shape), axes=("layers", *s.axes)), schema)


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
