"""Model registry: one uniform :class:`Model` facade per architecture
family, the port of ``repro/models/registry.py``.

The dense, moe, ssm and hybrid families are ported; the encdec and vlm
families raise ``NotImplementedError`` naming the ``ROADMAP.md`` queue 1
item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.config import ModelConfig
from repro_torch.core import errors
from repro_torch.models import hybrid, mamba2, moe, transformer
from repro_torch.models.params import (
    abstract_params, init_params,
)

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
}

# the families of the reference's registry that a later slice brings
UNPORTED_FAMILIES = ("encdec", "vlm")


def family_module(family: str):
    """The module of a ported family; ``NotImplementedError`` for a family
    of the reference's registry that is not ported yet, ``KeyError`` for
    an unknown one."""
    if family in _FAMILIES:
        return _FAMILIES[family]
    if family in UNPORTED_FAMILIES:
        raise NotImplementedError(errors.ERR_NOT_PORTED.format(
            feature=f"model family {family!r}", item=8))
    raise KeyError(f"unknown family {family!r}")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    schema: Any
    module: Any
    shards: int

    # ---- params ----
    def init(self, key, *, device=None):
        """Parameters drawn from ``key`` (a (2,) uint32 key of
        :func:`repro_torch.core.prng.prng_key`) on ``device``."""
        return init_params(self.schema, key, device=device)

    def abstract(self):
        return abstract_params(self.schema)

    # ---- compute ----
    def loss(self, params, batch, **kw):
        return self.module.loss_fn(params, batch, self.cfg, **kw)

    def forward(self, params, batch, **kw):
        return self.module.forward(params, batch["tokens"], self.cfg, **kw)

    def init_cache(self, batch: int, max_len: int, *, device=None):
        return self.module.init_cache(self.cfg, batch, max_len,
                                      shards=self.shards, device=device)

    def decode_step(self, params, caches, tokens, *, batch=None, **kw):
        """One decode step; ``batch`` carries the modality inputs of the
        encdec and vlm families (none for the ported ones)."""
        del batch
        return self.module.decode_step(params, caches, tokens, self.cfg, **kw)


def build_model(cfg: ModelConfig, *, shards: int = 1) -> Model:
    module = family_module(cfg.family)
    return Model(cfg, module.schema(cfg, shards=shards), module, shards)
