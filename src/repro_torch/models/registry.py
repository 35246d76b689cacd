"""Model registry: one uniform :class:`Model` facade per architecture
family, the port of ``repro/models/registry.py``: the dense, moe, ssm,
hybrid, encdec and vlm families.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.config import ModelConfig
from repro_torch.models import encdec, hybrid, mamba2, moe, transformer, vlm
from repro_torch.models.params import (
    abstract_params, init_params, logical_specs,
)

_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "ssm": mamba2,
    "hybrid": hybrid,
    "encdec": encdec,
    "vlm": vlm,
}


def family_module(family: str):
    """The module of a family; ``KeyError`` for an unknown one."""
    if family not in _FAMILIES:
        raise KeyError(f"unknown family {family!r}")
    return _FAMILIES[family]


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

    def param_logical_specs(self):
        return logical_specs(self.schema)

    # ---- compute ----
    def loss(self, params, batch, **kw):
        return self.module.loss_fn(params, batch, self.cfg, **kw)

    def forward(self, params, batch, **kw):
        extra = _modal_kwargs(self.cfg, batch)
        return self.module.forward(params, batch["tokens"], self.cfg,
                                   **extra, **kw)

    def init_cache(self, batch: int, max_len: int, *, device=None):
        return self.module.init_cache(self.cfg, batch, max_len,
                                      shards=self.shards, device=device)

    def decode_step(self, params, caches, tokens, *, batch=None, **kw):
        """One decode step; ``batch`` carries the modality inputs of the
        encdec (``enc_out``) and vlm (``img_feats``) families."""
        extra = _modal_kwargs(self.cfg, batch or {}, decode=True)
        return self.module.decode_step(params, caches, tokens, self.cfg,
                                       **extra, **kw)


def _modal_kwargs(cfg, batch, *, decode: bool = False):
    """The modality inputs a family's forward takes from ``batch``: the
    vlm's ``img_feats``; the encdec's ``enc_feats``, or at decode its
    precomputed ``enc_out``."""
    out = {}
    if cfg.family == "vlm":
        out["img_feats"] = batch["img_feats"]
    if cfg.family == "encdec":
        if decode:
            out["enc_out"] = batch["enc_out"]
        else:
            out["enc_feats"] = batch["enc_feats"]
    return out


def build_model(cfg: ModelConfig, *, shards: int = 1) -> Model:
    module = family_module(cfg.family)
    return Model(cfg, module.schema(cfg, shards=shards), module, shards)
