"""FL model facade and registry: the payload the NOMA uplink moves.

The port of ``repro/models/fl_models.py``.  An FL model offers
``init(seed, device)``, ``batch_loss(params, bx, by, valid)``,
``accuracy(params, x, y)`` and ``kind`` (``"image"``: flat (N, D) float
features and (N,) labels; ``"tokens"``: (N, S) int32 token rows and (N, S)
next-token labels, :func:`repro_torch.data.tokens.make_token_dataset`).
The batched engine calls ``batch_loss`` with a leading client axis on the
parameters and the batch, and gets one loss per client back.

Names, as the reference resolves them (:func:`get_fl_model`):

  * ``"lenet"``               — the paper's LeNet-300-100 (image kind);
  * ``"tiny-transformer"``    — 2-layer d=32 dense transformer (tests);
  * ``"tiny-transformer-1m"`` — a >= 10^6-parameter dense transformer;
  * ``"<arch_id>"`` / ``"<arch_id>:smoke"`` — any
    :mod:`repro_torch.configs` id, its CONFIG or SMOKE variant.

Token models wrap a :mod:`repro_torch.models.registry` family with the
masked next-token cross-entropy, over the reference's four token
families (dense, moe, ssm, hybrid); vlm / encdec raise the reference's
``ValueError`` (their forwards need modality features the client bank
does not carry).  ``batch_loss`` and ``accuracy`` unpack two values from
the family's forward, as the reference's adapter does, so a moe payload
(whose forward returns three) raises the reference's ``ValueError`` at its
first loss: the reference accepts such a configuration and fails there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.core import prng
from repro_torch.models import layers as L
from repro_torch.models import lenet
from repro_torch.models.params import init_lenet, init_params


@dataclasses.dataclass(frozen=True)
class LenetFLModel:
    """The paper's own model, with the reference's masked loss.

    ``batch_loss`` is the reference's op sequence (forward -> logsumexp ->
    gold logit -> valid-masked mean over max(sum(valid), 1)), per client:
    bx (K, B, 784), by (K, B) with -1 on padding, valid (K, B) float32.
    Returns the (K,) per-client losses; an all-padding batch gives a loss of
    exactly zero with an exactly-zero gradient.
    """

    name: str = "lenet"
    kind: str = "image"

    def init(self, seed: int, *, device=None):
        """Fresh parameters on ``device`` (``None`` means ``cuda``)."""
        return init_lenet(seed, device=device)

    def batch_loss(self, params, bx, by, valid):
        logits = lenet.forward(params, bx)
        logz = torch.logsumexp(logits, dim=-1)
        # padding labels are -1: gather index 0 there, the valid mask zeroes it
        idx = torch.clamp_min(by, 0).to(torch.int64).unsqueeze(-1)
        gold = torch.gather(logits, -1, idx).squeeze(-1)
        per = (logz - gold) * valid
        return per.sum(-1) / torch.clamp_min(valid.sum(-1), 1.0)

    def accuracy(self, params, x, y):
        return lenet.accuracy(params, x, y)


# Families whose forward needs no extra modality input: the FL uplink path
# trains language-model-shaped payloads; vlm / encdec need per-batch image
# or encoder features the client bank does not carry.
_TOKEN_FAMILIES = ("dense", "moe", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class TokenFLModel:
    """Next-token-prediction adapter over a registry family module.

    Shards are (n, S) int32 token rows with (n, S) shifted labels; the bank
    pads with label -1, which :func:`repro_torch.models.layers.
    cross_entropy` masks, so an all-padding batch contributes an
    exactly-zero gradient, the convention the image path keeps through
    ``valid``.
    """

    cfg: ModelConfig
    name: str
    kind: str = "tokens"

    def __post_init__(self):
        if self.cfg.family not in _TOKEN_FAMILIES:
            raise ValueError(
                f"FL token models support families {_TOKEN_FAMILIES}, got "
                f"{self.cfg.family!r} ({self.cfg.name}): vlm/encdec forwards "
                f"need modality features the client bank does not carry"
            )

    def _module(self):
        from repro_torch.models.registry import family_module

        return family_module(self.cfg.family)

    def schema(self):
        # shards=1: FL clients hold (and upload) the whole replica
        return self._module().schema(self.cfg, shards=1)

    def init(self, seed: int, *, device=None):
        """The reference's ``init(PRNGKey(seed))`` on ``device`` (``None``
        means ``cuda``)."""
        return init_params(self.schema(), prng.prng_key(seed), device=device)

    def _loss(self, params, bx, by):
        logits, _ = self._module().forward(params, bx, self.cfg)
        return L.cross_entropy(logits, by, vocab_size=self.cfg.vocab_size)

    def batch_loss(self, params, bx, by, valid):
        """(K,) losses of K clients: params with a leading client axis, bx
        and by (K, B, S).  Each client is its own forward on its own
        weights (``torch.func.vmap`` over the client axis), never one
        product over shared weights."""
        del valid  # cross_entropy masks by < 0 itself (the same mask)
        return torch.func.vmap(self._loss)(params, bx, by)

    def accuracy(self, params, x, y):
        """Next-token top-1 accuracy over non-padding positions."""
        logits, _ = self._module().forward(params, x, self.cfg)
        pred = torch.argmax(logits[..., : self.cfg.vocab_size], dim=-1)
        mask = (y >= 0).to(torch.float32)
        hit = (pred == torch.clamp_min(y, 0)).to(torch.float32) * mask
        return torch.sum(hit) / torch.clamp_min(torch.sum(mask), 1.0)


TINY_TRANSFORMER = ModelConfig(
    name="fl-tiny-transformer", family="dense",
    num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
    d_ff=64, vocab_size=64, head_dim=16, tie_embeddings=True,
    source="FL engine x model equality grid (tests)",
)

TINY_TRANSFORMER_1M = ModelConfig(
    name="fl-tiny-transformer-1m", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=16_384, head_dim=16, tie_embeddings=True,
    source="transformer-class (>=1e6 param) FL payload pin",
)


_REGISTRY: dict = {}


def register_fl_model(name: str, factory: Callable[[], object]) -> None:
    """Register a named FL model factory (re-registration replaces)."""
    _REGISTRY[name] = factory


register_fl_model("lenet", LenetFLModel)
register_fl_model(
    "tiny-transformer",
    lambda: TokenFLModel(cfg=TINY_TRANSFORMER, name="tiny-transformer"),
)
register_fl_model(
    "tiny-transformer-1m",
    lambda: TokenFLModel(cfg=TINY_TRANSFORMER_1M, name="tiny-transformer-1m"),
)


def available_fl_models() -> tuple:
    """Registered names (the :mod:`repro_torch.configs` arch-id fallback is
    open)."""
    return tuple(sorted(_REGISTRY))


@functools.lru_cache(maxsize=None)
def get_fl_model(name: str):
    """Resolve ``FLConfig.model`` to an FL model.

    Registered names win; otherwise ``name`` (or ``name:smoke``) resolves
    through the :mod:`repro_torch.configs` architecture registry.  Raises
    ``ValueError`` on unknown names and variants and on the vlm / encdec
    ids, as the reference does.
    """
    if name in _REGISTRY:
        return _REGISTRY[name]()
    base, _, variant = name.partition(":")
    if variant not in ("", "smoke"):
        raise ValueError(
            f"unknown FL model variant {variant!r} in {name!r}; "
            f"use '<arch_id>' or '<arch_id>:smoke'"
        )
    try:
        from repro_torch.configs import get_config, get_smoke

        cfg = get_smoke(base) if variant == "smoke" else get_config(base)
    except ImportError:
        raise ValueError(
            f"unknown FL model {name!r}; registered: "
            f"{available_fl_models()}, plus any repro_torch.configs arch id "
            f"('<arch_id>' or '<arch_id>:smoke')"
        ) from None
    return TokenFLModel(cfg=cfg, name=name)

