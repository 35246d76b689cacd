"""FL model facade: the payload the NOMA uplink moves.

An FL model offers ``init(seed, device)``, ``batch_loss(params, bx, by,
valid)`` and ``accuracy(params, x, y)``.  The batched engine calls
``batch_loss`` with a leading client axis on the parameters and the batch,
and gets one loss per client back.  Only the paper's LeNet-300-100 is
ported; the reference's token models come with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import errors
from repro_torch.models import lenet
from repro_torch.models.params import init_lenet


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


def get_fl_model(name: str):
    """Resolve ``FLConfig.model``; only ``"lenet"`` is ported."""
    if name == "lenet":
        return LenetFLModel()
    # the reference's tiny transformers and its architecture ids both come
    # with the LLM substrate and the token payloads
    raise NotImplementedError(
        errors.ERR_NOT_PORTED.format(feature=f"model={name!r}", item=8)
    )
