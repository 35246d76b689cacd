"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
With no CUDA and no explicit CPU request they raise: a run that asked for
the card never carries on quietly on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core import errors

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (``None`` means ``cuda``).

    Also pins float32 to full precision on the card: TF32 keeps about three
    decimal digits, so matmuls and convolutions must not use it where the
    reference computes in float32.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(errors.ERR_NO_CUDA.format(device=str(dev)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(errors.ERR_BAD_DEVICE.format(device=str(dev)))
    return dev
