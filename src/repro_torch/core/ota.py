"""Uplink-combination rules shared by ``FLConfig`` and the FL runtime.

The port's copy of ``repro.core.ota.check_uplink``; the over-the-air
uplink itself comes with a later slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from repro_torch.core import errors

UPLINK_MODES = ("noma", "tdma", "ota")
# the reference's uplink modes; this slice of the port runs "noma"


def check_uplink(uplink: str, *, compression: str, topk: float,
                 power_mode: str) -> None:
    """Raise ValueError with the pinned messages on incoherent combos."""
    if uplink not in UPLINK_MODES:
        raise ValueError(
            errors.ERR_UNKNOWN_UPLINK.format(uplink=uplink, modes=UPLINK_MODES)
        )
    if uplink == "ota":
        if topk < 1.0:
            raise ValueError(errors.ERR_OTA_TOPK)
        if compression != "none":
            raise ValueError(errors.ERR_OTA_COMPRESSION)
        if power_mode == "mapel":
            raise ValueError(errors.ERR_OTA_MAPEL)
    elif power_mode == "ota-align":
        raise ValueError(errors.ERR_OTA_ALIGN_UPLINK)
