"""FL settings (paper §IV, Table I): the port's ``FLConfig``.

The same field names and defaults as ``repro.config.FLConfig``, validated
at construction with the reference's rules, so ``FLConfig()`` is the
reference's default run (the legacy round body).  Settings the reference
accepts but the port does not run yet (online policies, ``horizon="scan"``
and the non-LeNet models) raise ``NotImplementedError`` naming the
``ROADMAP.md`` queue 1 item that brings them, so a run is never quietly a
different simulation.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import errors
from repro_torch.core import ota as ota_lib
from repro_torch.core import power as power_lib
from repro_torch.core import scheduling
from repro_torch.core.fl_engine import ENGINES, HORIZON_MODES


def _not_ported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        errors.ERR_NOT_PORTED.format(feature=feature, item=item)
    )


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Paper §IV system settings (Table I + text)."""

    num_devices: int = 300           # M
    group_size: int = 3              # K
    num_rounds: int = 35             # T
    learning_rate: float = 0.01      # eta
    batch_size: int = 10             # B
    local_epochs: int = 1
    scheduler: str = "lazy-gwmin"    # lazy-gwmin | literal-gwmin | random |
                                     # round-robin | proportional-fair
                                     # (ported); update-aware | age-fair |
                                     # matching-pursuit (online, item 5)
    scheduler_backend: str = "numpy"  # numpy (host) | jax (device, fused) |
                                      # jax-stepwise (device, sync per step)
    power_mode: str = "mapel"        # mapel | max | ota-align (ported)
    compression: str = "adaptive"    # adaptive | none
    paper_exact_range: bool = False  # DoReFa fixed [-1,1] range (Eq. 7)
    fl_engine: str = "legacy"        # legacy (per-device round body, the
                                     # oracle) | batched (client bank, one
                                     # aggregation launch per round); both
                                     # ported
    use_pallas: bool = False         # aggregate through the hand-written
                                     # kernel (the reference's name for its
                                     # fused Pallas path): the batched
                                     # engine's rounds, and the OTA rounds
                                     # of both engines
    horizon: str = "per-round"       # per-round (ported) | scan
    eval_sample: float = 1.0         # fraction of the test set evaluated per
                                     # round; 1.0 = full test set
    model: str = "lenet"             # lenet (ported)
    topk: float = 1.0                # kept fraction; 1.0 = dense, < 1 runs
                                     # top-k before DoReFa (both ported)
    client_bank: str = "padded"      # padded | bucketed (ported)
    uplink: str = "noma"             # noma | tdma | ota (ported)
    ota_noise: float = 0.0
    ota_threshold: float = 0.0
    seed: int = 0

    def __post_init__(self):
        """Fail at construction, not deep inside the simulation."""
        if self.num_rounds < 1:
            raise ValueError(f"num_rounds must be >= 1, got {self.num_rounds}")
        if not 1 <= self.group_size <= self.num_devices:
            raise ValueError(
                f"group_size must be in [1, num_devices={self.num_devices}], "
                f"got {self.group_size}"
            )
        if self.scheduler not in scheduling.REFERENCE_POLICIES:
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; registered: "
                f"{scheduling.REFERENCE_POLICIES}"
            )
        if self.power_mode not in power_lib.POWER_MODES:
            raise ValueError(
                f"unknown power_mode {self.power_mode!r}; known: "
                f"{power_lib.POWER_MODES}"
            )
        if self.scheduler_backend not in scheduling.SCHEDULER_BACKENDS:
            raise ValueError(
                f"unknown scheduler_backend {self.scheduler_backend!r}; "
                f"known: {scheduling.SCHEDULER_BACKENDS}"
            )
        if self.fl_engine not in ENGINES:
            raise ValueError(
                f"unknown fl_engine {self.fl_engine!r}; known: {ENGINES}"
            )
        if self.horizon not in HORIZON_MODES:
            raise ValueError(
                f"unknown horizon {self.horizon!r}; known: {HORIZON_MODES}"
            )
        if not 0.0 < self.eval_sample <= 1.0:
            raise ValueError(
                f"eval_sample must be in (0, 1], got {self.eval_sample}"
            )
        if (
            self.eval_sample < 1.0
            and self.fl_engine == "legacy"
            and self.horizon == "per-round"
        ):
            raise ValueError(
                "eval_sample < 1 requires fl_engine='batched' or "
                "horizon='scan' (the legacy loop always evaluates the full "
                "test set)"
            )
        if not 0.0 < self.topk <= 1.0:
            raise ValueError(f"topk must be in (0, 1], got {self.topk}")
        if (
            self.topk < 1.0
            and self.fl_engine == "legacy"
            and self.horizon == "per-round"
        ):
            raise ValueError(
                "topk < 1 requires fl_engine='batched' or horizon='scan' "
                "(the legacy oracle loop is dense DoReFa only)"
            )
        if self.topk < 1.0 and self.compression != "adaptive":
            raise ValueError(
                "topk < 1 requires compression='adaptive': the sparse "
                "(kept, bits) split is derived from the same per-client "
                "bit budgets that drive the adaptive DoReFa widths"
            )
        if self.client_bank not in ("padded", "bucketed"):
            raise ValueError(
                f"unknown client_bank {self.client_bank!r}; "
                f"known: ('padded', 'bucketed')"
            )
        if self.client_bank == "bucketed" and not (
            self.fl_engine == "batched" and self.horizon == "per-round"
        ):
            raise ValueError(
                "client_bank='bucketed' requires fl_engine='batched' with "
                "horizon='per-round': the scan horizon indexes one dense "
                "(M, NB, ...) bank inside the traced program"
            )
        ota_lib.check_uplink(
            self.uplink, compression=self.compression, topk=self.topk,
            power_mode=self.power_mode,
        )
        if self.ota_noise < 0.0:
            raise ValueError(
                f"ota_noise must be >= 0, got {self.ota_noise}"
            )
        if not 0.0 <= self.ota_threshold < 1.0:
            raise ValueError(
                f"ota_threshold must be in [0, 1), got {self.ota_threshold}"
            )
        self._check_ported()

    def _check_ported(self):
        """Valid settings that a later slice of the port brings."""
        if self.scheduler in scheduling.REFERENCE_ONLINE_POLICIES:
            raise _not_ported(f"online scheduler {self.scheduler!r}", 5)
        if self.horizon == "scan":
            raise _not_ported("horizon='scan'", 4)
        if self.model != "lenet":
            raise _not_ported(f"model={self.model!r}", 8)
