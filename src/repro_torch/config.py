"""Configuration: model shapes and FL settings.

``ModelConfig`` is the port's copy of ``repro.config.ModelConfig``: the
same fields, and the same derived shapes (``padded_heads``,
``padded_kv_heads``, ``padded_vocab``, ``param_count``), which decide every
parameter's shape.  Each architecture provides a module in
:mod:`repro_torch.configs` with ``CONFIG`` (the published configuration)
and ``SMOKE`` (a reduced same-family variant for CPU tests).

``FLConfig`` has the same field names and defaults as
``repro.config.FLConfig``, validated at construction with the reference's
rules, so ``FLConfig()`` is the reference's default run (the legacy round
body).  ``FLConfig.model`` resolves through
:func:`repro_torch.models.fl_models.get_fl_model`, which raises the
reference's ``ValueError`` for unknown names and for the vlm / encdec
ids, as the reference does, so a run is never quietly a different
simulation."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import errors
from repro_torch.core import ota as ota_lib
from repro_torch.core import power as power_lib
from repro_torch.core import scheduling


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | mlp
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention variants
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2
    sliding_window: Optional[int] = None    # mixtral SWA
    attention_chunk: Optional[int] = None   # llama4 block-local
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False  # llama4 shared expert
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssm_bf16: bool = False
    # hybrid (zamba2): one shared attention block every N mamba blocks
    hybrid_attn_every: int = 6
    # enc-dec (seamless)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm: one cross-attention layer every N self-attention layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""                 # citation for the config

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def padded_heads(self, shards: int = 16) -> int:
        """Q heads padded up so the head axis shards (qwen2: 14 -> 16)."""
        return _round_up(self.num_heads, shards) if self.num_heads else 0

    def padded_kv_heads(self, shards: int = 16) -> int:
        """KV heads replicated up to the shard count when kv < shards."""
        if not self.num_kv_heads:
            return 0
        if self.num_kv_heads >= shards:
            return self.num_kv_heads
        assert shards % self.num_kv_heads == 0 or self.num_kv_heads % shards == 0
        return shards

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    def param_count(self) -> int:
        """Analytic parameter count (approximate for exotic families)."""
        d, v = self.d_model, self.padded_vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        if self.family in ("dense", "moe", "vlm", "encdec"):
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            if self.num_experts:
                ff = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
                if self.moe_shared_expert:
                    ff += 3 * d * self.d_ff
            else:
                ff = 3 * d * self.d_ff
            per_layer = attn + ff + 2 * d
        elif self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            per_layer = (
                d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state + nheads)
                + d_in * d
                + self.ssm_conv_width * (d_in + 2 * self.ssm_groups * self.ssm_state)
                + 2 * nheads + d_in + 2 * d
            )
        total = emb + self.num_layers * per_layer
        if self.family == "hybrid":
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
            total += attn + 3 * d * self.d_ff + 2 * d  # one shared block
        if self.family == "encdec":
            total += self.encoder_layers * (per_layer)
            total += self.num_layers * (d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d + d)
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            total += n_cross * (d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d + d)
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) params: differs from total only for MoE."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(self, num_experts=0, experts_per_token=0)
        base = dense_like.param_count()
        active_ff = self.experts_per_token * 3 * d * self.d_ff
        shared = 3 * d * self.d_ff if self.moe_shared_expert else 0
        # base already counts one dense FFN; replace it with active experts
        return int(base + self.num_layers * (active_ff + shared - 3 * d * self.d_ff))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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
                                     # round-robin | proportional-fair |
                                     # update-aware | age-fair |
                                     # matching-pursuit (online); all ported
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
    horizon: str = "per-round"       # per-round | scan (both ported; scan
                                     # runs the batched round body whatever
                                     # fl_engine says)
    eval_sample: float = 1.0         # fraction of the test set evaluated per
                                     # round; 1.0 = full test set
    model: str = "lenet"             # lenet | tiny-transformer |
                                     # tiny-transformer-1m | a dense, moe,
                                     # ssm or hybrid repro_torch.configs
                                     # arch id or "<id>:smoke" (ported; a
                                     # moe payload fails at its first loss
                                     # as the reference's does)
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
        if self.scheduler not in scheduling.available_policies():
            raise ValueError(
                f"unknown scheduler {self.scheduler!r}; registered: "
                f"{scheduling.available_policies()}"
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
        from repro_torch.core.fl_engine import ENGINES, HORIZON_MODES

        if self.fl_engine not in ENGINES:
            raise ValueError(
                f"unknown fl_engine {self.fl_engine!r}; known: {ENGINES}"
            )
        if self.horizon not in HORIZON_MODES:
            raise ValueError(
                f"unknown horizon {self.horizon!r}; known: {HORIZON_MODES}"
            )
        if self.horizon == "scan" and scheduling.policy_is_online(
                self.scheduler):
            # an online policy runs inside the scan iff it implements the
            # traced protocol; no quiet fallback to the per-round driver
            if not scheduling.policy_is_traced(self.scheduler):
                raise ValueError(errors.ERR_SCAN_ONLINE_POLICY.format(
                    scheduler=self.scheduler))
            if self.power_mode == "mapel":
                # the polyblock search is host-iterative
                raise ValueError(errors.ERR_SCAN_ONLINE_MAPEL.format(
                    scheduler=self.scheduler))
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
        from repro_torch.models import fl_models

        fl_models.get_fl_model(self.model)  # raises on unknown names
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
