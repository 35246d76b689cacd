"""Federated learning runtime (paper Algorithm 1 + §IV simulation).

FedAvg over the simulated NOMA cell, per round t:
    1. PS broadcasts theta^t (downlink timing model, no compression).
    2. The precomputed schedule assigns K devices to round t (the MWIS
       schedule over the whole horizon, or a §IV baseline, planned before
       training).
    3. Each scheduled device runs local SGD on its own non-iid shard.
    4. The SIC uplink rate of each device over the shared slot sets its bit
       budget c_k = R_k * B * t; its delta is DoReFa-quantized to
       b_k = floor(32 / r_k) bits (paper §II-B).
    5. PS aggregates: theta^{t+1} = theta^t + sum_k w_k * dq(delta_k),
       w_k = |D_k| / sum_selected |D_k|.
  Timing: NOMA round = t_slot + T_d (§IV); an empty round costs T_d only.
  TDMA (the paper's Fig. 5 baseline): each scheduled device sends alone in
  its own sub-slot at its interference-free rate; a round costs one
  sub-slot per scheduled device + T_d.  OTA (over-the-air analog
  aggregation): the raw deltas are superposed on air and the noisy sum is
  the aggregate (:mod:`repro_torch.core.ota`); one shared slot, as NOMA.

The port of ``repro.core.fl``'s per-round loop.  The host control plane
(channels, schedule, MAPEL powers, rates, budgets, timing) is float64
numpy; steps 3-5 run on the run's device in one of the reference's two
round-body engines, selected by ``FLConfig.fl_engine``:

  * ``"legacy"`` (the default) — :func:`_legacy_round`: one
    :func:`local_update` per scheduled device (its shard copied to the
    device, then ``fl_engine.sgd_epoch`` with a client axis of 1), the
    eager DoReFa codec per device, and the FedAvg sum as separate float32
    products and sums in client order, as the reference's host
    ``tree_map`` takes them; under OTA the deltas are stacked and
    superposed (:func:`repro_torch.core.ota.superpose_tree`).  It is the
    reference's oracle, and the batched engine is held against it.
  * ``"batched"`` — :class:`repro_torch.core.fl_engine.BatchedRoundEngine`:
    every shard resident in a client bank, the K clients trained at once
    and the round's aggregation in one kernel launch (``use_pallas``).

With ``scheduler_backend="jax"`` or ``"jax-stepwise"`` the schedule's
greedy search runs on the run's device too (float64, the same schedule).
Without ``channels=`` and ``init_params=`` the run draws what the reference
draws from ``PRNGKey(seed)``: positions under ``fold_in(key, 1)``, fading
under ``fold_in(key, 2)`` and the initial weights under the per-leaf keys
of ``init_params`` (:mod:`repro_torch.core.prng`, bit for bit), so seed s
is the reference's seed s.  ``channels=`` and ``init_params=`` replace
those draws with given ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import channel as chan
from repro_torch.core import compression, fl_engine, noma, scheduling
from repro_torch.core import ota as ota_lib
from repro_torch.core import quantization as qlib
from repro_torch.core import tree as tree_lib
from repro_torch.device import resolve_device
from repro_torch.models.fl_models import get_fl_model


@dataclasses.dataclass
class RoundLog:
    round: int
    devices: tuple
    rates: np.ndarray            # spectral efficiency per scheduled device
    bits: np.ndarray             # quantization bit-widths used
    compression_ratios: np.ndarray
    test_accuracy: float
    wall_time_s: float           # cumulative simulated communication time


@dataclasses.dataclass
class FLResult:
    logs: list
    final_params: dict           # nested dict of tensors on the run's device
    scheme: str

    def accuracies(self):
        return np.array([l.test_accuracy for l in self.logs])

    def times(self):
        return np.array([l.wall_time_s for l in self.logs])


# --------------------------------------------------------------------------
# Local training and the legacy round body (the oracle)
# --------------------------------------------------------------------------

def local_update(params, xs, ys, cfg: FLConfig, model):
    """Run local epochs on one device's shard; returns the delta (new - old).

    The shard (numpy rows ``xs`` and labels ``ys``) is padded to
    ``ceil(n / batch_size)`` batches with label -1, copied to the
    parameters' device and trained by ``fl_engine.sgd_epoch`` with a client
    axis of 1.
    """
    n = len(xs)
    bs = cfg.batch_size
    n_batches = max(1, (n + bs - 1) // bs)
    pad = n_batches * bs - n
    xp = np.concatenate([xs, np.zeros((pad, *xs.shape[1:]), xs.dtype)])
    yp = np.concatenate([ys, np.full((pad, *ys.shape[1:]), -1, ys.dtype)])
    dev = tree_lib.tree_flatten(params)[0][0].device
    xb = torch.from_numpy(xp.reshape(1, n_batches, bs, *xs.shape[1:])).to(dev)
    yb = torch.from_numpy(yp.reshape(1, n_batches, bs, *ys.shape[1:])).to(dev)
    start = tree_lib.tree_map(lambda w: w.unsqueeze(0), params)
    new = start
    for _ in range(cfg.local_epochs):
        new = fl_engine.sgd_epoch(new, xb, yb, cfg.learning_rate, model=model)
    return tree_lib.tree_map(lambda a, b: (a - b)[0], new, start)


def _tree_l2(tree) -> float:
    """||tree||_2 over all leaves in float32 (the update-aware policies'
    norm signal); one host sync."""
    leaves = tree_lib.tree_flatten(tree)[0]
    return float(torch.sqrt(sum(
        torch.dot(leaf.reshape(-1), leaf.reshape(-1)) for leaf in leaves
    )))


def _legacy_round(
    params, devs, budgets, agg_w, dataset, shards, cfg: FLConfig, payload,
    *, need_norms: bool, model, ota=None,
):
    """The per-device host round body (steps 3-5), kept as the oracle.

    One :func:`local_update` + eager quantize pass per scheduled device,
    then the FedAvg sum ``sum(w * d)`` over the devices in order, each
    ``w`` the float32 rounding of the float64 weight and each product and
    sum its own float32 op (no fused multiply-add), from ``0``, and ``p +
    u``: the reference's host ``tree_map`` to the bit for the same deltas.
    Under the OTA uplink (``ota``: gains, key, pmax) the raw deltas are
    stacked client-major and superposed by
    :func:`repro_torch.core.ota.superpose_tree`, which under ``use_pallas``
    launches the keyed OTA kernel once.  Returns ``(params, bits_used,
    ratios, norms)``; an empty round (T*K > M tails) trains and aggregates
    nothing.
    """
    deltas, bits_used, ratios, norms = [], [], [], []
    for j, d in enumerate(devs):
        idx = shards[d]
        delta = local_update(
            params, dataset.x_train[idx], dataset.y_train[idx], cfg, model
        )
        if need_norms:
            # the raw local update, before quantization
            norms.append(_tree_l2(delta))
        if cfg.compression == "adaptive":
            # the host budget rounded to float32: the reference computes
            # the ratio and the bits in float32 from it
            budget = torch.tensor(float(budgets[j]), dtype=torch.float32)
            b = int(qlib.adaptive_bits(payload, budget))
            delta = compression.encode_decode_tree(
                delta, b, paper_exact=cfg.paper_exact_range
            )
            bits_used.append(b)
            ratios.append(float(qlib.compression_ratio(payload, budget)))
        else:
            bits_used.append(32)
            ratios.append(1.0)
        deltas.append(delta)

    if deltas and ota is not None:
        dev = tree_lib.tree_flatten(params)[0][0].device
        stacked = tree_lib.tree_map(lambda *ds: torch.stack(ds), *deltas)

        def f32(values):
            host = torch.as_tensor(np.asarray(values, np.float64))
            return fl_engine._to_device(host.to(torch.float32), dev)

        with torch.no_grad():
            update = ota_lib.superpose_tree(
                stacked, f32(ota["gains"]), f32(agg_w), ota["key"],
                pmax=float(ota["pmax"]), noise_std=float(cfg.ota_noise),
                threshold=float(cfg.ota_threshold),
                use_pallas=bool(cfg.use_pallas),
            )
        params = tree_lib.tree_map(lambda p, u: p + u, params, update)
    elif deltas:
        # float32 values of the float64 weights, as Python floats: each
        # product is one correctly rounded float32 multiply
        w32 = [float(np.float32(w)) for w in agg_w]
        update = tree_lib.tree_map(
            lambda *ds: sum(w * d for w, d in zip(w32, ds)), *deltas
        )
        params = tree_lib.tree_map(lambda p, u: p + u, params, update)
    return params, bits_used, ratios, norms


# --------------------------------------------------------------------------
# Scheduling front-end
# --------------------------------------------------------------------------

def policy_config(
    cell: chan.CellConfig, cfg: FLConfig, device=None
) -> scheduling.PolicyConfig:
    """PolicyConfig from the FL settings + the cell physics; ``device`` is
    where a device scheduler backend runs (``None`` means ``cuda``)."""
    return scheduling.PolicyConfig(
        group_size=cfg.group_size,
        power_mode=cfg.power_mode,
        pmax=cell.max_power_w,
        noise_power=cell.noise_power_w,
        backend=cfg.scheduler_backend,
        device=device,
        seed=cfg.seed,
    )


def make_schedule(
    gains_tm: np.ndarray,
    weights_m: np.ndarray,
    cell: chan.CellConfig,
    cfg: FLConfig,
    policy=None,
    device=None,
) -> scheduling.Schedule:
    """One-shot schedule via the policy registry."""
    if policy is None:
        policy = scheduling.get_policy(cfg.scheduler)
    return scheduling.build_schedule(
        policy, gains_tm, weights_m, policy_config(cell, cfg, device)
    )


def _round_physics(devs, powers_t, rates, t, gains, cell, uplink, dl_time):
    """Uplink rates, bit budgets and wall time of one scheduled round.

    The single owner of the §IV timing and budget rules.  Returns
    ``(rates, budgets, round_time)``; under NOMA and OTA ``rates`` /
    ``budgets`` are (len(devs),) float64, under TDMA float32 (the
    reference's jnp rates)."""
    if uplink == "tdma":
        # each device alone in its own full sub-slot, interference-free
        rates = noma.tdma_rates(powers_t, gains[t, list(devs)],
                                cell.noise_power_w)
        budgets = rates * cell.bandwidth_hz * cell.slot_seconds
        # airtime = one sub-slot per *scheduled* device (an empty or partial
        # T*K > M tail round is not charged K sub-slots)
        return rates, budgets, len(devs) * cell.slot_seconds + dl_time
    # noma and ota share one uplink slot per non-empty round (the analog
    # superposition is a simultaneous transmission); OTA logs the SIC rates
    # as the digital-equivalent capacity of that slot, which nothing
    # quantizes to (compression='none' is enforced)
    rates = np.asarray(rates)
    budgets = rates * cell.bandwidth_hz * cell.slot_seconds
    uplink_time = cell.slot_seconds if devs else 0.0
    return rates, budgets, uplink_time + dl_time


def _agg_weights(sizes, devs) -> np.ndarray:
    """FedAvg weights w_k = |D_k| / sum_selected |D_k| (host float64)."""
    raw_w = [sizes[d] for d in devs]
    return np.asarray(raw_w) / max(sum(raw_w), 1.0)


def _param_count(params) -> int:
    return sum(int(leaf.numel()) for layer in params.values()
               for leaf in layer.values())


# --------------------------------------------------------------------------
# Main simulation
# --------------------------------------------------------------------------

def run_federated_learning(
    dataset,
    shards: list,
    cell: chan.CellConfig,
    cfg: FLConfig,
    *,
    uplink: Optional[str] = None,
    schedule: Optional[scheduling.Schedule] = None,
    eval_every: int = 1,
    progress: Optional[Callable[[RoundLog], None]] = None,
    channels: Optional[chan.ChannelBundle] = None,
    init_params=None,
    device=None,
) -> FLResult:
    """Simulate the full FL process; returns per-round logs.

    dataset: ``repro_torch.data.Dataset``; shards: per-device index lists.
    ``cfg.fl_engine`` picks the round body: ``"legacy"`` trains, quantizes
    and sums device by device (:func:`_legacy_round`) and evaluates the
    full test set, copied to the device once, every evaluated round;
    ``"batched"`` runs each round in a
    :class:`~repro_torch.core.fl_engine.BatchedRoundEngine` over a client
    bank.  Both evaluate every ``eval_every`` rounds and the final round.
    ``uplink`` defaults to ``cfg.uplink`` and an explicit argument
    overrides it (checked against the config's combination rules either
    way).  Under ``"ota"`` the round's aggregate is the noisy analog
    superposition (:mod:`repro_torch.core.ota`) instead of the digital
    decode-and-average; under ``"tdma"`` every scheduled device sends alone
    in its own sub-slot.
    ``channels`` (a :class:`~repro_torch.core.channel.ChannelBundle`) and
    ``init_params`` (a nested dict of array-likes, e.g. the reference's
    initial weights as numpy) replace the draws from ``cfg.seed``.  ``device``
    defaults to ``cuda`` and raises when CUDA is absent; pass ``"cpu"`` to
    run on the CPU.
    """
    dev = resolve_device(device)
    uplink = cfg.uplink if uplink is None else uplink
    ota_lib.check_uplink(
        uplink, compression=cfg.compression, topk=cfg.topk,
        power_mode=cfg.power_mode,
    )
    model = get_fl_model(cfg.model)
    if init_params is None:
        params = model.init(cfg.seed, device=dev)
    else:
        params = params_from_jax(init_params, device=dev)
    payload = _param_count(params) * 32  # I: full-precision payload bits

    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    weights = sizes / sizes.sum()

    # None selects the legacy per-device round body (the oracle)
    engine = None
    if cfg.fl_engine == "batched":
        engine = fl_engine.BatchedRoundEngine(
            dataset, shards, cfg, payload, device=dev, model=model
        )
    else:
        # the legacy loop evaluates the full test set, on the device once
        x_test = torch.from_numpy(np.asarray(dataset.x_test)).to(dev)
        y_test = torch.from_numpy(np.asarray(dataset.y_test)).to(dev)

    if channels is None:
        channels = chan.sample_channels(cfg.seed, cell, cfg.num_rounds)
    gains = np.asarray(channels.gains)

    if schedule is None:
        schedule = make_schedule(gains, weights, cell, cfg, device=dev)
    else:
        schedule.validate(cell.num_devices, cfg.group_size)

    # Downlink broadcast time on the large-scale gain only (the paper's
    # Fig. 5 time scale implies a fading-free downlink)
    dl_time = float(chan.downlink_time_seconds(payload, channels.dl_gains, cell))

    # OTA receiver-noise keys for the whole horizon, on the host
    ota_keys = (
        ota_lib.horizon_keys(cfg.seed, cfg.num_rounds)
        if uplink == "ota" else None
    )

    logs = []
    t_wall = 0.0
    for t in range(cfg.num_rounds):
        devs = schedule.rounds[t]
        rates, budgets, round_time = _round_physics(
            devs, schedule.powers[t], schedule.rates[t], t, gains, cell,
            uplink, dl_time,
        )
        agg_w = _agg_weights(sizes, devs)
        ota_round = None
        if ota_keys is not None and devs:
            ota_round = dict(gains=gains[t, list(devs)], key=ota_keys[t],
                             pmax=float(cell.max_power_w))
        if engine is not None:
            params, bits_used, ratios = engine.run_round(
                params, devs, budgets, agg_w, ota=ota_round
            )
        else:
            # precomputed policies read no update norms
            params, bits_used, ratios, _ = _legacy_round(
                params, devs, budgets, agg_w, dataset, shards, cfg, payload,
                need_norms=False, model=model, ota=ota_round,
            )
        t_wall += round_time
        # the final round is always evaluated
        do_eval = t % eval_every == 0 or t == cfg.num_rounds - 1
        if not do_eval:
            acc = logs[-1].test_accuracy
        elif engine is not None:
            acc = engine.evaluate(params, t)
        else:
            acc = float(fl_engine._eval_full(params, x_test, y_test,
                                             model=model))
        log = RoundLog(t, tuple(devs), np.asarray(rates), np.asarray(bits_used),
                       np.asarray(ratios), acc, t_wall)
        logs.append(log)
        if progress:
            progress(log)

    scheme = f"{uplink}/{cfg.scheduler}/{cfg.power_mode}/{cfg.compression}"
    return FLResult(logs, params, scheme)
