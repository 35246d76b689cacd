"""Federated learning runtime (paper Algorithm 1 + §IV simulation).

FedAvg over the simulated NOMA cell, per round t:
    1. PS broadcasts theta^t (downlink timing model, no compression).
    2. The scheduler assigns K devices to round t: a precomputed policy
       (the MWIS schedule over the whole horizon, or a §IV baseline) planned
       this before training; an online policy (update-aware, age-fair,
       matching-pursuit) selects here, inside the loop, from the update
       norms, participation and realized rates of the rounds before
       (``scheduling.Observation``), and the round is finalized (powers,
       SIC rates) as it is selected.
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

``FLConfig.horizon = "scan"`` runs the whole horizon from device tensors
instead (:func:`run_horizon_scanned`): for a precomputed schedule the host
plans every round up front, uploads the plan once, and reads the card once
at the end; an online policy with the traced protocol selects on the
device inside the horizon (``fl_engine._online_horizon_core``), and the
host replays the downloaded schedule through the per-round driver's own
calls for the float64 logs (:func:`_finalize_online_plan`).
:func:`run_horizon_vmapped` stacks a seed sweep into one such program and
:func:`run_cell_sweep` runs a (cells x seeds) grid of them.

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
from repro_torch.core import compression, errors, fl_engine, noma, scheduling
from repro_torch.core import ota as ota_lib
from repro_torch.core import power as power_lib
from repro_torch.core import quantization as qlib
from repro_torch.core import tree as tree_lib
from repro_torch.data.client_bank import ClientBank, EvalBank, eval_sample_plan
from repro_torch.device import resolve_device
from repro_torch.models.fl_models import get_fl_model
from repro_torch.sharding import cells as cells_lib
from repro_torch.utils.tree import tree_count


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
        ota_noise=cfg.ota_noise,
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


def _setup(shards, cell, cfg: FLConfig, *, schedule, channels, init_params,
           device, model):
    """What every driver computes before round 0: the initial parameters
    (drawn from ``cfg.seed`` or ``init_params``), the payload I in bits,
    the shard sizes, the (T, M) channel gains (drawn or ``channels``), the
    schedule (planned or ``schedule``, validated; ``None`` for an online
    policy, which selects round by round) and the downlink broadcast
    time.  Returns them in that order."""
    if init_params is None:
        params = model.init(cfg.seed, device=device)
    else:
        params = params_from_jax(init_params, device=device)
    payload = tree_count(params) * 32  # I: full-precision payload bits
    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    if channels is None:
        channels = chan.sample_channels(cfg.seed, cell, cfg.num_rounds)
    gains = np.asarray(channels.gains)
    if schedule is not None:
        schedule.validate(cell.num_devices, cfg.group_size)
    elif not scheduling.policy_is_online(cfg.scheduler):
        schedule = make_schedule(gains, sizes / sizes.sum(), cell, cfg,
                                 device=device)
    # Downlink broadcast time on the large-scale gain only (the paper's
    # Fig. 5 time scale implies a fading-free downlink)
    dl_time = float(chan.downlink_time_seconds(payload, channels.dl_gains,
                                               cell))
    return params, payload, sizes, gains, schedule, dl_time


# --------------------------------------------------------------------------
# Main simulation
# --------------------------------------------------------------------------

def _resolve_uplink(cfg: FLConfig, uplink) -> str:
    """``uplink``, or ``cfg.uplink`` where it is None, checked against the
    config's combination rules."""
    uplink = cfg.uplink if uplink is None else uplink
    ota_lib.check_uplink(
        uplink, compression=cfg.compression, topk=cfg.topk,
        power_mode=cfg.power_mode,
    )
    return uplink


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
    uplink = _resolve_uplink(cfg, uplink)
    if cfg.horizon == "scan":
        return run_horizon_scanned(
            dataset, shards, cell, cfg, uplink=uplink, schedule=schedule,
            eval_every=eval_every, progress=progress, channels=channels,
            init_params=init_params, device=dev,
        )
    model = get_fl_model(cfg.model)
    params, payload, sizes, gains, schedule, dl_time = _setup(
        shards, cell, cfg, schedule=schedule, channels=channels,
        init_params=init_params, device=dev, model=model,
    )
    weights = sizes / sizes.sum()

    # an online policy selects inside the round loop, from the FL state of
    # the rounds before (live mode); a precomputed schedule is fixed
    policy = obs = policy_state = allocator = None
    if schedule is None:
        policy = scheduling.get_policy(cfg.scheduler)
        policy_state = policy.init_state(gains, weights,
                                         policy_config(cell, cfg, dev))
        obs = scheduling.Observation.initial(cell.num_devices)
        allocator = power_lib.make_power_allocator(
            cfg.power_mode, cell.max_power_w, cell.noise_power_w
        )
    need_norms = policy is not None and getattr(policy, "needs_norms", True)

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

    # OTA receiver-noise keys for the whole horizon, on the host
    ota_keys = (
        ota_lib.horizon_keys(cfg.seed, cfg.num_rounds)
        if uplink == "ota" else None
    )

    eval_mask = _eval_mask(cfg.num_rounds, eval_every)
    logs = []
    t_wall = 0.0
    for t in range(cfg.num_rounds):
        if policy is not None:
            group, policy_state = policy.select_round(t, policy_state, obs)
            devs = tuple(int(d) for d in group)
            scheduling.validate_group(
                devs, cell.num_devices, cfg.group_size,
                label=f"round-{t} group from policy {policy.name!r}",
            )
            powers_t, rates = scheduling.finalize_round(
                devs, t, gains, weights, allocator, cell.noise_power_w
            )
        else:
            devs = schedule.rounds[t]
            powers_t, rates = schedule.powers[t], schedule.rates[t]
        rates, budgets, round_time = _round_physics(
            devs, powers_t, rates, t, gains, cell, uplink, dl_time,
        )
        agg_w = _agg_weights(sizes, devs)
        ota_round = None
        if ota_keys is not None and devs:
            ota_round = dict(gains=gains[t, list(devs)], key=ota_keys[t],
                             pmax=float(cell.max_power_w))
        if engine is not None:
            params, bits_used, ratios, norms = engine.run_round(
                params, devs, budgets, agg_w, need_norms=need_norms,
                ota=ota_round,
            )
        else:
            params, bits_used, ratios, norms = _legacy_round(
                params, devs, budgets, agg_w, dataset, shards, cfg, payload,
                need_norms=need_norms, model=model, ota=ota_round,
            )
        if policy is not None:
            # the realized rates and (when the policy reads them) the raw
            # updates' norms, for the next round's selection
            obs = obs.record_round(t, devs, np.asarray(rates),
                                   norms if norms else None)
        t_wall += round_time
        if not eval_mask[t]:
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


# --------------------------------------------------------------------------
# Scanned horizons: every round of a precomputed schedule on the device
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _HorizonPlan:
    """The host plan of one simulation instance (one seed).

    Everything the per-round driver computes on the host (initial weights,
    channel draws, schedule, rates, budgets, FedAvg weights, timing),
    packed into fixed-shape (T, K) arrays, zero-padded past each round's
    true group size (a zero weight multiplies a padded row out of the
    aggregate exactly).
    """

    params0: dict                # initial weights, on the run's device
    payload: int                 # I: full-precision payload bits
    schedule: scheduling.Schedule
    dev_tk: np.ndarray           # (T, K) int64 device ids, 0-padded
    ksizes: np.ndarray           # (T,) true per-round group sizes
    budgets_tk: np.ndarray       # (T, K) float64 uplink bit budgets
    aggw_tk: np.ndarray          # (T, K) float64 FedAvg weights
    gains_tk: np.ndarray         # (T, K) float32 channel amplitudes (OTA)
    noise_keys: np.ndarray       # (T, 2) uint32 OTA receiver-noise keys
    rates: list                  # per-round (k,) uplink rates
    times: np.ndarray            # (T,) cumulative simulated wall clock
    eval_idx: Optional[np.ndarray]  # (T, n) eval plan; None = full set


def _horizon_setup(dataset, shards, cell, cfg: FLConfig, uplink, schedule,
                   *, device, channels=None, init_params=None) -> _HorizonPlan:
    """The host plan of one scanned instance, from the per-round driver's
    own setup (:func:`_setup`) and round rules (:func:`_round_physics`,
    :func:`_agg_weights`), so both drivers simulate the same system and
    log the same schedules, budgets, rates and times."""
    params, payload, sizes, gains, schedule, dl_time = _setup(
        shards, cell, cfg, schedule=schedule, channels=channels,
        init_params=init_params, device=device,
        model=get_fl_model(cfg.model),
    )
    if schedule is None:
        # traced online policies go to the online driver before this; an
        # online policy here lacks the traced protocol
        raise ValueError(
            errors.ERR_SCAN_ONLINE_POLICY.format(scheduler=cfg.scheduler))
    return _pack_plan(
        params, payload, schedule, gains, sizes, dl_time, cfg, cell, uplink,
        ota_lib.horizon_keys(cfg.seed, cfg.num_rounds),
        eval_sample_plan(len(dataset.y_test), cfg.eval_sample,
                         cfg.num_rounds, cfg.seed),
    )


def _pack_plan(params, payload, schedule, gains, sizes, dl_time,
               cfg: FLConfig, cell, uplink, noise_keys,
               eval_idx) -> _HorizonPlan:
    """A schedule's rounds through the per-round driver's round rules
    (:func:`_round_physics`, :func:`_agg_weights`), packed into the
    zero-padded (T, K) arrays of a :class:`_HorizonPlan`."""
    num_rounds, k_max = cfg.num_rounds, cfg.group_size
    dev_tk = np.zeros((num_rounds, k_max), np.int64)
    ksizes = np.zeros(num_rounds, np.intp)
    budgets_tk = np.zeros((num_rounds, k_max), np.float64)
    aggw_tk = np.zeros((num_rounds, k_max), np.float64)
    gains_tk = np.zeros((num_rounds, k_max), np.float32)
    rates_list = []
    times = np.zeros(num_rounds, np.float64)
    t_wall = 0.0
    for t in range(num_rounds):
        devs = schedule.rounds[t]
        rates, budgets, round_time = _round_physics(
            devs, schedule.powers[t], schedule.rates[t], t, gains, cell,
            uplink, dl_time,
        )
        k = len(devs)
        ksizes[t] = k
        dev_tk[t, :k] = devs
        budgets_tk[t, :k] = budgets
        aggw_tk[t, :k] = _agg_weights(sizes, devs)
        gains_tk[t, :k] = gains[t, list(devs)]
        rates_list.append(rates)
        t_wall += round_time
        times[t] = t_wall
    return _HorizonPlan(
        params, payload, schedule, dev_tk, ksizes, budgets_tk, aggw_tk,
        gains_tk, noise_keys, rates_list, times, eval_idx,
    )


def _horizon_statics(cfg: FLConfig, payload: int, cell, uplink) -> dict:
    """The keyword arguments of the fl_engine horizon functions; the OTA
    ones are zeros outside the OTA uplink."""
    ota = uplink == "ota"
    return dict(
        lr=float(cfg.learning_rate), epochs=int(cfg.local_epochs),
        payload=int(payload), compress=cfg.compression == "adaptive",
        paper_exact=bool(cfg.paper_exact_range),
        use_pallas=bool(cfg.use_pallas), model=get_fl_model(cfg.model),
        topk=float(cfg.topk), ota=ota,
        ota_noise=float(cfg.ota_noise) if ota else 0.0,
        ota_threshold=float(cfg.ota_threshold) if ota else 0.0,
        pmax=float(cell.max_power_w) if ota else 0.0,
    )


def _eval_mask(num_rounds: int, eval_every: int) -> np.ndarray:
    """(T,) bool: the rounds that evaluate, every ``eval_every``-th and
    the final one."""
    return np.array([t % eval_every == 0 or t == num_rounds - 1
                     for t in range(num_rounds)])


def _stack_plans(plans, bank, device):
    """The plans' arrays stacked on a leading run axis and put on
    ``device`` once, before the horizon: through pinned memory and queued
    on the stream on the card (a pageable copy would make the host wait).
    Budgets, weights and gains enter in float32, as the per-round engine
    takes them.  Returns ``(params_s, dev, bud, agg, gains, keys, eidx,
    nb)``: keys stay host numpy, ``eidx`` is ``None`` for the full test
    set, and ``nb`` is the sweep-wide batch count of the scheduled groups.
    """
    nb = max(bank.n_batches_for(g) for p in plans for g in p.schedule.rounds)
    return (
        fl_engine._stack_runs([p.params0 for p in plans]),
        _upload([p.dev_tk for p in plans], torch.int64, device),
        _upload([p.budgets_tk for p in plans], torch.float32, device),
        _upload([p.aggw_tk for p in plans], torch.float32, device),
        _upload([p.gains_tk for p in plans], torch.float32, device),
        np.stack([p.noise_keys for p in plans]), _upload_eval(plans, device),
        nb,
    )


def _upload(arrays, dtype, device):
    """Host arrays stacked on a leading axis, as ``dtype`` on ``device``
    (through pinned memory, queued on the stream, on the card)."""
    host = torch.from_numpy(np.stack(arrays)).to(dtype)
    return fl_engine._to_device(host, device)


def _upload_eval(plans, device):
    """The plans' (S, T, n) eval-row plans on ``device``, or ``None`` for
    the full test set."""
    if plans[0].eval_idx is None:
        return None
    return _upload([p.eval_idx for p in plans], torch.int64, device)


def _assemble_horizon_result(plan: _HorizonPlan, cfg: FLConfig, uplink,
                             eval_mask, bits_tk, kept_tk, accs_t,
                             final_params, progress=None) -> FLResult:
    """Per-round ``RoundLog`` entries from a horizon's downloaded log and
    its host plan: each round's (K,) row cut to its true group size, the
    compression ratios from the per-round engine's own rule
    (:func:`repro_torch.core.fl_engine._round_ratios`; ``kept_tk`` is
    ``None`` without top-k), skipped evaluations forward-filled.  The
    per-round driver's logs, entry for entry."""
    logs = []
    acc = None
    compress = cfg.compression == "adaptive"
    for t in range(cfg.num_rounds):
        k = int(plan.ksizes[t])
        bits = bits_tk[t, :k]
        ratios = fl_engine._round_ratios(
            plan.payload, compress, None if kept_tk is None else
            kept_tk[t, :k], bits,
            torch.from_numpy(plan.budgets_tk[t, :k]).to(torch.float32),
        )
        if eval_mask[t]:
            acc = float(accs_t[t])
        log = RoundLog(t, tuple(plan.schedule.rounds[t]),
                       np.asarray(plan.rates[t]), bits, ratios, acc,
                       float(plan.times[t]))
        logs.append(log)
        if progress:
            progress(log)
    scheme = f"{uplink}/{cfg.scheduler}/{cfg.power_mode}/{cfg.compression}"
    return FLResult(logs, final_params, scheme)


def _horizon_world(dataset, shards, cfg: FLConfig, device):
    """The client bank and the test set on the run's device."""
    bank = ClientBank.build(dataset.x_train, dataset.y_train, shards,
                            cfg.batch_size, device=device)
    return bank, EvalBank.build(dataset.x_test, dataset.y_test,
                                device=device)


def _run_plan(plan: _HorizonPlan, cfg: FLConfig, uplink, cell, eval_mask,
              bank, ebank, device, progress=None) -> FLResult:
    """One instance's scanned horizon from its host plan: the plan's one
    upload, the T rounds at its own batch count, the log's one download."""
    _, dev_tk, bud, agg, gains, keys, eidx, nb = _stack_plans([plan], bank,
                                                              device)
    final, log = fl_engine.run_horizon(
        plan.params0, dev_tk[0], bud[0], agg[0], gains[0], keys[0],
        eval_mask, None if eidx is None else eidx[0], bank, ebank, nb=nb,
        **_horizon_statics(cfg, plan.payload, cell, uplink),
    )
    bits, kept, accs = fl_engine.horizon_logs(log)
    return _assemble_horizon_result(plan, cfg, uplink, eval_mask, bits, kept,
                                    accs, final, progress)


def run_horizon_scanned(
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
    """One whole horizon with one read of the card (``cfg.horizon =
    "scan"``).

    All host work (draws, schedule, rates, budgets, weights, timing)
    happens up front in :func:`_horizon_setup`; the plan goes to the
    device in one upload; training, quantization, aggregation and
    evaluation for all T rounds then run from device tensors
    (:func:`repro_torch.core.fl_engine.run_horizon`), with kernel #1 in
    every dense round (all-padding tail rounds included) and the keyed
    OTA kernel in every OTA round; the log comes back in one download at
    the end.  The batched round body runs whatever ``cfg.fl_engine``
    says, as in the reference.  Same logs as the per-round driver:
    schedules, bits, rates, ratios and times equal, and accuracies and
    parameters too where every round is full.  ``channels``,
    ``init_params``, ``schedule`` and ``device`` act as in
    :func:`run_federated_learning`.
    """
    dev = resolve_device(device)
    uplink = _resolve_uplink(cfg, uplink)
    eval_mask = _eval_mask(cfg.num_rounds, eval_every)
    if schedule is None and _traced_online(cfg):
        plan = _online_horizon_setup(dataset, shards, cell, cfg, device=dev,
                                     channels=channels,
                                     init_params=init_params)
        bank, ebank = _horizon_world(dataset, shards, cfg, dev)
        return _run_online_plan(plan, cfg, uplink, cell, eval_mask, bank,
                                ebank, dev, progress)
    plan = _horizon_setup(dataset, shards, cell, cfg, uplink, schedule,
                          device=dev, channels=channels,
                          init_params=init_params)
    bank, ebank = _horizon_world(dataset, shards, cfg, dev)
    return _run_plan(plan, cfg, uplink, cell, eval_mask, bank, ebank, dev,
                     progress)


def run_horizon_vmapped(
    dataset,
    shards: list,
    cell: chan.CellConfig,
    cfg: FLConfig,
    *,
    seeds,
    uplink: Optional[str] = None,
    eval_every: int = 1,
    device=None,
) -> list:
    """A seed sweep: S independent scanned horizons in one stacked program.

    Each seed gets its own initial weights, channel draws, schedule, eval
    plan and receiver noise (``dataclasses.replace(cfg, seed=s)``); the
    client bank and test set are shared.  The seed axis folds into the
    client rows (:func:`repro_torch.core.fl_engine.run_horizon_vmapped`):
    one local-SGD pass for all S*K rows per batch, and the dense rounds'
    S x 6 (seed, leaf) sums through kernel #1, up to 16 to a launch.
    Returns one :class:`FLResult` per seed, in order; row s is the program
    :func:`run_horizon_scanned` runs for that seed alone.
    """
    dev = resolve_device(device)
    uplink = _resolve_uplink(cfg, uplink)
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("seeds must be a non-empty sequence")
    cfgs = [dataclasses.replace(cfg, seed=s) for s in seeds]
    if _traced_online(cfg):
        return _run_horizon_vmapped_online(dataset, shards, cell, cfg, cfgs,
                                           uplink, eval_every, dev)
    plans = [_horizon_setup(dataset, shards, cell, c, uplink, None,
                            device=dev) for c in cfgs]
    bank, ebank = _horizon_world(dataset, shards, cfg, dev)
    eval_mask = _eval_mask(cfg.num_rounds, eval_every)
    params_s, dev_stk, bud, agg, gains, keys, eidx, nb = _stack_plans(
        plans, bank, dev)
    final_s, log = fl_engine.run_horizon_vmapped(
        params_s, dev_stk, bud, agg, gains, keys, eval_mask, eidx, bank,
        ebank, nb=nb, **_horizon_statics(cfg, plans[0].payload, cell, uplink),
    )
    bits, kept, accs = fl_engine.horizon_logs(log)
    return [
        _assemble_horizon_result(plan, c, uplink, eval_mask, bits[i],
                                 None if kept is None else kept[i], accs[i],
                                 fl_engine._run_of(final_s, i))
        for i, (plan, c) in enumerate(zip(plans, cfgs))
    ]


def run_cell_sweep(
    dataset,
    shards: list,
    cell: chan.CellConfig,
    cfg: FLConfig,
    *,
    num_cells: int,
    seeds_per_cell: int = 1,
    uplink: Optional[str] = None,
    eval_every: int = 1,
    cell_shards: Optional[int] = None,
    device=None,
) -> list:
    """A (cells x seeds) grid of independent scanned horizons.

    Instance (c, s) runs seed ``cfg.seed + c * seeds_per_cell + s``: cells
    are disjoint seed blocks of one cell geometry.  Every instance runs
    as one :func:`repro_torch.core.fl_engine.run_horizon` (or
    ``run_horizon_online``) at its own batch count, over the shared bank
    and test set.  ``cell_shards`` is the reference's split of the cell
    axis across devices: an int is clamped to the card count (1 on the
    CPU), a sequence of devices is one shard per entry
    (:func:`repro_torch.sharding.cells.shard_devices`).  One shard runs
    every instance on the run's device; more run
    :func:`_run_cell_sweep_split`: one worker process per shard, each
    running its block of cells one horizon per instance, so the results
    do not depend on the shard count.  Returns ``results[c][s]``.
    """
    dev = resolve_device(device)
    uplink = _resolve_uplink(cfg, uplink)
    num_c, num_s = int(num_cells), int(seeds_per_cell)
    if num_c < 1 or num_s < 1:
        raise ValueError(f"need num_cells >= 1 and seeds_per_cell >= 1, "
                         f"got ({num_cells}, {seeds_per_cell})")
    eval_mask = _eval_mask(cfg.num_rounds, eval_every)
    online = _traced_online(cfg)
    devices = cells_lib.shard_devices(cell_shards, dev)
    if len(devices) > 1:
        return _run_cell_sweep_split(dataset, shards, cell, cfg, num_c, num_s,
                                     uplink, eval_mask, devices, dev, online)
    bank, ebank = _horizon_world(dataset, shards, cfg, dev)
    results = []
    for c in range(num_c):
        row = []
        for s in range(num_s):
            inst = dataclasses.replace(cfg, seed=cfg.seed + c * num_s + s)
            if online:
                plan = _online_horizon_setup(dataset, shards, cell, inst,
                                             device=dev)
                row.append(_run_online_plan(plan, inst, uplink, cell,
                                            eval_mask, bank, ebank, dev))
                continue
            plan = _horizon_setup(dataset, shards, cell, inst, uplink, None,
                                  device=dev)
            row.append(_run_plan(plan, inst, uplink, cell, eval_mask, bank,
                                 ebank, dev))
        results.append(row)
    return results


def _run_cell_sweep_split(dataset, shards, cell, cfg: FLConfig, num_c, num_s,
                          uplink, eval_mask, devices, device,
                          online) -> list:
    """The cell sweep split across ``devices``, as the reference's parent
    splits it (``repro/core/fl.py:1344-1400``, ``:1116-1157``): every
    instance's host plan built here (:func:`_horizon_setup` or
    :func:`_online_horizon_setup`, on ``device``), the plans stacked (C, S,
    ...), C padded to a multiple of the shards by repeating the leading
    cells (:func:`repro_torch.sharding.cells.pad_cells`), the blocks run
    by :func:`repro_torch.core.fl_engine.run_horizon_sharded` (or
    ``run_horizon_online_sharded``), the padding dropped and each
    instance's result assembled here as the unsplit sweep assembles it."""
    insts = [dataclasses.replace(cfg, seed=cfg.seed + i)
             for i in range(num_c * num_s)]
    pad = (-num_c) % len(devices)

    def cs(x):
        """(C*S, ...) -> (C + pad, S, ...)."""
        if x is None:
            return None
        return cells_lib.pad_cells(tree_lib.tree_map(
            lambda a: a.reshape(num_c, num_s, *a.shape[1:]), x), num_c, pad)

    def grid(one):
        """``results[c][s]`` from ``one(c, s, instance index, final
        params)``."""
        return [[one(c, s, c * num_s + s, tree_lib.tree_map(
            lambda w, c=c, s=s: w[c, s], final)) for s in range(num_s)]
            for c in range(num_c)]

    # the workers start (imports, the device's context) while the plans
    # are built here
    with cells_lib.Workers(devices) as workers:
        bank, ebank = _horizon_world(dataset, shards, cfg, device)
        world = (bank.xb, bank.yb, ebank.xe, ebank.ye)
        if online:
            plans = [_online_horizon_setup(dataset, shards, cell, inst,
                                           device=device) for inst in insts]
            params_s, solo, gains, weights, sizes, keys, eidx = (
                _stack_online_plans(plans, "cpu"))
            policy = scheduling.get_policy(cfg.scheduler)
            final, dev_cs, mask_cs, bits, kept, accs = (
                fl_engine.run_horizon_online_sharded(
                    cs(params_s), cs(solo), cs(gains), cs(keys), eval_mask,
                    cs(eidx), weights, sizes, *world, shards=workers,
                    nb=bank.n_batches_for(range(cell.num_devices)),
                    **_online_statics(cfg, cell, uplink, policy),
                    **_horizon_statics(cfg, plans[0].payload, cell, uplink)))
            return grid(lambda c, s, i, params: _assemble_horizon_result(
                _finalize_online_plan(plans[i], insts[i], cell, uplink,
                                      dev_cs[c, s], mask_cs[c, s]),
                insts[i], uplink, eval_mask, bits[c, s],
                None if kept is None else kept[c, s], accs[c, s], params))
        plans = [_horizon_setup(dataset, shards, cell, inst, uplink, None,
                                device=device) for inst in insts]
        params_s, dev_stk, bud, agg, gains, keys, eidx, _ = _stack_plans(
            plans, bank, "cpu")
        # each instance at its own batch count, as the unsplit sweep runs it
        nb = np.array([max(bank.n_batches_for(g) for g in p.schedule.rounds)
                       for p in plans])
        final, bits, kept, accs = fl_engine.run_horizon_sharded(
            cs(params_s), cs(dev_stk), cs(bud), cs(agg), cs(gains), cs(keys),
            eval_mask, cs(eidx), *world, shards=workers, nb=cs(nb),
            **_horizon_statics(cfg, plans[0].payload, cell, uplink))
        return grid(lambda c, s, i, params: _assemble_horizon_result(
            plans[i], insts[i], uplink, eval_mask, bits[c, s],
            None if kept is None else kept[c, s], accs[c, s], params))


# --------------------------------------------------------------------------
# Online-policy scanned horizons: selection inside the rounds on the device
# --------------------------------------------------------------------------

def _traced_online(cfg: FLConfig) -> bool:
    """Whether ``cfg.scheduler`` is an online policy with the traced
    protocol: the scanned drivers then select inside the horizon.  Under
    MAPEL they raise the pinned message, as ``FLConfig`` does (the
    polyblock search is host-iterative)."""
    if not (scheduling.policy_is_online(cfg.scheduler)
            and scheduling.policy_is_traced(cfg.scheduler)):
        return False
    if cfg.power_mode == "mapel":
        raise ValueError(
            errors.ERR_SCAN_ONLINE_MAPEL.format(scheduler=cfg.scheduler))
    return True


@dataclasses.dataclass
class _OnlinePlan:
    """The host plan of one online-policy instance (one seed).

    There is no schedule to pack (selection happens in the horizon), so the
    plan carries what the device selection and the host replay of its
    schedule read: the (T, M) channel gains, the data weights and shard
    sizes, and the policy's float32 solo-rate table (``init_traced``).
    """

    params0: dict                # initial weights, on the run's device
    payload: int                 # I: full-precision payload bits
    gains: np.ndarray            # (T, M) float32 channel amplitudes
    weights: np.ndarray          # (M,) float64 data weights
    sizes: np.ndarray            # (M,) float64 shard sizes
    solo: np.ndarray             # (T, M) float32 policy aux (init_traced)
    noise_keys: np.ndarray       # (T, 2) uint32 OTA receiver-noise keys
    dl_time: float               # downlink broadcast seconds per round
    eval_idx: Optional[np.ndarray]  # (T, n) eval plan; None = full set


def _online_statics(cfg: FLConfig, cell, uplink, policy) -> dict:
    """The online keyword arguments of ``fl_engine._online_horizon_core``
    (beside :func:`_horizon_statics`): the policy and its config, the
    uplink, the bandwidth * slot budget factor and whether the policy
    reads the norms."""
    return dict(
        policy=policy, pcfg=policy_config(cell, cfg), uplink=uplink,
        budget_scale=float(cell.bandwidth_hz) * float(cell.slot_seconds),
        need_norms=bool(getattr(policy, "needs_norms", True)),
    )


def _online_horizon_setup(dataset, shards, cell, cfg: FLConfig, *, device,
                          channels=None, init_params=None) -> _OnlinePlan:
    """The host plan of one online scanned instance, from the per-round
    driver's own setup (:func:`_setup`), with the policy's ``init_traced``
    solo table, so the device selection ranks what ``select_round`` ranks
    per round."""
    params, payload, sizes, gains, _, dl_time = _setup(
        shards, cell, cfg, schedule=None, channels=channels,
        init_params=init_params, device=device,
        model=get_fl_model(cfg.model),
    )
    weights = sizes / sizes.sum()
    policy = scheduling.get_policy(cfg.scheduler)
    aux = policy.init_traced(gains, weights, policy_config(cell, cfg))
    return _OnlinePlan(
        params, payload, gains, weights, sizes, aux["solo"],
        ota_lib.horizon_keys(cfg.seed, cfg.num_rounds), dl_time,
        eval_sample_plan(len(dataset.y_test), cfg.eval_sample,
                         cfg.num_rounds, cfg.seed),
    )


def _finalize_online_plan(plan: _OnlinePlan, cfg: FLConfig, cell, uplink,
                          dev_tk, mask_tk) -> _HorizonPlan:
    """The host float64 log plan of a realized online schedule: each
    round's (K,) device ids and masks from the horizon's download replay
    through the per-round driver's own calls (``scheduling.finalize_round``
    for powers and rates, :func:`_round_physics` for budgets and times), so
    the logged values are the per-round driver's by construction (the
    horizon's float32 rates priced only the bit budgets)."""
    allocator = power_lib.make_power_allocator(
        cfg.power_mode, cell.max_power_w, cell.noise_power_w
    )
    rounds, powers, rates_raw, total = [], [], [], 0.0
    for t in range(cfg.num_rounds):
        devs = tuple(int(d) for d in dev_tk[t][mask_tk[t]])
        p_k, r_k = scheduling.finalize_round(
            devs, t, plan.gains, plan.weights, allocator, cell.noise_power_w
        )
        rounds.append(devs)
        powers.append(p_k)
        rates_raw.append(r_k)
        if devs:
            total += float(np.sum(plan.weights[np.asarray(devs, np.intp)]
                                  * r_k))
    schedule = scheduling.Schedule(rounds, powers, rates_raw, total,
                                   cfg.scheduler, True)
    return _pack_plan(plan.params0, plan.payload, schedule, plan.gains,
                      plan.sizes, plan.dl_time, cfg, cell, uplink,
                      plan.noise_keys, plan.eval_idx)


def _stack_online_plans(plans, device):
    """The online plans' arrays stacked on a leading run axis and put on
    ``device`` once, as :func:`_stack_plans` does.  Returns ``(params_s,
    solo, gains, weights, sizes, keys, eidx)``: (S, T, M) float32 solo
    tables and gains, (M,) float32 data weights and shard sizes (shared),
    host numpy keys, and ``eidx`` ``None`` for the full test set."""
    return (
        fl_engine._stack_runs([p.params0 for p in plans]),
        _upload([p.solo for p in plans], torch.float32, device),
        _upload([p.gains for p in plans], torch.float32, device),
        _upload([plans[0].weights], torch.float32, device)[0],
        _upload([plans[0].sizes], torch.float32, device)[0],
        np.stack([p.noise_keys for p in plans]), _upload_eval(plans, device),
    )


def _run_online_plan(plan: _OnlinePlan, cfg: FLConfig, uplink, cell,
                     eval_mask, bank, ebank, device,
                     progress=None) -> FLResult:
    """One instance's online horizon from its host plan: the plan's one
    upload, the T rounds at the bank-wide batch count (the schedule is
    decided in the horizon, so every device must fit the gathered shape),
    the log's one download, then the host replay of the realized
    schedule."""
    _, solo, gains, weights, sizes, keys, eidx = _stack_online_plans(
        [plan], device)
    policy = scheduling.get_policy(cfg.scheduler)
    final, log = fl_engine.run_horizon_online(
        plan.params0, solo[0], gains[0], weights, sizes, keys[0], eval_mask,
        None if eidx is None else eidx[0], bank, ebank,
        nb=bank.n_batches_for(range(cell.num_devices)),
        **_online_statics(cfg, cell, uplink, policy),
        **_horizon_statics(cfg, plan.payload, cell, uplink),
    )
    dev_tk, mask_tk, bits, kept, accs = fl_engine.online_horizon_logs(log)
    hplan = _finalize_online_plan(plan, cfg, cell, uplink, dev_tk, mask_tk)
    return _assemble_horizon_result(hplan, cfg, uplink, eval_mask, bits, kept,
                                    accs, final, progress)


def _run_horizon_vmapped_online(dataset, shards, cell, cfg: FLConfig, cfgs,
                                uplink, eval_every, device) -> list:
    """The online seed sweep: S online horizons folded into the client rows
    of one program, one upload and one download."""
    plans = [_online_horizon_setup(dataset, shards, cell, c, device=device)
             for c in cfgs]
    bank, ebank = _horizon_world(dataset, shards, cfg, device)
    eval_mask = _eval_mask(cfg.num_rounds, eval_every)
    params_s, solo, gains, weights, sizes, keys, eidx = _stack_online_plans(
        plans, device)
    policy = scheduling.get_policy(cfg.scheduler)
    final_s, log = fl_engine.run_horizon_online_vmapped(
        params_s, solo, gains, weights, sizes, keys, eval_mask, eidx, bank,
        ebank, nb=bank.n_batches_for(range(cell.num_devices)),
        **_online_statics(cfg, cell, uplink, policy),
        **_horizon_statics(cfg, plans[0].payload, cell, uplink),
    )
    dev, mask, bits, kept, accs = fl_engine.online_horizon_logs(log)
    return [
        _assemble_horizon_result(
            _finalize_online_plan(plan, c, cell, uplink, dev[i], mask[i]), c,
            uplink, eval_mask, bits[i], None if kept is None else kept[i],
            accs[i], fl_engine._run_of(final_s, i))
        for i, (plan, c) in enumerate(zip(plans, cfgs))
    ]
