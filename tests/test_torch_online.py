"""The port's online policies (update-aware, age-fair, matching-pursuit)
against the JAX package's: the host policies, their traced protocol, and
whole runs per round and inside the scanned horizon.

In-process (``repro.core.scheduling`` and ``repro.core.power`` import
here): both packages get the same seeded gains, weights and sequences of
``Observation`` built by ``record_round`` (worlds M=12, T=6, K=3 and the
revisit tail M=4, K=2, T=3; matching-pursuit at ota_noise 0, 1e-9 and
large; a zero-gain device; tied scores), and ``select_round`` must equal
the reference's exactly, round by round, as must ``build_schedule``
(rounds, powers, rates) under max and MAPEL.  The traced protocol is held
against the reference's under ``jax.jit`` on the same float32 inputs:
device ids and masks exactly, ``traced_round_powers`` exactly.  The norm
estimates' two row sums are XLA reductions, which add in another order
than ``torch.sum``: measured before the bound was set, over 400 draws of
each size, the estimates differ by at most 3 float32 ulps at M=12 and 4
at M=300 (0 at M=4), so they are held within 4.

Whole runs go through one shimmed subprocess for the file
(test_torch_harness, the worker's ``online_runs`` task): the worlds of
tests/test_policy_scan.py (M=12 with 800 samples, the revisit world M=4
with 400), the three policies under NOMA and OTA (noise 1e-9), per round
on the batched engine with ``use_pallas=True`` and scanned, update-aware
under TDMA and on the legacy engine with MAPEL, ota-align, ``eval_every``,
the seed sweep and the cell sweep, all under
tests/test_fl_engine.py:_assert_equal_runs (schedules, bits, rates, ratios
and times exact, TDMA rates and ratios within 2 ulp; accuracy within 0.02;
parameter drift mean < 1e-6, max < 2e-2).  The norms each per-round run
fed its policy are held to the reference's: the batched engine's within
rtol 1e-6, the legacy engine's within 1e-4 (the reference's ``_tree_l2``
is XLA's sequential float32 ``vdot``, ROADMAP.md queue 3).  Against the
port's own per-round driver the scanned horizon gives the same logs and,
on the CPU, the same final parameters to the bit.  From its one upload to
its one download the online horizon reads nothing back from its tensors.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from test_torch_harness import (  # noqa: E402,F401
    _ulps, assert_equal_runs, one_torch_thread, start_reference,
)

from repro.core import power as ref_power  # noqa: E402
from repro.core import scheduling as ref_sched  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, errors, fl, fl_engine  # noqa: E402
from repro_torch.core import power, scheduling  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402

POLICIES = ("update-aware", "age-fair", "matching-pursuit")
NOISE = 1.6e-14
PMAX = 0.01
NORM_ULP = 4
TDMA_RATE_ULP = 2

# --------------------------------------------------------------------------
# The host policies
# --------------------------------------------------------------------------

HOST_WORLDS = {"m12": (12, 6, 3), "tail": (4, 3, 2)}     # M, T, K
OTA_NOISES = (0.0, 1e-9, 1e-3)
CASES = ("random", "zero-gain", "tied")
POLICY_NOISES = [(name, noise) for name in POLICIES
                 for noise in (OTA_NOISES if name == "matching-pursuit"
                               else (0.0,))]


def _instance(world, case, seed=0):
    """(T, M) float32 gains (as the channel draws are) and (M,) float64
    weights; ``zero-gain``: device 1 has no channel in any round;
    ``tied``: every device has round t's gain and the same weight."""
    m, t, _ = HOST_WORLDS[world]
    rng = np.random.default_rng(seed)
    gains = (np.abs(rng.normal(1e-6, 5e-7, (t, m))) + 1e-8).astype(np.float32)
    weights = rng.dirichlet(np.ones(m))
    if case == "zero-gain":
        gains[:, 1] = 0.0
    if case == "tied":
        gains[:] = gains[:, :1]
        weights = np.full(m, 1.0 / m)
    return gains, weights


def _feedback(rng, case, k):
    """A round's realized rates and update norms; ``tied``: all equal."""
    if case == "tied":
        return np.full(k, 2.0), np.full(k, 0.5)
    return rng.uniform(0.5, 8.0, k), rng.lognormal(0.0, 1.0, k)


def _pcfg(pkg, k, power_mode="max", ota_noise=0.0):
    return pkg.PolicyConfig(group_size=k, power_mode=power_mode, pmax=PMAX,
                            noise_power=NOISE, ota_noise=ota_noise)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", list(HOST_WORLDS))
@pytest.mark.parametrize("name,ota_noise", POLICY_NOISES)
def test_select_round_matches_reference(name, ota_noise, world, case):
    """Round by round, the port's selection equals the reference's on the
    same observations, and ``record_round`` gives the same observation."""
    gains, weights = _instance(world, case)
    _, num_rounds, k = HOST_WORLDS[world]
    got_p, want_p = scheduling.get_policy(name), ref_sched.get_policy(name)
    got_s = got_p.init_state(gains, weights,
                             _pcfg(scheduling, k, ota_noise=ota_noise))
    want_s = want_p.init_state(gains, weights,
                               _pcfg(ref_sched, k, ota_noise=ota_noise))
    got_o = scheduling.Observation.initial(len(weights))
    want_o = ref_sched.Observation.initial(len(weights))
    rng = np.random.default_rng(7)
    for t in range(num_rounds):
        got, got_s = got_p.select_round(t, got_s, got_o)
        want, want_s = want_p.select_round(t, want_s, want_o)
        assert got == want, (t, got, want)
        rates, norms = _feedback(rng, case, len(got))
        got_o = got_o.record_round(t, got, rates, norms)
        want_o = want_o.record_round(t, want, rates, norms)
        for field in ("update_norms", "participation", "last_round",
                      "realized_rates"):
            np.testing.assert_array_equal(getattr(got_o, field),
                                          getattr(want_o, field))
    if case == "tied" and name != "matching-pursuit":
        assert want_p.select_round(0, want_s, ref_sched.Observation.initial(
            len(weights)))[0] == tuple(range(k))    # ties to the lower id


def _same_schedule(got, want):
    assert got.rounds == want.rounds
    for pa, pb in zip(got.powers, want.powers):
        np.testing.assert_array_equal(pa, pb)
    for ra, rb in zip(got.rates, want.rates):
        np.testing.assert_array_equal(ra, rb)
    assert got.weighted_sum_rate == want.weighted_sum_rate
    assert (got.method, got.allow_revisits) == (want.method,
                                                want.allow_revisits)


@pytest.mark.parametrize("world,power_mode,name", [
    (world, "max", name) for world in HOST_WORLDS for name in POLICIES
] + [("tail", "mapel", name) for name in POLICIES] + [
    ("m12", "mapel", "update-aware")])
def test_build_schedule_online_matches_reference(name, power_mode, world):
    """Rate feedback only: every round finalized as it is selected, the
    schedule allowed to revisit.  MAPEL finalizes every policy's groups
    the same way (no policy reads the realized rates), so it runs on the
    tail world for each and on M=12 for one (a few seconds a horizon)."""
    gains, weights = _instance(world, "random", seed=3)
    k = HOST_WORLDS[world][2]
    got = scheduling.build_schedule(
        scheduling.get_policy(name), gains, weights,
        _pcfg(scheduling, k, power_mode, ota_noise=1e-9))
    want = ref_sched.build_schedule(
        ref_sched.get_policy(name), gains, weights,
        _pcfg(ref_sched, k, power_mode, ota_noise=1e-9))
    _same_schedule(got, want)
    assert got.allow_revisits


def test_registry_predicates_match_reference():
    for name in ref_sched.available_policies():
        assert scheduling.policy_is_online(name) \
            == ref_sched.policy_is_online(name)
        assert scheduling.policy_is_traced(name) \
            == ref_sched.policy_is_traced(name)
    assert scheduling.get_policy("update-aware").COLD_START_NORM \
        == scheduling.get_policy("matching-pursuit").COLD_START_NORM \
        == ref_sched.UpdateAwarePolicy.COLD_START_NORM
    with pytest.raises(ValueError, match="unknown scheduler"):
        scheduling.policy_is_online("nope")


# --------------------------------------------------------------------------
# The traced protocol
# --------------------------------------------------------------------------

def _traced_obs(rng, runs, m, case):
    """(S, M) observations: norms, participation and last rounds, with
    unseen devices; ``tied``: equal norms."""
    part = rng.integers(0, 3, (runs, m)).astype(np.int32)
    last = np.where(part > 0, rng.integers(0, 5, (runs, m)), -1)
    norms = rng.lognormal(0.0, 1.0, (runs, m)).astype(np.float32)
    if case == "tied":
        norms[:] = 0.5
    return norms, part, last.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("name", "cfg"))
def _ref_traced(t, solo, gains, weights, norms, part, last, *, name, cfg):
    """The reference's selection of ``name`` under ``jax.jit``, compiled
    once per config (the round is a traced argument)."""
    return ref_sched.get_policy(name).select_round_traced(
        t, solo, gains, weights, ref_sched.TracedObservation(norms, part,
                                                             last), cfg)


@jax.jit
def _ref_norm_estimates(norms, part, last):
    return ref_sched._norm_estimates_traced(
        ref_sched.TracedObservation(norms, part, last), 1.0)


@functools.partial(jax.jit, static_argnames=("mode",))
def _ref_powers(gains, weights, *, mode):
    return ref_power.traced_round_powers(mode, gains, weights, PMAX)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", list(HOST_WORLDS))
@pytest.mark.parametrize("name,ota_noise", POLICY_NOISES)
def test_select_round_traced_matches_reference(name, ota_noise, world, case):
    """S = 3 runs at once on CPU tensors against the reference's jitted
    selection of each run: ids and masks exactly, at every round of the
    solo table."""
    gains, weights = _instance(world, case, seed=1)
    m, num_rounds, k = HOST_WORLDS[world]
    runs = 3
    got_p, want_p = scheduling.get_policy(name), ref_sched.get_policy(name)
    cfg_kw = dict(ota_noise=ota_noise)
    solo = got_p.init_traced(gains, weights,
                             _pcfg(scheduling, k, **cfg_kw))["solo"]
    np.testing.assert_array_equal(solo, want_p.init_traced(
        gains, weights, _pcfg(ref_sched, k, **cfg_kw))["solo"])
    w32 = weights.astype(np.float32)
    rng = np.random.default_rng(11)
    for t in range(num_rounds):
        norms, part, last = _traced_obs(rng, runs, m, case)
        obs = scheduling.TracedObservation(*map(torch.from_numpy,
                                                (norms, part, last)))
        dev, mask = got_p.select_round_traced(
            t, torch.from_numpy(np.repeat(solo[t][None], runs, 0)),
            torch.from_numpy(np.repeat(gains[t][None], runs, 0)),
            torch.from_numpy(w32), obs, _pcfg(scheduling, k, **cfg_kw))
        assert dev.dtype == torch.int64 and mask.dtype == torch.bool
        for s in range(runs):
            want_dev, want_mask = map(np.asarray, _ref_traced(
                jnp.int32(t), solo[t], gains[t], w32, norms[s], part[s],
                last[s], name=name, cfg=_pcfg(ref_sched, k, **cfg_kw)))
            np.testing.assert_array_equal(mask[s].numpy(), want_mask)
            np.testing.assert_array_equal(dev[s].numpy()[want_mask],
                                          want_dev[want_mask])


@pytest.mark.parametrize("m", [4, 12, 300])
def test_norm_estimates_traced_within_measured_ulps(m):
    """The cold start, the mean of the observed norms and the floor: the
    reference's op order, the row sums in torch's order (module
    docstring: NORM_ULP was measured before it was set)."""
    rng = np.random.default_rng(m)
    norms, part, last = _traced_obs(rng, 4, m, "random")
    part[0] = 0                                  # nothing observed yet
    norms[1, :2] = 0.0                           # observed zeros: floored
    got = scheduling._norm_estimates_traced(scheduling.TracedObservation(
        *map(torch.from_numpy, (norms, part, last))), 1.0).numpy()
    for s in range(4):
        want = np.asarray(_ref_norm_estimates(norms[s], part[s], last[s]))
        assert _ulps(got[s], want).max() <= NORM_ULP
    np.testing.assert_array_equal(got[0], np.ones(m, np.float32))


@pytest.mark.parametrize("mode", power.TRACED_POWER_MODES)
def test_traced_round_powers_match_reference(mode):
    """Masked (S, K) groups with dead lanes (zero gain or weight) and an
    all-dead group: equal to the reference's float32 allocator exactly."""
    assert power.TRACED_POWER_MODES == ref_power.TRACED_POWER_MODES
    rng = np.random.default_rng(5)
    g = (np.abs(rng.normal(1e-6, 5e-7, (6, 3))) + 1e-8).astype(np.float32)
    w = rng.dirichlet(np.ones(3), 6).astype(np.float32)
    g[1, 2] = 0.0
    w[2, 0] = 0.0
    g[3] = 0.0
    got = power.traced_round_powers(mode, torch.from_numpy(g),
                                    torch.from_numpy(w), PMAX).numpy()
    for row in range(len(g)):
        np.testing.assert_array_equal(
            got[row], np.asarray(_ref_powers(g[row], w[row], mode=mode)))
    assert np.all(got[3] == 0.0)


def test_traced_round_powers_refuse_mapel():
    with pytest.raises(ValueError, match="has no traced allocator"):
        power.traced_round_powers("mapel", torch.ones(3), torch.ones(3), PMAX)


# --------------------------------------------------------------------------
# Whole runs against the reference (one subprocess for the file)
# --------------------------------------------------------------------------

WORLDS = {"m12": (12, 800), "m4": (4, 400)}     # M, samples
RUNS = {
    **{f"{p}-{u}-{h}": ("m12", dict(scheduler=p, uplink=u, horizon=h), 1)
       for p in POLICIES for u in ("noma", "ota")
       for h in ("per-round", "scan")},
    **{f"tail-{p}-{h}": ("m4", dict(scheduler=p, uplink="ota", group_size=2,
                                    num_rounds=3, horizon=h), 1)
       for p in POLICIES for h in ("per-round", "scan")},
    **{f"tdma-{h}": ("m12", dict(uplink="tdma", horizon=h), 1)
       for h in ("per-round", "scan")},
    "legacy-mapel": ("m12", dict(fl_engine="legacy", use_pallas=False,
                                 power_mode="mapel"), 1),
    **{f"ota-align-{h}": ("m12", dict(scheduler="matching-pursuit",
                                      uplink="ota", power_mode="ota-align",
                                      horizon=h), 1)
       for h in ("per-round", "scan")},
    **{f"eval-every-{h}": ("m12", dict(horizon=h), 3)
       for h in ("per-round", "scan")},
}
SEEDS = [0, 1, 2]


def _cfg(world, **kw):
    """tests/test_policy_scan.py's configuration, with the kernel path."""
    base = dict(num_devices=WORLDS[world][0], group_size=3, num_rounds=4,
                scheduler="update-aware", power_mode="max",
                compression="adaptive", fl_engine="batched", use_pallas=True,
                horizon="per-round", uplink="noma", seed=0)
    if kw.get("uplink") == "ota":
        base.update(compression="none", ota_noise=1e-9)
    base.update(kw)
    return FLConfig(**base)


SWEEPS = {
    "seeds": ("m12", _cfg("m12", num_rounds=3, horizon="scan")),
    "cells": ("m4", _cfg("m4", group_size=2, num_rounds=3,
                         scheduler="age-fair", horizon="scan")),
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _spec(key, kind, world, cfg, **extra):
    m, samples = WORLDS[world]
    return dict(key=key, kind=kind, num_devices=m, num_samples=samples,
                cfg=_fields(cfg), **extra)


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, (m, samples) in WORLDS.items():
        ds = make_mnist_like(num_samples=samples, seed=0)
        out[name] = (ds, channel.CellConfig(num_devices=m),
                     dirichlet_partition(ds.y_train, m, seed=0))
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """Every reference run of the file, in one subprocess started with the
    module's first test, so that it runs beside the in-process tests and
    the port's runs; killed at the end if no test waited for it."""
    runs = [_spec(name, "scan", world, _cfg(world, **kw), eval_every=every)
            for name, (world, kw, every) in RUNS.items()]
    runs.append(_spec("seeds", "seeds", *SWEEPS["seeds"], seeds=SEEDS))
    runs.append(_spec("cells", "cells", *SWEEPS["cells"], num_cells=2,
                      seeds_per_cell=2))
    job = start_reference(tmp_path_factory.mktemp("online"), "online_runs",
                          {"runs": runs}, timeout=900)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


def _want(reference, prefix):
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def port_runs(worlds):
    """Every port run of RUNS on the CPU, with the norms each per-round
    run fed its policy."""
    record = scheduling.Observation.record_round
    fed = []

    def keep(self, t, group, rates_k, update_norms_k=None):
        fed.append(np.zeros(0) if update_norms_k is None
                   else np.asarray(update_norms_k, np.float64))
        return record(self, t, group, rates_k, update_norms_k)

    out = {}
    scheduling.Observation.record_round = keep
    try:
        for name, (world, kw, every) in RUNS.items():
            ds, cell, shards = worlds[world]
            fed.clear()
            res = fl.run_federated_learning(ds, shards, cell,
                                            _cfg(world, **kw),
                                            eval_every=every, device="cpu")
            out[name] = (res, list(fed))
    finally:
        scheduling.Observation.record_round = record
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_online_run_matches_the_reference(reference, port_runs, name):
    world, kw, _ = RUNS[name]
    cfg = _cfg(world, **kw)
    got, norms = port_runs[name]
    want = _want(reference, f"{name}/")
    assert_equal_runs(got, want, cfg.num_rounds,
                      rate_ulp=TDMA_RATE_ULP if cfg.uplink == "tdma" else 0)
    if cfg.horizon == "scan":
        assert not norms          # the scan feeds its norms on the device
        return
    rtol = 1e-4 if cfg.fl_engine == "legacy" else 1e-6
    assert len(norms) == cfg.num_rounds
    for t, fed in enumerate(norms):
        np.testing.assert_allclose(fed, want[f"norms/{t}"], rtol=rtol)
    reads_norms = cfg.scheduler != "age-fair"
    assert all(len(fed) == (len(lg.devices) if reads_norms else 0)
               for fed, lg in zip(norms, got.logs))
    if name.startswith("tail-"):
        seen = [d for lg in got.logs for d in lg.devices]
        assert len(seen) > len(set(seen))            # revisits


@pytest.mark.parametrize("name", [n for n in RUNS if n.endswith("-scan")])
def test_online_scan_matches_the_per_round_driver(port_runs, name):
    """The scanned horizon against the port's own per-round run of the
    same configuration: logs equal (accuracy too) and final parameters
    equal to the bit on the CPU."""
    scanned, _ = port_runs[name]
    per_round, _ = port_runs[name[:-len("scan")] + "per-round"]
    assert [lg.devices for lg in scanned.logs] \
        == [lg.devices for lg in per_round.logs]
    for a, b in zip(scanned.logs, per_round.logs):
        assert a.test_accuracy == b.test_accuracy
        assert a.wall_time_s == b.wall_time_s
        for field in ("bits", "rates", "compression_ratios"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for layer, leaves in per_round.final_params.items():
        for leaf, v in leaves.items():
            assert torch.equal(scanned.final_params[layer][leaf], v)


def test_online_eval_every_forward_fills(port_runs):
    acc = port_runs["eval-every-scan"][0].accuracies()
    assert acc[1] == acc[0] and acc[2] == acc[0] and not np.isnan(acc).any()


def test_online_seed_sweep_matches_the_reference(reference, worlds):
    """Each row against the reference's vmapped row, and against the
    port's single scan at its seed to the bit; the seeds are real."""
    world, cfg = SWEEPS["seeds"]
    ds, cell, shards = worlds[world]
    sweep = fl.run_horizon_vmapped(ds, shards, cell, cfg, seeds=SEEDS,
                                   device="cpu")
    for s, res in enumerate(sweep):
        assert_equal_runs(res, _want(reference, f"seeds/{s}/"),
                          cfg.num_rounds)
    single = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert [lg.devices for lg in sweep[0].logs] \
        == [lg.devices for lg in single.logs]
    np.testing.assert_array_equal(sweep[0].accuracies(), single.accuracies())
    for layer, leaves in single.final_params.items():
        for leaf, v in leaves.items():
            assert torch.equal(sweep[0].final_params[layer][leaf], v)
    assert any([lg.devices for lg in res.logs]
               != [lg.devices for lg in sweep[0].logs] for res in sweep[1:])


def test_online_cell_sweep_matches_the_reference(reference, worlds):
    world, cfg = SWEEPS["cells"]
    ds, cell, shards = worlds[world]
    grid = fl.run_cell_sweep(ds, shards, cell, cfg, num_cells=2,
                             seeds_per_cell=2, cell_shards=2, device="cpu")
    for c in range(2):
        for s in range(2):
            assert_equal_runs(grid[c][s],
                              _want(reference, f"cells/{c}/{s}/"),
                              cfg.num_rounds)


def test_online_cold_start_ranks_by_the_solo_table(port_runs, worlds):
    """Round 0 of update-aware has seen no norm: on both drivers it takes
    the solo-rate table's top K (tests/test_policy_scan.py)."""
    ds, cell, shards = worlds["m12"]
    cfg = _cfg("m12")
    bundle = channel.sample_channels(cfg.seed, cell, cfg.num_rounds)
    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    solo = scheduling.get_policy("update-aware").init_traced(
        bundle.gains, sizes / sizes.sum(), fl.policy_config(cell, cfg))["solo"]
    want = tuple(int(d) for d in np.argsort(-solo[0], kind="stable")[:3])
    for horizon in ("per-round", "scan"):
        res, _ = port_runs[f"update-aware-noma-{horizon}"]
        assert res.logs[0].devices == want


# --------------------------------------------------------------------------
# The horizon reads nothing back; the configuration rules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(scheduler="age-fair", uplink="tdma"),
    dict(scheduler="matching-pursuit", uplink="ota",
         power_mode="ota-align"),
    dict(eval_sample=0.5),
], ids=["update-aware", "age-fair-tdma", "matching-pursuit-ota",
        "eval-sample"])
def test_online_horizon_reads_nothing_back(worlds, monkeypatch, kw):
    """From the upload to the download the online horizon turns no tensor
    into a host value (``item``, ``tolist``, ``numpy``, ``cpu``, ``bool``,
    ``float``, ``int``): on the card each of those waits for the device.
    chip_smoke.py holds the same part under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    core = fl_engine._online_horizon_core
    banned = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
              "__int__")
    calls = []

    def no_reads(*args, **kwargs):
        calls.append(1)
        with monkeypatch.context() as m:
            for name in banned:
                def refuse(*a, _name=name, **k):
                    raise AssertionError(f"Tensor.{_name} inside the horizon")
                m.setattr(torch.Tensor, name, refuse)
            return core(*args, **kwargs)

    monkeypatch.setattr(fl_engine, "_online_horizon_core", no_reads)
    ds, cell, shards = worlds["m4"]
    cfg = _cfg("m4", group_size=2, num_rounds=3, horizon="scan", **kw)
    got = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert len(got.logs) == 3 and np.all(np.isfinite(got.accuracies()))
    fl.run_horizon_vmapped(ds, shards, cell, cfg, seeds=[0, 1], device="cpu")
    assert len(calls) == 2


@pytest.mark.parametrize("scheduler", POLICIES)
def test_config_rejects_mapel_with_online_scan(scheduler):
    """The reference's rule and text, at construction."""
    msg = errors.ERR_SCAN_ONLINE_MAPEL.format(scheduler=scheduler)
    with pytest.raises(ValueError) as err:
        FLConfig(scheduler=scheduler, horizon="scan", power_mode="mapel")
    assert str(err.value) == msg
    from repro.core import errors as ref_errors
    assert msg == ref_errors.ERR_SCAN_ONLINE_MAPEL.format(scheduler=scheduler)


def test_config_rejects_an_untraced_online_policy_with_scan(monkeypatch):
    """An online policy without the traced protocol cannot run inside the
    scan: the reference's message, at construction and from the scanned
    setup called directly."""
    from repro.core import errors as ref_errors

    @scheduling.register_policy("untraced-online")
    class Untraced(scheduling.UpdateAwarePolicy):
        traced_protocol = False

    try:
        msg = errors.ERR_SCAN_ONLINE_POLICY.format(scheduler="untraced-online")
        assert msg == ref_errors.ERR_SCAN_ONLINE_POLICY.format(
            scheduler="untraced-online")
        with pytest.raises(ValueError) as err:
            FLConfig(scheduler="untraced-online", horizon="scan",
                     power_mode="max")
        assert str(err.value) == msg
        cfg = FLConfig(scheduler="untraced-online", power_mode="max",
                       num_devices=4, group_size=2, num_rounds=2)
        ds = make_mnist_like(num_samples=200, seed=0)
        cell = channel.CellConfig(num_devices=4)
        shards = dirichlet_partition(ds.y_train, 4, seed=0)
        with pytest.raises(ValueError) as err:
            fl._horizon_setup(ds, shards, cell, cfg, "noma", None,
                              device="cpu")
        assert str(err.value) == msg
    finally:
        scheduling._REGISTRY.pop("untraced-online")
