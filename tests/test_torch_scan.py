"""The port's scanned horizon, seed sweep and cell sweep against the JAX
package's, and against the port's own per-round driver.

``horizon="scan"`` plans every round on the host, uploads the plan once
and runs all T rounds from device tensors (``fl_engine._horizon_core``);
``run_horizon_vmapped`` folds a seed sweep into the client rows of one
such program and ``run_cell_sweep`` runs a (cells x seeds) grid.  The
port runs on the CPU here, so every round goes through the kernels' plain
versions.

Against the reference (all its runs in one shimmed subprocess for the
file, test_torch_harness): the grid of tests/test_fl_scan.py (uplink noma /
tdma / ota x compression adaptive / none x scheduler lazy-gwmin / random,
every run ``use_pallas=True``), the empty tail rounds, the eval cadence,
the sampled eval and top-k, under tests/test_fl_engine.py:
_assert_equal_runs (schedules, bits, rates, ratios and times exact, TDMA
rates and ratios within 2 ulp, accuracy within 0.02, mean parameter drift
below 1e-6).  Both packages draw from the seed alone: the draws are equal
to the bit (tests/test_torch_draws.py).

Against the port's per-round driver, in this process: the contract of
tests/test_fl_scan.py:_assert_equal_runs with acc_atol 0, and final
parameters equal to the bit where every round is full (a partial round
trains its padded rows and sums them with weight zero).  A sweep's row
equals the single scan at its seed to the bit (tests/test_fl_scan.py:129,
:153).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    assert_equal_runs, one_torch_thread, run_reference,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, compression, fl, fl_engine  # noqa: E402
from repro_torch.core import quantization as qlib  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.data.client_bank import ClientBank  # noqa: E402
from repro_torch.sharding import cells  # noqa: E402

TDMA_RATE_ULP = 2
SAMPLES = 400
T = 3
WORLDS = {"m6": (6, 3), "m4k3": (4, 3), "m4k2": (4, 2)}   # M, K
SEEDS = [0, 1, 2]
GRID = [(uplink, compression, scheduler)
        for uplink in ("noma", "tdma", "ota")
        for compression in ("adaptive", "none")
        for scheduler in ("lazy-gwmin", "random")
        if not (uplink == "ota" and compression == "adaptive")]
# name -> (world, FLConfig fields beyond _cfg's, eval_every)
CASES = {
    **{f"{u}-{c}-{s}": ("m6", dict(uplink=u, compression=c, scheduler=s), 1)
       for u, c, s in GRID},
    # T*K > M: round-robin ends in an empty round, lazy-gwmin in a short one
    "tail-round-robin": ("m4k3", dict(scheduler="round-robin"), 1),
    "tail-lazy-gwmin": ("m4k3", dict(), 1),
    "eval-every-3": ("m6", dict(num_rounds=4), 3),
    "eval-sample": ("m6", dict(eval_sample=0.5), 1),
    "topk": ("m6", dict(topk=0.1), 1),
}


def _cfg(world, **kw):
    m, k = WORLDS[world]
    if kw.get("uplink") == "ota":
        kw = dict(power_mode="ota-align", ota_noise=1e-9, **kw)
    return FLConfig(**{**dict(
        num_devices=m, group_size=k, num_rounds=T, power_mode="max",
        fl_engine="batched", use_pallas=True, horizon="scan", seed=0,
    ), **kw})


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, (m, _) in WORLDS.items():
        ds = make_mnist_like(num_samples=SAMPLES, seed=0)
        out[name] = (ds, channel.CellConfig(num_devices=m),
                     dirichlet_partition(ds.y_train, m, seed=0))
    return out


def _spec(key, kind, world, cfg, **extra):
    return dict(key=key, kind=kind, num_devices=WORLDS[world][0],
                num_samples=SAMPLES, cfg=_fields(cfg), **extra)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference run of the file, in one subprocess."""
    runs = [_spec(name, "scan", world, _cfg(world, **kw), eval_every=every)
            for name, (world, kw, every) in CASES.items()]
    runs.append(_spec("seeds", "seeds", "m6", _cfg("m6"), seeds=SEEDS))
    runs.append(_spec("cells", "cells", "m4k2", _cfg("m4k2"), num_cells=2,
                      seeds_per_cell=2))
    return run_reference(tmp_path_factory.mktemp("scan"), "horizon_runs",
                         {"runs": runs})


def _want(reference, prefix):
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


def _scan(worlds, world, cfg, every=1):
    ds, cell, shards = worlds[world]
    return fl.run_federated_learning(ds, shards, cell, cfg, eval_every=every,
                                     device="cpu")


def _rate_ulp(cfg):
    return TDMA_RATE_ULP if cfg.uplink == "tdma" else 0


def _assert_same_logs(got, want):
    """tests/test_fl_scan.py:_assert_equal_runs with acc_atol=0, without
    its drift bounds (the callers state the parameters' contract)."""
    assert [lg.devices for lg in got.logs] == [lg.devices for lg in want.logs]
    for a, b in zip(got.logs, want.logs):
        assert a.test_accuracy == b.test_accuracy
        for field in ("bits", "rates", "compression_ratios"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(got.times(), want.times())


def _assert_same_params(got, want):
    for name, layer in want.final_params.items():
        for leaf, v in layer.items():
            assert torch.equal(got.final_params[name][leaf], v), (name, leaf)


def _drift(got, want):
    """tests/test_fl_scan.py:_assert_equal_runs' parameter bounds."""
    for name, layer in want.final_params.items():
        for leaf, v in layer.items():
            d = (got.final_params[name][leaf].double() - v.double()).abs()
            assert d.mean().item() < 1e-6 and d.max().item() < 2e-2


@pytest.mark.parametrize("name", list(CASES))
def test_scan_matches_the_reference_scan(reference, worlds, name):
    world, kw, every = CASES[name]
    cfg = _cfg(world, **kw)
    got = _scan(worlds, world, cfg, every)
    assert_equal_runs(got, _want(reference, f"{name}/"), cfg.num_rounds,
                      rate_ulp=_rate_ulp(cfg))
    if name == "tail-round-robin":
        assert got.logs[-1].devices == () and got.logs[-1].bits.size == 0
    if name == "eval-every-3":
        acc = got.accuracies()
        assert acc[1] == acc[0] and acc[2] == acc[0]     # forward-filled
        assert not np.isnan(acc).any()
    if name == "topk":
        assert all(np.all(lg.compression_ratios > 1.0)
                   for lg in got.logs if lg.bits.size)


@pytest.mark.parametrize("name", list(CASES))
def test_scan_matches_the_per_round_driver(worlds, name):
    """The same config per round: logs equal (accuracy too), parameters
    equal to the bit where every round is full, else within the drift
    bounds."""
    world, kw, every = CASES[name]
    cfg = _cfg(world, **kw)
    scanned = _scan(worlds, world, cfg, every)
    per_round = _scan(worlds, world, dataclasses.replace(
        cfg, horizon="per-round"), every)
    _assert_same_logs(scanned, per_round)
    if all(len(lg.devices) == cfg.group_size for lg in per_round.logs):
        _assert_same_params(scanned, per_round)
    else:
        _drift(scanned, per_round)


def test_seed_sweep_matches_the_reference_sweep(reference, worlds):
    ds, cell, shards = worlds["m6"]
    cfg = _cfg("m6")
    sweep = fl.run_horizon_vmapped(ds, shards, cell, cfg, seeds=SEEDS,
                                   device="cpu")
    assert len(sweep) == len(SEEDS)
    for s, res in enumerate(sweep):
        assert_equal_runs(res, _want(reference, f"seeds/{s}/"), T)


def test_seed_sweep_rows_equal_single_scans(worlds):
    """Row s is the single scan at seed s to the bit, and the seeds are
    real: some row differs from row 0."""
    ds, cell, shards = worlds["m6"]
    cfg = _cfg("m6")
    sweep = fl.run_horizon_vmapped(ds, shards, cell, cfg, seeds=SEEDS,
                                   device="cpu")
    for s, res in enumerate(sweep):
        single = _scan(worlds, "m6", dataclasses.replace(cfg, seed=s))
        _assert_same_logs(res, single)
        _assert_same_params(res, single)
    r0 = sweep[0]
    assert any([lg.devices for lg in res.logs] != [lg.devices for lg in r0.logs]
               or not np.array_equal(res.accuracies(), r0.accuracies())
               for res in sweep[1:])


def test_cell_sweep_matches_the_reference_sweep(reference, worlds):
    ds, cell, shards = worlds["m4k2"]
    grid = fl.run_cell_sweep(ds, shards, cell, _cfg("m4k2"), num_cells=2,
                             seeds_per_cell=2, device="cpu")
    for c in range(2):
        for s in range(2):
            assert_equal_runs(grid[c][s], _want(reference, f"cells/{c}/{s}/"),
                              T)


@pytest.mark.parametrize("cell_shards", [None, 2])
def test_cell_sweep_instances_equal_their_own_scans(worlds, cell_shards):
    """Every (cell, seed) instance is the scan at its seed to the bit;
    ``cell_shards=2`` clamps to one shard on the CPU and gives the same
    grid."""
    ds, cell, shards = worlds["m4k2"]
    cfg = _cfg("m4k2")
    assert cells.cell_shards(cell_shards, "cpu") == 1
    grid = fl.run_cell_sweep(ds, shards, cell, cfg, num_cells=2,
                             seeds_per_cell=2, cell_shards=cell_shards,
                             device="cpu")
    for c in range(2):
        for s in range(2):
            inst = _scan(worlds, "m4k2", dataclasses.replace(cfg,
                                                             seed=c * 2 + s))
            _assert_same_logs(grid[c][s], inst)
            _assert_same_params(grid[c][s], inst)


def test_cell_sweep_runs_each_instance_at_its_own_batch_count(worlds,
                                                              monkeypatch):
    """One ``run_horizon`` per instance, each read as deep as its own
    schedule's groups need (no all-padding batches beyond them), from a
    one-run plan."""
    ds, cell, shards = worlds["m6"]
    cfg = _cfg("m6")
    seen = []
    horizon = fl_engine.run_horizon

    def spy(params, dev_tk, *args, nb, **kwargs):
        seen.append((tuple(dev_tk.shape), nb))
        return horizon(params, dev_tk, *args, nb=nb, **kwargs)

    monkeypatch.setattr(fl_engine, "run_horizon", spy)
    grid = fl.run_cell_sweep(ds, shards, cell, cfg, num_cells=2,
                             seeds_per_cell=2, device="cpu")
    bank = ClientBank.build(ds.x_train, ds.y_train, shards, cfg.batch_size,
                           device="cpu")
    want = [((T, cfg.group_size),
             max(bank.n_batches_for(lg.devices) for lg in res.logs))
            for row in grid for res in row]
    assert seen == want


@pytest.mark.parametrize("requested,want", [(None, 1), (1, 1), (2, 1),
                                            (0, 1), (-3, 1)])
def test_cell_shards_clamp_to_one_on_the_cpu(requested, want):
    assert cells.cell_shards(requested, "cpu") == want


@pytest.mark.parametrize("k", [3, 0], ids=["full", "empty"])
@pytest.mark.parametrize("mode", ["topk", "adaptive", "none"])
def test_round_ratios_follow_the_per_round_rule(mode, k):
    """The one rule both drivers log ratios by: the sparse on-air ratio
    from (kept, bits) under top-k, the float32 ratio of the budgets under
    adaptive DoReFa, else ones; an empty tail round gives an empty row."""
    payload = 32 * 1000
    rng = np.random.default_rng(0)
    budgets32 = torch.from_numpy(rng.uniform(1e3, 4e4, k)).to(torch.float32)
    bits = rng.integers(1, 33, k).astype(np.int32)
    kept = rng.integers(1, 1000, k).astype(np.int32) if mode == "topk" else None
    got = fl_engine._round_ratios(payload, mode != "none", kept, bits,
                                  budgets32)
    if mode == "topk":
        want = compression.sparse_compression_ratio(payload, kept, bits,
                                                    payload // 32)
    elif mode == "adaptive":
        want = qlib.compression_ratio(payload, budgets32).numpy()
    else:
        want = np.ones(k)
    assert got.dtype == np.float64 and got.shape == (k,)
    np.testing.assert_array_equal(got, want.astype(np.float64))


@pytest.mark.parametrize("topk", [True, False], ids=["topk", "dense"])
def test_horizon_logs_report_kept_counts_only_under_topk(topk):
    """The log's kept columns stay NaN unless the round body kept counts;
    the download then gives ``None`` for them, as the per-round engine
    does."""
    seeds, rounds, k = 2, 3, 2
    log = torch.full((seeds, rounds, 2 * k + 1), float("nan"),
                     dtype=torch.float64)
    log[..., :k] = 4.0
    log[..., 2 * k] = 0.5
    if topk:
        log[..., k:2 * k] = 7.0
    bits, kept, acc = fl_engine.horizon_logs(log)
    assert bits.dtype == np.int32 and np.all(bits == 4)
    assert np.all(acc == 0.5)
    if topk:
        assert kept.dtype == np.int32 and np.all(kept == 7)
    else:
        assert kept is None


def test_one_run_stacks_as_views():
    """S = 1, as the per-round engine and a single scan run it: the run
    axis is a view of the parameters, with no copy."""
    params = {"fc": {"w": torch.arange(6.0).reshape(2, 3),
                     "b": torch.zeros(3)}}
    stacked = fl_engine._stack_runs([params])
    for name in ("w", "b"):
        leaf = stacked["fc"][name]
        assert leaf.shape == (1, *params["fc"][name].shape)
        assert leaf.data_ptr() == params["fc"][name].data_ptr()
    two = fl_engine._stack_runs([params, params])
    assert two["fc"]["w"].shape == (2, 2, 3)


def test_horizon_aggregates_every_round_in_one_grouped_call(worlds,
                                                            monkeypatch):
    """Kernel #1's wrapper is called once per round, all-padding tail
    rounds included (the per-round engine skips those), with the six
    LeNet leaves of every run of the sweep as its matrices: one call of
    6 matrices a round in a scan, of 6 S in a sweep of S seeds."""
    calls = []
    group = fl_engine.weighted_aggregate_group

    def count(codes, coeffs):
        calls.append(len(codes))
        return group(codes, coeffs)

    monkeypatch.setattr(fl_engine, "weighted_aggregate_group", count)
    ds, cell, shards = worlds["m4k3"]
    cfg = _cfg("m4k3", scheduler="round-robin")
    scanned = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert scanned.logs[-1].devices == ()
    assert calls == [6] * T
    calls.clear()
    fl.run_federated_learning(ds, shards, cell, dataclasses.replace(
        cfg, horizon="per-round"), device="cpu")
    assert calls == [6] * (T - 1)
    calls.clear()
    fl.run_horizon_vmapped(ds, shards, cell, cfg, seeds=SEEDS, device="cpu")
    assert calls == [6 * len(SEEDS)] * T


@pytest.mark.parametrize("kw", [dict(), dict(uplink="ota", compression="none"),
                                dict(topk=0.1), dict(eval_sample=0.5)],
                         ids=["dense", "ota", "topk", "eval-sample"])
def test_horizon_reads_nothing_back_from_its_tensors(worlds, monkeypatch, kw):
    """From the upload to the download the horizon turns no tensor into a
    host value (``item``, ``tolist``, ``numpy``, ``cpu``, ``bool``,
    ``float``, ``int``): on the card each of those waits for the device.
    The card run of chip_smoke.py holds the same part under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    core = fl_engine._horizon_core
    banned = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
              "__int__")

    def no_reads(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in banned:
                def refuse(*a, _name=name, **k):
                    raise AssertionError(f"Tensor.{_name} inside the horizon")
                m.setattr(torch.Tensor, name, refuse)
            return core(*args, **kwargs)

    monkeypatch.setattr(fl_engine, "_horizon_core", no_reads)
    ds, cell, shards = worlds["m6"]
    got = _scan(worlds, "m6", _cfg("m6", **kw))
    assert len(got.logs) == T and np.all(np.isfinite(got.accuracies()))
    fl.run_horizon_vmapped(ds, shards, cell, _cfg("m6", **kw), seeds=[0, 1],
                           device="cpu")
