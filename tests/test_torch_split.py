"""The port's two splits across devices against its unsplit paths and the
JAX package's own splits.

The device greedy's vertex split (``rates_device.greedy_rounds_fused``
with ``shards``): each shard scores its contiguous slice of the subset
enumeration and the shards' argmaxes are combined as the reference's mesh
combines them.  The cell sweep's split (``fl.run_cell_sweep`` with
``cell_shards``): the cells are padded to a multiple of the shards and cut
into one block per worker process, each running its instances one horizon
at a time.  On the CPU the splits are reached with explicit device lists
(``["cpu"] * n``), the stand-in for the reference's forced host devices;
an int clamps to one shard here.

Against the port's unsplit paths, in this process: schedules (rounds and
weighted sum rate) and sweeps (logs, accuracies and final parameters) to
the bit.  Against the reference (one shimmed subprocess for the file, on 4
forced host devices): the greedy's ``shards=n`` schedules exactly, and
``run_cell_sweep(cell_shards=2)`` under tests/test_fl_engine.py:
_assert_equal_runs (logs exact, accuracy within 0.02, drift below 1e-6).
"""
import dataclasses
import pickle
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    assert_equal_runs, one_torch_thread, start_reference,
)

import _split_targets  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, fl_engine  # noqa: E402
from repro_torch.core import rates_device, scheduling  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.sharding import cells, rules  # noqa: E402
from repro_torch.sharding import vertex as vertex_lib  # noqa: E402

NOISE = 1.6e-14
SHARDS = (2, 3, 4)
# name -> (M, K, T, pool): tests/test_scheduling_edges.py's instance; equal
# gains, where every vertex of every shard ties; C(11, 3) = 165 rows, padded
# for 2 and 4 shards; and a tie across rounds whose winner lies in the
# last shard (round 0's strongest pair) ahead of the first shard's
# (round 1's)
INSTANCES = {"edges": (24, 3, 4, 10), "equal": (12, 3, 4, 8),
             "padded": (24, 3, 4, 11), "cross": (6, 2, 2, 6)}
SCHEDULES = [(name, scorer, n) for name in INSTANCES
             for scorer in ("xla", "pallas") for n in SHARDS]

SAMPLES = 400
M, K, T = 4, 2, 3          # tests/test_fl_scan.py's tiny world
C, S = 3, 2                # C = 3 pads to 4 on 2 shards
SWEEPS = {
    "lazy-gwmin": (dict(), S),
    "age-fair": (dict(scheduler="age-fair"), S),
    "ota": (dict(uplink="ota", compression="none", power_mode="ota-align",
                 ota_noise=1e-9), 1),
}
CPU2 = ["cpu", "cpu"]


def _instance(name):
    m, _, t, _ = INSTANCES[name]
    if name == "equal":
        return np.full((t, m), 1e-6), np.full(m, 1.0 / m)
    if name == "cross":
        gains = np.full((t, m), 1e-7)
        gains[0, 4:] = gains[1, :2] = 2e-6
        return gains, np.full(m, 1.0 / m)
    rng = np.random.default_rng({"edges": 12, "padded": 12}[name])
    gains = np.abs(rng.normal(1e-6, 5e-7, (t, m))) + 1e-8
    return gains, rng.dirichlet(np.ones(m))


def _schedule(name, scorer, shards, backend="jax"):
    _, k, _, pool = INSTANCES[name]
    gains, w = _instance(name)
    return scheduling.lazy_greedy_schedule(
        gains, w, k, noise_power=NOISE, candidate_pool=pool, backend=backend,
        scorer=scorer, shards=shards, device="cpu")


def _cfg(**kw):
    return FLConfig(**{**dict(
        num_devices=M, group_size=K, num_rounds=T, power_mode="max",
        fl_engine="batched", use_pallas=True, horizon="scan", seed=0,
    ), **kw})


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def world():
    ds = make_mnist_like(num_samples=SAMPLES, seed=0)
    return (ds, channel.CellConfig(num_devices=M),
            dirichlet_partition(ds.y_train, M, seed=0))


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """The reference's split schedules and sweeps, in one subprocess on 4
    forced host devices, started with the module's first test."""
    greedy, arrays = [], {}
    for name, scorer, n in SCHEDULES:
        key = f"{name}-{scorer}-{n}"
        arrays["g/" + key], arrays["w/" + key] = _instance(name)
        _, k, _, pool = INSTANCES[name]
        greedy.append(dict(key=key, k=k, pool=pool, backend="jax",
                           scorer=scorer, shards=n, power_mode="max"))
    sweeps = [dict(key=name, kind="cells", num_devices=M, num_samples=SAMPLES,
                   cfg=_fields(_cfg(**kw)), num_cells=C, seeds_per_cell=s,
                   cell_shards=2)
              for name, (kw, s) in SWEEPS.items()]
    job = start_reference(
        tmp_path_factory.mktemp("split"), "split_parts",
        {"greedy": {"runs": greedy, "noise": NOISE}, "sweeps": sweeps},
        arrays, timeout=900)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    out = reference_job()
    assert int(out["device_count"]) == 4
    return out


def _want(reference, prefix):
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


# --------------------------------------------------------------------------
# the vertex split of the device greedy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,scorer,n", SCHEDULES,
                         ids=[f"{a}-{b}-{c}" for a, b, c in SCHEDULES])
def test_split_schedule_equals_the_unsplit_one(name, scorer, n, monkeypatch):
    """n CPU shards give the one-device schedule to the bit (and the host
    backend's), through the split loop, one scorer call per shard a
    step."""
    split_calls = []
    real = rates_device._split_loop

    def spy(*args, **kwargs):
        split_calls.append(len(args[4]))
        return real(*args, **kwargs)

    monkeypatch.setattr(rates_device, "_split_loop", spy)
    got = _schedule(name, scorer, ["cpu"] * n)
    assert split_calls == [n]
    want = _schedule(name, scorer, None)
    assert got.rounds == want.rounds
    assert got.weighted_sum_rate == want.weighted_sum_rate
    host = _schedule(name, scorer, None, backend="numpy")
    assert got.rounds == host.rounds
    m, k, _, _ = INSTANCES[name]
    assert got.validate(m, k)


def test_cross_shard_tie_goes_to_the_earliest_round():
    """``cross``: round 0's pair (4, 5) lies in the last shard and ties
    exactly with round 1's pair (0, 1) in the first; the combine takes the
    smaller t-major index, the earlier round."""
    for n in SHARDS:
        got = _schedule("cross", "xla", ["cpu"] * n)
        assert got.rounds == [(4, 5), (0, 1)]


def test_combine_keeps_the_first_maximum_across_shards():
    """The combine on hand-made shard argmaxes: the largest score wins;
    among shards holding it, the smallest global index (t-major), and the
    winner's ids are gathered from its owner alone."""
    inf = torch.tensor(-torch.inf, dtype=torch.float64)
    v_local, t_cnt = 4, 3

    def part(val, t, v, ids):
        return (torch.tensor(val, dtype=torch.float64),
                torch.tensor(t * v_local + v), torch.tensor(ids))

    # shards 0 and 2 tie on 5.0: shard 2 in round 0 beats shard 0 in round 1
    won = rates_device._combine(
        [part(5.0, 1, 0, [1, 2]), part(4.0, 0, 0, [3, 4]),
         part(5.0, 0, 3, [7, 8])], v_local, t_cnt, torch.device("cpu"))
    assert won.tolist() == [1, 0, 7, 8]
    # within one round, the lower shard (earlier subset) wins the tie
    won = rates_device._combine(
        [part(5.0, 2, 3, [1, 2]), part(5.0, 2, 0, [3, 4])], v_local, t_cnt,
        torch.device("cpu"))
    assert won.tolist() == [1, 2, 1, 2]
    # no feasible vertex on any shard
    won = rates_device._combine(
        [(inf, torch.tensor(0), torch.tensor([9, 9])),
         (inf, torch.tensor(0), torch.tensor([9, 9]))], v_local, t_cnt,
        torch.device("cpu"))
    assert won[0].item() == 0


def test_split_loop_reads_nothing_back(monkeypatch):
    """The split loop turns no tensor into a host value: the CPU's
    stand-in for the card's ``set_sync_debug_mode("error")`` check."""
    want = _schedule("padded", "pallas", None)
    real = rates_device._split_loop
    banned = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
              "__int__")

    def no_reads(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in banned:
                def refuse(*a, _name=name, **k):
                    raise AssertionError(f"Tensor.{_name} inside the split")
                m.setattr(torch.Tensor, name, refuse)
            return real(*args, **kwargs)

    monkeypatch.setattr(rates_device, "_split_loop", no_reads)
    got = _schedule("padded", "pallas", ["cpu"] * 4)
    assert got.rounds == want.rounds


def test_split_scores_each_shard_once_per_step(monkeypatch):
    """With the SIC scorer, every shard calls the kernel's wrapper once a
    greedy step on its (T * V / n, K) slice: n * min(T, M // K) calls."""
    calls = []
    real = rates_device.sic_kernel.sic_weighted_rates

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(rates_device.sic_kernel, "sic_weighted_rates",
                        counting)
    m, k, t, _ = INSTANCES["padded"]
    _schedule("padded", "pallas", ["cpu"] * 4)
    assert calls == [(t * 168 // 4, k)] * (4 * min(t, m // k))


def test_int_shards_clamp_to_one_on_the_cpu(monkeypatch):
    """``shards=4`` clamps to one shard on the CPU (no split loop); the
    reference's range check on the devices of a shard count."""
    monkeypatch.setattr(rates_device, "_split_loop", None)
    assert _schedule("edges", "xla", 4).rounds \
        == _schedule("edges", "xla", None).rounds
    assert vertex_lib.vertex_devices(1, "cpu") == [torch.device("cpu")]
    for bad in (0, 2):
        with pytest.raises(ValueError, match="1 <= shards <= 1"):
            vertex_lib.vertex_devices(bad, "cpu")
    assert vertex_lib.shard_devices(4, "cpu") == [torch.device("cpu")]
    assert vertex_lib.shard_devices(("cpu", "cpu"), "cpu") \
        == [torch.device("cpu")] * 2
    assert vertex_lib.VERTEX_AXIS == "v"


# --------------------------------------------------------------------------
# the cell sweep's split
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweeps(world):
    """Each sweep unsplit and split over two CPU workers, with the split's
    worker launch counts."""
    ds, cell, shards = world
    out = {}
    for name, (kw, s) in SWEEPS.items():
        unsplit = fl.run_cell_sweep(ds, shards, cell, _cfg(**kw), num_cells=C,
                                    seeds_per_cell=s, device="cpu")
        split = fl.run_cell_sweep(ds, shards, cell, _cfg(**kw), num_cells=C,
                                  seeds_per_cell=s, cell_shards=CPU2,
                                  device="cpu")
        out[name] = (unsplit, split, list(cells.last_launches))
    return out


def _assert_identical(got, want):
    assert len(got.logs) == len(want.logs)
    for a, b in zip(got.logs, want.logs):
        assert a.devices == b.devices
        np.testing.assert_array_equal(a.bits, b.bits)
        np.testing.assert_array_equal(a.rates, b.rates)
        np.testing.assert_array_equal(a.compression_ratios,
                                      b.compression_ratios)
        assert a.test_accuracy == b.test_accuracy
        assert a.wall_time_s == b.wall_time_s
    for layer, leaves in want.final_params.items():
        for leaf, v in leaves.items():
            got_v = got.final_params[layer][leaf]
            assert got_v.device == v.device
            assert torch.equal(got_v, v), f"{layer}/{leaf}"


@pytest.mark.parametrize("name", list(SWEEPS))
def test_split_sweep_equals_the_unsplit_sweep(sweeps, name):
    """C = 3 cells (padded to 4) over two workers: every instance's logs,
    accuracies and final parameters equal the unsplit sweep's to the
    bit; each worker reports its launch counts (0 here, where every
    kernel runs its plain version)."""
    unsplit, split, launches = sweeps[name]
    assert len(split) == C and all(len(row) == SWEEPS[name][1]
                                   for row in split)
    for row_u, row_s in zip(unsplit, split):
        for got, want in zip(row_s, row_u):
            _assert_identical(got, want)
    assert len(launches) == 2
    assert all(set(c.values()) == {0} for c in launches)


def test_split_sweep_of_more_shards_than_cells(world):
    """C = 1 on 3 workers: the one cell is repeated twice to fill the
    blocks and the repeats are dropped."""
    ds, cell, shards = world
    got = fl.run_cell_sweep(ds, shards, cell, _cfg(), num_cells=1,
                            seeds_per_cell=1, cell_shards=["cpu"] * 3,
                            device="cpu")
    want = fl.run_federated_learning(ds, shards, cell, _cfg(), device="cpu")
    assert len(got) == 1 and len(got[0]) == 1
    _assert_identical(got[0][0], want)
    assert len(cells.last_launches) == 3


def test_one_shard_runs_in_this_process(world, monkeypatch):
    """``run_horizon_sharded(shards=1)`` is the in-process loop of one
    ``run_horizon`` per instance (the reference's contract): no worker is
    started, and the results are the unsplit sweep's."""
    monkeypatch.setattr(cells, "run_blocks", None)
    monkeypatch.setattr(cells, "Workers", type("NoWorkers", (), {}))
    ds, cell, shards = world
    cfg = _cfg()
    insts = [dataclasses.replace(cfg, seed=s) for s in range(2)]
    bank, ebank = fl._horizon_world(ds, shards, cfg, "cpu")
    plans = [fl._horizon_setup(ds, shards, cell, c, "noma", None,
                               device="cpu") for c in insts]
    params_s, dev, bud, agg, gains, keys, eidx, _ = fl._stack_plans(
        plans, bank, "cpu")
    nb = [max(bank.n_batches_for(g) for g in p.schedule.rounds)
          for p in plans]

    def cs(x):
        return None if x is None else x.reshape(2, 1, *x.shape[1:])

    final, bits, kept, accs = fl_engine.run_horizon_sharded(
        {k: {n: cs(w) for n, w in v.items()} for k, v in params_s.items()},
        cs(dev), cs(bud), cs(agg), cs(gains), cs(keys),
        fl._eval_mask(T, 1), cs(eidx), bank.xb, bank.yb, ebank.xe, ebank.ye,
        shards=1, nb=np.reshape(nb, (2, 1)),
        **fl._horizon_statics(cfg, plans[0].payload, cell, "noma"))
    want = fl.run_cell_sweep(ds, shards, cell, cfg, num_cells=2,
                             device="cpu")
    assert kept is None
    for c in range(2):
        got = fl._assemble_horizon_result(
            plans[c], insts[c], "noma", fl._eval_mask(T, 1), bits[c, 0],
            None, accs[c, 0], {k: {n: w[c, 0] for n, w in v.items()}
                               for k, v in final.items()})
        _assert_identical(got, want[c][0])


def test_split_sweep_keeps_the_mapel_rejection(world):
    """An online policy under MAPEL is refused before any worker starts
    (``FLConfig`` refuses it with ``horizon="scan"``; the sweep refuses a
    per-round config too)."""
    ds, cell, shards = world
    cfg = _cfg(scheduler="age-fair", power_mode="mapel", horizon="per-round")
    with pytest.raises(ValueError, match="cannot use power_mode='mapel'"):
        fl.run_cell_sweep(ds, shards, cell, cfg, num_cells=2,
                          cell_shards=CPU2, device="cpu")


def test_sharded_horizon_needs_cells_a_multiple_of_shards():
    params = {"w": torch.zeros(3, 1, 2)}
    with pytest.raises(ValueError, match="multiple of the 2 shards"):
        fl_engine.run_horizon_sharded(
            params, None, None, None, None, None, None, None, None, None,
            None, None, shards=CPU2, nb=1)


def test_cell_shards_of_an_explicit_device_list():
    assert cells.cell_shards(CPU2, "cpu") == 2
    assert cells.cell_shards(2, "cpu") == 1
    assert cells.shard_devices(None, "cpu") == [torch.device("cpu")]


def test_pad_cut_and_join_blocks():
    """Padding repeats the leading cells cyclically; ``Shard(0)``
    arguments are cut into contiguous blocks and joined back in order,
    ``Replicate()`` ones go whole to every block."""
    x = np.arange(3 * 2).reshape(3, 2)
    padded = cells.pad_cells({"a": x, "b": torch.from_numpy(x)}, 3, 3)
    np.testing.assert_array_equal(padded["a"], x[[0, 1, 2, 0, 1, 2]])
    assert torch.equal(padded["b"], torch.from_numpy(x[[0, 1, 2, 0, 1, 2]]))
    assert cells.pad_cells(None, 3, 1) is None
    shard = rules.cell_sweep_out_specs()[0]
    rep = rules.cell_sweep_in_specs()[6]
    blocks = cells.cut_blocks((padded["a"], "whole", None),
                              (shard, rep, shard), 3)
    assert [b[0].tolist() for b in blocks] == [[[0, 1], [2, 3]],
                                               [[4, 5], [0, 1]],
                                               [[2, 3], [4, 5]]]
    assert all(b[1] == "whole" and b[2] is None for b in blocks)
    joined = cells.join_blocks([(b[0], b[1]) for b in blocks], (shard, rep))
    np.testing.assert_array_equal(joined[0], padded["a"])
    assert joined[1] == "whole"
    with pytest.raises(ValueError, match="do not split"):
        cells.cut_blocks((x,), (shard,), 2)


# --------------------------------------------------------------------------
# the placements and the workers
# --------------------------------------------------------------------------

SPECS = ("cell_sweep_in_specs", "cell_sweep_out_specs",
         "cell_sweep_online_in_specs", "cell_sweep_online_out_specs")


@pytest.mark.parametrize("name", SPECS)
def test_cell_sweep_specs_match_the_references(name):
    """Each argument's placement over the cell axis is the reference's
    ``PartitionSpec``: ``Shard(0)`` where it names ``"cell"`` for the
    leading dim, ``Replicate()`` where it names nothing."""
    pytest.importorskip("jax")
    from torch.distributed.tensor import Replicate, Shard

    from repro.sharding import rules as ref_rules

    got = getattr(rules, name)()
    want = getattr(ref_rules, name)()
    assert len(got) == len(want)
    for p, ref in zip(got, want):
        if tuple(ref) == (rules.CELL_AXIS,):
            assert isinstance(p, Shard) and p.dim == 0
        else:
            assert tuple(ref) == () and isinstance(p, Replicate)
    assert rules.CELL_AXIS == ref_rules.CELL_AXIS


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(shape={rules.CELL_AXIS: 2})
    assert rules.named(mesh, rules.ShardSpec(rules.CELL_AXIS)) \
        == (mesh, (Shard(0),))
    assert rules.named(mesh, rules.ShardSpec()) == (mesh, (Replicate(),))
    assert rules.named(mesh, Shard(0)) == (mesh, (Shard(0),))


def test_workers_answer_in_block_order():
    got = cells.run_blocks(_split_targets.echoes, ["a", "b", "c"],
                           ["cpu"] * 3)
    assert got == [("a", "cpu"), ("b", "cpu"), ("c", "cpu")]
    assert len(cells.last_launches) == 3


def test_started_workers_run_their_blocks_once():
    """Workers started ahead of their blocks (as the split sweep starts
    them before building its plans) take one block each, and report their
    wall seconds."""
    with cells.Workers(CPU2) as workers:
        assert cells.shard_devices(workers, "cpu") == [torch.device("cpu")] * 2
        assert workers.run(_split_targets.echoes, [1, 2]) \
            == [(1, "cpu"), (2, "cpu")]
        with pytest.raises(RuntimeError, match="have run their blocks"):
            workers.run(_split_targets.echoes, [1, 2])
    assert [set(w) for w in cells.last_seconds] \
        == [{"start", "setup", "receive", "run", "exit"}] * 2
    assert not any(p.is_alive() for p in workers.procs)


def test_a_workers_exception_reaches_the_caller():
    """A worker that raises makes the caller raise, with the worker's
    traceback; the other workers are stopped, nothing falls back."""
    with pytest.raises(RuntimeError) as info:
        cells.run_blocks(_split_targets.raises, ["left", "right"], CPU2)
    text = str(info.value)
    assert re.search(r"worker [01] on cpu raised", text)
    assert re.search(r"ValueError: worker refused block '(left|right)'",
                     text)
    assert "Traceback" in text


def test_a_worker_that_dies_makes_the_caller_raise():
    with pytest.raises(RuntimeError, match="died without a result "
                       r"\(exit code 7\)"):
        cells.run_blocks(_split_targets.exits, [7, 7], CPU2)


def test_a_block_that_cannot_be_pickled_raises_at_once():
    """The blocks are pickled in the caller: one that cannot be raises
    there, and the started workers are stopped, nothing waits for them."""
    with pytest.raises((pickle.PicklingError, AttributeError)):
        cells.run_blocks(_split_targets.echoes, [1, lambda: 2], CPU2,
                         timeout=60)


def test_a_silent_worker_times_out():
    with pytest.raises(TimeoutError, match="within 1 s"):
        cells.run_blocks(_split_targets.sleeps, [0.0, 60.0], CPU2, timeout=1)


def test_a_split_sweep_needs_cuda_unless_asked_for_the_cpu(world,
                                                           monkeypatch):
    """Without CUDA the entry point raises unless given device='cpu',
    whatever ``cell_shards`` says."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, cell, shards = world
    for cell_shards in (2, CPU2):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            fl.run_cell_sweep(ds, shards, cell, _cfg(), num_cells=2,
                              cell_shards=cell_shards)


# --------------------------------------------------------------------------
# against the reference's splits (last: its subprocess runs meanwhile)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,scorer,n", SCHEDULES,
                         ids=[f"{a}-{b}-{c}" for a, b, c in SCHEDULES])
def test_split_schedule_matches_the_references_split(reference, name, scorer,
                                                     n):
    """The port's n-shard schedule equals the reference's
    ``lazy_greedy_schedule(backend="jax", shards=n)`` on n of 4 host
    devices exactly."""
    key = f"{name}-{scorer}-{n}"
    _, k, _, _ = INSTANCES[name]
    got = _schedule(name, scorer, ["cpu"] * n)
    rounds = np.full((len(got.rounds), k), -1, np.int64)
    for t, grp in enumerate(got.rounds):
        rounds[t, :len(grp)] = grp
    np.testing.assert_array_equal(rounds, reference["rounds/" + key])
    assert got.weighted_sum_rate == float(reference["wsum/" + key])


@pytest.mark.parametrize("name", list(SWEEPS))
def test_split_sweep_matches_the_references_split(reference, sweeps, name):
    """The port's split sweep against the reference's
    ``run_cell_sweep(cell_shards=2)`` on 2 of 4 host devices."""
    _, split, _ = sweeps[name]
    for c, row in enumerate(split):
        for s, res in enumerate(row):
            assert_equal_runs(res, _want(reference, f"{name}/{c}/{s}/"), T)
