"""The port's device-resident lazy GWMIN greedy against the JAX package.

Two layers:

  * ``repro_torch.core.rates_device`` against ``repro.core.rates_jax``
    in-process, in float32 (the reference runs without x64 here):
    ``sic_rates``, ``batched_weighted_rates``, ``weighted_rates_cmp`` and
    ``greedy_step``.  Scores within rtol 1e-6 (XLA's and PyTorch's float32
    ``log2`` differ by an ulp on a few rows; observed maximum 2.2e-7);
    argmax vertices, ids and masks exactly.
  * ``repro_torch.core.scheduling.lazy_greedy_schedule`` for every backend
    (numpy / jax / jax-stepwise), scorer (xla / pallas) and shard count,
    on the CPU, against the reference's through the shimmed subprocess of
    test_torch_harness (its device greedy needs ``enable_x64``): rounds and
    weighted sum rate exactly equal, and equal to the numpy backend's.
    The instances are tests/test_scheduling_edges.py's.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from test_torch_harness import one_torch_thread, run_reference  # noqa: E402,F401

from repro.core import rates_jax  # noqa: E402

from repro_torch.core import rates_device, scheduling  # noqa: E402
from repro_torch.kernels import sic_rates as sic_kernel  # noqa: E402
from repro_torch.sharding import vertex as vertex_lib  # noqa: E402

NOISE = 1.6e-14
PMAX = 0.01
SCORE_RTOL = 1e-6


def _instance(m, t, seed):
    """tests/test_scheduling_edges.py:_instance; ``seed=None`` gives equal
    gains and weights, where every subset ties."""
    if seed is None:
        return np.full((t, m), 1e-6), np.full(m, 1.0 / m)
    rng = np.random.default_rng(seed)
    gains = np.abs(rng.normal(1e-6, 5e-7, (t, m))) + 1e-8
    w = rng.dirichlet(np.ones(m))
    return gains, w


# ---------------------------------------------------------------------------
# rates_device vs rates_jax, float32, in-process
# ---------------------------------------------------------------------------

def _f32_batch(shape, seed):
    rng = np.random.default_rng(seed)
    g = (np.abs(rng.normal(1e-6, 5e-7, shape)) + 1e-8).astype(np.float32)
    p = rng.uniform(0.0, PMAX, shape).astype(np.float32)
    w = rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)
    p[..., 1] = p[..., 0]       # a tie in receive power in every group
    g[..., 1] = g[..., 0]
    return p, g, w


@pytest.mark.parametrize("shape", [(600, 3), (4, 50, 2), (2, 7, 8)])
@pytest.mark.parametrize("fn", ["sic_rates", "batched_weighted_rates",
                                "weighted_rates_cmp"])
def test_rates_match_reference_float32(fn, shape):
    p, g, w = _f32_batch(shape, seed=len(shape) * 100 + shape[-1])
    if fn == "sic_rates":
        want = rates_jax.sic_rates(jnp.asarray(p), jnp.asarray(g), NOISE)
        got = rates_device.sic_rates(torch.from_numpy(p), torch.from_numpy(g),
                                     NOISE)
    else:
        args = (p, g, w)
        want = getattr(rates_jax, fn)(*map(jnp.asarray, args), NOISE)
        got = getattr(rates_device, fn)(*map(torch.from_numpy, args), NOISE)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SCORE_RTOL, atol=0)


def _step_inputs(m, t, pool, seed, k):
    gains, w = _instance(m, t, seed)
    gains, w = gains.astype(np.float32), w.astype(np.float32)
    solo = (w * np.log2(1.0 + (PMAX * gains**2) / NOISE)).astype(np.float32)
    subs = np.array(list(itertools.combinations(range(pool), k)), np.int32)
    rng = np.random.default_rng(seed + 1)
    avail = rng.uniform(size=m) > 0.3          # a mid-schedule state
    done = np.zeros(t, bool)
    done[0] = True
    return gains, w, solo, subs, avail, done


@pytest.mark.parametrize("m,t,pool,k,seed", [
    (20, 4, 8, 3, 0),        # M > pool: proxy-ranked pools
    (6, 3, 16, 2, 1),        # pool > M: clamped, out-of-pool subsets masked
])
def test_greedy_step_matches_reference_float32(m, t, pool, k, seed):
    gains, w, solo, subs, avail, done = _step_inputs(m, t, pool, seed, k)
    want = rates_jax.greedy_step(
        *map(jnp.asarray, (gains, w, solo, subs, avail, done)),
        pool=pool, pmax=PMAX, noise_power=NOISE)
    got = rates_device.greedy_step(
        *map(torch.from_numpy, (gains, w, solo, subs, avail, done)),
        pool=pool, pmax=PMAX, noise_power=NOISE)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=SCORE_RTOL)
    assert int(got[1]) == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_infeasible_step_leaves_the_masks_unchanged():
    """No device left: the step scores -inf, its ids hold the sentinel M,
    and neither mask moves (no out-of-range scatter)."""
    gains, w, solo, subs, _, done = _step_inputs(10, 3, 4, 2, 2)
    avail = np.zeros(10, bool)
    val, _, ids, avail_new, done_new = rates_device.greedy_step(
        *map(torch.from_numpy, (gains, w, solo, subs, avail, done)),
        pool=4, pmax=PMAX, noise_power=NOISE)
    assert val.item() == -np.inf and int(ids.max()) == 10
    np.testing.assert_array_equal(avail_new.numpy(), avail)
    np.testing.assert_array_equal(done_new.numpy(), done)


# ---------------------------------------------------------------------------
# whole schedules vs the reference, every backend / scorer / shard count
# ---------------------------------------------------------------------------

EDGE_GRID = [
    (8, 2, 3, 24, 0),      # pool >= M: full enumeration
    (12, 3, 3, 24, 1),
    (32, 3, 4, 24, 2),     # proxy-ranked pool (M > pool)
    (24, 3, 4, 8, 3),
    (32, 2, 5, 8, 4),
    (5, 2, 4, 24, 5),      # T*K > M: host tail path for leftover groups
    (30, 3, 11, 8, 6),     # T*K > M with proxy pool
    (10, 3, 3, 2, 7),      # pool < K: groups shrink to the pool size
    (20, 3, 4, 12, 9),
    (7, 2, 3, 100, 2),     # pool > M: the full-cell enumeration
    (12, 3, 4, 8, None),   # equal gains: first maximum wins everywhere
]
PALLAS_GRID = [
    (20, 3, 4, 12, 9),
    (32, 2, 5, 8, 4),
    (5, 2, 4, 24, 5),      # T*K > M tail after the fused loop
    (10, 3, 3, 2, 7),
    (12, 3, 4, 8, None),
]
RUNS = (
    [(inst, b, "xla", None, "max") for b in ("numpy", "jax", "jax-stepwise")
     for inst in EDGE_GRID]
    + [(inst, "jax", "pallas", None, "max") for inst in PALLAS_GRID]
    + [((24, 3, 4, 10, 12), "jax", "xla", shards, "max")
       for shards in (1, 4)]
    + [((10, 2, 3, 24, 11), b, "xla", None, "mapel")
       for b in ("numpy", "jax", "jax-stepwise")]
)


def _key(run):
    (m, k, t, pool, seed), backend, scorer, shards, power = run
    return f"M{m}_K{k}_T{t}_p{pool}_s{seed}_{backend}_{scorer}_{shards}_{power}"


def _port_schedule(run):
    (m, k, t, pool, seed), backend, scorer, shards, power = run
    gains, w = _instance(m, t, seed)
    return scheduling.lazy_greedy_schedule(
        gains, w, k, power_mode=power, noise_power=NOISE,
        candidate_pool=pool, backend=backend, scorer=scorer, shards=shards,
        device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every run of RUNS through the reference, in one subprocess."""
    runs, arrays = [], {}
    for run in RUNS:
        (m, k, t, pool, seed), backend, scorer, shards, power = run
        key = _key(run)
        arrays["g/" + key], arrays["w/" + key] = _instance(m, t, seed)
        runs.append(dict(key=key, k=k, pool=pool, backend=backend,
                         scorer=scorer, shards=shards, power_mode=power))
    return run_reference(tmp_path_factory.mktemp("greedy"), "lazy_greedy",
                         {"runs": runs, "noise": NOISE}, arrays)


def _rounds_array(sched, k):
    out = np.full((len(sched.rounds), k), -1, np.int64)
    for t, grp in enumerate(sched.rounds):
        out[t, :len(grp)] = grp
    return out


@pytest.mark.parametrize("run", RUNS, ids=[_key(r) for r in RUNS])
def test_schedule_matches_reference(reference, run):
    key = _key(run)
    k = run[0][1]
    got = _port_schedule(run)
    np.testing.assert_array_equal(_rounds_array(got, k),
                                  reference["rounds/" + key])
    assert got.weighted_sum_rate == float(reference["wsum/" + key])
    host = _port_schedule((run[0], "numpy", "xla", None, run[4]))
    assert got.rounds == host.rounds
    assert got.weighted_sum_rate == host.weighted_sum_rate
    assert got.validate(run[0][0], k)


def test_padded_vertex_shards_give_the_unsharded_schedule(monkeypatch):
    """With four cards the enumeration (C(11, 3) = 165 rows) is padded to
    168 with sentinel rows; they are masked and the schedule is the
    unsharded one."""
    monkeypatch.setattr(vertex_lib, "max_vertex_shards", lambda device: 4)
    run = ((24, 3, 4, 11, 12), "jax", "xla", 4, "max")
    assert vertex_lib.pad_rows_to_multiple(165, 4) == 3
    a = _port_schedule(run)
    b = _port_schedule((run[0], "numpy", "xla", None, "max"))
    assert a.rounds == b.rounds
    assert a.weighted_sum_rate == b.weighted_sum_rate


def test_max_vertex_shards_on_the_cpu():
    assert vertex_lib.max_vertex_shards("cpu") == 1
    assert vertex_lib.pad_rows_to_multiple(8, 3) == 1
    assert vertex_lib.pad_rows_to_multiple(9, 3) == 0


def test_fused_loop_scores_once_per_greedy_step(monkeypatch):
    """The pallas scorer is called exactly min(T, M // K) times: one SIC
    launch per greedy step on the card."""
    calls = []
    real = sic_kernel.sic_weighted_rates

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(sic_kernel, "sic_weighted_rates", counting)
    m, k, t, pool = 20, 3, 4, 12
    run = ((m, k, t, pool, 9), "jax", "pallas", None, "max")
    _port_schedule(run)
    v = len(list(itertools.combinations(range(pool), k)))
    assert calls == [(t * v, k)] * min(t, m // k)


def test_device_backends_default_to_cuda(monkeypatch):
    """Without CUDA a device backend raises unless given device='cpu'; the
    host backend needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gains, w = _instance(8, 3, 0)
    for backend in ("jax", "jax-stepwise"):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            scheduling.lazy_greedy_schedule(gains, w, 2, noise_power=NOISE,
                                            backend=backend)
        cfg = scheduling.PolicyConfig(group_size=2, noise_power=NOISE,
                                      backend=backend)
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            scheduling.build_schedule(scheduling.get_policy("lazy-gwmin"),
                                      gains, w, cfg)
    scheduling.lazy_greedy_schedule(gains, w, 2, noise_power=NOISE)


def test_policy_config_carries_scorer_shards_and_device():
    gains, w = _instance(20, 4, 9)
    cfg = scheduling.PolicyConfig(group_size=3, noise_power=NOISE,
                                  candidate_pool=12, backend="jax",
                                  scorer="pallas", shards=4, device="cpu")
    a = scheduling.build_schedule(scheduling.get_policy("lazy-gwmin"),
                                  gains, w, cfg)
    b = scheduling.lazy_greedy_schedule(gains, w, 3, noise_power=NOISE,
                                        candidate_pool=12)
    assert a.rounds == b.rounds


def test_unknown_scorer_and_backend_raise():
    gains, w = _instance(6, 2, 0)
    with pytest.raises(ValueError, match="scorer"):
        scheduling.lazy_greedy_schedule(gains, w, 2, noise_power=NOISE,
                                        backend="jax", scorer="cuda",
                                        device="cpu")
    with pytest.raises(ValueError, match="backend"):
        scheduling.lazy_greedy_schedule(gains, w, 2, noise_power=NOISE,
                                        backend="tpu-v9", device="cpu")
