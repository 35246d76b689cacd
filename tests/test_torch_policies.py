"""The port's other precomputed policies and test oracles against the JAX
package, exactly.

In-process (``repro.core.scheduling`` and ``repro.core.power`` import
here): the explicit scheduling graph and GWMIN, the literal Algorithm 2,
the random, round-robin and proportional-fair baselines (``by_gain`` both
ways), the brute-force schedule and the power grid oracle must equal the
reference's to the bit: rounds, powers, rates and weighted sum rate, the
T*K > M edges of tests/test_scheduling_edges.py included.  They are float64
numpy and Python on the host in both packages, so nothing but exact
equality is a parity.

Whole batched runs with the ``random``, ``proportional-fair`` and
``literal-gwmin`` schedulers (M=12) go through one shimmed subprocess of
test_torch_harness, under tests/test_fl_engine.py:_assert_equal_runs
(schedules, bits, rates, ratios and times exact; accuracy within 0.02;
parameter drift mean < 1e-6, max < 2e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.numpy")

from test_torch_harness import (  # noqa: E402,F401
    assert_equal_runs, one_torch_thread, run_reference, tree,
)

from repro.core import power as ref_power  # noqa: E402
from repro.core import scheduling as ref_sched  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, power, scheduling  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402

NOISE = 1.6e-14
PMAX = 0.01
PRECOMPUTED = ("lazy-gwmin", "literal-gwmin", "random", "round-robin",
               "proportional-fair")
# tests/test_scheduling_edges.py's T*K > M horizons (M, T, K)
EDGES = [(5, 4, 2), (4, 3, 2), (6, 8, 1)]
INSTANCES = [(5, 2, 2, 0), (6, 2, 2, 1), (7, 3, 2, 2), (6, 3, 1, 3)]


def _instance(m, t, seed):
    rng = np.random.default_rng(seed)
    gains = np.abs(rng.normal(1e-6, 5e-7, (t, m))) + 1e-8
    w = rng.dirichlet(np.ones(m))
    return gains, w


def _same_schedule(got, want):
    assert got.rounds == want.rounds
    assert len(got.powers) == len(want.powers)
    for pa, pb in zip(got.powers, want.powers):
        np.testing.assert_array_equal(pa, pb)
    for ra, rb in zip(got.rates, want.rates):
        np.testing.assert_array_equal(ra, rb)
    assert got.weighted_sum_rate == want.weighted_sum_rate
    assert got.method == want.method
    assert got.allow_revisits == want.allow_revisits


def _max_power(gg, ww):
    return np.full(len(gg), PMAX)


# --------------------------------------------------------------------------
# The explicit graph and GWMIN
# --------------------------------------------------------------------------

def test_graph_matches_reference_on_paper_example():
    """tests/test_scheduling.py's paper Fig. 4 example: M=4, K=1, T=2 gives
    8 vertices; same-round and same-device vertices are connected."""
    gains, w = _instance(4, 2, 0)
    got = scheduling.build_scheduling_graph(gains, w, 1, _max_power, NOISE)
    want = ref_sched.build_scheduling_graph(gains, w, 1, _max_power, NOISE)
    assert got.vertices == want.vertices and len(got.vertices) == 8
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.adjacency == want.adjacency
    idx = {v: i for i, v in enumerate(got.vertices)}
    neigh = {got.vertices[j] for j in got.adjacency[idx[((0,), 0)]]}
    assert {((1,), 0), ((2,), 0), ((3,), 0), ((0,), 1)} <= neigh
    assert ((2,), 1) not in neigh
    assert got.degree(idx[((0,), 0)]) == want.degree(idx[((0,), 0)]) == 4


@pytest.mark.parametrize("power_mode", ["max", "mapel"])
@pytest.mark.parametrize("m,t,k,seed", INSTANCES)
def test_graph_and_gwmin_match_reference(m, t, k, seed, power_mode):
    """Weights from the power allocator, and GWMIN's picks in the
    reference's order (its ``max`` breaks ties by set iteration order)."""
    gains, w = _instance(m, t, seed)
    fn = power.make_power_allocator(power_mode, PMAX, NOISE)
    ref_fn = ref_power.make_power_allocator(power_mode, PMAX, NOISE)
    got = scheduling.build_scheduling_graph(gains, w, k, fn, NOISE)
    want = ref_sched.build_scheduling_graph(gains, w, k, ref_fn, NOISE)
    assert got.vertices == want.vertices
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.adjacency == want.adjacency
    assert scheduling.gwmin_mwis(got) == ref_sched.gwmin_mwis(want)


def test_gwmin_breaks_ties_as_the_reference():
    """Equal weights everywhere: every vertex ties, and the pick is decided
    by the order in which Q was filled from the alive set."""
    gains = np.full((2, 5), 1e-6)
    w = np.full(5, 0.2)
    got = scheduling.build_scheduling_graph(gains, w, 2, _max_power, NOISE)
    want = ref_sched.build_scheduling_graph(gains, w, 2, _max_power, NOISE)
    assert len(set(got.weights.tolist())) == 1
    assert scheduling.gwmin_mwis(got) == ref_sched.gwmin_mwis(want)


# --------------------------------------------------------------------------
# Schedules: literal Algorithm 2, the baselines and the oracle
# --------------------------------------------------------------------------

def _both(name, gains, w, k, *, power_mode="max", seed=0, by_gain=False):
    """(port, reference) schedules of one scheduler function."""
    kw = dict(power_mode=power_mode, pmax=PMAX, noise_power=NOISE)
    if name == "literal-gwmin":
        return (scheduling.literal_graph_schedule(gains, w, k, **kw),
                ref_sched.literal_graph_schedule(gains, w, k, **kw))
    if name == "random":
        return (scheduling.random_schedule(np.random.default_rng(seed),
                                           gains, w, k, **kw),
                ref_sched.random_schedule(np.random.default_rng(seed),
                                          gains, w, k, **kw))
    if name == "round-robin":
        return (scheduling.round_robin_schedule(gains, w, k, **kw),
                ref_sched.round_robin_schedule(gains, w, k, **kw))
    if name == "proportional-fair":
        return (scheduling.proportional_fair_schedule(
                    gains, w, k, by_gain=by_gain, **kw),
                ref_sched.proportional_fair_schedule(
                    gains, w, k, by_gain=by_gain, **kw))
    if name == "brute-force":
        return (scheduling.brute_force_schedule(gains, w, k, **kw),
                ref_sched.brute_force_schedule(gains, w, k, **kw))
    raise ValueError(name)


@pytest.mark.parametrize("power_mode", ["max", "mapel"])
@pytest.mark.parametrize("m,t,k,seed", INSTANCES)
@pytest.mark.parametrize("name", ["literal-gwmin", "random", "round-robin",
                                  "proportional-fair", "brute-force"])
def test_schedule_matches_reference(name, m, t, k, seed, power_mode):
    gains, w = _instance(m, t, seed)
    got, want = _both(name, gains, w, k, power_mode=power_mode, seed=seed)
    _same_schedule(got, want)
    assert got.validate(m, k)


@pytest.mark.parametrize("m,t,k", EDGES)
@pytest.mark.parametrize("name", ["literal-gwmin", "random", "round-robin",
                                  "proportional-fair"])
def test_schedule_matches_reference_when_tk_exceeds_m(name, m, t, k):
    """The horizon exhausts the device set: the same empty tail groups."""
    gains, w = _instance(m, t, seed=3)
    got, want = _both(name, gains, w, k)
    _same_schedule(got, want)
    assert sum(len(grp) for grp in got.rounds) <= m


@pytest.mark.parametrize("by_gain", [False, True])
@pytest.mark.parametrize("m,t,k,seed", INSTANCES + [(m, t, k, 3)
                                                     for m, t, k in EDGES])
def test_proportional_fair_by_gain_matches_reference(m, t, k, seed, by_gain):
    gains, w = _instance(m, t, seed)
    got, want = _both("proportional-fair", gains, w, k, by_gain=by_gain)
    _same_schedule(got, want)


@pytest.mark.parametrize("by_gain", [False, True])
def test_proportional_fair_ties_sort_as_the_reference(by_gain):
    """Equal gains and weights: the default ranking's stable sort keeps the
    lower id, ``by_gain`` keeps numpy's default (unstable) order."""
    gains = np.full((3, 20), 1e-6)
    gains[1, 7] = 2e-6
    w = np.full(20, 0.05)
    got, want = _both("proportional-fair", gains, w, 3, by_gain=by_gain)
    _same_schedule(got, want)
    if not by_gain:
        assert got.rounds[0] == (0, 1, 2)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_oracle_matches_reference(k, seed):
    rng = np.random.default_rng(seed)
    gains = np.abs(rng.normal(1e-6, 5e-7, k)) + 1e-8
    w = rng.dirichlet(np.ones(k))
    got = power.grid_oracle(gains, w, PMAX, NOISE, points=15)
    want = ref_power.grid_oracle(gains, w, PMAX, NOISE, points=15)
    np.testing.assert_array_equal(got.powers, want.powers)
    assert got.weighted_rate == want.weighted_rate
    assert (got.iterations, got.gap) == (want.iterations, want.gap) \
        == (15 ** k, 0.0)


# --------------------------------------------------------------------------
# The registry
# --------------------------------------------------------------------------

def test_registry_holds_every_precomputed_policy_of_the_reference():
    """The registry is the reference's, the online policies (item 5, held
    by tests/test_torch_online.py) included."""
    ref_names = set(ref_sched.available_policies())
    online = {name for name in ref_names if ref_sched.policy_is_online(name)}
    assert set(scheduling.available_policies()) == ref_names
    assert set(PRECOMPUTED) == ref_names - online
    assert scheduling.RandomPolicy.SEED_OFFSET \
        == ref_sched.RandomPolicy.SEED_OFFSET == 17


@pytest.mark.parametrize("power_mode", ["max", "mapel"])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", PRECOMPUTED)
def test_build_schedule_through_the_registry_matches_reference(
        name, seed, power_mode):
    gains, w = _instance(7, 3, seed)
    kw = dict(group_size=2, power_mode=power_mode, pmax=PMAX,
              noise_power=NOISE, seed=seed)
    got = scheduling.build_schedule(
        scheduling.get_policy(name), gains, w,
        scheduling.PolicyConfig(**kw, device="cpu"))
    want = ref_sched.build_schedule(
        ref_sched.get_policy(name), gains, w, ref_sched.PolicyConfig(**kw))
    _same_schedule(got, want)


def test_random_policy_seeds_its_own_generator():
    """``RandomPolicy`` draws ``default_rng(seed + 17).permutation(M)``."""
    gains, w = _instance(9, 3, 4)
    cfg = scheduling.PolicyConfig(group_size=3, pmax=PMAX, noise_power=NOISE,
                                  seed=4)
    got = scheduling.build_schedule(scheduling.get_policy("random"), gains,
                                    w, cfg)
    direct = scheduling.random_schedule(np.random.default_rng(4 + 17), gains,
                                        w, 3, pmax=PMAX, noise_power=NOISE)
    _same_schedule(got, direct)


def test_proportional_fair_by_gain_through_the_registry():
    gains, w = _instance(8, 3, 6)
    cfg = scheduling.PolicyConfig(group_size=2, pmax=PMAX, noise_power=NOISE)
    got = scheduling.build_schedule(
        scheduling.get_policy("proportional-fair", by_gain=True), gains, w,
        cfg)
    want = ref_sched.build_schedule(
        ref_sched.get_policy("proportional-fair", by_gain=True), gains, w,
        ref_sched.PolicyConfig(group_size=2, pmax=PMAX, noise_power=NOISE))
    _same_schedule(got, want)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------

WORLD = dict(m=12, samples=800, k=3, t=3)
RUNS = {
    "random": dict(scheduler="random", power_mode="mapel"),
    "proportional-fair": dict(scheduler="proportional-fair",
                              power_mode="max"),
    "literal-gwmin": dict(scheduler="literal-gwmin", power_mode="max"),
}


def _cfg_args(key):
    return {**dict(num_devices=WORLD["m"], group_size=WORLD["k"],
                   num_rounds=WORLD["t"], fl_engine="batched",
                   use_pallas=True, seed=0), **RUNS[key]}


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("policies"), "fl_runs", {
        "runs": [dict(key=key, num_devices=WORLD["m"],
                      num_samples=WORLD["samples"], cfg=_cfg_args(key))
                 for key in RUNS]})


@pytest.mark.parametrize("key", list(RUNS))
def test_policy_run_matches_reference(reference_runs, key):
    want = {name[len(key) + 1:]: v for name, v in reference_runs.items()
            if name.startswith(key + "/")}
    ds = make_mnist_like(num_samples=WORLD["samples"], seed=0)
    cell = channel.CellConfig(num_devices=WORLD["m"])
    shards = dirichlet_partition(ds.y_train, WORLD["m"], seed=0)
    bundle = channel.ChannelBundle(
        want["distances"], want["gains"], want["dl_gains"])
    got = fl.run_federated_learning(
        ds, shards, cell, FLConfig(**_cfg_args(key)), channels=bundle,
        init_params=tree(want, "init/"), device="cpu",
    )
    assert_equal_runs(got, want, WORLD["t"])
