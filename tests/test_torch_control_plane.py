"""The port's host control plane and codec against the JAX package, exactly.

Channels, rates, MAPEL, the lazy-GWMIN schedule, the downlink time, the
adaptive bit-widths and ratios, the DoReFa codes, the client bank and the
synthetic data must all equal the reference bit for bit (the reference pins
them exactly: tests/test_fl_engine.py:_assert_equal_runs).  That includes
``large_scale_gain``: the port calls the C library's ``powf``, which is
what XLA's float32 ``pow`` calls on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import channel as ref_channel  # noqa: E402
from repro.core import power as ref_power  # noqa: E402
from repro.core import quantization as ref_q  # noqa: E402
from repro.core import rates as ref_rates  # noqa: E402
from repro.core import scheduling as ref_sched  # noqa: E402
from repro.data import client_bank as ref_bank  # noqa: E402
from repro.data import dirichlet_partition as ref_partition  # noqa: E402
from repro.data import make_mnist_like as ref_mnist  # noqa: E402

from repro_torch.core import channel, power, quantization, rates, scheduling  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ClientBank, dirichlet_partition, eval_sample_plan, make_mnist_like,
)

CELL = channel.CellConfig(num_devices=24)
REF_CELL = ref_channel.CellConfig(num_devices=24)
PAYLOAD = 266_610 * 32      # LeNet-300-100's full-precision payload bits


def _gains(t, m, seed):
    """(T, M) float32 gains at the paper cell's scale (numpy draws)."""
    rng = np.random.default_rng(seed)
    dist = np.maximum(500 * np.sqrt(rng.uniform(size=m)), 10).astype(np.float32)
    ls = channel.large_scale_gain(dist, CELL)
    fade = np.sqrt(rng.standard_normal((t, m)) ** 2 * 0.5
                   + rng.standard_normal((t, m)) ** 2 * 0.5)
    return (ls[None, :] * fade.astype(np.float32)).astype(np.float32), dist


def _weights(m, seed):
    sizes = np.random.default_rng(seed).integers(8, 80, m).astype(np.float64)
    return sizes / sizes.sum()


def test_cell_config_matches():
    assert channel.CellConfig() == channel.CellConfig(
        **{f: getattr(ref_channel.CellConfig(), f)
           for f in ref_channel.CellConfig.__dataclass_fields__}
    )
    assert CELL.noise_power_w == REF_CELL.noise_power_w
    assert CELL.wavelength_m == REF_CELL.wavelength_m


def test_large_scale_gain_and_downlink_time():
    rng = np.random.default_rng(0)
    dist = np.maximum(500 * np.sqrt(rng.uniform(size=5000)), 10).astype(np.float32)
    ref = np.asarray(ref_channel.large_scale_gain(jnp.asarray(dist), REF_CELL))
    got = channel.large_scale_gain(dist, CELL)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # the downlink time from the same gains: exact (float64 on the host)
    assert channel.downlink_time_seconds(PAYLOAD, ref, CELL) == \
        ref_channel.downlink_time_seconds(PAYLOAD, ref, REF_CELL)
    with pytest.raises(ValueError, match="zero downlink SNR"):
        channel.downlink_time_seconds(PAYLOAD, np.zeros(3, np.float32), CELL)


def test_sampled_channels_shapes_and_determinism():
    a = channel.sample_channels(3, CELL, 4)
    b = channel.sample_channels(3, CELL, 4)
    assert a.gains.shape == (4, 24) and a.gains.dtype == np.float32
    assert a.distances.dtype == a.dl_gains.dtype == np.float32
    assert np.all(a.distances >= CELL.min_distance_m)
    assert np.all(a.distances <= CELL.cell_radius_m)
    np.testing.assert_array_equal(a.gains, b.gains)
    np.testing.assert_array_equal(a.dl_gains,
                                  channel.large_scale_gain(a.distances, CELL))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sic_rates_exact(k):
    rng = np.random.default_rng(k)
    p = rng.uniform(0, 0.01, (50, k))
    g = rng.uniform(1e-6, 1e-4, (50, k)).astype(np.float32)
    g[0, :] = g[0, 0]                   # receive-power ties: stable order
    w = rng.dirichlet(np.ones(k), 50)
    nz = CELL.noise_power_w
    np.testing.assert_array_equal(rates.sic_rates(p, g, nz),
                                  ref_rates.sic_rates(p, g, nz))
    np.testing.assert_array_equal(rates.batched_weighted_rates(p, g, w, nz),
                                  ref_rates.batched_weighted_rates(p, g, w, nz))
    assert rates.weighted_rate(p[1], g[1], w[1], nz) == \
        ref_rates.weighted_rate(p[1], g[1], w[1], nz)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_mapel_exact(k):
    gains, _ = _gains(6, k, seed=10 + k)
    w = np.random.default_rng(k).dirichlet(np.ones(k), 6)
    nz, pmax = CELL.noise_power_w, CELL.max_power_w
    for row in range(3):
        a = power.mapel(gains[row], w[row], pmax, nz)
        b = ref_power.mapel(gains[row], w[row], pmax, nz)
        np.testing.assert_array_equal(a.powers, b.powers)
        assert (a.weighted_rate, a.iterations, a.gap) == \
            (b.weighted_rate, b.iterations, b.gap)
    a = power.mapel_batched(gains, w, pmax, nz)
    b = ref_power.mapel_batched(gains, w, pmax, nz)
    for field in ("powers", "weighted_rates", "iterations", "gaps"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    alloc = power.make_power_allocator("mapel", pmax, nz)
    np.testing.assert_array_equal(
        alloc.solve_batched(gains, w),
        ref_power.make_power_allocator("mapel", pmax, nz).solve_batched(gains, w))
    np.testing.assert_array_equal(power.max_power(gains[0], pmax),
                                  ref_power.max_power(gains[0], pmax))


def _assert_same_schedule(a, b):
    assert a.rounds == b.rounds
    for pa, pb in zip(a.powers, b.powers):
        np.testing.assert_array_equal(pa, pb)
    for ra, rb in zip(a.rates, b.rates):
        np.testing.assert_array_equal(ra, rb)
    assert a.weighted_sum_rate == b.weighted_sum_rate
    assert a.method == b.method


@pytest.mark.parametrize("power_mode", ["max", "mapel"])
@pytest.mark.parametrize("t,m,k,pool", [
    (5, 24, 3, 24), (4, 30, 3, 8), (5, 7, 2, 24), (3, 4, 2, 24),
])
def test_lazy_gwmin_schedule_exact(power_mode, t, m, k, pool):
    """Paper-scale pools and T*K > M tails (the last two cases)."""
    gains, _ = _gains(t, m, seed=m * 10 + t)
    w = _weights(m, seed=m)
    kw = dict(power_mode=power_mode, pmax=CELL.max_power_w,
              noise_power=CELL.noise_power_w, candidate_pool=pool)
    _assert_same_schedule(
        scheduling.lazy_greedy_schedule(gains, w, k, **kw),
        ref_sched.lazy_greedy_schedule(gains, w, k, **kw),
    )


@pytest.mark.parametrize("name", ["lazy-gwmin", "round-robin"])
@pytest.mark.parametrize("power_mode", ["max", "mapel"])
def test_registry_build_schedule_exact(name, power_mode):
    """Through the registry with a PolicyConfig, T*K > M so round-robin
    ends in an empty tail."""
    gains, _ = _gains(5, 7, seed=1)
    w = _weights(7, seed=2)
    args = dict(group_size=2, power_mode=power_mode, pmax=CELL.max_power_w,
                noise_power=CELL.noise_power_w)
    a = scheduling.build_schedule(scheduling.get_policy(name), gains, w,
                                  scheduling.PolicyConfig(**args))
    b = ref_sched.build_schedule(ref_sched.get_policy(name), gains, w,
                                 ref_sched.PolicyConfig(**args))
    _assert_same_schedule(a, b)
    assert a.allow_revisits == b.allow_revisits
    if name == "round-robin":
        assert a.rounds[-1] == ()


def test_schedule_validation_messages():
    bad = scheduling.Schedule([(0, 1), (1, 2)], [None] * 2, [None] * 2, 0.0, "x")
    with pytest.raises(ValueError, match="C1 violated"):
        bad.validate(4, 2)
    with pytest.raises(ValueError, match="at most K=2 distinct"):
        scheduling.validate_group((0, 0), 4, 2)
    with pytest.raises(ValueError, match="unknown scheduler"):
        scheduling.get_policy("nope")


def test_adaptive_bits_and_ratios_exact():
    """Float32 like the reference's batched engine, over budgets from zero
    to far above the payload (every bit-width 1..32 occurs)."""
    budgets = np.concatenate([
        [0.0, 1e-12, 1.0, PAYLOAD / 32.0, PAYLOAD - 1.0, PAYLOAD, 2.0 * PAYLOAD],
        np.geomspace(1e3, 1e9, 400),
        PAYLOAD / np.arange(1, 40) * (1 + 1e-7),
    ])
    want_bits = np.asarray(ref_q.adaptive_bits(PAYLOAD, jnp.asarray(budgets)))
    want_ratio = np.asarray(ref_q.compression_ratio(PAYLOAD, jnp.asarray(budgets)))
    b32 = torch.as_tensor(budgets).to(torch.float32)
    got_bits = quantization.adaptive_bits(PAYLOAD, b32).numpy()
    got_ratio = quantization.compression_ratio(PAYLOAD, b32).numpy()
    assert got_bits.dtype == want_bits.dtype == np.int32
    np.testing.assert_array_equal(got_bits, want_bits)
    np.testing.assert_array_equal(got_ratio, want_ratio)
    assert set(got_bits.tolist()) == set(range(1, 33))


def test_dorefa_levels_exact():
    bits = np.arange(0, 41, dtype=np.int32)
    np.testing.assert_array_equal(
        quantization.dorefa_levels(torch.from_numpy(bits)).numpy(),
        np.asarray(ref_q.dorefa_levels(jnp.asarray(bits))),
    )


@pytest.mark.parametrize("paper_exact", [False, True])
def test_quantize_codes_batched_exact(paper_exact):
    rng = np.random.default_rng(9)
    flat = (rng.standard_normal((5, 3001)) * 0.05).astype(np.float32)
    flat[3] = 0.0                      # all-zero row: scale floor 1e-12
    bits = np.array([1, 4, 16, 32, 7], np.int32)
    ones = np.ones(5, np.float32)
    want = ref_q.quantize_codes_batched(
        jnp.asarray(flat), jnp.asarray(bits),
        scales=jnp.asarray(ones) if paper_exact else None,
    )
    got = quantization.quantize_codes_batched(
        torch.from_numpy(flat), torch.from_numpy(bits),
        scales=torch.from_numpy(ones) if paper_exact else None,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_data_and_partition_bit_exact():
    a, b = make_mnist_like(num_samples=600, seed=3), ref_mnist(num_samples=600, seed=3)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    sa = dirichlet_partition(a.y_train, 13, seed=4)
    sb = ref_partition(b.y_train, 13, seed=4)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)


def test_client_bank_matches_reference():
    ds = make_mnist_like(num_samples=500, seed=1)
    shards = dirichlet_partition(ds.y_train, 9, seed=1)
    got = ClientBank.build(ds.x_train, ds.y_train, shards, 10, device="cpu")
    want = ref_bank.ClientBank.build(ds.x_train, ds.y_train, shards, 10)
    np.testing.assert_array_equal(got.xb.numpy(), np.asarray(want.xb))
    np.testing.assert_array_equal(got.yb.numpy(), np.asarray(want.yb))
    np.testing.assert_array_equal(got.sizes, want.sizes)
    assert got.nbytes == want.nbytes
    for devs in [(0, 1, 2), (8,), (), (3, 5)]:
        assert got.n_batches_for(devs) == want.n_batches_for(devs)


@pytest.mark.parametrize("frac", [1.0, 0.25, 0.01])
def test_eval_sample_plan_matches_reference(frac):
    a = eval_sample_plan(120, frac, 5, 7)
    b = ref_bank.eval_sample_plan(120, frac, 5, 7)
    if b is None:
        assert a is None
    else:
        np.testing.assert_array_equal(a, b)
