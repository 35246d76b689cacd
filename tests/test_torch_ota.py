"""The port's over-the-air uplink against the JAX package's.

In-process, on the same numpy-seeded inputs:

  * kernel #2's plain version (``repro_torch.kernels.ota_aggregate``, what
    the wrapper runs on a CPU tensor) against
    ``repro.kernels.aggregate.ota_aggregate_pallas`` in interpret mode, over
    tests/test_ota.py's sweep plus K = 0, n = 0, a trailing shape, the
    chunked size and zero-coefficient rows: bit-equal (both start from the
    noise and add the clients in order, one rounded product and one rounded
    add each);
  * the noise stream: ``horizon_keys``, the 32-bit random bits and the
    normals equal JAX's exactly (NORMAL_ATOL = 0: the port computes XLA's
    float32 ``erf_inv`` as compiled on the CPU, fused multiply-adds
    included);
  * ``superpose_tree`` on tests/test_ota.py's delta stacks: at
    ``noise_std = 0`` exactly equal through the kernel path, and within
    EINSUM_RTOL through the einsum path (XLA's dot and torch's sum the K
    products in another order); with noise, within rtol 1e-5: the noise is
    the reference's to the bit, and eta differs by the ulps of its energy
    sums over P, which run in another order;
  * ``ota_align_powers`` and ``PowerAllocator("ota-align")`` in float64:
    exactly equal;
  * the keyed reduction (``ota_aggregate_keyed``, the noise formed from the
    round key inside the kernel on the card): its plain version equals the
    strip composition ``ota_aggregate(flat, coeff, scale * normal(key))``
    to the bit over the sweep above, spaced rows and a zero scale, and the
    Pallas kernel fed the reference's own ``scale * jax.random.normal``;
    ``superpose_flat(use_pallas=True)`` gives the bits the strip path gave.

Whole runs go through the shimmed subprocess of test_torch_harness, both
configurations in one call, under tests/test_fl_engine.py:_assert_equal_runs
(schedules, bits, rates, ratios and times exact; accuracy within 0.02;
parameter drift mean < 1e-6, max < 2e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from test_torch_harness import (  # noqa: E402,F401
    ACC_ATOL, LEAVES, assert_param_drift, flat, one_torch_thread,
    run_reference, tree,
)

from repro.core import ota as ref_ota  # noqa: E402
from repro.core import power as ref_power  # noqa: E402
from repro.kernels.aggregate import TILE_ELEMS, ota_aggregate_pallas  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, ota, power, prng  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.kernels import ota_aggregate  # noqa: E402

PMAX = 0.01
NORMAL_ATOL = 0.0
EINSUM_RTOL, EINSUM_ATOL = 1e-6, 1e-9


def _kernel_inputs(k, shape, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    deltas = rng.standard_normal((k, *shape)).astype(np.float32)
    coeff = (rng.dirichlet(np.ones(k)) if k else np.zeros(0)).astype(np.float32)
    coeff[list(zero_rows)] = 0.0
    noise = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    return deltas, coeff, noise


@pytest.mark.parametrize("k,shape,zero_rows,chunk", [
    (4, (1000,), (), None),
    (1, (257,), (), None),
    (3, (TILE_ELEMS + 3,), (), None),
    (0, (500,), (), None),
    (3, (0,), (), None),
    (2, (6, 9), (), None),
    (3, (2 * TILE_ELEMS + 777,), (), TILE_ELEMS),
    (4, (1000,), (1, 3), None),
], ids=["k4-n1000", "k1-n257", "k3-tile+3", "k0", "n0", "trailing",
        "chunked", "zero-coeff-rows"])
def test_plain_matches_pallas_bit_for_bit(k, shape, zero_rows, chunk):
    deltas, coeff, noise = _kernel_inputs(k, shape, seed=k * 1000 + sum(shape),
                                          zero_rows=zero_rows)
    want = np.asarray(ota_aggregate_pallas(
        jnp.asarray(deltas), jnp.asarray(coeff), jnp.asarray(noise),
        chunk_elems=chunk,
    ))
    before = ota_aggregate.ota_aggregate.launches
    got = ota_aggregate.ota_aggregate(
        torch.from_numpy(deltas), torch.from_numpy(coeff),
        torch.from_numpy(noise),
    )
    assert ota_aggregate.ota_aggregate.launches == before
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 257, 266_610])
def test_row_buffer_spaces_rows_and_keeps_the_sum(n):
    """The OTA payload's layout: rows on 16-byte boundaries (stride N
    rounded up to a multiple of 4); the plain version reads it to the same
    bits as contiguous rows."""
    deltas, coeff, noise = _kernel_inputs(3, (n,), seed=n, zero_rows=(1,))
    rows = ota_aggregate.row_buffer(3, n, device="cpu")
    assert rows.shape == (3, n)
    assert rows.stride(0) % 4 == 0 and 0 <= rows.stride(0) - n < 4
    rows.copy_(torch.from_numpy(deltas))
    got = ota_aggregate.ota_aggregate(rows, torch.from_numpy(coeff),
                                      torch.from_numpy(noise))
    want = ota_aggregate.ota_aggregate(torch.from_numpy(deltas),
                                       torch.from_numpy(coeff),
                                       torch.from_numpy(noise))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --------------------------------------------------------------------------
# The keyed reduction: the receiver noise formed from the round key
# --------------------------------------------------------------------------

_KEYED_CASES = [
    (4, (1000,), ()), (1, (257,), ()), (3, (TILE_ELEMS + 3,), ()),
    (0, (500,), ()), (3, (0,), ()), (2, (6, 9), ()),
    (3, (2 * TILE_ELEMS + 777,), ()), (4, (1000,), (1, 3)),
]
_KEYED_IDS = ["k4-n1000", "k1-n257", "k3-tile+3", "k0", "n0", "trailing",
              "two-tiles", "zero-coeff-rows"]


@pytest.mark.parametrize("scale", [3e-3, 0.0], ids=["scaled", "zero-scale"])
@pytest.mark.parametrize("k,shape,zero_rows", _KEYED_CASES, ids=_KEYED_IDS)
def test_keyed_plain_equals_the_strip_composition(k, shape, zero_rows, scale):
    """The keyed wrapper on a CPU tensor (its plain version, no launch)
    gives the strip wrapper's bits on ``scale * prng.normal(key, n)``:
    K = 0 gives the scaled noise itself, n = 0 zeros."""
    deltas, coeff, _ = _kernel_inputs(k, shape, seed=k * 7 + sum(shape),
                                      zero_rows=zero_rows)
    n = int(np.prod(shape))
    key = ota.horizon_keys(k + n, 3)[2]
    s = torch.tensor(scale, dtype=torch.float32)
    dt, ct = torch.from_numpy(deltas), torch.from_numpy(coeff)
    before = ota_aggregate.ota_aggregate.launches
    got = ota_aggregate.ota_aggregate_keyed(dt, ct, key, s)
    want = ota_aggregate.ota_aggregate(dt, ct, s * prng.normal(key, n,
                                                               device="cpu"))
    assert ota_aggregate.ota_aggregate.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if n:
        np.testing.assert_array_equal(
            ota_aggregate.ota_aggregate_keyed_plain(
                dt.reshape(k, n), ct, key, s).numpy(),
            want.numpy().reshape(-1))


@pytest.mark.parametrize("n", [1, 257, 266_610])
def test_keyed_plain_reads_spaced_rows(n):
    """The OTA payload's layout (``row_buffer``) gives the keyed plain
    version the bits of contiguous rows."""
    deltas, coeff, _ = _kernel_inputs(3, (n,), seed=n, zero_rows=(1,))
    rows = ota_aggregate.row_buffer(3, n, device="cpu")
    rows.copy_(torch.from_numpy(deltas))
    key = ota.horizon_keys(n, 2)[1]
    s = torch.tensor(1e-3, dtype=torch.float32)
    got = ota_aggregate.ota_aggregate_keyed(rows, torch.from_numpy(coeff),
                                            key, s)
    want = ota_aggregate.ota_aggregate(
        torch.from_numpy(deltas), torch.from_numpy(coeff),
        s * prng.normal(key, n, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("k,n", [(3, 266_610), (0, 1000), (4, 1001)])
@pytest.mark.parametrize("round_key", [0, 3])
def test_keyed_plain_matches_pallas_with_reference_noise(round_key, k, n):
    """The keyed plain version against the Pallas kernel (interpret mode)
    fed the reference's own noise strip ``scale * jax.random.normal(key,
    (n,))``, for two round keys: bit-equal."""
    deltas, coeff, _ = _kernel_inputs(k, (n,), seed=round_key + n)
    key = ota.horizon_keys(1, 4)[round_key]
    scale = np.float32(2.5e-3)
    noise = jnp.float32(scale) * jax.random.normal(jnp.asarray(key), (n,),
                                                   jnp.float32)
    want = np.asarray(ota_aggregate_pallas(
        jnp.asarray(deltas), jnp.asarray(coeff), noise))
    got = ota_aggregate.ota_aggregate_keyed(
        torch.from_numpy(deltas), torch.from_numpy(coeff), key,
        torch.tensor(scale))
    np.testing.assert_array_equal(got.numpy(), want)


def _strip_superpose(flat, coeff, key, scale):
    """The round's reduction as the strip path computed it: the noise drawn
    and scaled, then the strip kernel's wrapper."""
    noise = scale * prng.normal(key, flat.shape[1], device=flat.device)
    return ota_aggregate.ota_aggregate(flat, coeff, noise)


@pytest.mark.parametrize("case", [
    dict(w=[0.1, 0.4, 0.3, 0.2], threshold=0.0, noise_std=1e-8),
    dict(w=[0.1, 0.4, 0.3, 0.2], threshold=0.4, noise_std=1e-3),
    dict(w=[0.3, 0.3, 0.0, 0.4], threshold=0.0, noise_std=1e-3),
    dict(w=[0.0] * 4, threshold=0.0, noise_std=1e-3),
], ids=["noisy", "threshold", "zero-weight-row", "empty-round"])
def test_superpose_through_the_keyed_kernel_keeps_its_bits(monkeypatch, case):
    """``superpose_tree(use_pallas=True)`` on the spaced payload gives the
    bits of the same round with the noise drawn as a strip first (the round
    path before the keyed kernel)."""
    deltas = {name: {"d": torch.from_numpy(v)}
              for name, v in _delta_stack(seed=5).items()}
    args = (deltas, torch.tensor(_GAINS, dtype=torch.float32),
            torch.tensor(case["w"], dtype=torch.float32),
            ota.horizon_keys(5, 3)[2])
    kw = dict(pmax=PMAX, noise_std=case["noise_std"],
              threshold=case["threshold"], use_pallas=True)
    got = ota.superpose_tree(*args, **kw)
    monkeypatch.setattr(ota, "ota_aggregate_keyed", _strip_superpose)
    want = ota.superpose_tree(*args, **kw)
    for name in deltas:
        np.testing.assert_array_equal(got[name]["d"].numpy(),
                                      want[name]["d"].numpy())


# --------------------------------------------------------------------------
# The noise stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_horizon_keys_equal_reference(seed):
    got = ota.horizon_keys(seed, 35)
    want = ref_ota.horizon_keys(seed, 35)
    assert got.dtype == np.uint32 and got.shape == (35, 2)
    np.testing.assert_array_equal(got, want)


_ROUND_KEY = ota.horizon_keys(0, 4)[3]      # fold_in(PRNGKey(29), 3)


@pytest.mark.parametrize("p", [1, 54, 266_610])
def test_random_bits_equal_jax(p):
    want = np.asarray(jax.random.bits(jnp.asarray(_ROUND_KEY), (p,),
                                      jnp.uint32))
    got = prng.random_bits(_ROUND_KEY, p, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("p", [1, 54, 266_610])
def test_normals_within_tolerance_of_jax(p):
    want = np.asarray(jax.random.normal(jnp.asarray(_ROUND_KEY), (p,),
                                        jnp.float32))
    got = prng.normal(_ROUND_KEY, p, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (p,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_ATOL)


# --------------------------------------------------------------------------
# superpose_tree
# --------------------------------------------------------------------------

def _delta_stack(k=4, sizes=((7, 5), (11,)), seed=0):
    """tests/test_ota.py:_delta_stack, as numpy leaves; the nested layout
    ``{"leafI": {"d": ...}}`` keeps the reference's sorted leaf order."""
    rng = np.random.default_rng(seed)
    return {
        f"leaf{i}": rng.standard_normal((k, *s)).astype(np.float32)
        for i, s in enumerate(sizes)
    }


def _superpose_both(deltas, gains, w, key, **kw):
    want = ref_ota.superpose_tree(
        {name: jnp.asarray(v) for name, v in deltas.items()},
        jnp.asarray(gains, jnp.float32), jnp.asarray(w, jnp.float32),
        jnp.asarray(key), **kw,
    )
    got = ota.superpose_tree(
        {name: {"d": torch.from_numpy(v)} for name, v in deltas.items()},
        torch.from_numpy(np.asarray(gains, np.float32)),
        torch.from_numpy(np.asarray(w, np.float32)), key, **kw,
    )
    return ({name: got[name]["d"].numpy() for name in deltas},
            {name: np.asarray(v) for name, v in want.items()})


_GAINS = [1e-6, 2e-6, 5e-7, 3e-6]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "einsum"])
@pytest.mark.parametrize("case", [
    dict(gains=_GAINS, w=[0.1, 0.4, 0.3, 0.2], threshold=0.0),
    dict(gains=[1e-6, 5e-7, 1e-7, 9e-7], w=[0.25] * 4, threshold=0.5),
    dict(gains=[1e-6, 2e-6, 9e-6, 3e-6], w=[0.3, 0.3, 0.0, 0.4],
         threshold=0.0),
    dict(gains=[0.0] * 4, w=[0.0] * 4, threshold=0.0),
    dict(gains=_GAINS, w=[0.1, 0.4, 0.3, 0.2], threshold=0.0, zero=True),
], ids=["threshold-0", "threshold-0.5", "zero-weight-row", "empty-round",
        "all-zero-deltas"])
def test_noiseless_superpose_matches_reference(case, use_pallas):
    deltas = _delta_stack()
    if case.get("zero"):
        deltas = {name: np.zeros_like(v) for name, v in deltas.items()}
    got, want = _superpose_both(
        deltas, case["gains"], case["w"], ota.horizon_keys(0, 1)[0],
        pmax=PMAX, noise_std=0.0, threshold=case["threshold"],
        use_pallas=use_pallas,
    )
    for name in deltas:
        assert got[name].shape == want[name].shape
        if use_pallas:
            np.testing.assert_array_equal(got[name], want[name])
        else:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=EINSUM_RTOL, atol=EINSUM_ATOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "einsum"])
@pytest.mark.parametrize("seed,noise_std,threshold", [
    (1, 1e-8, 0.0), (7, 1e-3, 0.4),
])
def test_noisy_superpose_matches_reference(seed, noise_std, threshold,
                                           use_pallas):
    """The reference's noise, redrawn by the port (bit-equal normals, so
    the normals' bound NORMAL_ATOL scaled by the noise scale
    1 / (sqrt(eta) sum w) is 0); rtol 1e-5 covers eta's summation order."""
    deltas = _delta_stack(seed=seed)
    gains = np.asarray(_GAINS)
    w = np.asarray([0.1, 0.4, 0.3, 0.2])
    key = ota.horizon_keys(seed, 2)[1]
    kw = dict(pmax=PMAX, noise_std=noise_std, threshold=threshold,
              use_pallas=use_pallas)
    got, want = _superpose_both(deltas, gains, w, key, **kw)
    clean, _ = _superpose_both(deltas, gains, w, key,
                               **dict(kw, noise_std=0.0))
    energy = sum(np.sum(v.reshape(4, -1).astype(np.float64) ** 2, axis=1)
                 for v in deltas.values())
    keep = (gains >= threshold * gains.max())
    eta = np.min(PMAX * gains[keep] ** 2 / (w[keep] ** 2 * energy[keep]))
    scale = noise_std / (np.sqrt(eta) * w[keep].sum())
    for name in deltas:
        assert not np.array_equal(got[name], clean[name])
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-5,
            atol=scale * NORMAL_ATOL,
        )


# --------------------------------------------------------------------------
# OTA alignment powers
# --------------------------------------------------------------------------

def _groups(seed, v=64, k=3):
    rng = np.random.default_rng(seed)
    g = np.abs(rng.normal(1e-6, 5e-7, (v, k))) + 1e-8
    w = rng.dirichlet(np.ones(k), size=v)
    g[5, 1] = 0.0                   # dead channel
    w[9, 2] = 0.0                   # zero weight
    g[13] = 0.0                     # all-dead group
    w[17] = 0.0
    return g, w


@pytest.mark.parametrize("seed", [0, 1])
def test_ota_align_powers_equal_reference(seed):
    g, w = _groups(seed)
    for gk, wk in zip(g, w):
        np.testing.assert_array_equal(
            power.ota_align_powers(gk, wk, PMAX),
            ref_power.ota_align_powers(gk, wk, PMAX))
    mine = power.make_power_allocator("ota-align", PMAX, 1e-13)
    ref = ref_power.make_power_allocator("ota-align", PMAX, 1e-13)
    np.testing.assert_array_equal(mine.solve_batched(g, w),
                                  ref.solve_batched(g, w))
    np.testing.assert_array_equal(mine(g[0], w[0]), ref(g[0], w[0]))
    assert mine.solve_batched(np.zeros((0, 3)), np.zeros((0, 3))).shape == (0, 3)


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------

WORLD = dict(m=12, samples=800, k=3, t=3)
RUNS = {
    "max-noiseless": dict(power_mode="max", ota_noise=0.0),
    "align-noisy": dict(power_mode="ota-align", ota_noise=1e-9,
                        ota_threshold=0.1),
}


def _cfg_args(**kw):
    return dict(
        num_devices=WORLD["m"], group_size=WORLD["k"],
        num_rounds=WORLD["t"], scheduler="lazy-gwmin", fl_engine="batched",
        use_pallas=True, uplink="ota", compression="none", seed=0, **kw,
    )


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("ota"), "fl_runs", {"runs": [
        dict(key=key, num_devices=WORLD["m"], num_samples=WORLD["samples"],
             cfg=_cfg_args(**kw)) for key, kw in RUNS.items()
    ]})


def _world():
    ds = make_mnist_like(num_samples=WORLD["samples"], seed=0)
    cell = channel.CellConfig(num_devices=WORLD["m"])
    shards = dirichlet_partition(ds.y_train, WORLD["m"], seed=0)
    return ds, cell, shards


@pytest.mark.parametrize("key", list(RUNS))
def test_ota_run_matches_reference(reference_runs, key):
    want = {name[len(key) + 1:]: v for name, v in reference_runs.items()
            if name.startswith(key + "/")}
    ds, cell, shards = _world()
    bundle = channel.ChannelBundle(
        want["distances"], want["gains"], want["dl_gains"])
    got = fl.run_federated_learning(
        ds, shards, cell, FLConfig(**_cfg_args(**RUNS[key])), channels=bundle,
        init_params=tree(want, "init/"), device="cpu",
    )
    for t in range(WORLD["t"]):
        log = got.logs[t]
        assert log.devices == tuple(int(d) for d in want[f"devices/{t}"])
        np.testing.assert_array_equal(log.bits, want[f"bits/{t}"])
        np.testing.assert_array_equal(log.rates, want[f"rates/{t}"])
        np.testing.assert_array_equal(log.compression_ratios,
                                      want[f"ratios/{t}"])
    np.testing.assert_array_equal(got.times(), want["times"])
    np.testing.assert_allclose(got.accuracies(), want["acc"], atol=ACC_ATOL)
    assert_param_drift(flat(got.final_params, ""), {
        name: want["final/" + name] for name in LEAVES
    })
    assert all(int(b) == 32 for log in got.logs for b in log.bits)


def test_noiseless_ota_run_matches_digital_uncompressed():
    """tests/test_ota.py:275 on the port alone: at noise 0 and threshold 0
    the analog sum is the weighted aggregate, so the run tracks the digital
    uncompressed NOMA run (same schedule, near-identical parameters)."""
    ds, cell, shards = _world()
    args = _cfg_args(power_mode="max", ota_noise=0.0)
    ro = fl.run_federated_learning(ds, shards, cell, FLConfig(**args),
                                   device="cpu")
    rn = fl.run_federated_learning(
        ds, shards, cell, FLConfig(**dict(args, uplink="noma")), device="cpu")
    assert [l.devices for l in ro.logs] == [l.devices for l in rn.logs]
    np.testing.assert_array_equal(ro.times(), rn.times())
    np.testing.assert_allclose(ro.accuracies(), rn.accuracies(), atol=0.051)
    assert_param_drift(flat(ro.final_params, ""), flat(rn.final_params, ""))
