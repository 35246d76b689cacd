"""The port's seeded random draws against the reference's, bit for bit.

``repro_torch.core.prng`` recomputes ``jax.random``'s Threefry streams and
XLA's float32 ``erf_inv`` as compiled on the CPU; ``core.channel`` and
``models.params`` draw the reference's positions, fading and LeNet weights
from the reference's keys.  Everything here is exact: keys, bits,
uniforms, normals, truncated normals, channels and initial weights equal
the reference's to the bit, and a whole FL run from the seed alone (nothing
injected) meets tests/test_fl_engine.py:_assert_equal_runs against the
reference's run of the same seed on the four worlds of
tests/test_torch_fl.py.

``jax.random`` and ``repro.core.channel`` run in this process; LeNet's
initial weights and the FL runs come from one shimmed reference subprocess
for the whole file (test_torch_harness).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_harness import (  # noqa: E402,F401
    LEAVES, assert_equal_runs, one_torch_thread, run_reference,
)

from repro.core import channel as ref_channel  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, prng  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.kernels import cuda_build, threefry  # noqa: E402
from repro_torch.models import params  # noqa: E402

SEEDS = (0, 3)
XLA_ERF_INV = jax.jit(jax.lax.erf_inv)
CELL_M, CELL_T = 30, 5
# tests/test_torch_fl.py:test_slice_matches_reference_run's worlds
WORLDS = {
    "lazy-max": dict(m=12, samples=800, k=3, t=3, scheduler="lazy-gwmin",
                     power="max"),
    "lazy-mapel": dict(m=12, samples=800, k=3, t=3, scheduler="lazy-gwmin",
                       power="mapel"),
    "round-robin-tail": dict(m=4, samples=400, k=2, t=3,
                             scheduler="round-robin", power="max"),
    "lazy-mapel-jax": dict(m=12, samples=800, k=3, t=3,
                           scheduler="lazy-gwmin", power="mapel",
                           backend="jax"),
}


def _cfg_args(world):
    return dict(
        num_devices=world["m"], group_size=world["k"],
        num_rounds=world["t"], scheduler=world["scheduler"],
        scheduler_backend=world.get("backend", "numpy"),
        power_mode=world["power"], fl_engine="batched", use_pallas=True,
        seed=0,
    )


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One reference subprocess: the draws of SEEDS and the four worlds'
    runs."""
    runs = [dict(key=name, num_devices=w["m"], num_samples=w["samples"],
                 cfg=_cfg_args(w)) for name, w in WORLDS.items()]
    return run_reference(tmp_path_factory.mktemp("draws"), "draws", {
        "seeds": list(SEEDS), "num_devices": CELL_M, "num_rounds": CELL_T,
        "runs": runs,
    })


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.uint32)


def _assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --------------------------------------------------------------------------
# keys and streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 3, 2 ** 31 - 1])
def test_keys_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    _assert_bit_equal(prng.prng_key(seed), key)
    for d in (1, 2, 17, 629919112):
        _assert_bit_equal(prng.fold_in(prng.prng_key(seed), d),
                          jax.random.fold_in(key, d))
    for n in (1, 2, 3, 35, 50):
        _assert_bit_equal(prng.split(prng.prng_key(seed), n),
                          jax.random.split(key, n))
    _assert_bit_equal(prng.split(prng.prng_key(seed)), jax.random.split(key))


@pytest.mark.parametrize("n", [1, 7, 12, 300, 4099])
@pytest.mark.parametrize("seed", [0, 5])
def test_uniform_normal_and_truncated_normal_equal_jax(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    k = np.asarray(key)
    _assert_bit_equal(prng.uniform(k, n, device="cpu").numpy(),
                      jax.random.uniform(key, (n,)))
    _assert_bit_equal(prng.uniform(k, n, -2.5, 7.0, device="cpu").numpy(),
                      jax.random.uniform(key, (n,), jnp.float32, -2.5, 7.0))
    _assert_bit_equal(prng.normal(k, n, device="cpu").numpy(),
                      jax.random.normal(key, (n,)))
    _assert_bit_equal(
        prng.truncated_normal(k, -3, 3, n, device="cpu").numpy(),
        jax.random.truncated_normal(key, -3, 3, (n,), jnp.float32))


def test_normal_equals_jax_over_a_long_stream():
    """Half a million draws: both branches of erf_inv (w < 5 and w >= 5)
    and the tails."""
    key = jax.random.PRNGKey(11)
    got = prng.normal(np.asarray(key), 1 << 19, device="cpu").numpy()
    want = np.asarray(jax.random.normal(key, (1 << 19,)))
    assert np.abs(want).max() > 4.0
    _assert_bit_equal(got, want)


def test_erf_inv_dense_sweep_equals_xla():
    """The float32 inputs the normal draw feeds erf_inv, max(lo, 2 f + lo)
    of f on the 2^-23 grid of [0, 1), against XLA's compiled float32
    erf_inv: every eighth grid point, and every one where |u| > 0.99 (the
    w >= 5 branch and its square root, 84,000 values); 1.1 million in all."""
    f = np.arange(1 << 23, dtype=np.float32) * np.float32(2.0 ** -23)
    lo = np.float32(prng.NORMAL_LO)
    u = np.maximum(lo, f * np.float32(2.0) + lo)
    u = u[(np.arange(u.size) % 8 == 0) | (np.abs(u) > 0.99)]
    got = prng.erf_inv(torch.from_numpy(u)).numpy()
    want = np.asarray(XLA_ERF_INV(jnp.asarray(u)))
    _assert_bit_equal(got, want)


def test_truncated_normal_bounds_are_xla_erf():
    """The float32 literals of ERF_BOUNDS are XLA's erf(-+3 * fl(1/sqrt 2)),
    as jax.random.truncated_normal computes its uniform's range."""
    inv_sqrt2 = jnp.float32(1.0) / jnp.float32(np.sqrt(2.0))
    a, b = prng.ERF_BOUNDS[(-3.0, 3.0)]
    want_a = jax.lax.erf(jnp.float32(-3.0) * inv_sqrt2)
    want_b = jax.lax.erf(jnp.float32(3.0) * inv_sqrt2)
    _assert_bit_equal(np.float32(a), want_a)
    _assert_bit_equal(np.float32(b), want_b)
    with pytest.raises(ValueError, match="ported for the bounds"):
        prng.truncated_normal(prng.prng_key(0), -2, 2, 4, device="cpu")


def test_sqrt_f32_is_correctly_rounded():
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 20, 1 << 16).astype(np.float32))
    want = np.sqrt(x.numpy().astype(np.float64)).astype(np.float32)
    _assert_bit_equal(prng.sqrt_f32(x).numpy(), want)


def test_cuda_devices_take_the_kernel(monkeypatch, tmp_path):
    """A CUDA device goes to the kernel, which launches or raises: with no
    nvcc the build fails loudly, the plain version is not called and the
    launch count does not move; the CPU takes the plain version."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(threefry, "_lib", None)
    key = prng.prng_key(0)
    want = prng.normal(key, 5, device="cpu")
    _assert_bit_equal(want.numpy(), prng.draw_plain(
        key, 5, prng.NORMAL_LO, 1.0, normal=True, device="cpu").numpy())

    def _no_fallback(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA device")

    monkeypatch.setattr(prng, "draw_plain", _no_fallback)
    before = threefry.threefry_draw.launches
    for draw in (lambda: prng.uniform(key, 5, device="cuda"),
                 lambda: prng.normal(key, 5, device="cuda"),
                 lambda: prng.truncated_normal(key, -3, 3, 5, device="cuda")):
        with pytest.raises(RuntimeError,
                           match="building CUDA kernel 'threefry'"):
            draw()
    assert threefry.threefry_draw.launches == before
    with pytest.raises(ValueError, match="unsupported device type"):
        threefry.threefry_draw(key, 5, 0.0, 1.0, device="cpu")


def test_the_draw_has_one_copy_in_its_header():
    """The draw's device code lives in ``csrc/threefry.cuh`` alone: the
    draw kernel and the keyed OTA reduction include it, and no kernel
    source defines a Threefry or ``erf_inv`` function of its own."""
    header = (cuda_build.CSRC / "threefry.cuh").read_text()
    for fn in ("threefry_bits(", "log_f32(", "log1p_f32(", "erf_inv_f32(",
               "uniform_f32(", "normal_f32("):
        assert f" {fn}" in header
    for src in ("threefry.cu", "ota_aggregate.cu"):
        assert '#include "threefry.cuh"' in (cuda_build.CSRC / src).read_text()
    for src in cuda_build.CSRC.glob("*.cu"):
        text = src.read_text()
        for fn in ("uint32_t threefry_bits(", "float erf_inv_f32(",
                   "float log1p_f32(", "float normal_f32(",
                   "float bf16_normal_of_k("):
            assert fn not in text, f"{src.name} defines {fn}"
    # the bf16 kernel's table: the header's bf16_normal_of_k, which takes
    # the header's erf_inv_f32; threefry.cu holds no coefficient of its own
    body = header.split("float bf16_normal_of_k(", 1)[1].split("\n}\n", 1)[0]
    assert "erf_inv_f32(" in body
    draw = (cuda_build.CSRC / "threefry.cu").read_text()
    assert "bf16_normal_of_k(" in draw
    assert not re.search(r"0x[0-9a-fA-F]*\.[0-9a-fA-F]*p", draw)
    assert not re.search(r"float\s+\w+\[\w*\]\s*=", draw)


@pytest.mark.parametrize("seed", [0, 4])
def test_bf16_normal_table_equals_jax(seed):
    """The bf16 kernel's table is ``prng.bf16_normal_table``'s function:
    at indices whose 7-bit k = (bits & 0xFF) >> 1 takes all 128 values,
    ``jax.random.normal(key, (n,), bfloat16)`` is the table at k."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    n = 4096
    want = np.asarray(jax.random.normal(key, (n,), jnp.bfloat16))
    k = ((prng.random_bits(np.asarray(key), n, device="cpu") & 0xFF)
         >> 1).numpy()
    assert set(k.tolist()) == set(range(128))
    table = prng.bf16_normal_table("cpu").numpy()
    _assert_bit_equal(table[k], want.astype(np.float32))


@pytest.mark.parametrize("edit", ["header", "source", "other"])
def test_library_names_follow_the_shared_header(monkeypatch, tmp_path, edit):
    """With ``CSRC`` pointed at a copy of the sources, editing only a
    ``.cuh`` header renames (so rebuilds) every library; editing one ``.cu``
    renames its own library only; another file renames none.  nvcc gets
    the sources' directory on its include path."""
    for name in ("threefry.cu", "ota_aggregate.cu", "threefry.cuh"):
        (tmp_path / name).write_text((cuda_build.CSRC / name).read_text())
    (tmp_path / "notes.txt").write_text("x")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = {n: cuda_build.library_path(n)
              for n in ("threefry", "ota_aggregate")}
    target = {"header": "threefry.cuh", "source": "threefry.cu",
              "other": "notes.txt"}[edit]
    with open(tmp_path / target, "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in before}
    changed = {n for n in before if after[n] != before[n]}
    assert changed == {"header": {"threefry", "ota_aggregate"},
                       "source": {"threefry"}, "other": set()}[edit]
    cmd = cuda_build.nvcc_command("nvcc", tmp_path / "threefry.cu",
                                  tmp_path / "lib.so")
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)


# --------------------------------------------------------------------------
# channels and initial weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_channels_equal_the_reference_worker(reference, seed):
    """The keys of repro/core/fl.py and the draws made under them."""
    ref = {k.split("/", 1)[1]: v for k, v in reference.items()
           if k.startswith(f"{seed}/")}
    key = prng.prng_key(seed)
    k1, k2 = prng.fold_in(key, 1), prng.fold_in(key, 2)
    _assert_bit_equal(key, ref["key"])
    _assert_bit_equal(k1, ref["fold1"])
    _assert_bit_equal(k2, ref["fold2"])
    _assert_bit_equal(prng.split(k1), ref["split1"])
    _assert_bit_equal(prng.split(k2, CELL_T), ref["split2"])
    bundle = channel.sample_channels(seed, channel.CellConfig(
        num_devices=CELL_M), CELL_T)
    _assert_bit_equal(bundle.distances, ref["distances"])
    _assert_bit_equal(bundle.gains, ref["gains"])
    _assert_bit_equal(bundle.dl_gains, ref["dl_gains"])


@pytest.mark.parametrize("m,t,seed", [(300, 35, 0), (100, 35, 0),
                                      (1000, 50, 1), (4, 0, 2)])
def test_channels_equal_the_reference_in_process(m, t, seed):
    """The paper cell and the scheduler bench's cells, against
    repro.core.channel's samplers on the reference's keys."""
    cell = ref_channel.CellConfig(num_devices=m)
    key = jax.random.PRNGKey(seed)
    dist = ref_channel.sample_positions(jax.random.fold_in(key, 1), cell)
    bundle = channel.sample_channels(seed, channel.CellConfig(
        num_devices=m), t)
    _assert_bit_equal(bundle.distances, dist)
    _assert_bit_equal(bundle.dl_gains, ref_channel.large_scale_gain(dist,
                                                                    cell))
    if t:
        _assert_bit_equal(bundle.gains, ref_channel.sample_round_channels(
            jax.random.fold_in(key, 2), dist, cell, t))
    else:
        assert bundle.gains.shape == (0, m)


@pytest.mark.parametrize("seed", SEEDS)
def test_initial_weights_equal_the_reference(reference, seed):
    got = params.init_lenet(seed, device="cpu")
    for name in LEAVES:
        layer, leaf = name.split("/")
        _assert_bit_equal(got[layer][leaf].numpy(),
                          reference[f"{seed}/init/{name}"])


# --------------------------------------------------------------------------
# whole runs from the seed alone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(WORLDS))
def test_run_from_the_seed_matches_reference_run(reference, name):
    """Nothing injected: the port draws the reference's channels and
    weights itself, and the run meets _assert_equal_runs."""
    world = WORLDS[name]
    want = {k.split("/", 1)[1]: v for k, v in reference.items()
            if k.startswith(f"{name}/")}
    ds = make_mnist_like(num_samples=world["samples"], seed=0)
    cell = channel.CellConfig(num_devices=world["m"])
    shards = dirichlet_partition(ds.y_train, world["m"], seed=0)
    got = fl.run_federated_learning(ds, shards, cell,
                                    FLConfig(**_cfg_args(world)),
                                    device="cpu")
    assert_equal_runs(got, want, world["t"])
