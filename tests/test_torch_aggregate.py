"""The port's aggregation kernel module against the JAX package's.

On the CPU the port's ``weighted_aggregate`` runs its plain PyTorch version;
it is held against ``repro.kernels.aggregate.weighted_aggregate_pallas`` in
Pallas interpret mode, in-process, over the shape and edge sweep of
tests/test_kernels.py, at that file's tolerance (rtol 1e-5, atol 1e-6: the
two sum the same float32 products in possibly different orders).  The
engine-level ``_pallas_aggregate_leaf`` is held against the reference's,
b >= 32 passthrough rows included.  ``weighted_aggregate_group`` (one
grouped launch for many matrices) equals ``weighted_aggregate`` matrix by
matrix to the bit, and the dense FL round that reduces all its leaves
through it equals the one that reduced them leaf by leaf.  The CUDA kernel
itself runs only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import fl_engine as ref_engine  # noqa: E402
from repro.kernels.aggregate import weighted_aggregate_pallas  # noqa: E402
from repro.kernels.dorefa import BLOCK_ROWS, LANE  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, fl_engine  # noqa: E402
from repro_torch.core import quantization as qlib  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.kernels import aggregate, cuda_build  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6     # tests/test_kernels.py:59
# LeNet-300-100's leaves (fc1/w, fc1/b, fc2/w, fc2/b, fc3/w, fc3/b)
LENET_SHAPES = [(784, 300), (300,), (300, 100), (100,), (100, 10), (10,)]


def _inputs(k, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        codes = rng.integers(-15, 16, (k, *shape)).astype(np.int32)
    else:
        codes = np.round(rng.standard_normal((k, *shape)) * 40).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, k).astype(np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32) if k else np.zeros(0, np.float32)
    return codes, scales, w


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("shape", [
    (1,), (17,), (1000,), (BLOCK_ROWS * LANE + 5,), (3, 77, 11),
])
def test_plain_matches_pallas_static_bits(dtype, k, shape):
    codes, scales, w = _inputs(k, shape, dtype, seed=k * 7 + len(shape))
    want = weighted_aggregate_pallas(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(w), 4
    )
    got = aggregate.weighted_aggregate(
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(w), 4,
    )
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n", [10, 300, 30_000])
def test_plain_matches_pallas_per_client_levels(k, n):
    """Per-client a_k = 2^b_k - 1 with float32-held codes, b up to 32 (the
    batched engine's traced adaptive widths)."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((k, n)).astype(np.float32)
    bits = rng.integers(1, 33, k)
    a = (2.0 ** bits - 1).astype(np.float32)
    scales = np.abs(x).max(axis=1).astype(np.float32)
    codes = np.round(a[:, None] * np.clip(x / scales[:, None], -1, 1))
    codes = codes.astype(np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    want = weighted_aggregate_pallas(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(w),
        levels=jnp.asarray(a),
    )
    got = aggregate.weighted_aggregate(
        torch.from_numpy(codes), torch.from_numpy(scales), torch.from_numpy(w),
        levels=torch.from_numpy(a),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", [1, 3])
def test_plain_rounds_wide_int32_codes_like_the_jitted_kernel(k):
    """int32 codes at b = 31 lie above 2^24, where float32 holds them
    rounded: the kernel converts each code to float32 before its fused
    multiply-add, and so does the plain version, bit-equal to the Pallas
    kernel as the jitted round compiles it (at K = 1, one float32
    product)."""
    rng = np.random.default_rng(31 + k)
    a = 2 ** 31 - 1
    codes = rng.integers(-a, a + 1, (k, 4096)).astype(np.int32)
    codes[:, :3] = [a, -a, 2 ** 24 + 1]
    scales = rng.uniform(0.5, 2.0, k).astype(np.float32)
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    want = np.asarray(jax.jit(weighted_aggregate_pallas, static_argnums=3)(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(w), 31))
    got = aggregate.weighted_aggregate(
        torch.from_numpy(codes), torch.from_numpy(scales),
        torch.from_numpy(w), 31,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    if k == 1:
        coeff = aggregate.coefficients(
            torch.from_numpy(scales), torch.from_numpy(w),
            torch.tensor([float(a)])).numpy()
        np.testing.assert_array_equal(
            got.numpy(), codes[0].astype(np.float32) * coeff[0])


def test_empty_edges_and_argument_rule():
    """K = 0 and empty payloads give zeros of the reference's shape without
    a launch; exactly one of bits= / levels= is accepted."""
    before = aggregate.weighted_aggregate.launches
    out = aggregate.weighted_aggregate(
        torch.zeros((2, 0), dtype=torch.int32), torch.ones(2), torch.ones(2), 4)
    want = weighted_aggregate_pallas(
        jnp.zeros((2, 0), jnp.int32), jnp.ones(2), jnp.ones(2), 4)
    assert tuple(out.shape) == tuple(want.shape) == (0,)
    out = aggregate.weighted_aggregate(
        torch.zeros((0, 8), dtype=torch.int32), torch.zeros(0), torch.zeros(0), 4)
    assert tuple(out.shape) == (8,) and torch.all(out == 0.0)
    with pytest.raises(ValueError, match="exactly one of"):
        aggregate.weighted_aggregate(
            torch.zeros((2, 3)), torch.ones(2), torch.ones(2), 4,
            levels=torch.ones(2),
        )
    with pytest.raises(ValueError, match="exactly one of"):
        aggregate.weighted_aggregate(torch.zeros((2, 3)), torch.ones(2),
                                     torch.ones(2))
    assert aggregate.weighted_aggregate.launches == before


@pytest.mark.parametrize("paper_exact", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_aggregate_leaf_matches_reference(compress, paper_exact):
    """``_pallas_aggregate_leaf`` with b >= 32 rows: the kernel weight of a
    full-precision client is zeroed and its raw delta joins through a
    separate sum, in both packages."""
    rng = np.random.default_rng(3)
    leaf = (rng.standard_normal((4, 30, 10)) * 1.5).astype(np.float32)
    bits = np.array([32, 2, 40, 7], np.int32)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    want = ref_engine._pallas_aggregate_leaf(
        jnp.asarray(leaf), jnp.asarray(bits), jnp.asarray(w),
        compress=compress, paper_exact=paper_exact,
    )
    got = fl_engine._pallas_aggregate_leaf(
        torch.from_numpy(leaf), torch.from_numpy(bits), torch.from_numpy(w),
        compress=compress, paper_exact=paper_exact,
    )
    assert tuple(got.shape) == (30, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_einsum_leaf_matches_kernel_leaf():
    """``use_pallas=False`` (the reference's XLA einsum, here torch.einsum)
    and the kernel path aggregate the same codes alike."""
    rng = np.random.default_rng(5)
    leaf = torch.from_numpy(rng.standard_normal((3, 1000)).astype(np.float32))
    bits = torch.tensor([3, 32, 9], dtype=torch.int32)
    w = torch.tensor([0.2, 0.3, 0.5])
    for compress in (True, False):
        a = fl_engine._pallas_aggregate_leaf(
            leaf, bits, w, compress=compress, paper_exact=False)
        b = fl_engine._einsum_aggregate_leaf(
            leaf, bits, w, compress=compress, paper_exact=False)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: lets a CPU-only host drive
    the wrapper's CUDA branch up to the point where it needs the kernel."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_raises_without_kernel(monkeypatch, tmp_path):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    nvcc the build fails loudly, the plain version is never called and the
    launch count does not move."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(aggregate, "_lib", None)

    def _no_fallback(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(aggregate, "weighted_aggregate_plain", _no_fallback)
    codes = torch.ones((3, 8)).as_subclass(_CudaLabelled)
    assert codes.device.type == "cuda"
    before = aggregate.weighted_aggregate.launches
    with pytest.raises(RuntimeError, match="building CUDA kernel 'aggregate'"):
        aggregate.weighted_aggregate(
            codes, torch.ones(3), torch.ones(3), levels=torch.ones(3))
    assert aggregate.weighted_aggregate.launches == before


def test_build_names_sources_in_the_repo():
    """The kernel builds from the checkout's own source, for sm_90a."""
    src = cuda_build.CSRC / "aggregate.cu"
    assert src.is_file()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build.library_path("aggregate").parent == cuda_build.BUILD_DIR


# --------------------------------------------------------------------------
# The grouped launch
# --------------------------------------------------------------------------

def _tree_inputs(k, shapes, seed, dtype="float32"):
    """Per-leaf (K, *shape) codes, scales, weights and per-client levels,
    as the dense round makes them (widths up to 32 for float32-held codes,
    4 bits for int32)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.dirichlet(np.ones(k)).astype(np.float32)) \
        if k else torch.zeros(0)
    bits = rng.integers(1, 33, k) if dtype == "float32" else np.full(k, 4)
    levels = torch.from_numpy((2.0 ** bits - 1).astype(np.float32))
    leaves = []
    for shape in shapes:
        x = rng.standard_normal((k, *shape)).astype(np.float32)
        scales = np.abs(x.reshape(k, math.prod(shape))).max(
            axis=1, initial=0.0) + 0.5
        codes = np.round(levels.numpy().reshape(-1, *[1] * len(shape))
                         * np.clip(x / 3.0, -1, 1))
        codes = torch.from_numpy(codes.astype(dtype))
        leaves.append((codes, torch.from_numpy(scales.astype(np.float32))))
    return leaves, w, levels


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("k", [0, 1, 3, 6])
def test_group_equals_per_leaf_aggregate(k, dtype):
    """LeNet's six leaves plus two empty ones: one grouped call equals six
    ``weighted_aggregate`` calls to the bit, each result shaped like its
    leaf; K = 0 gives zeros; the plain version makes no launch."""
    shapes = LENET_SHAPES[:3] + [(0,), (7, 0)] + LENET_SHAPES[3:]
    leaves, w, levels = _tree_inputs(k, shapes, seed=k, dtype=dtype)
    before = aggregate.weighted_aggregate.launches
    got = aggregate.weighted_aggregate_group(
        [codes for codes, _ in leaves],
        [aggregate.coefficients(scales, w, levels) for _, scales in leaves])
    assert len(got) == len(shapes)
    for out, (codes, scales), shape in zip(got, leaves, shapes):
        want = aggregate.weighted_aggregate(codes, scales, w, levels=levels)
        assert out.dtype == torch.float32 and tuple(out.shape) == shape
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        if k == 0:
            assert not bool(out.any())
    assert aggregate.weighted_aggregate.launches == before


def test_group_of_more_matrices_than_one_table_holds():
    """2.5 tables' worth of matrices of every size mod 4: each result
    equals its own ``weighted_aggregate_plain`` to the bit."""
    n_mat = 2 * aggregate.MAX_SEGMENTS + aggregate.MAX_SEGMENTS // 2
    rng = np.random.default_rng(11)
    codes = [torch.from_numpy(np.round(rng.standard_normal((3, 97 + i)) * 40)
                              .astype(np.float32)) for i in range(n_mat)]
    coeffs = [torch.from_numpy(rng.uniform(-1, 1, 3).astype(np.float32))
              for _ in range(n_mat)]
    got = aggregate.weighted_aggregate_group(codes, coeffs)
    for out, c, cf in zip(got, codes, coeffs):
        assert torch.equal(out, aggregate.weighted_aggregate_plain(c, cf))
    assert aggregate.weighted_aggregate_group([], []) == []


def test_group_refuses_mixed_dtypes_and_mismatched_coefficients():
    f32 = torch.zeros((3, 8))
    i32 = torch.zeros((3, 8), dtype=torch.int32)
    coeff = torch.ones(3)
    with pytest.raises(TypeError, match="must all be float32 or all int32"):
        aggregate.weighted_aggregate_group([f32, i32], [coeff, coeff])
    with pytest.raises(TypeError, match="must all be float32 or all int32"):
        aggregate.weighted_aggregate_group([f32.double()], [coeff])
    with pytest.raises(ValueError, match="does not match"):
        aggregate.weighted_aggregate_group([f32, f32], [coeff, torch.ones(2)])
    with pytest.raises(ValueError, match="does not match"):
        aggregate.weighted_aggregate_group([f32], [torch.ones(3, 1)])
    with pytest.raises(ValueError, match="2 code matrices but 1"):
        aggregate.weighted_aggregate_group([f32, f32], [coeff])


def test_group_on_a_cuda_tensor_raises_without_kernel(monkeypatch, tmp_path):
    """The grouped call, like the one-matrix call, launches or raises."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(aggregate, "_lib", None)

    def _no_fallback(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(aggregate, "weighted_aggregate_plain", _no_fallback)
    codes = [torch.ones((3, n)).as_subclass(_CudaLabelled) for n in (8, 5)]
    before = aggregate.weighted_aggregate.launches
    with pytest.raises(RuntimeError, match="building CUDA kernel 'aggregate'"):
        aggregate.weighted_aggregate_group(codes, [torch.ones(3)] * 2)
    assert aggregate.weighted_aggregate.launches == before


def _per_leaf_aggregate(leaves, bits_k, agg_w, *, compress, paper_exact):
    """The dense round's aggregation as it was before the grouped launch:
    quantize and reduce one leaf at a time, one ``weighted_aggregate``
    call per leaf."""
    outs = []
    for leaf in leaves:
        k = leaf.shape[0]
        flat = leaf.reshape(k, -1).to(torch.float32)
        ones = torch.ones(k, dtype=torch.float32)
        if compress:
            codes, scales, a = qlib.quantize_codes_batched(
                flat, bits_k, scales=ones if paper_exact else None)
            full = (bits_k >= 32).to(torch.float32)
            out = aggregate.weighted_aggregate(
                codes, scales, agg_w * (1.0 - full), levels=a)
            out = out + torch.einsum("k,kn->n", agg_w * full, flat)
        else:
            out = aggregate.weighted_aggregate(flat, ones, agg_w, levels=ones)
        outs.append(out.reshape(leaf.shape[1:]))
    return outs


def _per_leaf_aggregate_seeds(leaves, bits_k, agg_w, *, seeds, compress,
                              paper_exact):
    """:func:`_per_leaf_aggregate` in the round body's seed-stacked form,
    for one run: one (1, ...) aggregate per leaf."""
    assert seeds == 1
    return [out.unsqueeze(0) for out in _per_leaf_aggregate(
        leaves, bits_k, agg_w, compress=compress, paper_exact=paper_exact)]


@pytest.mark.parametrize("paper_exact", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_leaves_in_one_group_equal_the_per_leaf_aggregate(compress,
                                                          paper_exact):
    """LeNet-shaped deltas with b >= 32 passthrough rows: the two-pass
    aggregation equals the per-leaf one, and ``_pallas_aggregate_leaf``,
    leaf by leaf, to the bit."""
    rng = np.random.default_rng(7)
    leaves = [torch.from_numpy((rng.standard_normal((4, *shape)) * 0.01)
                               .astype(np.float32)) for shape in LENET_SHAPES]
    bits = torch.tensor([32, 2, 40, 7], dtype=torch.int32)
    w = torch.from_numpy(rng.dirichlet(np.ones(4)).astype(np.float32))
    kw = dict(compress=compress, paper_exact=paper_exact)
    got = fl_engine._pallas_aggregate_leaves(leaves, bits, w, **kw)
    want = _per_leaf_aggregate(leaves, bits, w, **kw)
    for g, r, leaf in zip(got, want, leaves):
        assert g.shape == leaf.shape[1:]
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))
        one = fl_engine._pallas_aggregate_leaf(leaf, bits, w, **kw)
        assert torch.equal(g.view(torch.int32), one.view(torch.int32))


@pytest.mark.parametrize("paper_exact", [False, True])
@pytest.mark.parametrize("compression", ["adaptive", "none"])
def test_dense_round_equals_the_per_leaf_round(monkeypatch, compression,
                                               paper_exact):
    """A whole run with ``use_pallas=True``: logs (schedules, bits, rates,
    ratios, times, accuracies) and final parameters equal, to the bit,
    those of the same run with the aggregation leaf by leaf.  A 1 s slot
    gives the compressed run widths from 9 to 32, so b = 32 clients pass
    through beside quantized ones."""
    ds = make_mnist_like(num_samples=400, seed=0)
    cell = channel.CellConfig(num_devices=6, slot_seconds=1.0)
    shards = dirichlet_partition(ds.y_train, 6, seed=0)
    cfg = FLConfig(num_devices=6, group_size=3, num_rounds=2,
                   scheduler="round-robin", power_mode="max",
                   fl_engine="batched", use_pallas=True,
                   compression=compression, paper_exact_range=paper_exact)
    grouped = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    monkeypatch.setattr(fl_engine, "_pallas_aggregate_seeds",
                        _per_leaf_aggregate_seeds)
    per_leaf = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert len(grouped.logs) == len(per_leaf.logs) == 2
    if compression == "adaptive":
        bits = np.concatenate([log.bits for log in grouped.logs])
        assert bits.min() < 32 and bits.max() == 32
    for a, b in zip(grouped.logs, per_leaf.logs):
        assert a.devices == b.devices and a.test_accuracy == b.test_accuracy
        assert a.wall_time_s == b.wall_time_s
        for field in ("bits", "rates", "compression_ratios"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for name, layer in per_leaf.final_params.items():
        for leaf, v in layer.items():
            assert torch.equal(grouped.final_params[name][leaf], v)
