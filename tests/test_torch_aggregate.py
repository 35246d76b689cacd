"""The port's aggregation kernel module against the JAX package's.

On the CPU the port's ``weighted_aggregate`` runs its plain PyTorch version;
it is held against ``repro.kernels.aggregate.weighted_aggregate_pallas`` in
Pallas interpret mode, in-process, over the shape and edge sweep of
tests/test_kernels.py, at that file's tolerance (rtol 1e-5, atol 1e-6: the
two sum the same float32 products in possibly different orders).  The
engine-level ``_pallas_aggregate_leaf`` is held against the reference's,
b >= 32 passthrough rows included.  The CUDA kernel itself runs only on the
card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import fl_engine as ref_engine  # noqa: E402
from repro.kernels.aggregate import weighted_aggregate_pallas  # noqa: E402
from repro.kernels.dorefa import BLOCK_ROWS, LANE  # noqa: E402

from repro_torch.core import fl_engine  # noqa: E402
from repro_torch.kernels import aggregate, cuda_build  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6     # tests/test_kernels.py:59


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
