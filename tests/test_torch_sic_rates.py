"""The port's SIC scorer against the JAX package's Pallas kernel.

``repro.kernels.sic_rates.sic_weighted_rates_pallas`` runs in-process in
interpret mode (as tests/test_rates.py runs it); float64 inputs run under
``jax.enable_x64(True)`` so the reference forms ``rx`` in float64, as the
greedy feeds it.  The port's wrapper on CPU tensors runs the plain PyTorch
version.  Tolerance: relative 2e-5, the reference's own pallas-vs-jnp
tolerance (tests/test_rates.py).  Observed maximum relative difference:
2.0e-6, on K=1 rows of small SINR, where ``1 + x`` in float32 leaves few
digits and XLA's and PyTorch's ``log2`` round them differently; 2.3e-7
for K >= 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.sic_rates import sic_weighted_rates_pallas  # noqa: E402

from repro_torch.kernels import cuda_build, sic_rates  # noqa: E402

NOISE = 1.6e-14
PMAX = 0.01
RTOL = 2e-5


def _batch(v, k, seed, tie=False):
    """tests/test_rates.py's candidate batch; ``tie`` gives columns 0 and 1
    equal receive power (equal powers and gains)."""
    rng = np.random.default_rng(seed)
    g = np.abs(rng.normal(1e-6, 5e-7, (v, k))) + 1e-8
    p = rng.uniform(0.0, PMAX, (v, k))
    w = rng.dirichlet(np.ones(k), size=v) if v else np.zeros((0, k))
    if tie:
        g[:, 1] = g[:, 0]
        p[:, 1] = p[:, 0]
    return p, g, w


def _reference(p, g, w):
    with jax.enable_x64(p.dtype == np.float64):
        out = sic_weighted_rates_pallas(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(w), NOISE,
            interpret=True,
        )
        return np.asarray(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("v", [0, 1, 600])
def test_plain_matches_pallas_kernel(v, k, dtype):
    p, g, w = (a.astype(dtype) for a in _batch(v, k, seed=v * 10 + k))
    want = _reference(p, g, w)
    got = sic_rates.sic_weighted_rates(
        torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(w), NOISE)
    assert got.dtype == torch.float32 and got.shape == (v,)
    assert want.dtype == np.float32 and want.shape == (v,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_plain_matches_pallas_kernel_on_ties(k, dtype):
    """Equal receive powers: the lower index is decoded first."""
    p, g, w = (a.astype(dtype) for a in _batch(257, k, seed=k, tie=True))
    want = _reference(p, g, w)
    got = sic_rates.sic_weighted_rates(
        torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(w), NOISE)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_group_size_above_eight_raises():
    p, g, w = (torch.from_numpy(a) for a in _batch(4, 9, seed=0))
    with pytest.raises(ValueError, match=r"K <= 8 \(got K=9\)"):
        sic_rates.sic_weighted_rates(p, g, w, NOISE)
    with pytest.raises(ValueError, match="K <= 8"):
        sic_weighted_rates_pallas(
            jnp.asarray(p.numpy()), jnp.asarray(g.numpy()),
            jnp.asarray(w.numpy()), NOISE)


def test_argument_rules():
    p, g, w = (torch.from_numpy(a) for a in _batch(4, 3, seed=1))
    with pytest.raises(ValueError, match="one \\(V, K\\) shape"):
        sic_rates.sic_weighted_rates(p, g[:, :2], w, NOISE)
    with pytest.raises(TypeError, match="one dtype"):
        sic_rates.sic_weighted_rates(p, g.float(), w, NOISE)
    with pytest.raises(TypeError, match="one dtype"):
        sic_rates.sic_weighted_rates(p.half(), g.half(), w.half(), NOISE)


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: lets a CPU-only host drive
    the wrapper's CUDA branch up to the point where it needs the kernel."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_raises_without_kernel(monkeypatch, tmp_path):
    """On CUDA tensors the wrapper launches the kernel or raises: with no
    nvcc the build fails loudly, the plain version is never called and the
    launch count does not move."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sic_rates, "_lib", None)

    def _no_fallback(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(sic_rates, "sic_weighted_rates_plain", _no_fallback)
    p, g, w = (torch.from_numpy(a).as_subclass(_CudaLabelled)
               for a in _batch(8, 3, seed=2))
    before = sic_rates.sic_weighted_rates.launches
    with pytest.raises(RuntimeError, match="building CUDA kernel 'sic_rates'"):
        sic_rates.sic_weighted_rates(p, g, w, NOISE)
    assert sic_rates.sic_weighted_rates.launches == before


def test_build_names_sources_in_the_repo():
    """The kernel builds from the checkout's own source, for sm_90a."""
    assert (cuda_build.CSRC / "sic_rates.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build.library_path("sic_rates").parent == cuda_build.BUILD_DIR
