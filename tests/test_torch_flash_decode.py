"""The port's flash-decode kernel path and oracle against the JAX package.

The same numpy inputs go through the reference's ``ops.flash_decode``
(``use_pallas=True``: the Pallas kernel in interpret mode; ``False``: the
jnp oracle) and the port's (on the CPU: the kernel's plain version, and the
torch oracle).  Tolerances are tests/test_kernels.py's: atol and rtol 1e-5
in float32 and 5e-2 in bfloat16 against the oracle, and 1e-5 between block
sizes 256 and 512.  In bfloat16 the outputs are also held within one
rounding of each other (atol 1e-6, rtol 2^-7): both sides read the same
bfloat16 inputs and compute in float32, and at these shapes the outputs
are about 0.1, so 5e-2 alone would pass a version that returns zeros.
A test-local emulation of the bfloat16 CUDA kernel's rounding points
holds that kernel's design (q unscaled, scores scaled in float32, p split
into three bfloat16 parts) to the same one-rounding contract.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.core import errors  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# tests/test_kernels.py:test_flash_decode_matches_ref's shapes
SHAPES = [
    (1, 1, 1, 128, 256, 256),
    (2, 2, 3, 128, 512, 300),
    (1, 4, 2, 64, 1024, 1),
    (3, 1, 8, 128, 256, 129),
]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16, 5e-2)}
# (atol, rtol) of one rounding of the output in q's type
ONE_ROUNDING = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2.0 ** -7)}


def _inputs(b, hkv, g, d, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hkv, g, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The arrays in ``dtype`` for JAX and torch (bf16 rounded once, by
    JAX, so both sides see the same values)."""
    _, jdt, tdt, _ = DTYPES[dtype]
    js = [jnp.asarray(a).astype(jdt) for a in arrays]
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in js]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,g,d,s,vl", SHAPES)
def test_kernel_path_matches_reference_pallas(b, hkv, g, d, s, vl, dtype):
    """ops.flash_decode(use_pallas=True): the port's plain version against
    the Pallas kernel (interpret mode) and the oracle, in q's type."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hkv, g, d, s), dtype)
    tol = DTYPES[dtype][3]
    want = ref_ops.flash_decode(jq, jk, jv, jnp.asarray(vl), use_pallas=True)
    oracle = ref_ref.flash_decode_ref(jq, jk, jv, jnp.asarray(vl))
    got = ops.flash_decode(tq, tk, tv, vl, use_pallas=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    atol, rtol = ONE_ROUNDING[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=atol, rtol=rtol)
    # a 0-d tensor valid_len gives the same bits as the int
    again = ops.flash_decode(tq, tk, tv, torch.tensor(vl), use_pallas=True)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,g,d,s,vl", SHAPES)
def test_oracle_matches_reference_oracle(b, hkv, g, d, s, vl, dtype):
    """ops.flash_decode(use_pallas=False) is ref.flash_decode_ref, and it
    matches the reference's oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hkv, g, d, s, seed=1),
                                       dtype)
    tol = DTYPES[dtype][3]
    want = ref_ref.flash_decode_ref(jq, jk, jv, jnp.asarray(vl))
    got = ops.flash_decode(tq, tk, tv, vl, use_pallas=False)
    assert torch.equal(got, ref.flash_decode_ref(tq, tk, tv, vl))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    atol, rtol = ONE_ROUNDING[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("vl", [700, 1, 1024])
def test_block_invariance(vl):
    """tests/test_kernels.py:test_flash_decode_block_invariance: block 256
    against 512 within 1e-5 (and the reference's own 512-block kernel)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 128, 1024, 7))
    a = ops.flash_decode(q, k, v, vl, use_pallas=True, block_s=256)
    b = ops.flash_decode(q, k, v, vl, use_pallas=True, block_s=512)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    want = ref_ops.flash_decode(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                jnp.asarray(vl), use_pallas=True, block_s=512)
    np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_valid_len_gives_zeros_from_the_kernel_and_nan_from_the_oracle(
        dtype):
    """valid_len = 0: the kernel path floors the denominator (zeros), the
    oracle takes a softmax over all -inf (NaN), on both sides."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 2, 3, 64, 512), dtype)
    want_k = _np(ref_ops.flash_decode(jq, jk, jv, jnp.asarray(0),
                                      use_pallas=True))
    want_o = _np(ref_ref.flash_decode_ref(jq, jk, jv, jnp.asarray(0)))
    got_k = _np(ops.flash_decode(tq, tk, tv, 0, use_pallas=True))
    got_o = _np(ops.flash_decode(tq, tk, tv, 0, use_pallas=False))
    assert np.all(want_k == 0.0) and np.all(got_k == 0.0)
    assert np.all(np.isnan(want_o)) and np.all(np.isnan(got_o))


def test_plain_version_skips_blocks_past_valid_len():
    """Blocks wholly past valid_len are skipped: NaN in the cache there
    cannot reach the output (the block is never read)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 64, 1024, 3))
    want = fd.flash_decode_plain(q, k, v, 300)
    k[:, 512:] = float("nan")
    v[:, 512:] = float("nan")
    assert torch.equal(fd.flash_decode_plain(q, k, v, 300), want)
    assert torch.equal(fd.flash_decode_plain(q, k, v, torch.tensor(300)),
                       want)


def test_cache_length_must_be_a_multiple_of_the_block():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 64, 384))
    with pytest.raises(ValueError, match="not a multiple of block_s=256"):
        ops.flash_decode(q, k, v, 10, use_pallas=True)
    with pytest.raises(ValueError, match="do not match q"):
        fd.flash_decode_plain(q, k[:, :, :, :32], v[:, :, :, :32], 10,
                              block_s=128)


def _bf16_kernel_emulation(q, k, v, valid_len, parts: int):
    """The bfloat16 kernel's rounding points in plain torch: q stays
    unscaled bfloat16, the float32 scores q.k are scaled by log2(e) /
    sqrt(D) afterwards, the weights are exponentials in base 2 and reach
    p.v as ``parts`` bfloat16 parts (hi = bf16(p), mid = bf16(p - hi), lo =
    bf16(p - hi - mid); the kernel takes three), each product summed in
    float32."""
    d = q.shape[-1]
    qscale = float(np.float32(np.log2(np.e) / np.sqrt(d)))
    kf, vf = k[:, :valid_len].float(), v[:, :valid_len].float()
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), kf) * qscale
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    acc = torch.zeros(q.shape, dtype=torch.float32)
    rest = p
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        acc = acc + torch.einsum("bhgs,bshd->bhgd", part, vf)
        rest = rest - part
    return (acc / p.sum(dim=-1)[..., None]).to(torch.bfloat16)


def _decode_like():
    """B=4, Hkv=2, G=7, D=64, S=8,192, the whole cache valid."""
    _, (q, k, v) = _both(_inputs(4, 2, 7, 64, 8192, seed=17), "bfloat16")
    return q, k, v, 8192


def _short_cache():
    """tests/test_torch_cuda.py's tile-edge case D=128, G=8 at valid_len
    8, where a few products cancel to outputs near zero."""
    gen = torch.Generator().manual_seed(100 * 8 + 128)
    q = torch.randn(2, 2, 8, 128, generator=gen).to(torch.bfloat16)
    k = torch.randn(2, 512, 2, 128, generator=gen).to(torch.bfloat16)
    v = torch.randn(2, 512, 2, 128, generator=gen).to(torch.bfloat16)
    return q, k, v, 8


@pytest.mark.parametrize("case,parts,within", [
    (_decode_like, 3, True), (_decode_like, 1, False),
    (_short_cache, 3, True), (_short_cache, 2, False),
])
def test_bf16_kernel_needs_p_in_three_bf16_parts(case, parts, within):
    """The bfloat16 kernel's rounding points with p in three bfloat16
    parts stay within one rounding of the output (atol 1e-6, rtol 2^-7) of
    the plain version.  With p rounded once they leave it on a long cache;
    with two parts (p to about 2^-17) they leave it where a short cache's
    products cancel.  So the split is a requirement of the contract."""
    q, k, v, valid_len = case()
    want = fd.flash_decode_plain(q, k, v, valid_len).float()
    got = _bf16_kernel_emulation(q, k, v, valid_len, parts).float()
    atol, rtol = ONE_ROUNDING["bfloat16"]
    outside = (got - want).abs() > atol + rtol * want.abs()
    assert bool(outside.any()) != within


def test_three_bf16_parts_carry_p_exactly():
    """hi + mid + lo is the float32 weight p in (0, 1] exactly (each part
    rounds the exact float32 remainder); hi + lo alone is off."""
    p = torch.exp2(-torch.rand(100_000, generator=torch.Generator()
                               .manual_seed(0), dtype=torch.float32) * 30)
    hi = p.to(torch.bfloat16).float()
    mid = (p - hi).to(torch.bfloat16).float()
    lo = (p - hi - mid).to(torch.bfloat16).float()
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())
    assert not torch.equal(hi + (p - hi).to(torch.bfloat16).float(), p)


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: lets a CPU-only host drive
    the wrapper's CUDA branch up to the point where it needs the kernel."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensors_raise_without_the_kernel(monkeypatch, tmp_path):
    """On a CUDA tensor the wrapper launches the kernel or raises: with no
    nvcc the build fails loudly, the plain version is not called and the
    launch count does not move."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fd, "_lib", None)

    def _no_fallback(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fd, "flash_decode_plain", _no_fallback)
    q, k, v = (torch.from_numpy(a).as_subclass(_CudaLabelled)
               for a in _inputs(1, 1, 1, 64, 256))
    before = fd.flash_decode.launches
    with pytest.raises(RuntimeError,
                       match="building CUDA kernel 'flash_decode'"):
        ops.flash_decode(q, k, v, 10, use_pallas=True)
    assert fd.flash_decode.launches == before
    with pytest.raises(ValueError, match="unsupported device type"):
        fd.flash_decode(torch.zeros(1, 1, 1, 64, device="meta"),
                        torch.zeros(1, 256, 1, 64, device="meta"),
                        torch.zeros(1, 256, 1, 64, device="meta"), 1)


def test_kernel_source_is_built_for_hopper():
    """The kernel builds from the checkout's own source, for sm_90a, with a
    plain C entry point; the error template names the kernel."""
    src = cuda_build.CSRC / "flash_decode.cu"
    text = src.read_text()
    assert "int flash_decode(" in text and "cp.async" in text
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build.library_path("flash_decode").parent == \
        cuda_build.BUILD_DIR
    assert "flash_decode" in errors.ERR_KERNEL_LAUNCH.format(
        name="flash_decode", reason="x")
