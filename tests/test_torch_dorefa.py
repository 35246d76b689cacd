"""The port's DoReFa kernels (#3-5) and ops against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; it is held
against the Pallas kernel (``repro/kernels/dorefa.py``, interpret mode, in
this process) to the bit: codes equal, outputs bit-equal.  The kernels are
elementwise, so one (R, 128) tile array carries the data of every sweep
shape (tests/test_kernels.py's SHAPES and the LeNet leaf sizes) for each
type and bit width.  The ops (``repro_torch.kernels.ops``) are held against
the reference's jitted ``ops.*`` shape by shape, both ``use_pallas``
settings, bit for bit, except ``weighted_aggregate`` and
``sic_weighted_rates``, whose reductions are held at their kernels' own
tolerances (tests/test_kernels.py, tests/test_rates.py).  The CUDA kernels
run only on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import dorefa as ref_dorefa  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402

from repro_torch.kernels import cuda_build, dorefa, ops, ref  # noqa: E402

SHAPES = [(17,), (128,), (4096,), (32768,), (100_001,), (3, 77, 11)]
LENET_LEAVES = [(235_200,), (30_000,), (1_000,), (300,), (100,), (10,)]
BITS = [1, 2, 4, 8, 16, 24, 31, 32]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


# the reference's oracles as ops.py calls them: jitted, static bits
_jit_quantize_codes_ref = jax.jit(ref_ref.quantize_codes_ref, static_argnums=1)
_jit_dequantize_codes_ref = jax.jit(ref_ref.dequantize_codes_ref,
                                    static_argnums=1)
_jit_quantize_dequantize_ref = jax.jit(ref_ref.quantize_dequantize_ref,
                                       static_argnums=1)


def _normals(shape, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tile_array():
    """Every sweep shape's data back to back, zero-padded to (R, 128) with
    R % 256 == 0 (the Pallas kernels' grid)."""
    parts = [_normals(s, seed=i).reshape(-1)
             for i, s in enumerate(SHAPES + LENET_LEAVES)]
    flat = np.concatenate(parts)
    pad = (-flat.size) % ops.TILE
    return np.pad(flat, (0, pad)).reshape(-1, ops.LANE)


@pytest.fixture(scope="module")
def tiles():
    return _tile_array()


def _pair(x, dtype):
    """The same values as a torch and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_versions_match_pallas_kernels(tiles, dtype, bits):
    """#3 codes equal, #4 and #5 outputs bit-equal, over every sweep shape's
    data (4.1e5 values), at a scale from the data (the kernels' use)."""
    xt, xj = _pair(tiles, dtype)
    scale = np.float32(np.abs(np.asarray(xt.to(torch.float32))).max())
    st, sj = torch.tensor(scale), jnp.asarray(scale)

    want_codes = np.array(ref_dorefa.quantize_codes_pallas(xj, sj, bits))
    codes = dorefa.quantize_codes(xt, st, bits)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy().reshape(tiles.shape),
                                  want_codes)

    want_deq = np.asarray(ref_dorefa.dequantize_codes_pallas(
        jnp.asarray(want_codes), sj, bits))
    deq = dorefa.dequantize_codes(torch.from_numpy(want_codes), st, bits)
    assert deq.dtype == torch.float32
    np.testing.assert_array_equal(deq.numpy().reshape(tiles.shape), want_deq)

    want_qdq = ref_dorefa.quantize_dequantize_pallas(xj, sj, bits)
    qdq = dorefa.quantize_dequantize(xt, st, bits)
    assert qdq.dtype == xt.dtype
    np.testing.assert_array_equal(
        qdq.to(torch.float32).numpy().reshape(tiles.shape),
        np.asarray(want_qdq.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [1, 8, 31, 32])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_dequantize_of_views_at_every_offset(dtype, bits):
    """x = buf[o:o + n] at every element offset o = 0..7 and n of every
    residue mod 8 (where the card's 16-byte kernel splits x into a scalar
    head, whole vectors and a scalar tail), with NaN, +-Inf and a zero
    scale among the cases: each view's output equals the Pallas kernel's on
    the same values, to the bit."""
    buf = _normals((4096,), seed=bits)
    buf[[5, 700, 1403]] = [np.nan, np.inf, -np.inf]
    bt, _ = _pair(buf, dtype)
    views = [(o, n) for o in range(8) for n in (8 * o + r for r in range(8))
             ] + [(o, 3000 + o) for o in range(8)]
    for scale in (np.float32(np.abs(buf[np.isfinite(buf)]).max()),
                  np.float32(0.0)):
        st = torch.tensor(scale)
        got = [dorefa.quantize_dequantize(bt[o:o + n], st, bits)
               for o, n in views]
        assert all(g.dtype == bt.dtype and g.numel() == n
                   for g, (_, n) in zip(got, views))
        flat = np.concatenate([buf[o:o + n] for o, n in views])
        pad = (-flat.size) % ops.TILE
        _, xj = _pair(np.pad(flat, (0, pad)).reshape(-1, ops.LANE), dtype)
        want = np.asarray(ref_dorefa.quantize_dequantize_pallas(
            xj, jnp.asarray(scale), bits).astype(jnp.float32)).reshape(-1)
        np.testing.assert_array_equal(
            torch.cat(got).to(torch.float32).numpy(), want[:flat.size])


@pytest.mark.parametrize("bits", [1, 8, 31, 32])
def test_dequantize_codes_of_views_at_every_offset(bits):
    """codes = buf[o:o + n] at every element offset o = 0..7 and n of every
    residue mod 8 (where the card's 16-byte kernel splits the codes into a
    scalar head, whole int4 vectors and a scalar tail), with INT_MIN,
    INT_MAX, 0 and +-1 among the codes, under the data's scale, a zero
    scale and a NaN scale: each view's output equals the Pallas kernel's
    on the same codes, to the bit."""
    rng = np.random.default_rng(bits)
    hi = 2 ** min(bits, 31) - 1
    buf = rng.integers(-hi, hi, 4096, endpoint=True).astype(np.int32)
    buf[[2, 9, 700, 1401, 1402, 3001]] = [
        np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, 1, -1,
        np.iinfo(np.int32).min]
    bt = torch.from_numpy(buf)
    views = [(o, n) for o in range(8) for n in (8 * o + r for r in range(8))
             ] + [(o, 3000 + o) for o in range(8)]
    flat = np.concatenate([buf[o:o + n] for o, n in views])
    pad = (-flat.size) % ops.TILE
    cj = jnp.asarray(np.pad(flat, (0, pad)).reshape(-1, ops.LANE))
    for scale in (np.float32(0.37), np.float32(0.0), np.float32(np.nan)):
        st = torch.tensor(scale)
        got = [dorefa.dequantize_codes(bt[o:o + n], st, bits)
               for o, n in views]
        assert all(g.dtype == torch.float32 and g.numel() == n
                   for g, (_, n) in zip(got, views))
        want = np.asarray(ref_dorefa.dequantize_codes_pallas(
            cj, jnp.asarray(scale), bits)).reshape(-1)
        np.testing.assert_array_equal(torch.cat(got).numpy(),
                                      want[:flat.size])


def test_b3_dequantize_multiplies_by_the_folded_reciprocal():
    """At b = 3 the source text's c * (s / a) and the compiled c * (s *
    fl(1/a)) differ on most elements; the Pallas kernel gives the second,
    and so does the port, so a port that divides fails here."""
    x = _normals((256, 128), seed=0)
    s = np.float32(np.abs(x).max())
    a = np.float32(7.0)
    assert s / a != s * (np.float32(1.0) / a)    # this scale tells them apart
    codes = np.array(ref_dorefa.quantize_codes_pallas(
        jnp.asarray(x), jnp.asarray(s), 3))
    want = np.asarray(ref_dorefa.dequantize_codes_pallas(
        jnp.asarray(codes), jnp.asarray(s), 3))
    cf = codes.astype(np.float32)
    divided = cf * (s / a)
    folded = cf * (s * (np.float32(1.0) / a))
    assert np.count_nonzero(divided != want) > codes.size // 2
    np.testing.assert_array_equal(folded, want)
    got = dorefa.dequantize_codes(torch.from_numpy(codes), torch.tensor(s), 3)
    np.testing.assert_array_equal(got.numpy().reshape(x.shape), want)
    qdq = dorefa.quantize_dequantize(torch.from_numpy(x), torch.tensor(s), 3)
    np.testing.assert_array_equal(
        qdq.numpy().reshape(x.shape),
        np.asarray(ref_dorefa.quantize_dequantize_pallas(
            jnp.asarray(x), jnp.asarray(s), 3)))


@pytest.mark.parametrize("bits", [31, 32])
def test_codes_saturate_at_the_int32_range(bits):
    """a = 2^b - 1 exceeds int32 in float32 at b = 31 and 32: the
    reference's convert clamps to [-2^31, 2^31 - 1], and so does the
    port's cast."""
    x = np.linspace(-1.0, 1.0, 256 * 128, dtype=np.float32).reshape(-1, 128)
    s = np.float32(1.0)
    want = np.asarray(ref_dorefa.quantize_codes_pallas(
        jnp.asarray(x), jnp.asarray(s), bits))
    got = dorefa.quantize_codes(torch.from_numpy(x), torch.tensor(s), bits)
    np.testing.assert_array_equal(got.numpy().reshape(x.shape), want)
    assert want.min() == -(2 ** 31) and want.max() == 2 ** 31 - 1


NON_FINITE = np.array([np.nan, np.inf, -np.inf, 0.5, -0.5, 0.0, -0.0, 1e30,
                       -np.nan], np.float32)


@pytest.mark.parametrize("bits", [3, 31, 32])
@pytest.mark.parametrize("scale", [1.0, np.nan, np.inf, 0.0, -1.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_non_finite_values_pass_through_as_in_the_reference(dtype, scale,
                                                            bits):
    """NaN and Inf elements, and a NaN, Inf, zero or negative scale: the
    reference's max and clip propagate NaN, so a NaN element or scale
    gives a NaN output and code 0 (its convert's NaN), never a finite
    value that hides a diverged update; codes equal, outputs equal with
    NaN at the same places."""
    x = np.zeros((256, 128), np.float32)
    x[0, :NON_FINITE.size] = NON_FINITE
    x[1:] = _normals((255, 128), seed=5)
    xt, xj = _pair(x, dtype)
    s = np.float32(scale)
    st, sj = torch.tensor(s), jnp.asarray(s)
    want_codes = np.array(ref_dorefa.quantize_codes_pallas(xj, sj, bits))
    codes = dorefa.quantize_codes(xt, st, bits)
    np.testing.assert_array_equal(codes.numpy().reshape(x.shape), want_codes)
    np.testing.assert_array_equal(
        dorefa.dequantize_codes(torch.from_numpy(want_codes), st,
                                bits).numpy().reshape(x.shape),
        np.asarray(ref_dorefa.dequantize_codes_pallas(
            jnp.asarray(want_codes), sj, bits)))
    want_qdq = np.asarray(ref_dorefa.quantize_dequantize_pallas(
        xj, sj, bits).astype(jnp.float32))
    qdq = dorefa.quantize_dequantize(xt, st, bits)
    np.testing.assert_array_equal(
        qdq.to(torch.float32).numpy().reshape(x.shape), want_qdq)
    assert np.isnan(want_qdq[0, 0])          # the NaN element stays NaN


@pytest.mark.parametrize("use_pallas", [False, True])
def test_a_nan_update_is_not_hidden_by_the_ops(use_pallas):
    """A NaN element makes the max-abs scale NaN: quantize_pack gives code
    0 and a NaN scale, and every decoded or fused value is NaN, as in the
    reference's jitted ops."""
    x = _normals((1000,), seed=9)
    x[17] = np.nan
    xt, xj = _pair(x, "f32")
    want_c, want_s = ref_ops.quantize_pack(xj, 4, use_pallas=use_pallas)
    codes, scale = ops.quantize_pack(xt, 4, use_pallas=use_pallas)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    assert np.isnan(scale.item()) and np.isnan(float(want_s))
    got = ops.unpack_dequantize(codes, scale, 4, x.size, use_pallas=use_pallas)
    assert torch.isnan(got).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_ops.unpack_dequantize(want_c, want_s, 4, x.size,
                                  use_pallas=use_pallas)))
    got = ops.quantize_dequantize(xt, 4, use_pallas=use_pallas)
    assert torch.isnan(got).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_ops.quantize_dequantize(xj, 4, use_pallas=use_pallas)))


def test_quantize_codes_writes_the_pad_as_zeros():
    x = torch.from_numpy(_normals((1000,), seed=3))
    codes = dorefa.quantize_codes(x, torch.tensor(0.5), 4, n_out=ops.TILE)
    assert codes.shape == (ops.TILE,)
    assert torch.all(codes[1000:] == 0)
    torch.testing.assert_close(codes[:1000], dorefa.quantize_codes(
        x, torch.tensor(0.5), 4), rtol=0, atol=0)
    with pytest.raises(ValueError, match="below the 1000 input elements"):
        dorefa.quantize_codes(x, torch.tensor(0.5), 4, n_out=999)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [LENET_LEAVES[0], LENET_LEAVES[-1]])
def test_ops_match_the_reference_jitted_ops(shape, use_pallas):
    """quantize_pack (codes laid out (R, 128), pad coded 0, and the scale),
    unpack_dequantize and quantize_dequantize (float32 and bfloat16) equal
    the reference's jitted ops to the bit."""
    x = _normals(shape, seed=len(shape) * 100 + shape[0] % 97)
    for bits in (3, 8, 32):
        xt, xj = _pair(x, "f32")
        want_c, want_s = ref_ops.quantize_pack(xj.reshape(-1), bits,
                                               use_pallas=use_pallas)
        codes, scale = ops.quantize_pack(xt.reshape(-1), bits,
                                         use_pallas=use_pallas)
        assert codes.dtype == torch.int32 and codes.shape[1] == ops.LANE
        assert codes.shape[0] % ops.BLOCK_ROWS == 0
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
        assert scale.item() == float(want_s)
        want = ref_ops.unpack_dequantize(want_c, want_s, bits, x.size,
                                         use_pallas=use_pallas)
        got = ops.unpack_dequantize(codes, scale, bits, x.size,
                                    use_pallas=use_pallas)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for dtype, bits in (("f32", 3), ("bf16", 4)):
        xt, xj = _pair(x, dtype)
        want = ref_ops.quantize_dequantize(xj, bits, use_pallas=use_pallas)
        got = ops.quantize_dequantize(xt, bits, use_pallas=use_pallas)
        assert got.dtype == xt.dtype and tuple(got.shape) == shape
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [3, 8, 32])
def test_oracles_match_the_reference_oracles_jitted(bits):
    """kernels/ref.py's DoReFa oracles equal the reference's under jit
    (static bits: the folded reciprocal), the int32 cast included."""
    x = _normals((5000,), seed=11)
    s = np.float32(np.abs(x).max() * 0.75)       # clips a quarter of x
    xt, st = torch.from_numpy(x), torch.tensor(s)
    want_c = _jit_quantize_codes_ref(jnp.asarray(x), bits, jnp.asarray(s))
    np.testing.assert_array_equal(ref.quantize_codes_ref(xt, bits, st).numpy(),
                                  np.asarray(want_c))
    want_d = _jit_dequantize_codes_ref(want_c, bits, jnp.asarray(s))
    np.testing.assert_array_equal(
        ref.dequantize_codes_ref(torch.from_numpy(np.array(want_c)), bits,
                                 st).numpy(), np.asarray(want_d))
    want_q = _jit_quantize_dequantize_ref(jnp.asarray(x), bits,
                                          jnp.asarray(s))
    np.testing.assert_array_equal(
        ref.quantize_dequantize_ref(xt, bits, st).numpy(), np.asarray(want_q))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ops_reductions_match_the_reference(use_pallas):
    """weighted_aggregate (tests/test_kernels.py: rtol 1e-5, atol 1e-6) and
    sic_weighted_rates (tests/test_rates.py: relative 2e-5) through both
    paths, against the reference's ops."""
    rng = np.random.default_rng(4)
    codes = rng.integers(-15, 16, (3, 2, 4100)).astype(np.int32)
    scales = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    w = rng.dirichlet(np.ones(3)).astype(np.float32)
    want = ref_ops.weighted_aggregate(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(w), 4,
        use_pallas=use_pallas)
    got = ops.weighted_aggregate(
        torch.from_numpy(codes), torch.from_numpy(scales), torch.from_numpy(w),
        4, use_pallas=use_pallas)
    assert tuple(got.shape) == (2, 4100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    g = (np.abs(rng.normal(1e-6, 5e-7, (300, 3))) + 1e-8).astype(np.float32)
    p = rng.uniform(0.0, 0.01, (300, 3)).astype(np.float32)
    wv = rng.dirichlet(np.ones(3), size=300).astype(np.float32)
    want = np.asarray(ref_ops.sic_weighted_rates(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(wv), 1.6e-14,
        use_pallas=use_pallas))
    got = ops.sic_weighted_rates(torch.from_numpy(p), torch.from_numpy(g),
                                 torch.from_numpy(wv), 1.6e-14,
                                 use_pallas=use_pallas).numpy()
    assert got.dtype == np.float32 and got.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_flash_decode_names_its_roadmap_item():
    """ROADMAP.md queue 1 item 8a is done: ops.flash_decode no longer
    raises; both of its paths match the reference's jitted ops within
    tests/test_kernels.py's float32 tolerance (the full sweep is in
    tests/test_torch_flash_decode.py)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 2, 3, 64)).astype(np.float32)
    k = rng.standard_normal((1, 512, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, 512, 2, 64)).astype(np.float32)
    for use_pallas in (True, False):
        want = np.asarray(ref_ops.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(300),
            use_pallas=use_pallas))
        got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 300,
                               use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: lets a CPU-only host drive
    the wrappers' CUDA branch up to the point where they need the kernel."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensors_raise_without_the_kernels(monkeypatch, tmp_path):
    """On a CUDA tensor each wrapper launches its kernel or raises: with no
    nvcc the build fails loudly, no plain version is called and no launch
    count moves."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(dorefa, "_lib", None)

    def _no_fallback(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("quantize_codes_plain", "dequantize_codes_plain",
                 "quantize_dequantize_plain"):
        monkeypatch.setattr(dorefa, name, _no_fallback)
    x = torch.ones(64).as_subclass(_CudaLabelled)
    c = torch.ones(64, dtype=torch.int32).as_subclass(_CudaLabelled)
    s = torch.ones(())
    wrappers = (dorefa.quantize_codes, dorefa.dequantize_codes,
                dorefa.quantize_dequantize)
    before = [fn.launches for fn in wrappers]
    for fn, arg in zip(wrappers, (x, c, x)):
        with pytest.raises(RuntimeError,
                           match="building CUDA kernel 'dorefa'"):
            fn(arg, s, 4)
    assert [fn.launches for fn in wrappers] == before


def test_build_names_the_source_in_the_repo():
    """The kernels build from the checkout's own source, for sm_90a."""
    src = cuda_build.CSRC / "dorefa.cu"
    assert src.is_file()
    text = src.read_text()
    for entry in ("dorefa_quantize_codes", "dorefa_dequantize_codes",
                  "dorefa_quantize_dequantize",
                  "dorefa_dequantize_codes_attributes"):
        assert f"int {entry}(" in text
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert cuda_build.library_path("dorefa").parent == cuda_build.BUILD_DIR
