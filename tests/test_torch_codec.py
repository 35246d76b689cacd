"""The port's packed codec and quantizers against the JAX package's.

``repro_torch.core.compression`` (encode_tree / decode_tree through the
DoReFa kernels' plain versions here, payload and sparse accounting) and
``repro_torch.core.quantization`` (quantize, quantize_int, dequantize_int,
quantize_batched, quantize_tree, quantization_error), each held against
the reference in this process.

Contracts: codes, scales, shapes, bits and ``total_bits`` (a Python int)
equal; decoded trees bit-equal.  The quantize-dequantize functions follow
the reference's eager op order (``/ a`` then ``* scale``) and equal it to
the bit; under ``jax.jit`` with static bits the reference folds ``/ a``
into a product with ``fl(1/a)`` and rounds three times where the eager form
rounds twice, which the port is held to within JIT_ULP float32 ulps
(ROADMAP.md queue 3): 2, the most measured between the reference's own two
forms over bits 1-31 on 10^5 normals of five magnitudes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from test_torch_harness import _ulps, one_torch_thread  # noqa: E402,F401

from repro.core import compression as RC  # noqa: E402
from repro.core import quantization as RQ  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402

LENET = {"fc1": {"w": (784, 300), "b": (300,)},
         "fc2": {"w": (300, 100), "b": (100,)},
         "fc3": {"w": (100, 10), "b": (10,)}}


def _small_tree(seed):
    """tests/test_compression.py:_tree's structure and scales: mixed
    depths and magnitudes."""
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((37, 11)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(5) * 0.01).astype(np.float32),
        "nested": {"w2": (rng.standard_normal(130) * 2.0).astype(np.float32)},
    }


def _lenet_tree(seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return {a: {c: (rng.standard_normal(s) * scale).astype(np.float32)
                for c, s in v.items()} for a, v in LENET.items()}


def _to_torch(tree):
    return tree_lib.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves_np(tree):
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for v in tree_lib.tree_flatten(tree)[0]]


TREES = {"small": _small_tree, "lenet": _lenet_tree}
JIT_ULP = 2

# the reference's functions under jax.jit with static bits (the form that
# folds / a into * fl(1/a)) and with traced bits
_jit_encode_decode = jax.jit(RC.encode_decode_tree, static_argnums=1,
                             static_argnames="paper_exact")
_jit_quantize_static = jax.jit(RQ.quantize, static_argnums=1)
_jit_quantize_traced = jax.jit(RQ.quantize)


def test_tree_flatten_follows_jax_leaf_order():
    tree = {"z": np.zeros(1), "a": {"y": np.ones(2), "b": np.full(3, 2.0)},
            "m": {"k": {"j": np.full(4, 3.0)}}}
    leaves, treedef = tree_lib.tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [x.tolist() for x in leaves] == [x.tolist() for x in want]
    back = tree_lib.tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        tree)
    with pytest.raises(ValueError, match="more leaves"):
        tree_lib.tree_unflatten(treedef, leaves + [np.zeros(1)])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bits", [1, 4, 6, 8, 16])
@pytest.mark.parametrize("which", sorted(TREES))
def test_encode_tree_matches_reference(which, bits, use_pallas):
    """Every EncodedTree field equals the reference's, and both decodings
    are bit-equal."""
    tree = TREES[which](seed=bits)
    want = RC.encode_tree(_to_jax(tree), bits, use_pallas=use_pallas)
    got = C.encode_tree(_to_torch(tree), bits, use_pallas=use_pallas)
    assert got.bits == want.bits == bits
    assert type(got.total_bits) is int and got.total_bits == want.total_bits
    assert got.shapes == [tuple(s) for s in want.shapes]
    n = len(want.codes)
    assert tree_lib.tree_unflatten(got.treedef, range(n)) == \
        jax.tree_util.tree_unflatten(want.treedef, range(n))
    for c, s, wc, ws in zip(got.codes, got.scales, want.codes, want.scales):
        assert c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        assert s.item() == float(ws)
    dec_want = RC.decode_tree(want, use_pallas=use_pallas)
    dec_got = C.decode_tree(got, use_pallas=use_pallas)
    for g, w in zip(_leaves_np(dec_got), jax.tree_util.tree_leaves(dec_want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("which", sorted(TREES))
def test_reference_encoding_decodes_in_the_port(which):
    """A tree encoded by the JAX package, handed over by
    convert.encoded_tree_from_jax, decodes in the port to the same bits
    as the reference's own decode_tree."""
    tree = TREES[which](seed=5)
    enc = RC.encode_tree(_to_jax(tree), 4)
    port_enc = convert.encoded_tree_from_jax(enc, tree, device="cpu")
    assert port_enc.total_bits == enc.total_bits and port_enc.bits == 4
    want = RC.decode_tree(enc)
    for use_pallas in (False, True):
        got = C.decode_tree(port_enc, use_pallas=use_pallas)
        for g, w in zip(_leaves_np(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="structure has 1 leaves"):
        convert.encoded_tree_from_jax(enc, {"x": 0}, device="cpu")


def test_encoded_tree_conversion_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = _small_tree(0)
    enc = RC.encode_tree(_to_jax(tree), 4)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        convert.encoded_tree_from_jax(enc, tree)


def test_encoded_size_and_payload_accounting():
    """total_bits = sum n (b + 1) + 32 per leaf; payload_bits is a Python
    int that survives a 10^8-parameter tree (3.2e9 bits)."""
    tree = _small_tree(2)
    enc = C.encode_tree(_to_torch(tree), 6)
    n = sum(v.size for v in _leaves_np(tree))
    assert enc.total_bits == n * 7 + 32 * 3
    assert C.payload_bits(_to_torch(tree)) == RC.payload_bits(_to_jax(tree))
    big = {"w": torch.empty((10_000, 10_000), device="meta")}
    assert C.payload_bits(big) == 3_200_000_000
    budget = torch.tensor([1e5, 1e6, 1e9])
    np.testing.assert_array_equal(
        C.adaptive_bits_for_budget(_to_torch(tree), budget).numpy(),
        np.asarray(RC.adaptive_bits_for_budget(_to_jax(tree),
                                               jnp.asarray(budget.numpy()))))


@pytest.mark.parametrize("paper_exact", [False, True])
@pytest.mark.parametrize("bits", [1, 3, 8, 16, 32])
def test_encode_decode_tree_matches_eager_reference(bits, paper_exact):
    """The fused tree q->dq equals the reference's eager call (the legacy
    round's) to the bit, and its jitted call within JIT_ULP ulps."""
    tree = _small_tree(seed=bits)
    got = _leaves_np(C.encode_decode_tree(_to_torch(tree), bits,
                                          paper_exact=paper_exact))
    eager = jax.tree_util.tree_leaves(
        RC.encode_decode_tree(_to_jax(tree), bits, paper_exact=paper_exact))
    jitted = jax.tree_util.tree_leaves(
        _jit_encode_decode(_to_jax(tree), bits, paper_exact=paper_exact))
    for g, e, j in zip(got, eager, jitted):
        np.testing.assert_array_equal(g, np.asarray(e))
        assert _ulps(g, np.asarray(j)).max() <= JIT_ULP


@pytest.mark.parametrize("bits", [2, 5, 8, 32])
def test_quantize_matches_reference(bits):
    """quantize: eager and traced-bits jit bit-equal, static-bits jit
    within JIT_ULP ulps; quantization_error alike."""
    x = (np.random.default_rng(bits).standard_normal(3000) * 0.5).astype(
        np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    got = Q.quantize(xt, bits).numpy()
    np.testing.assert_array_equal(got, np.asarray(RQ.quantize(xj, bits)))
    traced = _jit_quantize_traced(xj, jnp.asarray(bits))
    np.testing.assert_array_equal(
        Q.quantize(xt, torch.tensor(bits)).numpy(), np.asarray(traced))
    static = _jit_quantize_static(xj, bits)
    assert _ulps(got, np.asarray(static)).max() <= JIT_ULP
    np.testing.assert_array_equal(
        Q.quantize(xt, bits, scale=1.0).numpy(),
        np.asarray(RQ.quantize(xj, bits, scale=1.0)))
    assert Q.quantization_error(xt, bits).item() == float(
        RQ.quantization_error(xj, bits))


@pytest.mark.parametrize("bits", [1, 4, 16, 31, 32])
def test_integer_codec_matches_reference(bits):
    """quantize_int (saturating int32 codes, scale) and dequantize_int
    (eager op order) equal the reference's eager calls."""
    x = (np.random.default_rng(1).standard_normal(2000) * 3.0).astype(
        np.float32)
    codes, scale = Q.quantize_int(torch.from_numpy(x), bits)
    want_c, want_s = RQ.quantize_int(jnp.asarray(x), bits)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    assert scale.item() == float(want_s)
    np.testing.assert_array_equal(
        Q.dequantize_int(codes, bits, scale).numpy(),
        np.asarray(RQ.dequantize_int(want_c, bits, want_s)))
    c1, _ = Q.quantize_int(torch.from_numpy(x), bits, scale=1.0)
    np.testing.assert_array_equal(
        c1.numpy(), np.asarray(RQ.quantize_int(jnp.asarray(x), bits,
                                               scale=1.0)[0]))


@pytest.mark.parametrize("paper_exact", [False, True])
def test_batched_tree_quantization_matches_reference(paper_exact):
    """(K,) bits over client-stacked leaves: quantize_batched through
    quantize_tree, b >= 32 rows passed through, bit-equal to the eager
    reference."""
    rng = np.random.default_rng(9)
    tree = {"a": {"w": rng.standard_normal((4, 20, 7)).astype(np.float32)},
            "b": (rng.standard_normal((4, 33)) * 0.1).astype(np.float32)}
    bits = np.array([1, 6, 32, 12], np.int32)
    got = Q.quantize_tree(_to_torch(tree), torch.from_numpy(bits),
                          paper_exact=paper_exact)
    want = RQ.quantize_tree(_to_jax(tree), jnp.asarray(bits),
                            paper_exact=paper_exact)
    for g, w in zip(_leaves_np(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(_leaves_np(got)[0][2], tree["a"]["w"][2])


def test_sparse_payload_accounting_matches_reference():
    """S_k = k (b + 1 + idx) + 32 and the honest ratio I / S_k, float64."""
    p = 266_610
    kept = np.asarray([100, 26_661, p])
    bits = np.asarray([4, 10, 32])
    for num in (2, 1024, 1025, p):
        assert C.topk_index_bits(num) == RC.topk_index_bits(num)
    with pytest.raises(ValueError, match="num_params must be >= 1"):
        C.topk_index_bits(0)
    np.testing.assert_array_equal(C.sparse_payload_bits(kept, bits, p),
                                  RC.sparse_payload_bits(kept, bits, p))
    got = C.sparse_compression_ratio(p * 32, kept, bits, p)
    np.testing.assert_array_equal(
        got, RC.sparse_compression_ratio(p * 32, kept, bits, p))
    assert got.dtype == np.float64 and got[2] == 1.0
