"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a host without a CUDA card every test skips (the
decision is taken inside the fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the aggregation kernel within rtol 1e-5 / atol 1e-6, as
tests/test_kernels.py holds the Pallas kernels; the SIC scorer within
relative 2e-5, as tests/test_rates.py holds its Pallas kernel.  Each kernel
and its plain version take the same operations in the same order, so in
practice they agree to the bit; the OTA kernel is held to its plain version
bit for bit (both take one fused multiply-add per client).  The device
greedy's schedules equal the numpy backend's exactly, and the random
streams (the OTA noise, the seeded channels and initial weights) have the
same bits on the card as on the CPU; the Threefry kernel that draws them
there equals its plain version (core/prng.py) to the bit, and so does the
keyed OTA kernel, which forms the round's noise from its key in registers
(the same device code, csrc/threefry.cuh), against its plain version and
the strip kernel fed the drawn noise.  The three DoReFa kernels equal
their plain versions to the bit (codes equal, outputs bit-equal), on the
card and on the CPU, and so do the packed codec and the top-k round's
aggregate computed on the card and on the CPU.  The flash-decode kernel
visits the cache in another order than its plain version (the Pallas
kernel's block order) and takes base-2 exponentials: it is held within
tests/test_kernels.py's float32 tolerance, atol and rtol 1e-5, and in
bfloat16 within one rounding of the output (atol 1e-6, rtol 2^-7), also
against the oracle; at valid_len = 0 it gives zeros.  Beside the
shapes, valid_len crosses the bfloat16 kernel's 8- and 16-position mma
edges and a warp's run at every G, and the three DoReFa kernels read
views of a buffer at every element offset off a 16-byte boundary.  The
grouped aggregation kernel (one launch for many matrices) equals the
plain version matrix by matrix, bit for bit, and the dense FL round that
reduces every leaf in that one launch gives the same update and bits on
the card as on the CPU.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compression, fl_engine, ota, prng  # noqa: E402
from repro_torch.core import quantization as qlib  # noqa: E402
from repro_torch.core import scheduling  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    aggregate, dorefa, flash_decode, ota_aggregate, ref, sic_rates,
)

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6
SIC_RTOL = 2e-5
NOISE, PMAX = 1.6e-14, 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 17, 1000, 32_773, 235_200, 2_200_000])
def test_aggregate_kernel_matches_plain(cuda, dtype, k, n):
    gen = torch.Generator().manual_seed(k * 1000 + n)
    bits = torch.randint(1, 33 if dtype == torch.float32 else 5, (k,),
                         generator=gen)
    levels = torch.pow(torch.full((k,), 2.0), bits.float()) - 1.0
    x = torch.clamp(torch.randn(k, n, generator=gen) / 3.0, -1.0, 1.0)
    codes = torch.round(levels[:, None] * x).to(dtype).to(cuda)
    scales = (torch.rand(k, generator=gen) + 0.5).to(cuda)
    w = torch.rand(k, generator=gen)
    w = (w / w.sum()).to(cuda)
    levels = levels.to(cuda)
    before = aggregate.weighted_aggregate.launches
    got = aggregate.weighted_aggregate(codes, scales, w, levels=levels)
    assert aggregate.weighted_aggregate.launches == before + 1
    want = aggregate.weighted_aggregate_plain(
        codes, aggregate.coefficients(scales, w, levels))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (n,)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def test_aggregate_kernel_shapes_and_empty_edges(cuda):
    codes = torch.ones((3, 4, 5), device=cuda)
    out = aggregate.weighted_aggregate(codes, torch.ones(3, device=cuda),
                                       torch.full((3,), 0.5, device=cuda), 1)
    assert out.shape == (4, 5)
    torch.testing.assert_close(out, torch.full((4, 5), 1.5, device=cuda))
    before = aggregate.weighted_aggregate.launches
    empty = aggregate.weighted_aggregate(
        torch.zeros((0, 7), device=cuda), torch.zeros(0, device=cuda),
        torch.zeros(0, device=cuda), 4)
    assert empty.shape == (7,) and not bool(empty.any())
    assert aggregate.weighted_aggregate.launches == before


def test_unaligned_rows_take_the_scalar_path(cuda):
    """n % 4 != 0 and an offset view: the kernel's one-element path."""
    base = torch.arange(3 * 1001 + 1, dtype=torch.float32, device=cuda)
    codes = base[1:].reshape(3, 1001)         # rows not 16-byte aligned
    coeff = torch.tensor([0.5, -1.0, 2.0], device=cuda)
    got = aggregate._launch(codes.contiguous(), coeff)
    want = aggregate.weighted_aggregate_plain(codes, coeff)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


LENET_SHAPES = [(784, 300), (300,), (300, 100), (100,), (100, 10), (10,)]


def _group_case(k, sizes, dtype, seed, offset=0):
    """(K, n) codes for each size, each a view ``offset`` elements into a
    buffer of its own, and (K,) coefficients, on the card."""
    gen = torch.Generator().manual_seed(seed)
    codes, coeffs = [], []
    for n in sizes:
        hi = 2 ** 20 if dtype == torch.float32 else 15
        buf = torch.randint(-hi, hi + 1, (k * n + offset,), generator=gen)
        codes.append(buf.to(dtype).to("cuda")[offset:].reshape(k, n))
        coeffs.append((torch.rand(k, generator=gen) - 0.3).to("cuda"))
    return codes, coeffs


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_grouped_aggregate_kernel_matches_plain(cuda, k, dtype, offset):
    """LeNet's six leaves (n % 4 == 0 and != 0), two empty matrices, and
    views off the 16-byte boundary (offset != 0: the scalar path), in one
    launch, each result bit-equal to the plain version."""
    sizes = [math.prod(s) for s in LENET_SHAPES] + [1, 17, 4099]
    codes, coeffs = _group_case(k, sizes, dtype, seed=k + offset, offset=offset)
    codes.insert(2, torch.zeros((k, 0), dtype=dtype, device=cuda))
    coeffs.insert(2, coeffs[0])
    codes.append(torch.zeros((0, 5), dtype=dtype, device=cuda))
    coeffs.append(torch.zeros(0, device=cuda))
    before = aggregate.weighted_aggregate.launches
    got = aggregate.weighted_aggregate_group(codes, coeffs)
    assert aggregate.weighted_aggregate.launches == before + 1
    torch.cuda.synchronize()
    for out, c, cf in zip(got, codes, coeffs):
        assert out.device.type == "cuda" and out.shape == c.shape[1:]
        want = (aggregate.weighted_aggregate_plain(c, cf) if c.numel()
                else torch.zeros(c.shape[1:], device=cuda))
        _same_bits(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_grouped_aggregate_kernel_splits_a_long_list(cuda, dtype):
    """More matrices than one table holds go out in as many launches as
    tables; a list of empty matrices launches nothing."""
    n_mat = 2 * aggregate.MAX_SEGMENTS + 3
    codes, coeffs = _group_case(3, [5 + 3 * i for i in range(n_mat)], dtype,
                                seed=n_mat)
    before = aggregate.weighted_aggregate.launches
    got = aggregate.weighted_aggregate_group(codes, coeffs)
    assert aggregate.weighted_aggregate.launches == before + 3
    for out, c, cf in zip(got, codes, coeffs):
        _same_bits(out, aggregate.weighted_aggregate_plain(c, cf))
    empty = aggregate.weighted_aggregate_group(
        [torch.zeros((3, 0), device=cuda)] * 2, [torch.ones(3, device=cuda)] * 2)
    assert [tuple(e.shape) for e in empty] == [(0,), (0,)]
    assert aggregate.weighted_aggregate.launches == before + 3


@pytest.mark.parametrize("paper_exact", [False, True])
@pytest.mark.parametrize("compress", [True, False])
def test_dense_round_on_the_card_equals_the_cpu(cuda, compress, paper_exact):
    """The dense round's aggregation of LeNet-shaped deltas: one grouped
    launch, the same update bits on the card as on the CPU.  One client
    passes through at b = 32: its einsum then has one non-zero product,
    which is exact in any summation order."""
    rng = np.random.default_rng(9)
    leaves = [torch.from_numpy((rng.standard_normal((4, *shape)) * 0.01)
                               .astype(np.float32)) for shape in LENET_SHAPES]
    bits = torch.tensor([32, 2, 9, 7], dtype=torch.int32)
    w = torch.from_numpy(rng.dirichlet(np.ones(4)).astype(np.float32))
    kw = dict(compress=compress, paper_exact=paper_exact)
    before = aggregate.weighted_aggregate.launches
    got = fl_engine._pallas_aggregate_leaves(
        [v.to(cuda) for v in leaves], bits.to(cuda), w.to(cuda), **kw)
    assert aggregate.weighted_aggregate.launches == before + 1
    want = fl_engine._pallas_aggregate_leaves(leaves, bits, w, **kw)
    for g, r in zip(got, want):
        _same_bits(g, r)


def test_grouped_aggregate_kernel_attributes(cuda):
    for dtype in (torch.float32, torch.int32):
        attrs = aggregate.attributes(dtype)
        assert attrs["local_bytes"] == 0 and attrs["static_smem"] == 0
        assert 0 < attrs["registers"] <= 64 and attrs["ctas_per_sm"] >= 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("v", [1, 255, 256, 257, 100_003])
@pytest.mark.parametrize("tie", [False, True])
def test_sic_kernel_matches_plain(cuda, dtype, k, v, tie):
    rng = np.random.default_rng(v * 10 + k)
    g = np.abs(rng.normal(1e-6, 5e-7, (v, k))) + 1e-8
    p = rng.uniform(0.0, PMAX, (v, k))
    w = rng.dirichlet(np.ones(k), size=v)
    if tie and k > 1:
        g[:, 1], p[:, 1] = g[:, 0], p[:, 0]
    p, g, w = (torch.as_tensor(a).to(cuda, dtype) for a in (p, g, w))
    before = sic_rates.sic_weighted_rates.launches
    got = sic_rates.sic_weighted_rates(p, g, w, NOISE)
    assert sic_rates.sic_weighted_rates.launches == before + 1
    want = sic_rates.sic_weighted_rates_plain(p, g, w, NOISE)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (v,)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=SIC_RTOL, atol=0)


def test_sic_kernel_edges(cuda):
    z = torch.zeros((0, 3), dtype=torch.float64, device=cuda)
    before = sic_rates.sic_weighted_rates.launches
    assert sic_rates.sic_weighted_rates(z, z, z, NOISE).shape == (0,)
    assert sic_rates.sic_weighted_rates.launches == before
    big = torch.ones((4, 9), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="K <= 8"):
        sic_rates.sic_weighted_rates(big, big, big, NOISE)
    strided = torch.ones((4, 6), dtype=torch.float64, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sic_rates.sic_weighted_rates(strided, strided, strided, NOISE)


@pytest.mark.parametrize("backend,scorer", [
    ("jax", "xla"), ("jax", "pallas"), ("jax-stepwise", "xla"),
])
@pytest.mark.parametrize("m,k,t,pool,seed", [
    (32, 3, 4, 24, 2), (5, 2, 4, 24, 5), (10, 3, 3, 2, 7), (12, 3, 4, 8, None),
])
def test_device_greedy_matches_numpy_on_the_card(cuda, backend, scorer, m, k,
                                                 t, pool, seed):
    """The first-maximum tie-break included (seed None: equal gains)."""
    if seed is None:
        gains, w = np.full((t, m), 1e-6), np.full(m, 1.0 / m)
    else:
        rng = np.random.default_rng(seed)
        gains = np.abs(rng.normal(1e-6, 5e-7, (t, m))) + 1e-8
        w = rng.dirichlet(np.ones(m))
    kw = dict(noise_power=NOISE, candidate_pool=pool)
    a = scheduling.lazy_greedy_schedule(gains, w, k, **kw)
    b = scheduling.lazy_greedy_schedule(gains, w, k, backend=backend,
                                        scorer=scorer, device=cuda, **kw)
    assert a.rounds == b.rounds
    assert a.weighted_sum_rate == b.weighted_sum_rate


@pytest.mark.parametrize("k", [0, 1, 3, 8])
@pytest.mark.parametrize("n", [1, 257, 1000, 32_771, 266_610, 2_200_000])
def test_ota_kernel_matches_plain_bit_for_bit(cuda, k, n):
    gen = torch.Generator().manual_seed(k * 1000 + n)
    x = torch.randn(k, n, generator=gen).to(cuda)
    coeff = torch.rand(k, generator=gen)
    if k > 1:
        coeff[1] = 0.0                      # a participant masked out
    coeff = (coeff / coeff.sum() if k else coeff).to(cuda)
    noise = (torch.randn(n, generator=gen) * 1e-3).to(cuda)
    before = ota_aggregate.ota_aggregate.launches
    got = ota_aggregate.ota_aggregate(x, coeff, noise)
    assert ota_aggregate.ota_aggregate.launches == before + (k > 0)
    want = ota_aggregate.ota_aggregate_plain(x, coeff, noise)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (n,)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 2, 257, 1000, 266_610])
def test_ota_kernel_reads_spaced_rows(cuda, k, n):
    """The OTA path's layout (row_buffer: 16-byte loads, ragged last quad
    element by element) against the plain version, bit for bit."""
    gen = torch.Generator().manual_seed(k * 7 + n)
    x = torch.randn(k, n, generator=gen)
    coeff = torch.rand(k, generator=gen)
    noise = torch.randn(n, generator=gen) * 1e-3
    rows = ota_aggregate.row_buffer(k, n, device=cuda)
    rows.copy_(x)
    got = ota_aggregate.ota_aggregate(rows, coeff.to(cuda), noise.to(cuda))
    want = ota_aggregate.ota_aggregate_plain(x, coeff, noise)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_ota_kernel_edges_and_unaligned_rows(cuda):
    out = ota_aggregate.ota_aggregate(
        torch.zeros((3, 0), device=cuda), torch.ones(3, device=cuda),
        torch.zeros(0, device=cuda))
    assert out.shape == (0,)
    x = torch.randn(2, 6, 9, device=cuda)
    coeff = torch.tensor([0.4, 0.6], device=cuda)
    noise = torch.randn(54, device=cuda)
    out = ota_aggregate.ota_aggregate(x, coeff, noise)
    assert out.shape == (6, 9)
    torch.testing.assert_close(
        out, ota_aggregate.ota_aggregate_plain(x.reshape(2, 54), coeff,
                                               noise).reshape(6, 9),
        rtol=0, atol=0)
    base = torch.randn(3 * 1001 + 1, device=cuda)
    rows = base[1:].reshape(3, 1001)            # rows not 16-byte aligned
    got = ota_aggregate._launch(rows.contiguous(), coeff.new_tensor(
        [0.5, -1.0, 2.0]), noise.new_zeros(1001))
    torch.testing.assert_close(got, ota_aggregate.ota_aggregate_plain(
        rows, coeff.new_tensor([0.5, -1.0, 2.0]), noise.new_zeros(1001)),
        rtol=0, atol=0)


LENET_P = 266_610


@pytest.mark.parametrize("spaced", [True, False], ids=["spaced", "contiguous"])
@pytest.mark.parametrize("k", range(7))
@pytest.mark.parametrize("n", [1, 2, 3, 257, 1000, 32_771, LENET_P, 2_200_000])
def test_keyed_ota_kernel_matches_plain_and_the_strip(cuda, k, n, spaced):
    """The keyed kernel (noise formed from the round key in registers)
    equals its plain version and the strip kernel fed ``scale *
    prng.normal(key, n)`` on the card, bit for bit, at a scale and at
    scale 0, in the path's spaced rows and in contiguous ones; one launch
    per call, K = 0 included."""
    gen = torch.Generator().manual_seed(k * 131 + n)
    x = torch.randn(k, n, generator=gen) * 0.01
    coeff = torch.rand(k, generator=gen)
    if k > 1:
        coeff[1] = 0.0
    coeff = (coeff / coeff.sum() if k else coeff).to(cuda)
    rows = ota_aggregate.row_buffer(k, n, device=cuda) if spaced else \
        torch.empty(k, n, device=cuda)
    rows.copy_(x)
    key = ota.horizon_keys(n, k + 1)[k]
    for scale in (3e-3, 0.0):
        s = torch.tensor(scale, dtype=torch.float32, device=cuda)
        before = ota_aggregate.ota_aggregate.launches
        got = ota_aggregate.ota_aggregate_keyed(rows, coeff, key, s)
        assert ota_aggregate.ota_aggregate.launches == before + 1
        assert got.device.type == "cuda" and got.shape == (n,)
        _same_bits(got, ota_aggregate.ota_aggregate_keyed_plain(
            rows, coeff, key, s))
        strip = s * prng.normal(key, n, device=cuda)
        _same_bits(got, ota_aggregate._launch(rows, coeff, strip) if k else
                   strip)


def test_keyed_ota_kernel_edges_and_refusals(cuda):
    """An empty payload returns zeros without a launch; a trailing shape
    keeps its shape; the scale must be one float32 on the card."""
    key = ota.horizon_keys(0, 1)[0]
    s = torch.tensor(1e-3, device=cuda)
    before = ota_aggregate.ota_aggregate.launches
    out = ota_aggregate.ota_aggregate_keyed(
        torch.zeros((3, 0), device=cuda), torch.ones(3, device=cuda), key, s)
    assert out.shape == (0,) and ota_aggregate.ota_aggregate.launches == before
    x = torch.randn(2, 6, 9, device=cuda)
    coeff = torch.tensor([0.4, 0.6], device=cuda)
    out = ota_aggregate.ota_aggregate_keyed(x, coeff, key, s)
    assert out.shape == (6, 9)
    _same_bits(out, ota_aggregate.ota_aggregate_keyed_plain(
        x.reshape(2, 54), coeff, key, s).reshape(6, 9))
    with pytest.raises(ValueError, match="scale must be float32"):
        ota_aggregate.ota_aggregate_keyed(x, coeff, key, s.cpu())


def test_keyed_ota_kernel_attributes(cuda):
    attrs = ota_aggregate.keyed_attributes()
    assert attrs["local_bytes"] == 0 and attrs["static_smem"] == 0
    assert 0 < attrs["registers"] <= 128 and attrs["ctas_per_sm"] >= 2


def test_ota_round_on_the_card_draws_no_strip(cuda, monkeypatch):
    """superpose_tree(use_pallas=True) on the card makes one OTA launch and
    no Threefry launch, and gives the bits of the same round with the
    noise drawn as a strip first (the round path before the keyed
    kernel)."""
    from repro_torch.kernels import threefry

    rng = np.random.default_rng(4)
    deltas = {f"leaf{i}": {"d": torch.from_numpy(
        rng.standard_normal((3, *shape)).astype(np.float32) * 0.01).to(cuda)}
        for i, shape in enumerate([(784, 300), (300,), (10,)])}
    args = (deltas, torch.tensor([1e-6, 2e-6, 5e-7], device=cuda),
            torch.tensor([0.2, 0.5, 0.3], device=cuda),
            ota.horizon_keys(0, 2)[1])
    kw = dict(pmax=PMAX, noise_std=1e-3, threshold=0.0, use_pallas=True)
    draws = threefry.threefry_draw.launches
    launches = ota_aggregate.ota_aggregate.launches
    got = ota.superpose_tree(*args, **kw)
    assert threefry.threefry_draw.launches == draws
    assert ota_aggregate.ota_aggregate.launches == launches + 1

    def strip_path(flat, coeff, key, scale):
        noise = scale * prng.normal(key, flat.shape[1], device=flat.device)
        return ota_aggregate.ota_aggregate(flat, coeff, noise)

    monkeypatch.setattr(ota, "ota_aggregate_keyed", strip_path)
    want = ota.superpose_tree(*args, **kw)
    assert threefry.threefry_draw.launches == draws + 1
    for name in deltas:
        _same_bits(got[name]["d"], want[name]["d"])


@pytest.mark.parametrize("p", [1, 54, 266_610])
def test_noise_bits_on_the_card_equal_the_cpu(cuda, p):
    key = ota.horizon_keys(0, 4)[3]
    got = prng.random_bits(key, p, device=cuda)
    torch.testing.assert_close(got.cpu(), prng.random_bits(key, p,
                                                           device="cpu"),
                               rtol=0, atol=0)
    z = prng.normal(key, p, device=cuda)
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    _same_bits(z, prng.normal(key, p, device="cpu"))


@pytest.mark.parametrize("n", [0, 1, 255, 266_610, (1 << 20) + 3])
@pytest.mark.parametrize("kind", ["uniform", "normal", "truncated"])
def test_threefry_kernel_matches_plain_bit_for_bit(cuda, kind, n):
    """One launch per draw, the plain version's bits on the card and on
    the CPU."""
    from repro_torch.kernels import threefry

    key = prng.fold_in(prng.prng_key(n), 2)
    args = {"uniform": (-2.5, 7.0, False, None),
            "normal": (prng.NORMAL_LO, 1.0, True, None),
            "truncated": (*prng.ERF_BOUNDS[(-3.0, 3.0)], True,
                          (float(np.nextafter(np.float32(-3), 0)),
                           float(np.nextafter(np.float32(3), 0))))}[kind]
    lo, hi, normal, clip = args
    before = threefry.threefry_draw.launches
    got = prng.draw(key, n, lo, hi, normal=normal, clip=clip, device=cuda)
    assert threefry.threefry_draw.launches == before + (n > 0)
    assert got.device.type == "cuda" and got.shape == (n,)
    _same_bits(got, prng.draw_plain(key, n, lo, hi, normal=normal,
                                    clip=clip, device=cuda))
    _same_bits(got, prng.draw_plain(key, n, lo, hi, normal=normal,
                                    clip=clip, device="cpu"))


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_draws_on_the_card_equal_the_cpu(cuda, seed):
    """The reference's draws from a seed (channels of the paper cell,
    LeNet's initial weights, a truncated-normal stream) have the same bits
    on the card as on the CPU."""
    from repro_torch.core import channel
    from repro_torch.models.params import init_lenet

    cell = channel.CellConfig(num_devices=300)
    card = channel.sample_channels(seed, cell, 5, device=cuda)
    host = channel.sample_channels(seed, cell, 5)
    for field in ("distances", "gains", "dl_gains"):
        _same_bits(torch.from_numpy(getattr(card, field)),
                   torch.from_numpy(getattr(host, field)))
    w_card, w_host = init_lenet(seed, device=cuda), init_lenet(seed,
                                                              device="cpu")
    for layer in w_host:
        for leaf in w_host[layer]:
            _same_bits(w_card[layer][leaf], w_host[layer][leaf])
    key = prng.fold_in(prng.prng_key(seed), 2)
    _same_bits(prng.truncated_normal(key, -3, 3, 4099, device=cuda),
               prng.truncated_normal(key, -3, 3, 4099, device="cpu"))


def _same_bits(got, want):
    """Equal bits, NaN at the same places (a NaN's payload may differ)."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.is_floating_point:
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(want))
        got, want = got[~nan], want[~nan]
        view = torch.int16 if got.element_size() == 2 else torch.int32
        got, want = got.view(view), want.view(view)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [1, 3, 8, 16, 24, 31, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [17, 32_768, 100_001, 235_200, 1 << 20])
def test_dorefa_kernels_match_plain_bit_for_bit(cuda, n, dtype, bits):
    gen = torch.Generator().manual_seed(n + bits)
    x = (torch.randn(n, generator=gen) * 0.3).to(dtype)
    s = torch.amax(torch.abs(x.float()))
    xc, sc = x.to(cuda), s.to(cuda)
    n_out = -(-n // 32_768) * 32_768
    wrappers = (dorefa.quantize_codes, dorefa.dequantize_codes,
                dorefa.quantize_dequantize)
    before = [fn.launches for fn in wrappers]
    codes = dorefa.quantize_codes(xc, sc, bits, n_out)
    deq = dorefa.dequantize_codes(codes[:n], sc, bits)
    qdq = dorefa.quantize_dequantize(xc, sc, bits)
    torch.cuda.synchronize()
    assert [fn.launches for fn in wrappers] == [b + 1 for b in before]
    assert qdq.dtype == dtype and deq.dtype == torch.float32
    for got, plain in (
        (codes, lambda t, u: dorefa.quantize_codes_plain(t, u, bits, n_out)),
        (qdq, lambda t, u: dorefa.quantize_dequantize_plain(t, u, bits)),
    ):
        _same_bits(got, plain(xc, sc))        # plain version on the card
        _same_bits(got, plain(x, s))          # and on the CPU
    _same_bits(deq, dorefa.dequantize_codes_plain(codes[:n], sc, bits))
    _same_bits(deq, dorefa.dequantize_codes_plain(codes[:n].cpu(), s, bits))
    assert bool(torch.all(codes[n:] == 0))


@pytest.mark.parametrize("bits", [31, 32])
def test_dorefa_codes_saturate_on_the_card(cuda, bits):
    x = torch.linspace(-1.0, 1.0, 4099, device=cuda)
    codes = dorefa.quantize_codes(x, torch.ones((), device=cuda), bits)
    assert codes.min().item() == -(2 ** 31)
    assert codes.max().item() == 2 ** 31 - 1
    _same_bits(codes, dorefa.quantize_codes_plain(x.cpu(), torch.ones(()),
                                                  bits))


@pytest.mark.parametrize("bits", [3, 31, 32])
@pytest.mark.parametrize("scale", [1.0, float("nan"), float("inf"), 0.0, -1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dorefa_kernels_keep_non_finite_values(cuda, dtype, scale, bits):
    """NaN and Inf elements and scales: NaN outputs and code 0 where the
    plain versions (and the reference) give them."""
    gen = torch.Generator().manual_seed(bits)
    x = torch.randn(4099, generator=gen) * 0.3
    x[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.5,
                          -0.5, 0.0, -0.0, 1e30, -float("nan")])
    x = x.to(dtype)
    s = torch.tensor(scale, dtype=torch.float32)
    xc, sc = x.to(cuda), s.to(cuda)
    codes = dorefa.quantize_codes(xc, sc, bits, 32_768)
    deq = dorefa.dequantize_codes(codes[:4099], sc, bits)
    qdq = dorefa.quantize_dequantize(xc, sc, bits)
    _same_bits(codes, dorefa.quantize_codes_plain(x, s, bits, 32_768))
    _same_bits(deq, dorefa.dequantize_codes_plain(codes[:4099].cpu(), s,
                                                  bits))
    _same_bits(qdq, dorefa.quantize_dequantize_plain(x, s, bits))
    assert codes[0].item() == 0 and torch.isnan(qdq[0]).item()


def test_dorefa_kernels_refuse_and_skip(cuda):
    """Empty inputs return without a launch; a scale off the card, an
    integer input to the quantizers or float codes are refused."""
    wrappers = (dorefa.quantize_codes, dorefa.dequantize_codes,
                dorefa.quantize_dequantize)
    before = [fn.launches for fn in wrappers]
    s = torch.ones((), device=cuda)
    assert dorefa.quantize_codes(torch.zeros(0, device=cuda), s, 4).shape == (0,)
    assert dorefa.dequantize_codes(
        torch.zeros(0, dtype=torch.int32, device=cuda), s, 4).shape == (0,)
    assert dorefa.quantize_dequantize(torch.zeros(0, device=cuda), s,
                                      4).shape == (0,)
    assert [fn.launches for fn in wrappers] == before
    x = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="scale must be one float32"):
        dorefa.quantize_codes(x, torch.ones(()), 4)
    with pytest.raises(TypeError, match="must be one of"):
        dorefa.quantize_dequantize(x.to(torch.int32), s, 4)
    with pytest.raises(TypeError, match="must be one of"):
        dorefa.dequantize_codes(x, s, 4)


@pytest.mark.parametrize("dtype,offset", [(torch.float32, o) for o in (1, 2, 3)]
                         + [(torch.bfloat16, o) for o in range(1, 8)])
def test_quantize_codes_reads_views_at_any_offset(cuda, dtype, offset):
    """x = buf[o:o + n] off its 16-byte boundary, n = 1, 2, 3 (mod 8),
    zero codes past n, NaN and Inf scales: the 16-byte kernel's head, tail
    and per-element code stores equal the plain version bit for bit."""
    gen = torch.Generator().manual_seed(offset)
    buf = (torch.randn(70_000, generator=gen) * 0.3).to(dtype).to(cuda)
    for n in (1, 2, 3, 9, 17, 1001, 4099, 65_537):
        x = buf[offset:offset + n]
        assert x.data_ptr() % 16 != 0
        for n_out in (n, n + 1, n + 7, -(-n // 32_768) * 32_768 + 32_768):
            for scale in (x.float().abs().max(),
                          torch.tensor(float("nan"), device=cuda),
                          torch.tensor(float("inf"), device=cuda)):
                s = scale.reshape(()).float()
                for bits in (3, 8, 32):
                    got = dorefa.quantize_codes(x, s, bits, n_out)
                    _same_bits(got, dorefa.quantize_codes_plain(
                        x, s, bits, n_out))
                    _same_bits(got, dorefa.quantize_codes_plain(
                        x.cpu(), s.cpu(), bits, n_out))


@pytest.mark.parametrize("bits", [1, 8, 31, 32])
def test_dequantize_codes_reads_views_at_any_offset(cuda, bits):
    """codes = buf[o:o + n] at every element offset o = 0..7 and every
    n mod 8, INT_MIN and INT_MAX among the codes, under a finite, zero and
    NaN scale: the int4 kernel's head, vectors, tail and per-element stores
    equal the plain version on the card and on the CPU, bit for bit."""
    gen = torch.Generator().manual_seed(bits)
    hi = 2 ** min(bits, 31) - 1
    buf = torch.randint(-hi, hi + 1, (70_000,), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    buf[[3, 10, 17, 40_001]] = torch.tensor(
        [-(2 ** 31), 2 ** 31 - 1, 0, -(2 ** 31)], dtype=torch.int32)
    buf = buf.to(cuda)
    before = dorefa.dequantize_codes.launches
    calls = 0
    for o in range(8):
        for n in [1 + r for r in range(8)] + [24 + r for r in range(8)] \
                + [65_536 + r for r in range(8)]:
            c = buf[o:o + n]
            for scale in (0.37, 0.0, float("nan")):
                s = torch.tensor(scale, dtype=torch.float32, device=cuda)
                got = dorefa.dequantize_codes(c, s, bits)
                calls += 1
                assert got.dtype == torch.float32 and got.shape == (n,)
                _same_bits(got, dorefa.dequantize_codes_plain(c, s, bits))
                _same_bits(got, dorefa.dequantize_codes_plain(
                    c.cpu(), s.cpu(), bits))
    assert dorefa.dequantize_codes.launches == before + calls


def test_dequantize_codes_kernel_attributes(cuda):
    attrs = dorefa.dequantize_codes_attributes()
    assert attrs["local_bytes"] == 0 and attrs["static_smem"] == 0
    assert 0 < attrs["registers"] <= 64 and attrs["ctas_per_sm"] >= 4


def test_quantize_codes_kernel_attributes(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        attrs = dorefa.quantize_codes_attributes(dtype)
        assert attrs["local_bytes"] == 0 and attrs["ctas_per_sm"] >= 1


@pytest.mark.parametrize("bits", [1, 8, 31, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_dequantize_reads_views_at_any_offset(cuda, dtype, bits):
    """x = buf[o:o + n] at every element offset o = 0..7 and every n mod 8,
    NaN and +-Inf among the elements, under a finite, zero, NaN and Inf
    scale: the 16-byte kernel's head, vectors, tail and per-element stores
    equal the plain version on the card and on the CPU, bit for bit."""
    gen = torch.Generator().manual_seed(bits)
    buf = torch.randn(70_000, generator=gen) * 0.3
    buf[[3, 10, 17, 40_001]] = torch.tensor(
        [float("nan"), float("inf"), -float("inf"), float("nan")])
    buf = buf.to(dtype).to(cuda)
    before = dorefa.quantize_dequantize.launches
    calls = 0
    for o in range(8):
        for n in [1 + r for r in range(8)] + [24 + r for r in range(8)] \
                + [65_536 + r for r in range(8)]:
            x = buf[o:o + n]
            for scale in (x.float().nan_to_num(0, 0, 0).abs().max(),
                          torch.zeros((), device=cuda),
                          torch.tensor(float("nan"), device=cuda),
                          torch.tensor(float("inf"), device=cuda)):
                s = scale.reshape(()).float()
                got = dorefa.quantize_dequantize(x, s, bits)
                calls += 1
                assert got.dtype == dtype and got.shape == (n,)
                _same_bits(got, dorefa.quantize_dequantize_plain(x, s, bits))
                _same_bits(got, dorefa.quantize_dequantize_plain(
                    x.cpu(), s.cpu(), bits))
    assert dorefa.quantize_dequantize.launches == before + calls


def test_quantize_dequantize_kernel_attributes(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        attrs = dorefa.quantize_dequantize_attributes(dtype)
        assert attrs["local_bytes"] == 0 and attrs["static_smem"] == 0
        assert 0 < attrs["registers"] <= 64 and attrs["ctas_per_sm"] >= 4


@pytest.mark.parametrize("bits", [1, 4, 8, 16])
def test_codec_on_the_card_equals_the_cpu(cuda, bits):
    rng = np.random.default_rng(bits)
    tree = {"fc1": {"w": rng.standard_normal((784, 300)) * 0.01,
                    "b": rng.standard_normal(300) * 0.01},
            "fc3": {"w": rng.standard_normal((100, 10)) * 0.1}}
    cpu = tree_lib.tree_map(lambda v: torch.tensor(v, dtype=torch.float32),
                            tree)
    card = tree_lib.tree_map(lambda v: v.to(cuda), cpu)
    enc = compression.encode_tree(card, bits, use_pallas=True)
    want = compression.encode_tree(cpu, bits, use_pallas=True)
    assert enc.total_bits == want.total_bits
    for c, w in zip(enc.codes + enc.scales, want.codes + want.scales):
        _same_bits(c, w)
    dec = tree_lib.tree_flatten(compression.decode_tree(enc, use_pallas=True))
    ref = tree_lib.tree_flatten(compression.decode_tree(want, use_pallas=True))
    for d, w in zip(dec[0], ref[0]):
        _same_bits(d, w)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_round_on_the_card_equals_the_cpu(cuda, use_pallas):
    """The top-k round's aggregate: the same kept, bits and update bits on
    the card (aggregation kernel, float64 fused multiply-adds) as on the
    CPU."""
    rng = np.random.default_rng(5)
    deltas = {"a": {"w": rng.standard_normal((3, 300, 100)) * 0.01},
              "b": {"w": rng.standard_normal((3, 1000)) * 0.01}}
    cpu = tree_lib.tree_map(lambda v: torch.tensor(v, dtype=torch.float32),
                            deltas)
    budgets = torch.tensor([4e5, 1e5, 3e6])
    w = torch.tensor([0.2, 0.3, 0.5])
    kw = dict(payload=31_000 * 32, topk=0.1, paper_exact=False,
              use_pallas=use_pallas)
    before = aggregate.weighted_aggregate.launches
    got = fl_engine._sparse_quantize_aggregate(
        tree_lib.tree_map(lambda v: v.to(cuda), cpu), budgets.to(cuda),
        w.to(cuda), **kw)
    assert aggregate.weighted_aggregate.launches == before + int(use_pallas)
    want = fl_engine._sparse_quantize_aggregate(cpu, budgets, w, **kw)
    _same_bits(got[1], want[1])
    _same_bits(got[2], want[2])
    for g, r in zip(tree_lib.tree_flatten(got[0])[0],
                    tree_lib.tree_flatten(want[0])[0]):
        _same_bits(g, r)


def _legacy_round_on(device, monkeypatch, *, compression="adaptive",
                     ota_round=None):
    """fl._legacy_round on ``device`` with local_update replaced by a
    hand-over of three seeded LeNet-shaped deltas; float64 weights that
    float32 does not hold and budgets giving b = 4, 1 and 32."""
    from repro_torch.config import FLConfig
    from repro_torch.core import fl
    from repro_torch.models.fl_models import LenetFLModel

    rng = np.random.default_rng(11)
    names = [("fc1", "w"), ("fc1", "b"), ("fc2", "w"), ("fc2", "b"),
             ("fc3", "w"), ("fc3", "b")]
    shapes = dict(zip(names, [(784, 300), (300,), (300, 100), (100,),
                              (100, 10), (10,)]))

    def lenet(scale):
        out = {}
        for (a, c), shape in shapes.items():
            out.setdefault(a, {})[c] = torch.from_numpy(
                (rng.standard_normal(shape) * scale).astype(np.float32)
            ).to(device)
        return out

    # zero weights under OTA, so the new weights are the update itself
    params = lenet(0.0 if ota_round else 0.05)
    given = iter([lenet(0.01) for _ in range(3)])
    monkeypatch.setattr(fl, "local_update", lambda *a, **kw: next(given))
    sizes = np.array([37.0, 52.0, 80.0])
    cfg = (FLConfig(uplink="ota", compression="none", power_mode="ota-align",
                    ota_noise=1e-9, use_pallas=True)
           if ota_round else FLConfig(compression=compression))
    dataset = type("D", (), dict(x_train=np.zeros((1, 1), np.float32),
                                 y_train=np.zeros(1, np.int32)))
    return fl._legacy_round(
        params, (5, 0, 9), np.array([1.3e6 + 0.37, 4.1e5, 3.0e7]),
        sizes / sizes.sum(), dataset, [[0]] * 10, cfg, 266_610 * 32,
        need_norms=False, model=LenetFLModel(), ota=ota_round)


@pytest.mark.parametrize("compression", ["adaptive", "none"])
def test_legacy_round_on_the_card_equals_the_cpu(cuda, compression,
                                                 monkeypatch):
    """The legacy round's eager DoReFa codec and its FedAvg sum (one
    float32 product and one sum per client, in order) on the same deltas:
    the same new weights, bit for bit, on the card as on the CPU, and no
    kernel launch."""
    before = (aggregate.weighted_aggregate.launches,
              ota_aggregate.ota_aggregate.launches,
              dorefa.quantize_dequantize.launches)
    got = _legacy_round_on(cuda, monkeypatch, compression=compression)
    assert (aggregate.weighted_aggregate.launches,
            ota_aggregate.ota_aggregate.launches,
            dorefa.quantize_dequantize.launches) == before
    want = _legacy_round_on("cpu", monkeypatch, compression=compression)
    assert got[1] == want[1] and got[2] == want[2]
    for a in want[0]:
        for c in want[0][a]:
            assert got[0][a][c].device.type == "cuda"
            _same_bits(got[0][a][c], want[0][a][c])


def test_legacy_ota_round_launches_the_keyed_kernel_once(cuda, monkeypatch):
    """Under OTA with use_pallas the legacy round stacks its deltas and
    launches the keyed OTA kernel once (no strip, no aggregation launch);
    the update is the CPU's within rtol 1e-5, and atol 1e-5 of its largest
    element where noise and sum cancel (the energy sums behind eta run in
    another order on the card)."""
    from repro_torch.kernels import threefry

    ota_round = dict(gains=np.array([1e-6, 2.5e-6, 7e-7]),
                     key=ota.horizon_keys(3, 2)[1], pmax=PMAX)
    before = (aggregate.weighted_aggregate.launches,
              ota_aggregate.ota_aggregate.launches,
              threefry.threefry_draw.launches)
    got = _legacy_round_on(cuda, monkeypatch, ota_round=ota_round)
    assert (aggregate.weighted_aggregate.launches,
            ota_aggregate.ota_aggregate.launches,
            threefry.threefry_draw.launches) == (before[0], before[1] + 1,
                                                 before[2])
    want = _legacy_round_on("cpu", monkeypatch, ota_round=ota_round)
    assert got[1] == want[1] == [32] * 3
    for a in want[0]:
        for c in want[0][a]:
            ref = want[0][a][c].numpy()
            np.testing.assert_allclose(got[0][a][c].cpu().numpy(), ref,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())


# tests/test_kernels.py's flash-decode shapes (B, Hkv, G, D, S), plus
# Qwen2-0.5B's head layout (Hkv = 2, G = 7, D = 64) at a short cache
FLASH_SHAPES = [(1, 1, 1, 128, 256), (2, 2, 3, 128, 512), (1, 4, 2, 64, 1024),
                (3, 1, 8, 128, 256), (4, 2, 7, 64, 2048)]
# (atol, rtol): float32 at tests/test_kernels.py's 1e-5; in bfloat16 the
# kernel, its plain version and the oracle read the same inputs and compute
# in float32, so they differ by at most one bfloat16 rounding of the output
# (2^-7 relative), far inside that test's 5e-2
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_decode_kernel_matches_plain(cuda, shape, dtype):
    b, hkv, g, d, s = shape
    gen = torch.Generator().manual_seed(b * 1000 + s + g)
    q = torch.randn(b, hkv, g, d, generator=gen).to(dtype).to(cuda)
    k = torch.randn(b, s, hkv, d, generator=gen).to(dtype).to(cuda)
    v = torch.randn(b, s, hkv, d, generator=gen).to(dtype).to(cuda)
    atol, rtol = FLASH_TOL[dtype]
    for vl in (0, 1, 129, 300, s - 1, s, s + 5):
        before = flash_decode.flash_decode.launches
        got = flash_decode.flash_decode(q, k, v, vl)
        # the valid length read from the card, as the path hands it over
        again = flash_decode.flash_decode(
            q, k, v, torch.tensor(vl, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert flash_decode.flash_decode.launches == before + 2
        assert torch.equal(got, again) and got.dtype == dtype
        want = flash_decode.flash_decode_plain(q, k, v, vl)
        if min(vl, s) == 0:
            assert torch.equal(got, torch.zeros_like(got))
            continue
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        oracle = ref.flash_decode_ref(q, k, v, vl)
        torch.testing.assert_close(got.float(), oracle.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("g", range(1, 9))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_edges_of_its_tiles(cuda, dtype, d, g):
    """valid_len across the bfloat16 kernel's mma edges (8 and 16
    positions) and its warps' runs (16 positions each, in turn), at every
    G and both head widths, in both types; zeros at valid_len = 0."""
    s = 512
    gen = torch.Generator().manual_seed(100 * g + d)
    q = torch.randn(2, 2, g, d, generator=gen).to(dtype).to(cuda)
    k = torch.randn(2, s, 2, d, generator=gen).to(dtype).to(cuda)
    v = torch.randn(2, s, 2, d, generator=gen).to(dtype).to(cuda)
    atol, rtol = FLASH_TOL[dtype]
    zeros = flash_decode.flash_decode(q, k, v, 0)
    assert torch.equal(zeros, torch.zeros_like(zeros))
    for vl in (1, 7, 8, 15, 16, 17, 63, 64, 65, s - 1, s):
        got = flash_decode.flash_decode(
            q, k, v, torch.tensor(vl, dtype=torch.int32, device=cuda))
        want = flash_decode.flash_decode_plain(q, k, v, vl)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


def test_flash_decode_kernel_attributes(cuda):
    """The bfloat16 kernel fits two CTAs on an SM without spilling."""
    for d in (64, 128):
        attrs = flash_decode.kernel_attributes(torch.bfloat16, d, 7)
        assert attrs["local_bytes"] == 0 and attrs["ctas_per_sm"] >= 2
        assert attrs["dynamic_smem"] <= 113 * 1024


def test_flash_decode_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 9, 64, device=cuda)
    kv = torch.zeros(1, 256, 1, 64, device=cuda)
    with pytest.raises(ValueError, match="1 <= G <= 8"):
        flash_decode.flash_decode(q, kv, kv, 1)
    q = torch.zeros(1, 1, 2, 32, device=cuda)
    kv = torch.zeros(1, 256, 1, 32, device=cuda)
    with pytest.raises(ValueError, match="D in"):
        flash_decode.flash_decode(q, kv, kv, 1)
    with pytest.raises(TypeError, match="share one type"):
        flash_decode.flash_decode(torch.zeros(1, 1, 2, 64, device=cuda),
                                  kv.new_zeros(1, 256, 1, 64).bfloat16(),
                                  kv.new_zeros(1, 256, 1, 64).bfloat16(), 1)
