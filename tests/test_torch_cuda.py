"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a host without a CUDA card every test skips (the
decision is taken inside the fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance rtol 1e-5 / atol 1e-6, as tests/test_kernels.py holds the Pallas
kernels (the kernel and the plain version sum in the same order, so in
practice they agree to the bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import aggregate  # noqa: E402

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6


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
