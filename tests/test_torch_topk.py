"""The port's top-k FL path and bucketed client bank against the JAX
package's.

In this process: ``compression.topk_plan`` against the reference's under
``jax.jit`` (the FL round's form: ``spend / (2 + idx)`` is a product with
the float32 reciprocal there), ``topk_mask`` against the numpy oracle of
tests/test_compression.py:200 (kept = 0 and N, tied magnitudes broken by
position), ``fl_engine._sparse_quantize_aggregate`` against the
reference's under ``jax.jit`` (kept and bits exact, the update bit-equal,
both ``use_pallas`` settings), and ``BucketedClientBank.gather`` against
the reference's bank and the port's padded bank, bit for bit.

Whole FL runs go through the shimmed subprocess of test_torch_harness (all
of them in one call): ``topk=0.1`` on the NOMA uplink with and without the
kernel path, and on TDMA, each under tests/test_fl_engine.py:
_assert_equal_runs (TDMA rates and ratios within 2 ulp, ROADMAP.md queue
3).  A bucketed-bank run equals the padded run's logs and parameters to the
bit.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from test_torch_harness import (  # noqa: E402,F401
    assert_equal_runs, flat, one_torch_thread, run_reference, tree,
)

from repro.core import compression as RC  # noqa: E402
from repro.core import fl_engine as ref_engine  # noqa: E402
from repro.data import client_bank as ref_bank  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, fl_engine  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.data import client_bank  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.data.client_bank import (  # noqa: E402
    BucketedClientBank, ClientBank,
)

TDMA_RATE_ULP = 2

# the reference's functions under jax.jit, as its FL round runs them
_jit_topk_plan = jax.jit(RC.topk_plan, static_argnums=0,
                         static_argnames="topk")
_jit_sparse = jax.jit(
    ref_engine._sparse_quantize_aggregate,
    static_argnames=("payload", "topk", "paper_exact", "use_pallas"),
)


@pytest.mark.parametrize("num_params,topk", [
    (64, 0.8), (1024, 1.0), (1024, 0.01), (266_610, 0.1), (266_610, 0.5),
])
def test_topk_plan_matches_the_jitted_reference(num_params, topk):
    idx = C.topk_index_bits(num_params)
    per = 2 + idx
    budgets = np.concatenate([
        [0.0, 31.0, 32.0, 33.0, 300.0, 700.0, 1e6, 1e9, 8_531_520.0],
        32.0 + per * np.arange(1, 400, 7, dtype=np.float64),   # floor edges
        np.random.default_rng(num_params).uniform(0, 5e6, 200),
    ])
    want_k, want_b = _jit_topk_plan(num_params, jnp.asarray(budgets),
                                    topk=topk)
    kept, bits = C.topk_plan(num_params, torch.from_numpy(budgets),
                             topk=topk)
    assert kept.dtype == bits.dtype == torch.int32
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("ties", [False, True])
def test_topk_mask_matches_the_numpy_oracle(ties):
    """Row i keeps its kept[i] largest magnitudes, ties to the lower
    position; kept = 0 is an all-zero row, kept = N the identity."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal((5, 37)).astype(np.float32)
    if ties:
        f = np.round(f * 2.0) / 2.0          # many equal magnitudes
        f[4, :10] = 0.0
        f[4, 10:20] = -0.0
    kept = [0, 1, 5, 37, 20]
    mask = C.topk_mask(torch.from_numpy(f), torch.tensor(kept)).numpy()
    for i, k in enumerate(kept):
        keep = np.argsort(-np.abs(f[i]), kind="stable")[:k]
        want = np.zeros(37, np.float32)
        want[keep] = 1.0
        np.testing.assert_array_equal(mask[i], want)
    assert mask[0].sum() == 0
    np.testing.assert_array_equal(mask[3], np.ones(37, np.float32))
    np.testing.assert_array_equal(
        mask, np.asarray(RC.topk_mask(jnp.asarray(f), jnp.asarray(kept))))


def _sparse_both(deltas, budgets, agg_w, *, payload, topk, paper_exact,
                 use_pallas):
    """The reference's and the port's _sparse_quantize_aggregate on the same
    numpy inputs; the reference under jax.jit, as its round runs it."""
    want = _jit_sparse(
        jax.tree_util.tree_map(jnp.asarray, deltas), jnp.asarray(budgets),
        jnp.asarray(agg_w), payload=payload, topk=topk,
        paper_exact=paper_exact, use_pallas=use_pallas)
    got = fl_engine._sparse_quantize_aggregate(
        jax.tree_util.tree_map(torch.from_numpy, deltas),
        torch.from_numpy(budgets).to(torch.float32), torch.from_numpy(agg_w),
        payload=payload, topk=topk, paper_exact=paper_exact,
        use_pallas=use_pallas)
    return got, want


def _assert_sparse_equal(got, want):
    (update, kept, bits), (w_update, w_kept, w_bits) = got, want
    np.testing.assert_array_equal(kept.numpy(), np.asarray(w_kept))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(w_bits))
    w_leaves = jax.tree_util.tree_leaves(w_update)
    leaves = jax.tree_util.tree_leaves(update)
    assert len(leaves) == len(w_leaves)
    for g, w in zip(leaves, w_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("paper_exact", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_quantize_aggregate_matches_the_reference(use_pallas,
                                                         paper_exact):
    """tests/test_fl_engine.py:332's instance: a starved client at the 1-bit
    floor, one in between and one at b = 32 (passed through)."""
    rng = np.random.default_rng(0)
    k, p = 3, 64
    deltas = {"w": rng.standard_normal((k, 8, 4)).astype(np.float32),
              "b": rng.standard_normal((k, 32)).astype(np.float32)}
    budgets = np.asarray([300.0, 700.0, 1e6])
    agg_w = np.asarray([0.2, 0.3, 0.5], np.float32)
    got, want = _sparse_both(deltas, budgets, agg_w, payload=p * 32,
                             topk=0.8, paper_exact=paper_exact,
                             use_pallas=use_pallas)
    _assert_sparse_equal(got, want)
    kept, bits = got[1].numpy(), got[2].numpy()
    assert kept[0] < p and bits[2] == 32


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_quantize_aggregate_matches_at_lenet_width(use_pallas):
    """The concatenated (3, 266,610) LeNet update at topk = 0.1, with a
    b = 32 client beside quantized ones."""
    rng = np.random.default_rng(1)
    shapes = {"fc1": {"w": (784, 300), "b": (300,)},
              "fc2": {"w": (300, 100), "b": (100,)},
              "fc3": {"w": (100, 10), "b": (10,)}}
    deltas = {a: {c: (rng.standard_normal((3, *s)) * 0.01).astype(np.float32)
                  for c, s in v.items()} for a, v in shapes.items()}
    got, want = _sparse_both(
        deltas, np.asarray([3.2e6, 8e5, 2e6]),
        np.asarray([0.2, 0.3, 0.5], np.float32), payload=266_610 * 32,
        topk=0.1, paper_exact=False, use_pallas=use_pallas)
    _assert_sparse_equal(got, want)
    np.testing.assert_array_equal(got[1].numpy(), [26_661] * 3)


def _skewed_world(rng, d=6):
    """tests/test_client_bank.py:25's shards: sizes spanning several pow-2
    batch buckets at bs = 4."""
    sizes = [3, 4, 5, 8, 9, 12, 12, 20, 65]
    n = sum(sizes)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    bounds = np.cumsum([0] + sizes)
    shards = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(sizes))]
    return x, y, shards


def test_bucketed_gather_matches_the_reference_and_the_padded_bank():
    x, y, shards = _skewed_world(np.random.default_rng(0))
    padded = ClientBank.build(x, y, shards, 4, device="cpu")
    bucketed = BucketedClientBank.build(x, y, shards, 4, device="cpu")
    want_bank = ref_bank.BucketedClientBank.build(x, y, shards, 4)
    assert bucketed.num_devices == padded.num_devices == 9
    np.testing.assert_array_equal(bucketed.bucket_of, want_bank.bucket_of)
    np.testing.assert_array_equal(bucketed.row_of, want_bank.row_of)
    for devs in ([0], [8, 0], [3, 7, 1], [2, 4, 6, 8], list(range(9))):
        nb = bucketed.n_batches_for(devs)
        assert nb == padded.n_batches_for(devs) == want_bank.n_batches_for(devs)
        gx, gy = bucketed.gather(devs, nb)
        px, py = padded.gather(devs, nb)
        wx, wy = want_bank.gather(devs, nb)
        for got, pad, want in ((gx, px, wx), (gy, py, wy)):
            np.testing.assert_array_equal(got.numpy(), pad.numpy())
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for xb, _ in bucketed.buckets:
        nb = xb.shape[1]
        assert nb & (nb - 1) == 0
    assert bucketed.nbytes < padded.nbytes


def test_padded_bank_warns_near_the_card_memory(monkeypatch):
    """The padded bank warns when it would claim more than half the card
    (the card's memory is read with torch.cuda.mem_get_info); the CPU
    reports no limit."""
    x, y, shards = _skewed_world(np.random.default_rng(1))
    assert client_bank._device_memory_limit("cpu") is None
    monkeypatch.setattr(client_bank, "_device_memory_limit",
                        lambda device: 2 * 9 * 17 * 4 * (6 * 4 + 4) - 1)
    with pytest.warns(ResourceWarning, match="client_bank='bucketed'"):
        ClientBank.build(x, y, shards, 4, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        BucketedClientBank.build(x, y, shards, 4, device="cpu")


def test_banks_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, shards = _skewed_world(np.random.default_rng(2))
    for cls in (ClientBank, BucketedClientBank):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            cls.build(x, y, shards, 4)


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------

WORLD = dict(m=12, samples=800, k=3, t=3)
RUNS = {
    "noma": dict(uplink="noma", use_pallas=True),
    "noma-einsum": dict(uplink="noma", use_pallas=False),
    "tdma": dict(uplink="tdma", use_pallas=True),
}


def _cfg_args(run):
    return dict(
        num_devices=WORLD["m"], group_size=WORLD["k"],
        num_rounds=WORLD["t"], scheduler="lazy-gwmin", fl_engine="batched",
        compression="adaptive", power_mode="mapel", topk=0.1, seed=0,
        **RUNS[run],
    )


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("topk"), "fl_runs", {"runs": [
        dict(key=run, num_devices=WORLD["m"], num_samples=WORLD["samples"],
             cfg=_cfg_args(run)) for run in RUNS
    ]})


def _world():
    ds = make_mnist_like(num_samples=WORLD["samples"], seed=0)
    cell = channel.CellConfig(num_devices=WORLD["m"])
    shards = dirichlet_partition(ds.y_train, WORLD["m"], seed=0)
    return ds, cell, shards


@pytest.mark.parametrize("run", sorted(RUNS))
def test_topk_run_matches_the_reference(reference_runs, run):
    want = {name[len(run) + 1:]: v for name, v in reference_runs.items()
            if name.startswith(run + "/")}
    ds, cell, shards = _world()
    bundle = channel.ChannelBundle(
        want["distances"], want["gains"], want["dl_gains"])
    got = fl.run_federated_learning(
        ds, shards, cell, FLConfig(**_cfg_args(run)), channels=bundle,
        init_params=tree(want, "init/"), device="cpu",
    )
    assert_equal_runs(got, want, WORLD["t"],
                      rate_ulp=TDMA_RATE_ULP if run == "tdma" else 0)
    # the honest sparse ratios: I / S_k from the realized (kept, bits)
    assert all(np.all(log.compression_ratios > 1.0) for log in got.logs)


@pytest.mark.parametrize("topk", [1.0, 0.1])
def test_bucketed_run_equals_the_padded_run(topk):
    """Same logs and final parameters, to the bit, through either bank."""
    ds, cell, shards = _world()
    runs = []
    for bank in ("padded", "bucketed"):
        cfg = FLConfig(**{**_cfg_args("noma"), "client_bank": bank,
                          "topk": topk})
        runs.append(fl.run_federated_learning(ds, shards, cell, cfg,
                                              device="cpu"))
    padded, bucketed = runs
    engine = fl_engine.BatchedRoundEngine(
        ds, shards, FLConfig(**{**_cfg_args("noma"), "client_bank":
                                "bucketed"}), 32, device="cpu")
    assert len(engine.bank.buckets) > 1          # the rounds span buckets
    for a, b in zip(padded.logs, bucketed.logs):
        assert a.devices == b.devices and a.test_accuracy == b.test_accuracy
        for field in ("bits", "rates", "compression_ratios"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(padded.times(), bucketed.times())
    want, got = flat(padded.final_params, ""), flat(bucketed.final_params, "")
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
