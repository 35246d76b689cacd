"""Token payloads through the port's FL engines against the JAX
package's, on the reference's token world (tests/test_fl_engine.py:
token_world: ``make_token_dataset(vocab_size=64, num_samples=400,
seq_len=8)``, M=12, Dirichlet shards by pseudo-class; the
``tiny-transformer`` at lr 0.05, batch 8, lazy GWMIN, max power, adaptive
DoReFa, K=3, T=3).

The reference runs go through one shimmed subprocess for the file (the
worker's ``token_runs`` task): the batched and the legacy engine under NOMA
and TDMA, the bucketed bank, top-k 0.05, and the batched NOMA run again
with XLA's compilation off (``jax.disable_jit``).  Each port run on the
CPU is held to tests/test_fl_engine.py:_assert_equal_runs for its logs:
schedules, bits, rates, ratios and times exact (TDMA rates and ratios
within 2 ulp), accuracy within 0.02.

The parameter drift leaves the contract's mean bound (1e-6), as F3
(ROADMAP.md queue 3) records: the forward pass is the reference's to the
bit (tests/test_torch_models.py), but the bf16 backward pass rounds in
other places under XLA's fusions than under torch's autograd, so the
gradients differ by up to 3 bf16 ulps of each leaf's largest entry, and
every update by about a bf16 ulp of itself (0.3% to 0.7% of each leaf's
change over the run).  The reference shows the same against itself: run
op by op (``jax.disable_jit``, every bf16 result rounded, as torch's are)
against its compiled run, the logs are equal and the worst leaf's drift is
mean 1.16e-5, max 3.6e-4 (the port's: 1.01e-5, 3.3e-4); a one-ulp move of
one initial float32 weight, by contrast, moves the final weights by 1e-12
at this world.  Each run is held to F3's shape: logs exact, accuracy
within 0.02, and every leaf's mean and max drift below its model's
F3_LIMITS.  The limits lie above the worst sound run and below two wrong
runs, both read by tests/_token_measure.py and held by
test_f3_limits_reject_a_wrong_run: the run that did not train (the initial
weights) and the run that dropped one client from the last round's sum.
The port's own engines agree with each other as the reference's do:
batched and legacy within the whole contract, the padded and the bucketed
bank to the bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    ACC_ATOL, PARAM_MAX_ATOL, PARAM_MEAN_ATOL, TOKEN_DATA, TOKEN_M,
    assert_equal_runs,
    one_torch_thread, param_drift, run_reference, token_world, tree_arrays,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths  # noqa: E402

T = 3
BASE = dict(num_devices=TOKEN_M, group_size=3, num_rounds=T,
            learning_rate=0.05, batch_size=8, scheduler="lazy-gwmin",
            power_mode="max", compression="adaptive",
            model="tiny-transformer", seed=0)
RUNS = {
    "batched-noma": dict(fl_engine="batched", use_pallas=True),
    "legacy-noma": dict(fl_engine="legacy"),
    "batched-tdma": dict(fl_engine="batched", uplink="tdma"),
    "legacy-tdma": dict(fl_engine="legacy", uplink="tdma"),
    "bucketed": dict(fl_engine="batched", client_bank="bucketed",
                     use_pallas=True),
    "topk": dict(fl_engine="batched", topk=0.05, use_pallas=True),
}
# F3's limits per model, on every leaf's (mean, max) drift after the last
# round: above the sound runs' worst (and the reference's own op-by-op
# run's) and below the worst leaf of a wrong run, the mean below the run
# that dropped one client from the last round, the max below that run's or
# the untrained weights' (tests/_token_measure.py; the readings are in
# ROADMAP.md's F3)
F3_LIMITS = {
    "tiny-transformer": (4e-5, 2.5e-3),      # sound 1.27e-5, 1.1e-3
    "tiny-transformer-1m": (8e-5, 3.2e-2),   # sound 1.7e-5, 0.027
    "qwen2_0_5b:smoke": (1.6e-4, 5e-2),      # sound 9.2e-5, 0.0282
}
# the batched NOMA run with XLA's compilation off: F3's witness
WITNESS = dict(RUNS["batched-noma"])


def _cfg(key):
    return FLConfig(**BASE, **RUNS[key])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    runs = [dict(key=key, num_devices=TOKEN_M, data=TOKEN_DATA,
                 cfg=dict(BASE, **over)) for key, over in RUNS.items()]
    runs.append(dict(key="witness", num_devices=TOKEN_M, data=TOKEN_DATA,
                     cfg=dict(BASE, **WITNESS), eager=True))
    return run_reference(tmp_path_factory.mktemp("tokens"), "token_runs",
                         {"runs": runs})


@pytest.fixture(scope="module")
def world():
    return token_world()


@pytest.fixture(scope="module")
def port_runs(world):
    ds, cell, shards = world
    return {key: fl.run_federated_learning(ds, shards, cell, _cfg(key),
                                           device="cpu") for key in RUNS}


def assert_f3_drift(params, want, prefix, model):
    """F3's shape of the final parameters' drift (module docstring)."""
    mean_atol, max_atol = F3_LIMITS[model]
    for path, (mean, worst) in param_drift(params, want, prefix).items():
        assert mean < mean_atol, f"{path}: mean drift {mean}"
        assert worst < max_atol, f"{path}: max drift {worst}"


def dropped_client_run(ds, shards, cell, cfg, monkeypatch):
    """A wrong run: the port's, with the last scheduled client of the last
    round left out of that round's FedAvg sum (its weight 0, the others
    renormalized)."""
    agg_weights, calls = fl._agg_weights, []

    def dropped(sizes, devs):
        w = agg_weights(sizes, devs)
        calls.append(len(devs))
        if len(calls) == cfg.num_rounds:
            assert len(devs) > 1
            w = w.copy()
            w[-1] = 0.0
            w = w / w.sum()
        return w

    monkeypatch.setattr(fl, "_agg_weights", dropped)
    res = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert len(calls) == cfg.num_rounds
    return res


def _want(reference, key):
    return {k[len(key) + 1:]: v for k, v in reference.items()
            if k.startswith(key + "/")}


@pytest.mark.parametrize("key", list(RUNS))
def test_token_run_matches_the_reference(reference, port_runs, key):
    res = port_runs[key]
    want = _want(reference, key)
    assert_equal_runs(res, want, T, drift=False,
                      rate_ulp=2 if "tdma" in key else 0)
    assert_f3_drift(res.final_params, reference, f"{key}/final/",
                    BASE["model"])


@pytest.mark.parametrize("control", ["no-training", "dropped-client"])
def test_f3_limits_reject_a_wrong_run(reference, world, monkeypatch,
                                      control):
    """F3's limits are tight enough to fail a wrong run of the batched NOMA
    world: its initial weights (no training), or the run that dropped one
    client from the last round."""
    key = "batched-noma"
    if control == "no-training":
        params = fl.get_fl_model(BASE["model"]).init(0, device="cpu")
    else:
        ds, cell, shards = world
        params = dropped_client_run(ds, shards, cell, _cfg(key),
                                    monkeypatch).final_params
    with pytest.raises(AssertionError, match="drift"):
        assert_f3_drift(params, reference, f"{key}/final/", BASE["model"])


def test_f3_reference_leaves_the_contract_without_fusion(reference):
    """F3's witness, the reference against itself: its batched NOMA run op
    by op (every bf16 result rounded) against the compiled run has the
    same logs (accuracy within 0.02), and its final weights leave the
    contract's mean bound in F3's shape, as the port's do."""
    base, eager = _want(reference, "batched-noma"), _want(reference,
                                                           "witness")
    np.testing.assert_array_equal(eager["times"], base["times"])
    np.testing.assert_allclose(eager["acc"], base["acc"], atol=ACC_ATOL)
    for t in range(T):
        for name in ("devices", "bits", "rates", "ratios"):
            np.testing.assert_array_equal(eager[f"{name}/{t}"],
                                          base[f"{name}/{t}"])
    final = {k[len("final/"):]: torch.from_numpy(v) for k, v in eager.items()
             if k.startswith("final/")}
    drift = param_drift(final, reference, "batched-noma/final/")
    assert max(mean for mean, _ in drift.values()) > PARAM_MEAN_ATOL
    assert_f3_drift(final, reference, "batched-noma/final/", BASE["model"])


@pytest.mark.parametrize("key", list(RUNS))
def test_token_run_starts_from_the_reference_init(reference, world, key):
    """The run's initial weights are the reference's draw, to the bit."""
    params = fl.get_fl_model(_cfg(key).model).init(0, device="cpu")
    for path, leaf in tree_arrays(params).items():
        np.testing.assert_array_equal(leaf, reference[f"{key}/init/{path}"])


@pytest.mark.parametrize("uplink", ["noma", "tdma"])
def test_batched_engine_equals_the_legacy_oracle(port_runs, uplink):
    """The port's engine grid on a transformer (tests/test_fl_engine.py:
    test_engine_equality_grid_transformer): batched and legacy meet the
    whole contract against each other, drift included."""
    a, b = port_runs[f"batched-{uplink}"], port_runs[f"legacy-{uplink}"]
    assert [lg.devices for lg in a.logs] == [lg.devices for lg in b.logs]
    for la, lb in zip(a.logs, b.logs):
        np.testing.assert_array_equal(la.bits, lb.bits)
        np.testing.assert_array_equal(la.rates, lb.rates)
        np.testing.assert_array_equal(la.compression_ratios,
                                      lb.compression_ratios)
    np.testing.assert_array_equal(a.times(), b.times())
    np.testing.assert_allclose(a.accuracies(), b.accuracies(), atol=ACC_ATOL)
    for path, (mean, worst) in param_drift(
            a.final_params, tree_arrays(b.final_params), "").items():
        assert mean < PARAM_MEAN_ATOL and worst < PARAM_MAX_ATOL, path


def test_bucketed_bank_equals_the_padded_bank_on_token_rows(port_runs):
    """tests/test_fl_engine.py:test_bucketed_bank_equality on token
    shards: the bucketed bank gathers element-equal (nb, bs, S) rows."""
    padded, bucketed = port_runs["batched-noma"], port_runs["bucketed"]
    np.testing.assert_array_equal(padded.accuracies(), bucketed.accuracies())
    for (_, x), (_, y) in zip(tree_flatten_with_paths(padded.final_params),
                              tree_flatten_with_paths(bucketed.final_params)):
        assert torch.equal(x, y)


def test_topk_run_logs_honest_sparse_ratios(port_runs):
    """tests/test_fl_engine.py:test_topk_run_logs_honest_sparse_ratios."""
    for lg in port_runs["topk"].logs:
        if lg.bits.size:
            assert np.all(lg.compression_ratios >= 1.0)
            assert np.all(np.isfinite(lg.compression_ratios))


def test_token_banks_hold_the_trailing_sequence_axis(world):
    """Both client banks carry token rows as (M, NB, BS, S) int32 with
    label -1 on padding, and gather the same rows."""
    from repro_torch.data import BucketedClientBank, ClientBank

    ds, _, shards = world
    padded = ClientBank.build(ds.x_train, ds.y_train, shards, 8,
                              device="cpu")
    bucketed = BucketedClientBank.build(ds.x_train, ds.y_train, shards, 8,
                                        device="cpu")
    assert padded.xb.shape[-1] == padded.yb.shape[-1] == 8
    assert padded.xb.dtype == torch.int32
    for devs in ([0, 5, 11], [3], [7, 2]):
        nb = padded.n_batches_for(devs)
        xp, yp = padded.gather(devs, nb)
        xb, yb = bucketed.gather(devs, nb)
        assert torch.equal(xp, xb) and torch.equal(yp, yb)
        for row, d in enumerate(devs):
            n = len(shards[d])
            flat_x = xp[row].reshape(-1, 8)
            np.testing.assert_array_equal(flat_x[:n].numpy(),
                                          ds.x_train[shards[d]])
            assert torch.all(yp[row].reshape(-1, 8)[n:] == -1)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=64, num_samples=400, seq_len=8, seed=0),
    dict(vocab_size=151_936, num_samples=600, seq_len=16, seed=0),
    dict(vocab_size=16_384, num_samples=200, seq_len=8, seed=3),
])
def test_make_token_dataset_is_the_reference(kw):
    """make_token_dataset is numpy: the port's copy draws the reference's
    arrays for the same keywords, to the bit."""
    from repro.data.tokens import make_token_dataset as ref_make

    got, want = make_token_dataset(**kw), ref_make(**kw)
    for field in ("x_train", "y_train", "x_test", "y_test", "class_train",
                  "class_test"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_synthetic_token_batches_are_the_reference():
    from repro.data.tokens import synthetic_token_batches as ref_batches

    from repro_torch.data.tokens import synthetic_token_batches

    ours, theirs = synthetic_token_batches(512, 4, 8, seed=2), ref_batches(
        512, 4, 8, seed=2)
    for _ in range(3):
        (a, b), (c, d) = next(ours), next(theirs)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
