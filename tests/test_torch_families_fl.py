"""The ssm and hybrid families as FL payloads through the port's engines
against the JAX package's, on the token world of tests/test_torch_tokens.py
with the SMOKE models' 512-token vocabulary (``make_token_dataset(
vocab_size=512, num_samples=400, seq_len=8)``, M=12, K=3, T=3, lr 0.05,
lazy GWMIN, max power), each client training on one local batch of its
whole shard, so that the reference compiles one round body a run.  The
SMOKE Mamba2 trains with adaptive DoReFa at batch 80 (every shard holds
at most 74 rows); the SMOKE Zamba2 (one shared-attention site and a tail
layer) on half the rows, with no codes (F4 below), at batch 24 (at most
24 rows a shard).

The reference runs go through one shimmed subprocess for the file (the
worker's ``token_runs`` task): each model on the batched and the legacy
engine.  Every port run's logs are the reference's (schedules, bits,
rates, ratios and times exact; accuracy within 0.02).  The port's scanned
horizons equal their per-round batched runs to the bit, so each scan is
held to the reference's batched run.

The final parameters follow F3's shape (ROADMAP.md queue 3), with limits
per model measured by tests/_family_measure.py between the sound runs and
two wrong runs (the untrained initial weights, and the run that dropped
one client from the last round's sum), and beside the reference's own
op-by-op run against its compiled one (its witness):

- SMOKE Mamba2: worst leaf mean / max drift 9.7e-6 / 4.7e-3 (batched,
  legacy, scan); the witness 9.1e-6 / 4.7e-3; dropped client 1.6e-4 /
  6.2e-3; untrained 4.0e-4 / 0.022.  Limits 5e-5 / 1.5e-2: the mean
  rejects both wrong runs, the max the untrained weights too.
- SMOKE Zamba2 (F4): with 1-bit codes its 8- and 16-element ``d_skip``
  leaves' codes flip under float order, and the reference's witness
  drifts as far as the untrained weights, so no limit separates a sound
  run from a wrong one there.  With no codes: drift 3.9e-5 / 1.1e-3
  (batched, legacy, scan); the witness 3.2e-5 / 1.1e-3; dropped client
  3.7e-4 / 0.013; untrained 2.0e-3 / 0.041.  Limits 1.5e-4 / 4e-3: the
  mean and the max each reject both wrong runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    TOKEN_M, assert_equal_runs, cached_plain_draws, one_torch_thread,
    param_drift, start_reference, token_world,
)
from test_torch_tokens import dropped_client_run  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import fl  # noqa: E402

T = 3
DATA = dict(vocab_size=512, num_samples=400, seq_len=8, seed=0)
BASE = dict(num_devices=TOKEN_M, group_size=3, num_rounds=T,
            learning_rate=0.05, scheduler="lazy-gwmin",
            power_mode="max", compression="adaptive", seed=0)
MAMBA2, ZAMBA2 = "mamba2_130m:smoke", "zamba2_7b:smoke"
# one local batch a client (module docstring); the Zamba2 world on half
# the rows with no codes (F4)
MAMBA2_WORLD = dict(batch_size=80)
ZAMBA2_DATA = dict(DATA, num_samples=200)
ZAMBA2_WORLD = dict(compression="none", batch_size=24)
RUNS = {
    "mamba2-batched": dict(model=MAMBA2, fl_engine="batched",
                           use_pallas=True, **MAMBA2_WORLD),
    "mamba2-legacy": dict(model=MAMBA2, fl_engine="legacy", **MAMBA2_WORLD),
    "zamba2-batched": dict(model=ZAMBA2, fl_engine="batched",
                           use_pallas=True, **ZAMBA2_WORLD),
    "zamba2-legacy": dict(model=ZAMBA2, fl_engine="legacy", **ZAMBA2_WORLD),
}
# the port's runs: the reference's and the scanned horizons, each held to
# the reference's batched run (the run it equals to the bit)
PORT_RUNS = dict(RUNS, **{
    "mamba2-scan": dict(RUNS["mamba2-batched"], horizon="scan"),
    "zamba2-scan": dict(RUNS["zamba2-batched"], horizon="scan"),
})
REFERENCE_OF = {"mamba2-scan": "mamba2-batched",
                "zamba2-scan": "zamba2-batched"}
# per model (mean, max) limits on every leaf's drift (module docstring)
FAMILY_LIMITS = {MAMBA2: (5e-5, 1.5e-2), ZAMBA2: (1.5e-4, 4e-3)}


def _cfg(key):
    return FLConfig(**{**BASE, **PORT_RUNS[key]})


def data_of(key):
    """The token world's ``make_token_dataset`` keywords of a run."""
    return ZAMBA2_DATA if key.startswith("zamba2") else DATA


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """The file's reference runs in one subprocess, started with its first
    test so that they run beside the port's; killed at the end if no test
    waited for them."""
    runs = [dict(key=key, num_devices=TOKEN_M, data=data_of(key),
                 cfg=dict(BASE, **over)) for key, over in RUNS.items()]
    job = start_reference(tmp_path_factory.mktemp("families_fl"),
                          "token_runs", {"runs": runs}, timeout=900)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


@pytest.fixture(scope="module")
def worlds():
    return {model: token_world(**data_of(model))
            for model in ("mamba2", "zamba2")}


@pytest.fixture(scope="module")
def port_runs(worlds):
    out = {}
    for key in PORT_RUNS:
        ds, cell, shards = worlds[key.split("-")[0]]
        out[key] = fl.run_federated_learning(ds, shards, cell, _cfg(key),
                                             device="cpu")
    return out


def _want(reference, key):
    return {k[len(key) + 1:]: v for k, v in reference.items()
            if k.startswith(key + "/")}


def assert_family_drift(params, want, prefix, model):
    mean_atol, max_atol = FAMILY_LIMITS[model]
    for path, (mean, worst) in param_drift(params, want, prefix).items():
        assert mean < mean_atol, f"{path}: mean drift {mean}"
        assert worst < max_atol, f"{path}: max drift {worst}"


@pytest.mark.parametrize("key", list(PORT_RUNS))
def test_logs_equal_the_reference(port_runs, reference, key):
    want = REFERENCE_OF.get(key, key)
    assert_equal_runs(port_runs[key], _want(reference, want), T, drift=False)


@pytest.mark.parametrize("key", [k for k in PORT_RUNS
                                 if k.startswith("mamba2")])
def test_mamba2_drift_within_its_limits(port_runs, reference, key):
    want = REFERENCE_OF.get(key, key)
    assert_family_drift(port_runs[key].final_params, reference,
                        f"{want}/final/", MAMBA2)


@pytest.mark.parametrize("key", [k for k in PORT_RUNS
                                 if k.startswith("zamba2")])
def test_zamba2_drift_within_its_limits(port_runs, reference, key):
    want = REFERENCE_OF.get(key, key)
    assert_family_drift(port_runs[key].final_params, reference,
                        f"{want}/final/", ZAMBA2)


@pytest.mark.parametrize("model", ["mamba2", "zamba2"])
def test_scan_equals_the_per_round_run(port_runs, model):
    """The scanned horizon runs the batched round body: logs and final
    parameters bit-equal."""
    scan, per_round = port_runs[f"{model}-scan"], port_runs[f"{model}-batched"]
    assert [lg.devices for lg in scan.logs] == [lg.devices
                                                for lg in per_round.logs]
    for a, b in zip(scan.logs, per_round.logs):
        np.testing.assert_array_equal(a.bits, b.bits)
        assert a.test_accuracy == b.test_accuracy
    a, b = _flat(scan.final_params), _flat(per_round.final_params)
    assert a.keys() == b.keys()
    for path in a:
        assert torch.equal(a[path], b[path]), path


def _flat(params):
    from repro_torch.utils.tree import tree_flatten_with_paths

    return dict(tree_flatten_with_paths(params))


@pytest.mark.parametrize("model, wrong", [
    pytest.param(model, wrong, id=wrong if model == "mamba2"
                 else f"{model}-{wrong}")
    for model in ("mamba2", "zamba2")
    for wrong in ("untrained", "dropped-client")])
def test_family_limits_reject_a_wrong_run(reference, worlds, model, wrong,
                                          monkeypatch):
    """Each model's limits fail the untrained weights and the run that
    dropped a client from the last round."""
    key = f"{model}-batched"
    cfg = _cfg(key)
    if wrong == "untrained":
        params = fl.get_fl_model(cfg.model).init(cfg.seed, device="cpu")
    else:
        ds, cell, shards = worlds[model]
        params = dropped_client_run(ds, shards, cell, cfg,
                                    monkeypatch).final_params
    with pytest.raises(AssertionError):
        assert_family_drift(params, reference, f"{key}/final/", cfg.model)


def test_zamba2_run_trains_finite_weights(port_runs):
    """The Zamba2 run's final weights are finite, the shared block's among
    them, and moved from the initial draw."""
    res = port_runs["zamba2-batched"]
    init = _flat(fl.get_fl_model(ZAMBA2).init(0, device="cpu"))
    final = _flat(res.final_params)
    assert final.keys() == init.keys()
    assert any(p.startswith("shared_attn/") for p in final)
    for path, leaf in final.items():
        assert torch.isfinite(leaf).all(), path
    assert sum(not torch.equal(final[p], init[p]) for p in final) > 0
