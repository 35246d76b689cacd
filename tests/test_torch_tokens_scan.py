"""Token payloads through the port's scanned horizon, the online policies,
the over-the-air uplink and an architecture id, against the JAX
package's: the second half of tests/test_torch_tokens.py, with its own
reference subprocess so the two halves run side by side.

World, settings and contract are tests/test_torch_tokens.py's (token world
M=12, ``tiny-transformer``, T=3; logs exact, accuracy within 0.02, drift
in F3's shape).  Runs: ``horizon="scan"`` under NOMA and TDMA;
update-aware per round (the norms the policy was fed, within rtol 5e-3 of
the reference's: they are norms of the bf16 backward's updates, F3) and
scanned; OTA with ota-align powers and receiver noise 1e-9 through the
keyed OTA kernel's plain version; the SMOKE Qwen2 (QKV bias, GQA, tied
embeddings) with the aggregation kernel's plain version; and the
reference's transformer-class pin (tests/test_fl_scan.py:
test_transformer_class_payload_topk_batched_and_scan): the
``tiny-transformer-1m`` (>= 10^6 parameters) with top-k 0.01 on M=6, K=2,
T=2, where the port's scan must equal its own per-round run to the bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    TOKEN_DATA, TOKEN_M, assert_equal_runs, one_torch_thread, run_reference,
    token_world,
)
from test_torch_tokens import (  # noqa: E402
    BASE, T, assert_f3_drift, dropped_client_run,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.models.fl_models import get_fl_model  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_count, tree_flatten_with_paths,
)

OTA = dict(uplink="ota", compression="none", power_mode="ota-align",
           ota_noise=1e-9, use_pallas=True)
RUNS = {
    "scan-noma": dict(fl_engine="batched", horizon="scan", use_pallas=True),
    "scan-tdma": dict(fl_engine="batched", horizon="scan", uplink="tdma"),
    "online": dict(fl_engine="batched", scheduler="update-aware",
                   use_pallas=True),
    "online-scan": dict(fl_engine="batched", scheduler="update-aware",
                        horizon="scan", use_pallas=True),
    "ota": dict(fl_engine="batched", **OTA),
    "qwen2-smoke": dict(fl_engine="batched", model="qwen2_0_5b:smoke",
                        use_pallas=True),
}
ONE_M = dict(num_devices=6, group_size=2, num_rounds=2,
             model="tiny-transformer-1m", topk=0.01, fl_engine="batched",
             use_pallas=True)
ONE_M_DATA = dict(vocab_size=16_384, num_samples=200, seq_len=8, seed=0)
NORM_RTOL = 5e-3         # F3: measured worst 1.4e-3


def _cfg(key):
    if key == "1m":
        return FLConfig(**{**BASE, **ONE_M})
    return FLConfig(**{**BASE, **RUNS[key]})


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    runs = [dict(key=key, num_devices=TOKEN_M, data=TOKEN_DATA,
                 cfg=dict(BASE, **over)) for key, over in RUNS.items()]
    runs.append(dict(key="1m", num_devices=6, data=ONE_M_DATA,
                     cfg={**BASE, **ONE_M}))
    return run_reference(tmp_path_factory.mktemp("tokens_scan"),
                         "token_runs", {"runs": runs})


@pytest.fixture(scope="module")
def worlds():
    return {"token": token_world(), "1m": token_world(6, **ONE_M_DATA)}


@pytest.fixture(scope="module")
def port_runs(worlds):
    out = {}
    for key in list(RUNS) + ["1m"]:
        ds, cell, shards = worlds["1m" if key == "1m" else "token"]
        out[key] = fl.run_federated_learning(ds, shards, cell, _cfg(key),
                                             device="cpu")
    return out


def _want(reference, key):
    return {k[len(key) + 1:]: v for k, v in reference.items()
            if k.startswith(key + "/")}


@pytest.mark.parametrize("key", list(RUNS) + ["1m"])
def test_token_run_matches_the_reference(reference, port_runs, key):
    res = port_runs[key]
    assert_equal_runs(res, _want(reference, key), len(res.logs), drift=False,
                      rate_ulp=2 if "tdma" in key else 0)
    assert_f3_drift(res.final_params, reference, f"{key}/final/",
                    _cfg(key).model)


@pytest.mark.parametrize("key", ["qwen2-smoke", "1m"])
@pytest.mark.parametrize("control", ["no-training", "dropped-client"])
def test_f3_limits_reject_a_wrong_run(reference, worlds, monkeypatch, key,
                                      control):
    """F3's limits for the SMOKE Qwen2 and tiny-transformer-1m fail a wrong
    run: its initial weights (no training), or the run that dropped one
    client from the last round."""
    cfg = _cfg(key)
    if control == "no-training":
        params = get_fl_model(cfg.model).init(cfg.seed, device="cpu")
    else:
        ds, cell, shards = worlds["1m" if key == "1m" else "token"]
        params = dropped_client_run(ds, shards, cell, cfg,
                                    monkeypatch).final_params
    with pytest.raises(AssertionError, match="drift"):
        assert_f3_drift(params, reference, f"{key}/final/", cfg.model)


@pytest.mark.parametrize("uplink", ["noma", "tdma"])
def test_scan_equals_the_per_round_run(worlds, port_runs, uplink):
    """tests/test_fl_scan.py:test_scan_equality_grid_transformer on the
    port: the scanned horizon's logs and final weights equal the per-round
    batched run's to the bit."""
    ds, cell, shards = worlds["token"]
    per_round = fl.run_federated_learning(
        ds, shards, cell, dataclasses.replace(_cfg(f"scan-{uplink}"),
                                              horizon="per-round"),
        device="cpu")
    _assert_identical(port_runs[f"scan-{uplink}"], per_round)


def _assert_identical(a, b):
    assert [lg.devices for lg in a.logs] == [lg.devices for lg in b.logs]
    for la, lb in zip(a.logs, b.logs):
        np.testing.assert_array_equal(la.bits, lb.bits)
        np.testing.assert_array_equal(la.compression_ratios,
                                      lb.compression_ratios)
    np.testing.assert_array_equal(a.accuracies(), b.accuracies())
    np.testing.assert_array_equal(a.times(), b.times())
    for (_, x), (_, y) in zip(tree_flatten_with_paths(a.final_params),
                              tree_flatten_with_paths(b.final_params)):
        assert torch.equal(x, y)


def test_online_scan_equals_the_online_per_round_run(port_runs):
    _assert_identical(port_runs["online-scan"], port_runs["online"])


def test_online_run_feeds_the_reference_norms(reference, worlds):
    """update-aware reads the raw updates' norms: the port's, fed to its
    policy round by round, within NORM_RTOL of the reference's."""
    from repro_torch.core import scheduling

    fed = []
    record = scheduling.Observation.record_round

    def keep(self, t, group, rates_k, update_norms_k=None):
        fed.append(np.asarray(update_norms_k, np.float64))
        return record(self, t, group, rates_k, update_norms_k)

    ds, cell, shards = worlds["token"]
    scheduling.Observation.record_round = keep
    try:
        fl.run_federated_learning(ds, shards, cell, _cfg("online"),
                                  device="cpu")
    finally:
        scheduling.Observation.record_round = record
    assert len(fed) == T
    for t, got in enumerate(fed):
        want = reference[f"online/norms/{t}"]
        assert got.shape == want.shape and np.all(got > 0)
        np.testing.assert_allclose(got, want, rtol=NORM_RTOL)


def test_transformer_class_payload_scan_equals_per_round(worlds, port_runs):
    """The reference's acceptance pin on the port: a >= 10^6-parameter
    payload with top-k 0.01 runs per round and scanned, bit for bit, with
    large honest sparse ratios."""
    model = get_fl_model("tiny-transformer-1m")
    assert tree_count(model.init(0, device="cpu")) >= 1_000_000
    ds, cell, shards = worlds["1m"]
    scanned = fl.run_federated_learning(
        ds, shards, cell, dataclasses.replace(_cfg("1m"), horizon="scan"),
        device="cpu")
    _assert_identical(scanned, port_runs["1m"])
    assert all(np.all(lg.compression_ratios > 5.0)
               for lg in scanned.logs if lg.bits.size)


def test_seed_sweep_rows_equal_single_token_scans(worlds, port_runs):
    """run_horizon_vmapped folds two seeds into the client rows: seed 0's
    row equals the single scan to the bit on the CPU."""
    ds, cell, shards = worlds["token"]
    sweep = fl.run_horizon_vmapped(ds, shards, cell, _cfg("scan-noma"),
                                   seeds=[0, 1], device="cpu")
    _assert_identical(sweep[0], port_runs["scan-noma"])
    single1 = fl.run_federated_learning(
        ds, shards, cell, dataclasses.replace(_cfg("scan-noma"), seed=1),
        device="cpu")
    _assert_identical(sweep[1], single1)


@pytest.mark.parametrize("kw", [dict(), dict(topk=0.05)], ids=["dense", "topk"])
def test_token_horizon_reads_nothing_back(worlds, monkeypatch, kw):
    """tests/test_torch_scan.py's check on a token payload: from the upload
    to the download the horizon turns no tensor into a host value, so the
    transformer's forward and backward run inside it without a sync (the
    card run holds it under ``set_sync_debug_mode("error")``)."""
    from repro_torch.core import fl_engine

    core = fl_engine._horizon_core
    banned = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
              "__int__")

    def no_reads(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in banned:
                def refuse(*a, _name=name, **k):
                    raise AssertionError(f"Tensor.{_name} inside the horizon")
                m.setattr(torch.Tensor, name, refuse)
            return core(*args, **kwargs)

    monkeypatch.setattr(fl_engine, "_horizon_core", no_reads)
    ds, cell, shards = worlds["token"]
    cfg = dataclasses.replace(_cfg("scan-noma"), model="qwen2_0_5b:smoke",
                              **kw)
    got = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert len(got.logs) == T and np.all(np.isfinite(got.accuracies()))
