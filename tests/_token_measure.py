"""Measure the token payload's differences from the reference (F3).

    PYTHONPATH=src python tests/_token_measure.py

Runs the reference sides of tests/test_torch_models.py,
tests/test_torch_tokens.py and tests/test_torch_tokens_scan.py (their
worker subprocesses) and the port's counterparts on the CPU, and prints
what those tests bound: per model and batch the logits' difference in
bf16 ulps of the largest logit, the loss's relative difference and the
gradients' in bf16 ulps of each leaf's largest entry; per run whether its
logs equal the reference's and the worst leaf's mean and max parameter
drift, beside the same reading of two wrong runs (no training, one client
dropped from the last round); the reference's op-by-op run against its
compiled one; and the online run's largest relative norm difference.  The
tests' bounds were set from this script's output (F3's limits between the
sound runs and the wrong ones).  It takes a few minutes.
"""
import sys
import tempfile
from pathlib import Path

import numpy as np


class _TmpFactory:
    def __init__(self, root):
        self.root = Path(root)

    def mktemp(self, name):
        path = self.root / name
        path.mkdir(parents=True)
        return path


def _models(tmp):
    import test_torch_models as tm
    from repro_torch.models.fl_models import get_fl_model

    ref = tm.reference.__wrapped__(_TmpFactory(tmp))
    for name in tm.MODELS:
        params = get_fl_model(name).init(0, device="cpu")
        for b in range(tm.BATCHES):
            bx, by = tm._batch(name, b)
            logits, loss, _, grads = tm._logits_loss_grads(name, params,
                                                           bx, by)
            pre = f"{b}/{name}"
            want = ref[f"{pre}/logits"]
            lu = np.abs(logits - want).max() / tm._bf16_ulp(np.abs(want).max())
            wl = float(ref[f"{pre}/loss"])
            gu = max(np.abs(g - ref[f"{pre}/grad/{p}"]).max()
                     / tm._bf16_ulp(np.abs(ref[f"{pre}/grad/{p}"]).max())
                     for p, g in grads.items())
            print(f"{name:26s} batch {b}: logits {lu:.2f} ulp, loss rel "
                  f"{abs(loss - wl) / abs(wl):.3g}, gradients {gu:.2f} ulp")


def _worst(drift):
    """The worst leaf's (mean, max) of a param_drift result."""
    return (max(v[0] for v in drift.values()),
            max(v[1] for v in drift.values()))


def _runs(tmp, module):
    """Each run of ``module``: its logs against the reference's and the
    worst leaf's drift; beside it the same reading of two wrong runs, the
    initial weights (no training) and the run that dropped one client
    from the last round (where the run's driver plans its FedAvg weights
    on the host); and the reference's own op-by-op run against its
    compiled one where the module has it."""
    import pytest

    from repro_torch.core import fl
    from test_torch_harness import assert_equal_runs, param_drift
    from test_torch_tokens import dropped_client_run

    ref = module.reference.__wrapped__(_TmpFactory(tmp))
    worlds = (module.world.__wrapped__() if hasattr(module, "world")
              else module.worlds.__wrapped__())
    runs = module.port_runs.__wrapped__(worlds)
    for key, res in runs.items():
        want = {k[len(key) + 1:]: v for k, v in ref.items()
                if k.startswith(key + "/")}
        try:
            assert_equal_runs(res, want, len(res.logs), drift=False,
                              rate_ulp=2 if "tdma" in key else 0)
            logs = "logs equal"
        except AssertionError as exc:
            logs = f"LOGS DIFFER: {exc}"
        cfg = module._cfg(key)
        prefix = f"{key}/final/"
        sound = _worst(param_drift(res.final_params, ref, prefix))
        still = _worst(param_drift(
            fl.get_fl_model(cfg.model).init(cfg.seed, device="cpu"), ref,
            prefix))
        ds, cell, shards = (worlds if hasattr(module, "world") else
                            worlds["1m" if key == "1m" else "token"])
        with pytest.MonkeyPatch.context() as mp:
            try:
                bad = _worst(param_drift(dropped_client_run(
                    ds, shards, cell, cfg, mp).final_params, ref, prefix))
                dropped = ("n/a (weights not planned on the host)"
                           if bad == sound else "%.3g / %.3g" % bad)
            except AssertionError:
                dropped = "n/a (weights not planned on the host)"
        print(f"{key:14s} {cfg.model:20s} {logs}; drift (mean / max) "
              f"{sound[0]:.3g} / {sound[1]:.3g}; no training {still[0]:.3g}"
              f" / {still[1]:.3g}; dropped client {dropped}")
    if "witness/final/ln_f/scale" in ref:
        import torch

        eager = {k[len("witness/final/"):]: torch.from_numpy(v)
                 for k, v in ref.items() if k.startswith("witness/final/")}
        print("reference op by op against compiled (batched-noma): drift "
              "%.3g / %.3g" % _worst(param_drift(
                  eager, ref, "batched-noma/final/")))
    return ref


def main() -> int:
    import test_torch_tokens
    import test_torch_tokens_scan

    with tempfile.TemporaryDirectory() as tmp:
        _models(Path(tmp) / "models")
        _runs(Path(tmp) / "tokens", test_torch_tokens)
        ref = _runs(Path(tmp) / "scan", test_torch_tokens_scan)
    from repro_torch.core import fl, scheduling

    fed, record = [], scheduling.Observation.record_round

    def keep(self, t, group, rates_k, update_norms_k=None):
        fed.append(np.asarray(update_norms_k, np.float64))
        return record(self, t, group, rates_k, update_norms_k)

    ds, cell, shards = test_torch_tokens_scan.worlds.__wrapped__()["token"]
    scheduling.Observation.record_round = keep
    try:
        fl.run_federated_learning(ds, shards, cell,
                                  test_torch_tokens_scan._cfg("online"),
                                  device="cpu")
    finally:
        scheduling.Observation.record_round = record
    rel = max(np.max(np.abs(got / ref[f"online/norms/{t}"] - 1.0))
              for t, got in enumerate(fed))
    print(f"online norms: largest relative difference {rel:.3g}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
