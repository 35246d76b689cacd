"""Measure the moe, ssm and hybrid families' and the trainer's differences
from the reference.

    PYTHONPATH=src python tests/_family_measure.py [fl [PREFIX] | launch]

Runs the reference sides of tests/test_torch_families.py,
tests/test_torch_families_fl.py and tests/test_torch_launch.py (their
worker subprocesses, plus the FL runs those files leave out: the
reference's scanned Mamba2 and Zamba2, and the reference's op-by-op runs,
its witness) and the port's counterparts on the CPU, and prints what the
tests bound: per model the logits' difference in bf16 ulps of the largest logit,
the loss's and the moe aux loss's relative difference and the gradients'
in bf16 ulps of each leaf's largest entry; the SSD scan's error relative
to each output's largest magnitude; per FL run whether its logs equal the
reference's and the worst leaf's mean and max parameter drift, beside the
witness and two wrong runs (no training, one client dropped from the last
round); the train step's and the trainer's losses and final-parameter
drift beside the run that dropped one step's update; and the share of the
server's greedy tokens equal to the reference's.  The tests' bounds were
set from this script's output.  It takes about a quarter of an hour.
"""
import contextlib
import io
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


def _worst(drift):
    """The worst leaf's (mean, max) drift of a param_drift result."""
    return (max(v[0] for v in drift.values()),
            max(v[1] for v in drift.values()))


def _worst_leaf(drift):
    return max(drift, key=lambda path: drift[path][0])


def _nested(arrays, prefix):
    import torch

    out = {}
    for k, v in arrays.items():
        if k.startswith(prefix):
            node = out
            *head, leaf = k[len(prefix):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = torch.from_numpy(v)
    return out


def _parts(tmp):
    import torch

    import test_torch_families as tf
    from repro_torch.models import mamba2

    ref = tf.reference_job.__wrapped__(_TmpFactory(tmp)).__next__()()
    for name in tf.MODELS:
        params = tf.build_model(tf.get_fl_model(name).cfg).init(
            tf.prng.prng_key(0), device="cpu")
        bx, by = tf._batch(name)
        logits, aux, loss, grads = tf.family_readings(name, params, bx, by)
        want = ref[f"0/{name}/logits"]
        lu = np.abs(logits - want).max() / tf._bf16_ulp(np.abs(want).max())
        wl = float(ref[f"0/{name}/loss"])
        gu = max(np.abs(g - ref[f"0/{name}/grad/{p}"]).max()
                 / tf._bf16_ulp(np.abs(ref[f"0/{name}/grad/{p}"]).max())
                 for p, g in grads.items())
        extra = ""
        if aux is not None:
            wa = float(ref[f"0/{name}/aux"])
            extra = f", aux rel {abs(aux - wa) / abs(wa):.3g}"
        print(f"{name:30s} logits {lu:.2f} ulp, loss rel "
              f"{abs(loss - wl) / abs(wl):.3g}, gradients {gu:.2f} ulp{extra}")
    for key in tf.SSD_CASES:
        a = {k: torch.from_numpy(v) for k, v in tf._ssd_inputs(key).items()}
        c = tf.SSD_CASES[key]
        y, final = mamba2.ssd_chunked(
            a["x"], a["dt"], a["a_log"], a["b"], a["c"], chunk=c[6],
            init_state=a.get("init"),
            einsum_dtype=torch.bfloat16 if c[8] else torch.float32)
        errs = [np.abs(got.numpy() - ref[f"ssd/{key}/{n}"]).max()
                / np.abs(ref[f"ssd/{key}/{n}"]).max()
                for got, n in ((y, "y"), (final, "final"))]
        print(f"ssd {key:22s} y {errs[0]:.3g}, final state {errs[1]:.3g} "
              f"(of the largest magnitude)")


def _fl(tmp, only=""):
    import pytest

    import test_torch_families_fl as ff
    from repro_torch.config import FLConfig
    from repro_torch.core import fl
    from test_torch_harness import (
        assert_equal_runs, param_drift, run_reference,
    )
    from test_torch_tokens import dropped_client_run

    Path(tmp).mkdir(parents=True)
    runs = {k: v for k, v in ff.PORT_RUNS.items() if k.startswith(only)}
    spec = [dict(key=k, num_devices=ff.TOKEN_M, data=ff.data_of(k),
                 cfg=dict(ff.BASE, **v)) for k, v in runs.items()]
    spec += [dict(key=f"{k}-witness", num_devices=ff.TOKEN_M,
                  data=ff.data_of(k), cfg=dict(ff.BASE, **runs[k]),
                  eager=True)
             for k in ("mamba2-batched", "zamba2-batched") if k in runs]
    ref = run_reference(Path(tmp), "token_runs", {"runs": spec},
                        timeout=3600)
    for key, over in runs.items():
        ds, cell, shards = ff.token_world(**ff.data_of(key))
        cfg = FLConfig(**{**ff.BASE, **over})
        res = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
        want = {k[len(key) + 1:]: v for k, v in ref.items()
                if k.startswith(key + "/")}
        try:
            assert_equal_runs(res, want, ff.T, drift=False)
            logs = "logs equal"
        except AssertionError as exc:
            logs = f"LOGS DIFFER: {exc}"
        pre = f"{key}/final/"
        drift = param_drift(res.final_params, ref, pre)
        sound = _worst(drift)
        still = _worst(param_drift(fl.get_fl_model(cfg.model).init(
            0, device="cpu"), ref, pre))
        with pytest.MonkeyPatch.context() as mp:
            bad = _worst(param_drift(dropped_client_run(
                ds, shards, cell, cfg, mp).final_params, ref, pre))
        line = (f"{key:16s} {logs}; drift (mean / max) {sound[0]:.3g} / "
                f"{sound[1]:.3g} (worst mean: {_worst_leaf(drift)}); no "
                f"training {still[0]:.3g} / {still[1]:.3g}"
                f"; dropped client {bad[0]:.3g} / {bad[1]:.3g}")
        if f"{key}-witness/acc" in ref:
            wit = _worst(param_drift(_nested(ref, f"{key}-witness/final/"),
                                     ref, pre))
            line += f"; reference op by op {wit[0]:.3g} / {wit[1]:.3g}"
        print(line)


def _in_process():
    """The largest float32 ulp distance of the port's SIC rates, bit
    budgets, schedules and Adam / AdamW updates from the reference's
    (in-process, as tests/test_torch_launch.py runs them)."""
    import jax
    import jax.numpy as jnp
    import torch

    import test_torch_launch as tl
    from repro import optim as ref_optim
    from repro.core import noma as ref_noma
    from repro_torch import optim
    from repro_torch.core import noma
    from repro_torch.core import tree as tree_lib
    from test_torch_harness import tree_arrays

    worst = 0
    for seed in range(6):
        rng = np.random.default_rng(seed)
        k = 2 + seed % 3
        p = rng.uniform(0.0, 0.01, k).astype(np.float32)
        g = (10.0 ** rng.uniform(-8, -5, k)).astype(np.float32)
        pt, gt = torch.from_numpy(p), torch.from_numpy(g)
        worst = max(worst, int(tl._ulps(noma.bit_budget(
            pt, gt, 1.6e-14, 4e6, 0.2), ref_noma.bit_budget(
            p, g, 1.6e-14, 4e6, 0.2)).max()))
    print(f"noma rates and bit budgets: {worst} ulp at most")
    reads = []
    for ours, theirs in (
            (optim.cosine_decay(3e-4, 30), ref_optim.cosine_decay(3e-4, 30)),
            (optim.linear_warmup_cosine(3e-4, 10, 20),
             ref_optim.linear_warmup_cosine(3e-4, 10, 20))):
        reads.append([int(tl._ulps(ours(torch.tensor(i, dtype=torch.int32)),
                                   theirs(jnp.asarray(i, jnp.int32))).max())
                      for i in range(45)])
    print("schedules: ulps per step " + "; ".join(
        ",".join(map(str, r)) for r in reads))
    for name in ("adam", "adamw"):
        ours, theirs = getattr(optim, name)(1e-2), getattr(ref_optim, name)(
            1e-2)
        p0 = tl._opt_tree(0)
        pt = tree_lib.tree_map(torch.from_numpy, p0)
        pj = jax.tree_util.tree_map(jnp.asarray, p0)
        st, sj = ours.init(pt), theirs.init(pj)
        for i in range(3):
            g = tl._opt_tree(10 + i)
            pt, st = ours.update(tree_lib.tree_map(torch.from_numpy, g), st,
                                 pt)
            pj, sj = theirs.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   sj, pj)
        got, want = tree_arrays(pt), tl._jax_arrays(pj)
        print(f"{name}: parameters within "
              f"{max(int(tl._ulps(got[k], want[k]).max()) for k in got)} "
              f"ulp after 3 updates")


def _launch(tmp):
    import test_torch_launch as tl
    from test_torch_harness import tree_arrays

    ckpt = Path(tmp) / "ckpt"
    ckpt.mkdir(parents=True)
    ref = tl.reference_job.__wrapped__(_TmpFactory(tmp), ckpt).__next__()()
    for fam in tl.STEP_MODELS:
        params, losses = tl._port_steps(fam)
        rel = max(abs(x - float(ref[f"step/{fam}/loss/{i}"]))
                  / float(ref[f"step/{fam}/loss/{i}"])
                  for i, x in enumerate(losses))
        drift = max(np.abs(v.astype(np.float64)
                           - ref[f"step/{fam}/final/{p}"]).mean()
                    for p, v in tree_arrays(params).items())
        print(f"train step {fam:6s}: loss rel {rel:.3g}, worst leaf mean "
              f"drift {drift:.3g}")
    for run, (argv, _) in tl.TRAIN_RUNS.items():
        out = []
        for drop in (None, 3):
            path = ckpt / f"port_{run}_{drop}.ckpt"
            losses = np.asarray(tl._run_train(argv + ["--save", str(path)],
                                              drop=drop))
            drifts = tl._mean_drifts(path, ckpt / f"ref_{run}.ckpt")
            rel = np.max(np.abs(losses - ref[f"train/{run}"])
                         / ref[f"train/{run}"])
            out.append((max(drifts.values()), rel))
        print(f"train.main {run:8s}: worst leaf mean drift {out[0][0]:.3g} "
              f"(loss rel {out[0][1]:.3g}); dropped 3rd step "
              f"{out[1][0]:.3g} (loss rel {out[1][1]:.3g})")
    for arch in tl.SERVE_ARCHS:
        with contextlib.redirect_stdout(io.StringIO()):
            gen = tl.serve.main(["--arch", arch, "--smoke", "--device",
                                 "cpu"])
        same = float((gen.numpy() == ref[f"serve/{arch}"]).mean())
        print(f"serve {arch:24s}: {same:.3f} of the greedy tokens equal")


def main(argv) -> int:
    """With no argument every reading; ``fl [prefix]`` (the FL runs whose
    key starts with ``prefix``) or ``launch`` alone."""
    with tempfile.TemporaryDirectory() as tmp:
        if argv[:1] == ["fl"]:
            _fl(Path(tmp) / "fl", *argv[1:2])
            return 0
        if argv[:1] == ["launch"]:
            _launch(Path(tmp) / "launch")
            return 0
        _in_process()
        _parts(Path(tmp) / "parts")
        _launch(Path(tmp) / "launch")
        _fl(Path(tmp) / "fl")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main(sys.argv[1:]))
