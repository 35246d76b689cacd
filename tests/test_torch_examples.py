"""The port's example twins against the reference's example scripts, each
run as a user runs it: ``examples/fl_noma_mnist_torch.py``,
``serve_decode_torch.py`` and ``train_llm_torch.py`` with ``--device cpu``
here, beside the reference's ``examples/fl_noma_mnist.py``,
``serve_decode.py`` and ``train_llm.py`` run by their own ``main`` in one
shimmed subprocess (the worker's ``example_runs`` task, which wraps the
reference's run functions to keep what ``main`` ran).

Contracts:

- ``fl_noma_mnist``, eight argv at ``--fast --rounds 2`` (M=60, K=3):
  tests/test_torch_harness.py:assert_equal_runs (schedules, bits, rates,
  ratios and times exact, TDMA's rates within 2 ulps; accuracy within
  0.02; final parameters within the drift bounds).  The token run
  (``--model tiny-transformer --topk 0.1 --horizon scan``) is held without
  the drift: F3's limits (tests/test_torch_tokens.py) were set at another
  world (M=12, 400 rows of 8), and this one (M=60, 4,000 rows of 16) is
  held by its logs.  The printed lines are the reference's, the
  accuracies in them within 0.02 (+ the last printed digit).
  ``--sanitize-nans`` runs the reference under ``jax_debug_nans`` and the
  twin under ``nan_guard``: both run clean and agree.
- ``serve_decode --arch zamba2-7b --batch 2``: the contract of
  tests/test_torch_launch.py:test_serve_main_matches_the_reference for a
  model with bf16 near-ties (every token within 4 bf16 ulps of the best
  logit of the port's full forward over each side's sequence).
- ``train_llm --steps 3`` (the SMOKE Mixtral, batch 8 x 128, 8-bit codes):
  the contract of test_train_main_matches_the_reference: losses within
  5e-4 relative, every leaf's mean drift of the final parameters (read
  from each side's ``--save`` checkpoint) below the Mixtral run's 5e-6.
- The parsers: each twin takes the reference script's flags with the same
  defaults, choices, types and actions, plus ``--device``.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    ACC_ATOL, REPO, assert_equal_runs, load_example, one_torch_thread,
    start_reference,
)
from test_torch_launch import (  # noqa: E402
    SERVE_TIE_ULPS, TRAIN_LOSS_RTOL, TRAIN_RUNS, _bf16_ulp, _mean_drifts,
)
from _torch_reference_worker import parser_actions  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

FAST = ["--fast", "--rounds", "2"]
FL_RUNS = {
    "default": [],
    "legacy": ["--engine", "legacy"],
    "tdma": ["--pallas-agg", "--uplink", "tdma"],
    "ota-mp": ["--uplink", "ota", "--ota-noise", "1e-9", "--scheduler",
               "matching-pursuit"],
    "scan-online": ["--horizon", "scan", "--scheduler", "update-aware"],
    "seeds": ["--seeds", "2"],
    "tokens": ["--model", "tiny-transformer", "--topk", "0.1", "--horizon",
               "scan"],
    "sanitize": ["--sanitize-nans"],
}
SERVE_ARGV = ["--arch", "zamba2-7b", "--batch", "2"]
TRAIN_ARGV = ["--steps", "3"]
TRAIN_DRIFT_LIMIT = TRAIN_RUNS["mixtral"][1]
TWINS = {"fl_noma_mnist.py": "fl_noma_mnist_torch",
         "serve_decode.py": "serve_decode_torch",
         "train_llm.py": "train_llm_torch"}
# an accuracy as the scripts print it: three decimals (times print one)
PRINTED_ACC = re.compile(r"\d+\.\d{3}\b")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("example_ckpt")


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory, ckpt_dir):
    """The file's one reference subprocess, started with its first test so
    that it runs beside the port's runs; killed at the end if no test
    waited for it."""
    spec = {
        "fl": [dict(key=k, argv=FAST + argv) for k, argv in FL_RUNS.items()],
        "serve": [dict(key="zamba2", argv=SERVE_ARGV)],
        "train": [dict(key="mixtral", argv=TRAIN_ARGV,
                       save=str(ckpt_dir / "ref.ckpt"))],
        "parsers": list(TWINS),
    }
    job = start_reference(tmp_path_factory.mktemp("examples"),
                          "example_runs", spec)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


def _quietly(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def twin_runs(reference_job, ckpt_dir):
    """The twins' runs of every case, made while the reference subprocess
    (started first) runs beside them: ``fl/<key>`` (result, printed
    lines), ``serve`` the tokens, ``train`` the losses (the final
    parameters saved to ``port.ckpt``)."""
    cpu = ["--device", "cpu"]
    fl_twin = load_example("fl_noma_mnist_torch")
    out = {}
    for key, argv in FL_RUNS.items():
        out[f"fl/{key}"] = _quietly(lambda: fl_twin.main(FAST + argv + cpu))
    out["serve"], _ = _quietly(
        lambda: load_example("serve_decode_torch").main(SERVE_ARGV + cpu))
    real = train.main
    train.main = lambda argv: real(argv + ["--save",
                                           str(ckpt_dir / "port.ckpt")])
    try:
        out["train"], _ = _quietly(
            lambda: load_example("train_llm_torch").main(TRAIN_ARGV + cpu))
    finally:
        train.main = real
    return out


def _want(reference, prefix):
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


def _assert_same_lines(got, want):
    """The printed lines equal with each printed accuracy masked, the
    accuracies within ACC_ATOL plus the last printed digit."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert PRINTED_ACC.sub("#", a) == PRINTED_ACC.sub("#", b), (a, b)
        accs = [(float(x), float(y)) for x, y in zip(
            PRINTED_ACC.findall(a), PRINTED_ACC.findall(b))]
        assert all(abs(x - y) <= ACC_ATOL + 1e-3 for x, y in accs), (a, b)


@pytest.mark.parametrize("run", list(FL_RUNS))
def test_fl_noma_mnist_twin_matches_the_reference_example(twin_runs,
                                                          reference, run):
    out, lines = twin_runs[f"fl/{run}"]
    results = out if isinstance(out, list) else [out]
    assert len(results) == (2 if run == "seeds" else 1)
    for i, res in enumerate(results):
        assert_equal_runs(res, _want(reference, f"fl/{run}/{i}/"),
                          len(res.logs), drift=run != "tokens",
                          rate_ulp=2 if run == "tdma" else 0)
    _assert_same_lines(lines, json.loads(str(reference[f"fl/{run}/stdout"])))


def test_serve_decode_twin_matches_the_reference_example(twin_runs,
                                                        reference):
    gen = twin_runs["serve"]
    want = reference["serve/zamba2"]
    assert gen.shape == want.shape == (2, 16) and gen.dtype == torch.int32
    cfg = get_smoke("zamba2-7b")
    model = build_model(cfg)
    key = prng.prng_key(0)
    params = model.init(key, device="cpu")
    prompts = prng.randint(prng.fold_in(key, 1), (2, 32), 0, cfg.vocab_size,
                           device="cpu")
    for tokens in (torch.from_numpy(want), gen):
        seq = torch.cat([prompts, tokens[:, :-1]], dim=1)
        with torch.no_grad():
            logits = model.forward(params, {"tokens": seq})[0]
        logits = logits[:, 31:, : cfg.vocab_size]
        best = logits.max(-1).values
        chosen = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
        tol = SERVE_TIE_ULPS * _bf16_ulp(float(logits.abs().max()))
        assert float((best - chosen).max()) <= tol


def test_train_llm_twin_matches_the_reference_example(twin_runs, reference,
                                                      ckpt_dir):
    losses = np.asarray(twin_runs["train"])
    want = reference["train/mixtral"]
    assert losses.shape == want.shape == (3,)
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want, rtol=TRAIN_LOSS_RTOL)
    drifts = _mean_drifts(ckpt_dir / "port.ckpt", ckpt_dir / "ref.ckpt")
    worst = max(drifts, key=drifts.get)
    assert drifts[worst] < TRAIN_DRIFT_LIMIT, (worst, drifts[worst])


@pytest.mark.parametrize("script", list(TWINS))
def test_twin_takes_the_reference_scripts_flags(reference, script):
    want = json.loads(str(reference[f"parser/{script}"]))
    got = parser_actions(load_example(TWINS[script]).parser())
    device = [a for a in got if a["options"] == ["--device"]]
    assert len(device) == 1 and device[0]["default"] == "cuda"
    assert [a for a in got if a["options"] != ["--device"]] == want


_IMPORT_TWINS = """
import importlib.util, json, os, sys
for name in sys.argv[1:]:
    path = os.path.join("examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "repro", "tools"))))
"""


def test_twins_import_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_TWINS, *TWINS.values()],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
