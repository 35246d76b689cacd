"""The port's server against the JAX package's serving records.

``tests/torch_reference/serve_<arch>.json`` records the reference's
``launch.serve.main`` for each of chip_smoke.py's serving runs (the
worker's ``--write-serve-reference``): the prompts, the greedy tokens of
the cached decode and, from one uncached forward over the prompts and the
served tokens, the teacher-forced logits at the positions that predict
each token (top 8, 64 fixed ids, the top-2 gap).  ``[serve:*]`` holds the
card's runs to them with ``chip_smoke.check_serve_record``.  Here:

- the full-width records are whole (runs, argv, shapes, depths equal to
  chip_smoke.py's serving runs; where a record holds the served weights'
  elements, their leaves are the served schema's) and their prompts are
  the port's ``prng.randint`` draw;
- the same writer's SMOKE records (one reference subprocess for the file,
  ``--smoke``) hold the port's CPU serve of every SMOKE config (the dense
  family with Mistral-Large, and Llama-4-Scout among them, Scout's prompt
  across its attention chunk) through ``check_serve_record``, at limits
  between the sound runs and the wrong runs below (readings in
  SMOKE_LOGIT_ULPS), and the port's initial weights equal the records'
  elements;
- wrong runs are rejected: the last layer dropped, each model's own
  wrong run of tests/_serve_measure.py where the SMOKE config shows it,
  the vlm's gates left at 0 against the gated record, and Qwen2's QKV
  biases ignored against the biased one.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    REPO, WORKER, cached_plain_draws, one_torch_thread,
)

sys.path.insert(0, REPO)

import _serve_measure  # noqa: E402
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths  # noqa: E402

NAMES = ("mamba2_130m", "zamba2_7b", "mixtral_8x22b", "seamless_m4t_medium",
         "llama_3_2_vision_90b", "qwen2_0_5b", "qwen3_8b", "granite_34b",
         "llama4_scout_17b_a16e", "mistral_large_123b")
# the SMOKE runs' teacher-forced logits against the SMOKE records (each
# SMOKE config at its published config's rope_theta), in bf16 ulps of each
# row's largest |logit|, between the sound runs (Mamba2 1, Zamba2 2,
# Mixtral 1, SeamlessM4T 2.5, Llama-Vision 1.25 at init and 1.5 gated,
# Qwen2 1 and 2 with its biases drawn, Qwen3 1, Granite 1, Scout 1.5,
# Mistral-Large 1) and the wrong ones (the last layer dropped: 248, 157.8,
# 314.5, 201.2, 326 and 361, 258 and 180, 209, 263, 243, 225; Mamba2's D
# zeroed 492; Zamba2's shared block at head_dim 128 12.62; Mixtral at
# the default rope_theta 18.88 and at one expert 15.5; SeamlessM4T's
# encoder a layer short 85.5;
# Llama-Vision at the default rope_theta 82.34, gated 99.38; the gates
# left at 0 against the gated record 131.1; Qwen2's biases ignored 328;
# Qwen3 without qk-norm 222.8; Granite's K and V swapped 335 and its rope
# over interleaved pairs 62; Scout without its shared expert 219.5 and
# with its chunked mask ignored 308; Mistral-Large at the default
# rope_theta 35.5 and with Qwen3's qk-norm switched on 243.5), as
# `PYTHONPATH=src python
# tests/_serve_measure.py --smoke` reads them
SMOKE_LOGIT_ULPS = 6


def serving_runs():
    """chip_smoke.py's serving runs: (record name, run, arch, depth,
    what is set after init)."""
    runs = list(chip_smoke.SERVE_RUNS) + list(chip_smoke.MULTIMODAL_SERVE_RUNS)
    return [(chip_smoke.record_name(a), chip_smoke.serve_run_label(a, g), a,
             n, g) for a, n, g in runs]


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """The file's one reference subprocess, the SMOKE records written into
    a temporary directory, started with the file's first test."""
    out = tmp_path_factory.mktemp("serve_records")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, WORKER, "--write-serve-reference", str(out),
         "--smoke"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def smoke_records(reference_job):
    proc, out = reference_job
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    records = {}
    for name in NAMES:
        with open(out / f"serve_{name}.json", encoding="utf-8") as fh:
            records[name] = json.load(fh)
    return records


@pytest.fixture(scope="module")
def smoke_serves():
    """The port's CPU serve of every SMOKE run, keyed by run (the tests
    ask for it before ``smoke_records``, so it runs while the reference
    subprocess writes the records)."""
    runs = {}
    for name, run, arch, _, setting in serving_runs():
        with chip_smoke.serve_init(setting), \
                _serve_measure.published_theta(), \
                contextlib.redirect_stdout(io.StringIO()):
            runs[run] = serve.run(_serve_measure.smoke_argv(arch))
    return runs


@pytest.mark.parametrize("name", NAMES)
def test_full_width_record_is_whole(name):
    """serve_<name>.json: written by the stated command, under 200 kB, its
    runs those of chip_smoke.py at their depths, every array of the
    record's shape, the recorded ids inside the vocabulary, the prompts
    the port's own draw."""
    path = os.path.join(REPO, "tests", "torch_reference",
                        f"serve_{name}.json")
    assert os.path.getsize(path) < 200_000
    record = chip_smoke.serve_record(name)
    assert record["_command"] == (
        "PYTHONPATH=src JAX_PLATFORMS=cpu python "
        "tests/_torch_reference_worker.py --write-serve-reference "
        "tests/torch_reference")
    runs = [r for r in serving_runs() if r[0] == name]
    assert sorted(record["runs"]) == sorted(r[1] for r in runs)
    for _, run, arch, depth, setting in runs:
        want = record["runs"][run]
        assert want["argv"][:2] == ["--arch", arch]
        assert want["argv"][2:] == ["--batch", "4", "--prompt-len", "32",
                                    "--gen", "16", "--seed", "0"]
        assert _serve_measure.run_setting(want) == (
            {"biases": tuple(setting["biases"])}
            if isinstance(setting, dict) else setting)
        assert want["num_layers"] == (depth or get_config(arch).num_layers)
        if "leaves" in want:
            cfg = dataclasses.replace(get_config(arch),
                                      num_layers=want["num_layers"])
            shapes = {path: list(leaf.shape) for path, leaf in
                      tree_flatten_with_paths(build_model(cfg).abstract())}
            assert {p: v["shape"] for p, v in want["leaves"].items()} \
                == shapes
        vocab = want["vocab_size"]
        assert np.asarray(want["prompts"]).shape == (4, 32)
        tokens = np.asarray(want["tokens"])
        assert tokens.shape == (4, 16)
        assert ((tokens >= 0) & (tokens < vocab)).all()
        assert want["positions"] == list(range(31, 47))
        top = np.asarray(want["top_ids"])
        assert top.shape == (16, 4, 8) and (top < vocab).all()
        assert np.asarray(want["top_values"]).shape == (16, 4, 8)
        assert len(set(want["ids"])) == 64 and max(want["ids"]) == vocab - 1
        assert np.asarray(want["values"]).shape == (16, 4, 64)
        assert np.asarray(want["gap_ulps"]).shape == (16, 4)
        assert (np.diff(np.asarray(want["top_values"]), axis=-1) <= 0).all()
        draw = prng.randint(prng.fold_in(prng.prng_key(0), 1), (4, 32), 0,
                            vocab, device="cpu")
        assert np.array_equal(draw.numpy(), np.asarray(want["prompts"]))


@pytest.mark.parametrize("run", [r[1] for r in serving_runs()])
def test_smoke_serve_holds_the_reference_record(run, smoke_serves,
                                                smoke_records):
    """The port's CPU serve of the SMOKE run against the same writer's
    SMOKE record: prompts bit-equal, tokens equal through each row's first
    near-tie, the teacher-forced logits within the run's limit."""
    name = next(r[0] for r in serving_runs() if r[1] == run)
    record = smoke_records[name]
    out = smoke_serves[run]
    logits = chip_smoke.teacher_forced_logits(
        out["model"], out["params"], record["runs"][run], out["extras"])
    got = chip_smoke.check_serve_record(out, logits, record, run,
                                        SMOKE_LOGIT_ULPS)
    assert got["worst"] <= SMOKE_LOGIT_ULPS
    if "leaves" in record["runs"][run]:
        chip_smoke._check_record_elements(out["params"],
                                          record["runs"][run], run)


@pytest.mark.parametrize("run", ["mamba2-130m", "zamba2-7b", "mixtral-8x22b",
                                 "seamless-m4t-medium",
                                 "llama-3.2-vision-90b-gated", "qwen2-0.5b",
                                 "qwen2-0.5b-biased", "qwen3-8b",
                                 "granite-34b", "llama4-scout-17b-a16e",
                                 "mistral-large-123b"])
def test_a_dropped_layer_is_rejected(run, smoke_serves, smoke_records):
    """The same weights with the decoder's last layer taken out leave the
    record's logits beyond the limit, and check_serve_record fails."""
    name = next(r[0] for r in serving_runs() if r[1] == run)
    record = smoke_records[name]
    out = smoke_serves[run]
    model, params = _serve_measure.drop_last_layer(out["model"],
                                                   out["params"])
    logits = chip_smoke.teacher_forced_logits(
        model, params, record["runs"][run], out["extras"])
    want = record["runs"][run]
    bad = chip_smoke.serve_readings(want["tokens"], out["prompts"], logits,
                                    want)
    assert bad["worst"] > SMOKE_LOGIT_ULPS
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_serve_record(dict(out, tokens=torch.tensor(
            want["tokens"])), logits, record, run, SMOKE_LOGIT_ULPS)


@pytest.mark.parametrize("run,label", [
    ("mamba2-130m", "D skip zeroed"),
    ("zamba2-7b", "shared block at head_dim 128"),
    ("mixtral-8x22b", "rope_theta 10000"),
    ("mixtral-8x22b", "one expert a token"),
    ("seamless-m4t-medium", "encoder's last layer dropped"),
    ("llama-3.2-vision-90b", "rope_theta 10000"),
    ("qwen2-0.5b-biased", "QKV biases ignored"),
    ("qwen3-8b", "qk-norm left out"),
    ("granite-34b", "K and V projections swapped"),
    ("granite-34b", "rope over interleaved pairs"),
    ("llama4-scout-17b-a16e", "shared expert left out"),
    ("llama4-scout-17b-a16e", "chunked mask ignored"),
    ("mistral-large-123b", "rope_theta 10000"),
    ("mistral-large-123b", "qk-norm switched on"),
])
def test_a_models_own_wrong_run_is_rejected(run, label, smoke_serves,
                                            smoke_records):
    """Each model's own wrong run of tests/_serve_measure.py leaves the
    SMOKE record's logits beyond the limit (at full width some of them do
    not: ROADMAP.md queue 3, the serving records' known difference)."""
    name = next(r[0] for r in serving_runs() if r[1] == run)
    want = smoke_records[name]["runs"][run]
    out = smoke_serves[run]
    extras = dict(out["extras"])
    if out["model"].cfg.family == "encdec":
        extras["feats"] = _serve_measure.smoke_frames(out["model"].cfg)
    setting = next(r[4] for r in serving_runs() if r[1] == run)
    wrong = {w[0]: w[1:] for w in _serve_measure.wrong_runs(
        name, out["model"], out["params"], extras, setting,
        seq_len=want["positions"][-1] + 2)}
    model, params, extras = wrong[label]
    extras.pop("feats", None)
    logits = chip_smoke.teacher_forced_logits(model, params, want, extras)
    bad = chip_smoke.serve_readings(want["tokens"], out["prompts"], logits,
                                    want)
    assert bad["worst"] > SMOKE_LOGIT_ULPS


def test_gates_left_at_zero_are_rejected(smoke_serves, smoke_records):
    """The vlm served at init (gates 0) against the gated record: its
    teacher-forced logits leave the limit, and check_serve_record fails."""
    run = "llama-3.2-vision-90b-gated"
    record = smoke_records["llama_3_2_vision_90b"]
    out = smoke_serves["llama-3.2-vision-90b"]
    logits = chip_smoke.teacher_forced_logits(
        out["model"], out["params"], record["runs"][run], out["extras"])
    want = record["runs"][run]
    bad = chip_smoke.serve_readings(want["tokens"], out["prompts"], logits,
                                    want)
    assert bad["worst"] > SMOKE_LOGIT_ULPS
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_serve_record(out, logits, record, run,
                                      SMOKE_LOGIT_ULPS)
