"""The port's LLM trainer and server, and what they read, against the JAX
package's: the NOMA SIC rates, the learning-rate schedules, the
optimizers, error feedback, the trainer's bit schedule, ``randint``, the
train step and the two entry points.

The jnp modules (``repro.core.noma``, ``repro.optim``,
``repro.core.compression``) import here and run in-process; the launch
modules go through one shimmed subprocess for the file (the worker's
``launch_parts`` task).  Contracts, measured by tests/_family_measure.py
before the bounds were set:

- Exact: SIC decode orders and SINRs, the bit schedule of
  ``fl_bits_schedule``, ``randint``, and SGD and momentum updates.  Within
  2 float32 ulps: the rates and bit budgets (measured 2: XLA's float32
  log, as ``noma.tdma_rates``; ROADMAP.md queue 3), the Adam / AdamW
  updates (measured 0; XLA's pow and sqrt against torch's) and the
  schedules (XLA's float32 cos and torch's differ by an ulp on a few
  inputs, which the schedule's products carry to 2: one step of the 45
  read in each cosine schedule, 0 at the others).
- The train step (``make_train_step(grad_accum=2, fl_bits=4)``, two steps
  of AdamW on the SMOKE Qwen2, Mixtral and Mamba2): losses within 5e-5
  relative (measured 1.25e-5), every leaf's mean drift below 4e-6
  (measured 5.1e-7).
- ``train.main`` (6 steps, batch 4, seq 32, adaptive NOMA bits) on the
  SMOKE Qwen2, Mamba2, Mixtral and Zamba2: losses within 5e-4 relative
  (measured 1.75e-4, the bf16 backward pass of F3), and every leaf's mean
  drift of the final parameters (read from each side's ``--save``
  checkpoint) below the run's limit, which lies between the sound run
  (worst 9.7e-6, Zamba2) and the run that dropped one step's update
  (smallest 1.0e-5, Qwen2): test_train_limits_reject_a_dropped_step holds
  the wrong runs of the two closest.  Error feedback is held update by
  update (test_optimizers_match_the_reference).
- ``serve.main``: the greedy tokens of the SMOKE Mamba2 and Mixtral equal
  the reference's; where bf16 near-ties flip a choice (Zamba2,
  Llama4: 61% and 98% of tokens equal), every reference token is within
  4 bf16 ulps of the best logit of the port's full forward over the
  reference's sequence, and every port token is its own full forward's
  best within the same (decode matches the full forward).
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    cached_plain_draws, one_torch_thread, start_reference, tree_arrays,
)

from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.core import channel, noma, prng  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.core.compression import error_feedback_optimizer  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models.fl_models import get_fl_model  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw, constant, cosine_decay, linear_warmup_cosine,
)
from repro_torch.utils.tree import tree_flatten_with_paths  # noqa: E402

BITS_CASES = (dict(seed=0, payload=494_147_456 * 32, rounds=20),
              dict(seed=3, payload=129_074_304 * 32, rounds=10),
              dict(seed=0, payload=266_610 * 32, rounds=20),
              dict(seed=5, payload=20_000 * 32, rounds=20),
              dict(seed=7, payload=2_000_000 * 32, rounds=30))
RANDINT_CASES = (dict(seed=0, shape=[4, 32], lo=0, hi=512),
                 dict(seed=0, shape=[4, 32], lo=0, hi=50_280),
                 dict(seed=1, shape=[3, 5], lo=-7, hi=100),
                 dict(seed=2, shape=[7], lo=0, hi=151_936))
STEP_MODELS = {"dense": "qwen2_0_5b:smoke", "moe": "mixtral_8x22b:smoke",
               "ssm": "mamba2_130m:smoke"}
STEP_LOSS_RTOL, STEP_MEAN_ATOL = 5e-5, 4e-6
_TRAIN = ["--steps", "6", "--batch", "4", "--seq", "32"]
TRAIN_RUNS = {      # name: (argv, every leaf's mean drift limit)
    "qwen2": (["--arch", "qwen2-0.5b", "--smoke"] + _TRAIN, 5e-6),
    "mamba2": (["--arch", "mamba2-130m", "--smoke"] + _TRAIN, 5e-6),
    "mixtral": (["--arch", "mixtral-8x22b", "--smoke"] + _TRAIN, 5e-6),
    "zamba2": (["--arch", "zamba2-7b", "--smoke"] + _TRAIN, 2e-5),
}
# the runs whose limits sit closest to their sound readings
WRONG_RUNS = ("qwen2", "zamba2")
TRAIN_LOSS_RTOL = 5e-4
SERVE_ARCHS = ("mamba2-130m", "zamba2-7b", "mixtral-8x22b",
               "llama4-scout-17b-a16e")
SERVE_EXACT = ("mamba2-130m", "mixtral-8x22b")
SERVE_TIE_ULPS = 4


def _step_arrays():
    arrays, cases = {}, []
    for fam, name in STEP_MODELS.items():
        cfg = get_fl_model(name).cfg
        rng = np.random.default_rng(3)
        for i in range(2):
            for k in ("tokens", "labels"):
                arrays[f"step/{fam}/{i}/{k}"] = rng.integers(
                    0, cfg.vocab_size, (4, 16)).astype(np.int32)
        cases.append(dict(key=fam, model=name, fl_bits=4, grad_accum=2,
                          steps=2))
    return arrays, cases


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("launch_ckpt")


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory, ckpt_dir):
    """The file's one reference subprocess, started with its first test so
    that it runs beside the in-process tests; killed at the end if no test
    waited for it."""
    arrays, cases = _step_arrays()
    spec = {
        "bits": list(BITS_CASES), "randint": list(RANDINT_CASES),
        "train_steps": cases,
        "train_main": [dict(key=k, argv=argv + [
            "--save", str(ckpt_dir / f"ref_{k}.ckpt")])
            for k, (argv, _) in TRAIN_RUNS.items()],
        "serve_main": [dict(key=a, argv=["--arch", a, "--smoke"])
                       for a in SERVE_ARCHS],
    }
    job = start_reference(tmp_path_factory.mktemp("launch"), "launch_parts",
                          spec, arrays)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _bf16_ulp(x):
    x = max(float(abs(x)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# --------------------------------------------------------------------------
# in-process: noma, schedules, optimizers, error feedback
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_noma_sic_functions_match_the_reference(seed):
    import jax.numpy as jnp

    from repro.core import noma as ref

    rng = np.random.default_rng(seed)
    k = 2 + seed % 3
    p = rng.uniform(0.0, 0.01, k).astype(np.float32)
    g = (10.0 ** rng.uniform(-8, -5, k)).astype(np.float32)
    if seed == 5:
        p[:] = 0.01
        g[1] = g[0]                      # a tie in received power
    if seed == 11:
        p[0] = 0.0                       # a silent user
    noise, bw, slot = 1.6e-14, 4e6, 0.2
    pt, gt = torch.from_numpy(p), torch.from_numpy(g)
    assert _ulps(noma.sinr(pt, gt, noise),
                 ref.sinr(jnp.asarray(p), jnp.asarray(g), noise)).max() == 0
    for got, want in (
            (noma.rates(pt, gt, noise), ref.rates(p, g, noise)),
            (noma.bit_budget(pt, gt, noise, bw, slot),
             ref.bit_budget(p, g, noise, bw, slot))):
        assert got.dtype == torch.float32
        assert _ulps(got, want).max() <= 2


def test_schedules_match_the_reference():
    import jax.numpy as jnp

    from repro.optim import schedules as ref

    pairs = (
        (constant(3e-4), ref.constant(3e-4)),
        (cosine_decay(3e-4, 30), ref.cosine_decay(3e-4, 30)),
        (cosine_decay(1e-2, 7, 0.0), ref.cosine_decay(1e-2, 7, 0.0)),
        (linear_warmup_cosine(3e-4, 10, 20),
         ref.linear_warmup_cosine(3e-4, 10, 20)),
        (linear_warmup_cosine(1e-3, 3, 40),
         ref.linear_warmup_cosine(1e-3, 3, 40)),
    )
    for ours, theirs in pairs:
        for step in range(45):
            got = ours(torch.tensor(step, dtype=torch.int32))
            want = theirs(jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            assert _ulps(got, want).max() <= 2, step


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam",
                                  "adamw", "adamw-schedule", "ef-sgd",
                                  "ef-adamw"])
def test_optimizers_match_the_reference(name):
    """Three updates from the same parameters and gradients: SGD and
    momentum exact, Adam / AdamW within 2 float32 ulps (XLA's and torch's
    pow and sqrt), error feedback (4 bits) likewise."""
    import jax
    import jax.numpy as jnp

    from repro.core import compression as ref_comp
    from repro import optim as ref

    make = {
        "sgd": (lambda o: o.sgd(0.1)), "momentum": (lambda o: o.momentum(0.1)),
        "nesterov": (lambda o: o.momentum(0.1, nesterov=True)),
        "adam": (lambda o: o.adam(1e-2)), "adamw": (lambda o: o.adamw(1e-2)),
        "adamw-schedule": (lambda o: o.adamw(o.linear_warmup_cosine(
            1e-2, 2, 10))),
        "ef-sgd": (lambda o: o.sgd(0.1)), "ef-adamw": (lambda o: o.adamw(1e-2)),
    }[name]
    import repro_torch.optim as ours_mod

    ours, theirs = make(ours_mod), make(ref)
    if name.startswith("ef-"):
        ours = error_feedback_optimizer(ours, 4)
        theirs = ref_comp.error_feedback_optimizer(theirs, 4)
    p0 = _opt_tree(0)
    pt = tree_lib.tree_map(torch.from_numpy, p0)
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    st, sj = ours.init(pt), theirs.init(pj)
    for i in range(3):
        g = _opt_tree(10 + i)
        pt, st = ours.update(tree_lib.tree_map(torch.from_numpy, g), st, pt)
        pj, sj = theirs.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
    exact = name in ("sgd", "momentum", "nesterov")
    got = tree_arrays({"p": pt, "s": st})
    want = {"p/" + k: v for k, v in _jax_arrays(pj).items()}
    want.update({"s/" + k: v for k, v in _jax_arrays(sj).items()})
    assert got.keys() == want.keys()
    for key, v in got.items():
        assert v.dtype == want[key].dtype, key
        if v.dtype == np.float32:
            assert _ulps(v, want[key]).max() <= (0 if exact else 2), key
        else:
            np.testing.assert_array_equal(v, want[key], err_msg=key)


def _jax_arrays(tree):
    from repro.utils.tree import tree_flatten_with_paths

    return {p: np.asarray(v) for p, v in tree_flatten_with_paths(tree)}


# --------------------------------------------------------------------------
# through the worker: bits, randint, train step, entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(BITS_CASES)))
def test_fl_bits_schedule_is_the_references_exactly(reference, i):
    c = BITS_CASES[i]
    got = train.fl_bits_schedule(prng.fold_in(prng.prng_key(c["seed"]), 99),
                                 c["payload"], c["rounds"],
                                 channel.CellConfig())
    np.testing.assert_array_equal(got, reference[f"bits/{i}"])


def test_fl_bits_schedule_covers_more_than_one_width(reference):
    widths = set()
    for i in range(len(BITS_CASES)):
        widths |= set(reference[f"bits/{i}"].tolist())
    assert {1, 32} <= widths and len(widths) > 4


@pytest.mark.parametrize("i", range(len(RANDINT_CASES)))
def test_randint_is_the_references_exactly(reference, i):
    c = RANDINT_CASES[i]
    got = prng.randint(prng.fold_in(prng.prng_key(c["seed"]), 1), c["shape"],
                       c["lo"], c["hi"], device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), reference[f"randint/{i}"])


def _port_steps(fam, fl_bits=4, grad_accum=2):
    arrays, _ = _step_arrays()
    model = build_model(get_fl_model(STEP_MODELS[fam]).cfg)
    params = model.init(prng.prng_key(0), device="cpu")
    opt = adamw(linear_warmup_cosine(3e-4, 10, 20))
    state = opt.init(params)
    step = steps.make_train_step(model, opt, fl_bits=fl_bits,
                                 grad_accum=grad_accum)
    losses = []
    for i in range(2):
        batch = {k: torch.from_numpy(arrays[f"step/{fam}/{i}/{k}"])
                 for k in ("tokens", "labels")}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("fam", list(STEP_MODELS))
def test_train_step_with_accumulation_and_fl_bits(reference, fam):
    params, losses = _port_steps(fam)
    for i, loss in enumerate(losses):
        want = float(reference[f"step/{fam}/loss/{i}"])
        assert abs(loss - want) <= STEP_LOSS_RTOL * abs(want)
    for path, leaf in tree_arrays(params).items():
        d = np.abs(leaf.astype(np.float64)
                   - reference[f"step/{fam}/final/{path}"])
        assert d.mean() < STEP_MEAN_ATOL, (path, d.mean())


def test_train_step_accumulates_interleaved_microbatches():
    """grad_accum=2 splits rows i % 2 into microbatch i % 2 and averages:
    the same gradient as two half batches by hand, within float32."""
    model = build_model(get_smoke("qwen2_0_5b"))
    params = model.init(prng.prng_key(0), device="cpu")
    arrays, _ = _step_arrays()
    batch = {k: torch.from_numpy(arrays[f"step/dense/0/{k}"])
             for k in ("tokens", "labels")}
    seen = []

    class Recorder:
        def init(self, p):
            return {}

        def update(self, grads, state, p):
            seen.append(grads)
            return p, state

    steps.make_train_step(model, Recorder(), grad_accum=2)(params, {}, batch)
    halves = [steps._value_and_grad(
        model, params, {k: v[i::2] for k, v in batch.items()}, 1024)[1]
        for i in range(2)]
    want = tree_lib.tree_map(lambda a, b: (a + b) / 2, *halves)
    for (p, g), (_, w) in zip(tree_arrays(seen[0]).items(),
                              tree_arrays(want).items()):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8, err_msg=p)


def test_serve_step_takes_the_greedy_token_of_the_real_vocabulary():
    """make_serve_step's argmax reads only the first ``vocab_size``
    logits: a larger logit in the padded tail is never chosen; the caches
    and the batch reach ``decode_step`` as given."""
    seen = {}

    class Fake:
        class cfg:
            vocab_size = 5

        def decode_step(self, params, caches, tokens, *, batch, kv_chunk):
            seen.update(caches=caches, batch=batch, kv_chunk=kv_chunk)
            logits = torch.tensor([[[0.1, 0.7, 0.2, 0.0, 0.3, 9.0, 8.0]],
                                   [[0.5, 0.1, 0.2, 0.4, 0.6, 7.0, 0.0]]])
            return logits, "new caches"

    batch = {"tokens": torch.zeros((2, 1), dtype=torch.int32)}
    nxt, caches = steps.make_serve_step(Fake())(None, "caches", batch)
    assert nxt.dtype == torch.int32 and nxt.tolist() == [[1], [4]]
    assert caches == "new caches" and seen["caches"] == "caches"
    assert seen["batch"] is batch and seen["kv_chunk"] == 4096


def _run_train(argv, *, drop=None):
    """``train.main`` quietly on the CPU; ``drop``: the 1-based step whose
    parameter update is thrown away (a wrong run)."""
    real = steps.make_train_step
    calls = []

    def make(model, opt, **kw):
        inner = real(model, opt, **kw)

        def step(params, state, batch):
            calls.append(1)
            new, new_state, loss = inner(params, state, batch)
            return (params if len(calls) == drop else new), new_state, loss

        return step

    steps.make_train_step = make
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return train.main(argv + ["--device", "cpu"])
    finally:
        steps.make_train_step = real


def _mean_drifts(path_a, path_b):
    a = tree_arrays(load_checkpoint(str(path_a), device="cpu")["params"])
    b = tree_arrays(load_checkpoint(str(path_b), device="cpu")["params"])
    assert a.keys() == b.keys()
    return {p: float(np.abs(a[p].astype(np.float64) - b[p]).mean())
            for p in a}


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_train_main_matches_the_reference(reference, ckpt_dir, run):
    argv, limit = TRAIN_RUNS[run]
    path = ckpt_dir / f"port_{run}.ckpt"
    losses = np.asarray(_run_train(argv + ["--save", str(path)]))
    want = reference[f"train/{run}"]
    assert losses.shape == want.shape and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want, rtol=TRAIN_LOSS_RTOL)
    drifts = _mean_drifts(path, ckpt_dir / f"ref_{run}.ckpt")
    worst = max(drifts, key=drifts.get)
    assert drifts[worst] < limit, (worst, drifts[worst])


@pytest.mark.parametrize("run", WRONG_RUNS)
def test_train_limits_reject_a_dropped_step(reference, ckpt_dir, run):
    """The run that threw away its 3rd step's update leaves the limit."""
    argv, limit = TRAIN_RUNS[run]
    path = ckpt_dir / f"wrong_{run}.ckpt"
    _run_train(argv + ["--save", str(path)], drop=3)
    drifts = _mean_drifts(path, ckpt_dir / f"ref_{run}.ckpt")
    assert max(drifts.values()) >= limit


def test_train_resume_gives_the_uninterrupted_stream(tmp_path, monkeypatch):
    """6 steps in one run equal a resume from that run's step-3
    checkpoint: the same losses and final parameters, bit for bit."""
    import repro_torch.checkpoint as ck

    argv = ["--arch", "mamba2-130m", "--smoke", "--batch", "2", "--seq",
            "16", "--steps", "6", "--fl-bits", "4"]
    whole, three = tmp_path / "whole.ckpt", tmp_path / "three.ckpt"
    save = ck.save_checkpoint
    monkeypatch.setattr(ck, "save_checkpoint", lambda path, tree: save(
        str(three) if tree["step"] == 3 else path, tree))
    losses = _run_train(argv + ["--save", str(whole), "--save-every", "3"])
    monkeypatch.setattr(ck, "save_checkpoint", save)
    assert load_checkpoint(str(three), device="cpu")["step"] == 3
    resumed = tmp_path / "resumed.ckpt"
    rest = _run_train(argv + ["--resume", str(three), "--save",
                              str(resumed)])
    assert rest == losses[3:]
    a = tree_arrays(load_checkpoint(str(whole), device="cpu")["params"])
    b = tree_arrays(load_checkpoint(str(resumed), device="cpu")["params"])
    for p in a:
        np.testing.assert_array_equal(a[p], b[p], err_msg=p)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_main_matches_the_reference(reference, arch):
    with contextlib.redirect_stdout(io.StringIO()):
        gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    want = reference[f"serve/{arch}"]
    assert gen.shape == want.shape and gen.dtype == torch.int32
    if arch in SERVE_EXACT:
        np.testing.assert_array_equal(gen.numpy(), want)
        return
    cfg = get_smoke(arch)
    model = build_model(cfg)
    key = prng.prng_key(0)
    params = model.init(key, device="cpu")
    prompts = prng.randint(prng.fold_in(key, 1), (4, 32), 0, cfg.vocab_size,
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


def test_train_reference_record_is_the_trainers_run():
    """tests/torch_reference/train_losses.json (written by the reference,
    its command in the file) holds the trainer runs chip_smoke.py holds the
    card's losses to: Mamba2-130M at full width and the SMOKE Mixtral, one
    finite loss a step, falling; beside each the wrong run that threw away
    one step's update: the same losses up to that step, others after."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_reference", "train_losses.json")
    with open(path, encoding="utf-8") as fh:
        record = json.load(fh)
    assert "--write-train-reference" in record["_command"]
    runs = record["runs"]
    want = {"mamba2-130m": ("mamba2-130m", False, 20, 8, 128),
            "mixtral-8x22b-smoke": ("mixtral-8x22b", True, 12, 4, 32)}
    assert set(runs) == set(want)
    drop = record["dropped_step"]
    for name, run in runs.items():
        args = train.parser().parse_args(run["argv"])
        assert (args.arch, args.smoke, args.steps, args.batch,
                args.seq) == want[name]
        assert args.fl_bits is None and not args.no_fl and not args.ef
        losses = np.asarray(run["losses"])
        wrong = np.asarray(run["dropped_losses"])
        assert losses.shape == wrong.shape == (args.steps,)
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
        np.testing.assert_array_equal(wrong[:drop], losses[:drop])
        assert np.all(wrong[drop:] != losses[drop:])
