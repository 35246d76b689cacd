"""The port's server and trainer on the encdec and vlm families against the
JAX package's: the modality inputs they draw, ``serve.main``'s greedy
tokens and ``train.main``'s losses and final parameters.

The reference side runs in one shimmed subprocess for the file (the
worker's ``launch_parts`` task).  Models: the SMOKE SeamlessM4T (encdec)
and Llama-3.2-Vision (vlm).  The vlm's gates start at zero, so the
server runs it twice, at init and with its gates set (``GATES``, set in
``Model.init`` on both sides), and the trainer with the gates set: at
zero gates its cross layers move no logit.  Contracts, measured by
tests/_multimodal_measure.py before the bounds were set:

- ``serve.main``: the greedy tokens equal the reference's at init (both
  families); with the vlm's gates set, bf16 near-ties flip choices (83%
  of tokens equal), and each side's tokens are held to the best logit of
  the port's full forward within 4 bf16 ulps, as tests/test_torch_launch.py
  holds Zamba2's and Llama4's.
- ``train.main`` (6 steps, batch 4, seq 32, adaptive NOMA bits): losses
  within 5e-4 relative (tests/test_torch_launch.py's bound), and every
  leaf's mean drift of the final parameters (read from each side's
  ``--save`` checkpoint) below the run's limit, which lies between the
  sound run and the run that dropped its 3rd step's update
  (test_train_limits_reject_a_dropped_step holds the wrong runs); the
  vlm's two scalar gates are left out (F5, ROADMAP.md queue 3: the
  reference sums their gradients in bf16, which moves them as far in the
  sound run as the dropped step does).
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    cached_plain_draws, one_torch_thread, start_reference, tree_arrays,
)

from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import adamw, constant  # noqa: E402

GATES = [0.5, -0.7]
_SEAMLESS = ["--arch", "seamless-m4t-medium", "--smoke"]
_VISION = ["--arch", "llama-3.2-vision-90b", "--smoke"]
SERVE_RUNS = {"seamless": (_SEAMLESS, None), "vision": (_VISION, None),
              "vision-gated": (_VISION, GATES)}
_TRAIN = ["--steps", "6", "--batch", "4", "--seq", "32"]
TRAIN_RUNS = {      # name: (argv, the vlm's gates, every leaf's drift limit)
    "seamless": (_SEAMLESS + _TRAIN, None, 5e-6),    # 1.65e-6 / 1.42e-5
    "vision": (_VISION + _TRAIN, GATES, 5e-6),       # 1.53e-6 / 1.3e-5
}
SERVE_EXACT = ("seamless", "vision")
SERVE_TIE_ULPS = 4          # tests/test_torch_launch.py's near-tie bound
TRAIN_LOSS_RTOL = 5e-4
GATE_LEAVES = ("cross_layers/gate_attn", "cross_layers/gate_mlp")
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_reference", "train_losses_multimodal.json")


@contextlib.contextmanager
def gated_init(gates):
    """The port's ``Model.init`` setting a vlm's gates (nothing when
    ``gates`` is None), as the worker's ``_gated_init`` sets the
    reference's."""
    real = registry.Model.init

    def init(self, key, *, device=None):
        params = real(self, key, device=device)
        if self.cfg.family == "vlm":
            cross = params["cross_layers"]
            for name, value in zip(("gate_attn", "gate_mlp"), gates):
                cross[name] = torch.full_like(cross[name], value)
        return params

    if gates is not None:
        registry.Model.init = init
    try:
        yield
    finally:
        registry.Model.init = real


def start_job(tmp_path_factory, ckpt_dir):
    spec = {
        "train_main": [dict(key=k, gates=gates, argv=argv + [
            "--save", str(ckpt_dir / f"ref_{k}.ckpt")])
            for k, (argv, gates, _) in TRAIN_RUNS.items()],
        "serve_main": [dict(key=k, argv=argv, gates=gates)
                       for k, (argv, gates) in SERVE_RUNS.items()],
    }
    return start_reference(tmp_path_factory.mktemp("mm_launch"),
                           "launch_parts", spec)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mm_ckpt")


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory, ckpt_dir):
    """The file's one reference subprocess, started with its first test so
    that it runs beside the in-process tests; killed at the end if no test
    waited for it."""
    job = start_job(tmp_path_factory, ckpt_dir)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


def run_serve(argv, gates):
    with gated_init(gates), contextlib.redirect_stdout(io.StringIO()):
        return serve.main(argv + ["--device", "cpu"])


def run_train(argv, *, gates=None, drop=None):
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
        with gated_init(gates), contextlib.redirect_stdout(io.StringIO()):
            return train.main(argv + ["--device", "cpu"])
    finally:
        steps.make_train_step = real


def mean_drifts(path_a, path_b):
    """Every leaf's mean |a - b| of two checkpoints' parameters but the
    vlm's two scalar gates, whose gradients the reference sums in bf16
    (F5, ROADMAP.md queue 3: their drift is the reference's rounding, as
    large in the sound run as in the wrong one)."""
    a = tree_arrays(load_checkpoint(str(path_a), device="cpu")["params"])
    b = tree_arrays(load_checkpoint(str(path_b), device="cpu")["params"])
    assert a.keys() == b.keys()
    return {p: float(np.abs(a[p].astype(np.float64) - b[p]).mean())
            for p in a if p not in GATE_LEAVES}


# --------------------------------------------------------------------------
# in-process: the modality inputs
# --------------------------------------------------------------------------

def test_serve_draws_the_references_modality_inputs():
    """An encdec's frame embeddings are ``normal(fold_in(key, 3), (B,
    max(P, 8), D), bf16)``, encoded once; a vlm's image features
    ``normal(fold_in(key, 2), (B, num_image_tokens, D), bf16)``."""
    key = prng.prng_key(0)
    for arch, fold, frames in (("seamless-m4t-medium", 3, 8),
                               ("llama-3.2-vision-90b", 2, None)):
        cfg = get_smoke(arch)
        model = registry.build_model(cfg)
        params = model.init(key, device="cpu")
        extras = serve.modality_inputs(model, params, key, 2, 5, "cpu")
        shape = (2, frames or cfg.num_image_tokens, cfg.d_model)
        draw = prng.normal(prng.fold_in(key, fold), int(np.prod(shape)),
                           device="cpu", dtype=torch.bfloat16).reshape(shape)
        if cfg.family == "encdec":
            with torch.no_grad():
                want = encdec.encode(params, draw, cfg)
            assert torch.equal(extras["enc_out"], want)
        else:
            assert torch.equal(extras["img_feats"], draw)
        assert next(iter(extras.values())).dtype == torch.bfloat16
    dense = registry.build_model(get_smoke("qwen2-0.5b"))
    assert serve.modality_inputs(dense, None, key, 2, 5, "cpu") == {}


def test_train_draws_the_references_modality_inputs():
    """Step i's features are ``normal(fold_in(fold_in(key, 7), i), ...,
    bf16)``: an encdec's (batch, max(seq // 4, 8), D), a vlm's (batch,
    num_image_tokens, D)."""
    key = prng.fold_in(prng.fold_in(prng.prng_key(0), 7), 3)
    for arch, name, frames in (("seamless-m4t-medium", "enc_feats", 10),
                               ("llama-3.2-vision-90b", "img_feats", 16)):
        cfg = get_smoke(arch)
        got = train.modality_batch(cfg, key, 2, 40, "cpu")
        shape = (2, frames, cfg.d_model)
        want = prng.normal(key, int(np.prod(shape)), device="cpu",
                           dtype=torch.bfloat16).reshape(shape)
        assert list(got) == [name] and torch.equal(got[name], want)
    assert train.modality_batch(get_smoke("seamless-m4t-medium"), key, 2, 8,
                                "cpu")["enc_feats"].shape[1] == 8
    assert train.modality_batch(get_smoke("mamba2-130m"), key, 2, 8,
                                "cpu") == {}


def test_serve_keeps_the_vlm_sites_whole():
    """``--num-layers`` for a vlm must stay a multiple of its
    ``cross_attn_every``, as the reference's ``sites_of`` asserts."""
    with pytest.raises(AssertionError):
        serve.run(_VISION + ["--num-layers", "3", "--device", "cpu"])


def test_grad_accum_splits_the_modality_inputs():
    """``make_train_step(grad_accum=2)`` splits the frame embeddings with
    the tokens: its loss is the mean of the two interleaved microbatches'
    losses."""
    cfg = get_smoke("seamless-m4t-medium")
    model = registry.build_model(cfg)
    params = model.init(prng.prng_key(0), device="cpu")
    rng = np.random.default_rng(1)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, 512, (4, 8)).astype(
            np.int32)),
        "labels": torch.from_numpy(rng.integers(0, 512, (4, 8)).astype(
            np.int32)),
        "enc_feats": torch.from_numpy(rng.standard_normal(
            (4, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16),
    }
    opt = adamw(constant(1e-3))
    _, _, loss = steps.make_train_step(model, opt, grad_accum=2)(
        params, opt.init(params), batch)
    with torch.no_grad():
        parts = [model.loss(params, {k: v[i::2] for k, v in batch.items()})
                 for i in range(2)]
    torch.testing.assert_close(loss, (parts[0] + parts[1]) / 2, rtol=1e-6,
                               atol=0)


# --------------------------------------------------------------------------
# against the reference: serve.main, train.main, the record
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(SERVE_RUNS))
def test_serve_main_matches_the_reference(reference, key):
    """The greedy tokens equal the reference's; where bf16 near-ties flip
    a choice (the gated vlm: 83% of tokens equal), every reference token
    is within SERVE_TIE_ULPS bf16 ulps of the best logit of the port's
    full forward over the reference's sequence, and every port token is
    its own full forward's best within the same."""
    argv, gates = SERVE_RUNS[key]
    gen = run_serve(argv, gates)
    want = reference[f"serve/{key}"]
    assert gen.shape == want.shape and gen.dtype == torch.int32
    if key in SERVE_EXACT:
        np.testing.assert_array_equal(gen.numpy(), want)
        return
    cfg = get_smoke(argv[1])
    model = registry.build_model(cfg)
    pkey = prng.prng_key(0)
    with gated_init(gates):
        params = model.init(pkey, device="cpu")
    extras = serve.modality_inputs(model, params, pkey, 4, 32, "cpu")
    prompts = prng.randint(prng.fold_in(pkey, 1), (4, 32), 0, cfg.vocab_size,
                           device="cpu")
    for tokens in (torch.from_numpy(want), gen):
        seq = torch.cat([prompts, tokens[:, :-1]], dim=1)
        with torch.no_grad():
            logits = model.module.forward(params, seq, cfg, **extras)[0]
        logits = logits[:, 31:, : cfg.vocab_size]
        best = logits.max(-1).values
        chosen = torch.gather(logits, -1, tokens.long()[..., None])[..., 0]
        tol = SERVE_TIE_ULPS * _bf16_ulp(float(logits.abs().max()))
        assert float((best - chosen).max()) <= tol


def _bf16_ulp(x):
    x = max(float(abs(x)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_gated_vlm_serves_other_tokens(reference):
    """The gates reach the server: the gated run's tokens differ from the
    zero-gate run's, on both sides."""
    assert not np.array_equal(reference["serve/vision"],
                              reference["serve/vision-gated"])


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_train_main_matches_the_reference(reference, ckpt_dir, run):
    argv, gates, limit = TRAIN_RUNS[run]
    path = ckpt_dir / f"port_{run}.ckpt"
    losses = np.asarray(run_train(argv + ["--save", str(path)], gates=gates))
    want = reference[f"train/{run}"]
    assert losses.shape == want.shape and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want, rtol=TRAIN_LOSS_RTOL)
    drifts = mean_drifts(path, ckpt_dir / f"ref_{run}.ckpt")
    worst = max(drifts, key=drifts.get)
    assert drifts[worst] < limit, (worst, drifts[worst])


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_train_limits_reject_a_dropped_step(reference, ckpt_dir, run):
    """The run that threw away its 3rd step's update leaves the limit."""
    argv, gates, limit = TRAIN_RUNS[run]
    path = ckpt_dir / f"wrong_{run}.ckpt"
    run_train(argv + ["--save", str(path)], gates=gates, drop=3)
    drifts = mean_drifts(path, ckpt_dir / f"ref_{run}.ckpt")
    assert max(drifts.values()) >= limit


def test_multimodal_train_record_is_the_trainers_run():
    """tests/torch_reference/train_losses_multimodal.json (written by the
    reference, its command in the file) holds the SMOKE encdec and vlm
    runs chip_smoke.py holds the card's losses to: one finite loss a
    step, falling; the vlm's gates set; beside each the wrong run that
    threw away one step's update: the same losses up to that step, others
    after."""
    with open(RECORD, encoding="utf-8") as fh:
        record = json.load(fh)
    assert "--write-multimodal-train-reference" in record["_command"]
    runs = record["runs"]
    assert set(runs) == {"seamless-smoke", "llama-vision-smoke"}
    assert runs["llama-vision-smoke"]["gates"] == GATES
    assert runs["seamless-smoke"]["gates"] is None
    drop = record["dropped_step"]
    for name, run in runs.items():
        args = train.parser().parse_args(run["argv"])
        assert args.smoke and (args.steps, args.batch, args.seq) == (12, 4, 32)
        assert args.fl_bits is None and not args.no_fl and not args.ef
        assert get_smoke(args.arch).name == name
        losses = np.asarray(run["losses"])
        wrong = np.asarray(run["dropped_losses"])
        assert losses.shape == wrong.shape == (args.steps,)
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
        np.testing.assert_array_equal(wrong[:drop], losses[:drop])
        assert np.all(wrong[drop:] != losses[drop:])
