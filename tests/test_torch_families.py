"""The port's moe, ssm and hybrid families against the JAX package's: initial
weights, logits, loss, gradients, the moe routing, the SSD scan, decode,
full-width shapes and the moe FL payload's failure.

The reference side runs in one shimmed subprocess for the file (the
worker's ``family_parts`` task; ``repro.models`` does not import in this
process under JAX 0.9.0).  Models: the SMOKE mixtral, llama4-scout, mamba2
and zamba2, through the registry (shards=1, the FL payload's schema).

- Initial parameters are bit-equal (the same Threefry draws from the same
  path-derived keys; Mamba2's ``a_log`` the log of a uniform on [1, 16)).
- Logits, loss (the moe aux term included) and gradients of one seeded
  batch.  Measured by tests/_family_measure.py before the bounds were set:
  logits within 2 bf16 ulps of the largest logit (zamba2; the others 0 to
  1.25), loss within 1.4e-4 relative (llama4), gradients within 3.3 bf16
  ulps of each leaf's largest entry (zamba2); the moe aux loss within
  5.8e-5 relative.
  The bounds are 3 ulps, 5e-4 and 8 ulps: F3's
  shape (ROADMAP.md queue 3), the bf16 backward pass rounding in other
  places under XLA's fusions than under torch's autograd.
- The moe routing is the reference's exactly: the dispatch one-hot (which
  expert and slot each token takes, and which tokens drop past an
  expert's capacity) and the combine weights as the bf16 operand the
  reference multiplies, on three cases, two with a skewed router that
  overflows an expert's buffer; the block's output within 1 bf16 ulp of
  its largest magnitude (measured 0.5).
- ``ssd_chunked`` and ``ssd_step`` within float32 rtol 1e-5 of each
  output's largest magnitude (measured 5.2e-6), in float32 and with bf16
  operands, with and without an initial state, one and several chunks.
- Decode matches the full forward, the reference's own check
  (tests/test_models_smoke.py: within 0.05 * scale + 0.05), against the
  port's full forward and the reference's; in float32 compute with no
  capacity drops the moe decode equals the full forward within the
  reference's 2e-4 (test_moe_decode_exact_without_drops).
- A moe FL payload raises the reference's ``ValueError`` at its first loss
  (the adapter unpacks two values from a forward that returns three), in
  port and reference alike; ROADMAP.md queue 3 files it under the
  reference's own faults.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    TOKEN_DATA, TOKEN_M, cached_plain_draws, one_torch_thread,
    start_reference, token_world,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import fl, prng  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.models import hybrid, mamba2, moe  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.fl_models import get_fl_model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_count, tree_flatten_with_paths,
)

MOE = ("mixtral_8x22b", "llama4_scout_17b_a16e")
IDS = MOE + ("mamba2_130m", "zamba2_7b")
MODELS = tuple(f"{a}:smoke" for a in IDS)
SEQ = 8
LOGIT_ULPS = 3       # measured: 2
LOSS_RTOL = 5e-4     # measured: 1.4e-4
GRAD_ULPS = 8        # measured: 3.3
AUX_RTOL = 5e-4      # measured: 5.8e-5
SSD_RTOL = 1e-5      # of the output's largest magnitude; measured 5.2e-6
MAMBA2_PARAMS = 129_100_224     # the FL schema's leaves (padded vocab)
MAMBA2_CONFIG_COUNT = 129_074_304   # ModelConfig.param_count()'s estimate
# moe_block cases: (model, router skew); a skew adds to expert 0's router
# column and the inputs are made positive, so expert 0's buffer overflows
MOE_CASES = (("mixtral_8x22b:smoke", 0.0), ("mixtral_8x22b:smoke", 0.05),
             ("llama4_scout_17b_a16e:smoke", 0.05))
# ssd cases: (B, S, H, P, G, N, chunk, initial state, bf16 operands)
SSD_CASES = {
    "one-chunk": (2, 128, 4, 8, 1, 16, 128, False, False),
    "chunks-groups-state": (2, 256, 4, 8, 2, 16, 64, True, False),
    "bf16": (1, 128, 4, 8, 1, 16, 32, True, True),
}
MAMBA2_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_reference", "mamba2_130m.json")


@functools.lru_cache(maxsize=None)
def _init(name, capacity_factor=None, num_layers=None):
    """The port's registry model of an FL name (its config's capacity
    factor and depth replaced where given) and its initial parameters
    from ``PRNGKey(0)``, drawn once per module (the plain Threefry draw is
    thousands of tensor ops)."""
    cfg = get_fl_model(name).cfg
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = build_model(cfg)
    return model, model.init(prng.prng_key(0), device="cpu")


def _batch(name):
    cfg = get_fl_model(name).cfg
    rng = np.random.default_rng(MODELS.index(name))
    bx = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    by = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    by[1, SEQ // 2:] = -1
    return bx, by


def _decode_cases():
    cases = [dict(name=n, key=n) for n in MODELS]
    cases += [dict(name=f"{a}:smoke", key=f"{a}:smoke-f32", f32=True)
              for a in MOE]
    return cases


def _decode_tokens(name):
    cfg = get_fl_model(name).cfg
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)


def _moe_key(case):
    return f"{case[0]}-{case[1]}"


def _moe_inputs(case):
    """(x, first-layer moe parameters as arrays) of a moe_block case."""
    name, skew = case
    cfg = get_fl_model(name).cfg
    _, params = _init(name)
    p = tree_lib.tree_map(lambda w: w[0].numpy().copy(),
                          params["layers"]["moe"])
    x = np.random.default_rng(11).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    if skew:
        x = np.abs(x)
        p["router"][:, 0] += skew
    return x, p


def _ssd_inputs(key):
    b, s, h, p_, g, n, _, init, _ = SSD_CASES[key]
    rng = np.random.default_rng(len(key))
    out = {
        "x": rng.standard_normal((b, s, h, p_)),
        "dt": np.abs(rng.standard_normal((b, s, h))) * 0.1,
        "a_log": np.log(rng.uniform(1, 16, h)),
        "b": rng.standard_normal((b, s, g, n)),
        "c": rng.standard_normal((b, s, g, n)),
    }
    if init:
        out["init"] = rng.standard_normal((b, h, p_, n))
    return {k: v.astype(np.float32) for k, v in out.items()}


def reference_spec():
    """(spec, arrays) of the file's one reference subprocess."""
    arrays = {}
    for name in MODELS:
        arrays[f"0/{name}/bx"], arrays[f"0/{name}/by"] = _batch(name)
    for case in _decode_cases():
        arrays[f"dec/{case['key']}/tokens"] = _decode_tokens(case["name"])
    for case in MOE_CASES:
        x, p = _moe_inputs(case)
        arrays[f"moe/{_moe_key(case)}/x"] = x
        for path, leaf in tree_flatten_with_paths(p):
            arrays[f"moe/{_moe_key(case)}/p/{path}"] = leaf
    for key in SSD_CASES:
        for name, v in _ssd_inputs(key).items():
            arrays[f"ssd/{key}/{name}"] = v
    spec = {
        "seed": 0, "models": list(MODELS), "batches": 1,
        "decode": _decode_cases(),
        "moe_blocks": [dict(key=_moe_key(c), model=c[0]) for c in MOE_CASES],
        "ssd": [dict(key=k, chunk=c[6], init=c[7], bf16=c[8])
                for k, c in SSD_CASES.items()],
        "fl_errors": [f"{a}:smoke" for a in MOE],
        "fl_data": TOKEN_DATA, "fl_devices": TOKEN_M,
        "schemas": list(IDS),
    }
    return spec, arrays


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """The file's one reference subprocess, started with its first test so
    that it runs beside the port's tests; killed at the end if no test
    waited for it."""
    spec, arrays = reference_spec()
    job = start_reference(tmp_path_factory.mktemp("families"),
                          "family_parts", spec, arrays)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


@pytest.fixture(scope="module")
def port_params():
    return {name: _init(name)[1] for name in MODELS}


def _bf16_ulp(x):
    """One bf16 ulp at |x| (the spacing of bf16 numbers in its binade)."""
    x = max(float(abs(x)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def family_readings(name, params, bx, by):
    """(logits, aux or None, loss, {path: gradient}) of the port's model on
    one batch: the registry's forward and ``model.loss`` (the moe aux term
    included), as the reference's ``jax.value_and_grad(model.loss)``."""
    cfg = get_fl_model(name).cfg
    model = build_model(cfg)
    tokens, labels = torch.from_numpy(bx), torch.from_numpy(by)
    with torch.no_grad():
        res = model.module.forward(params, tokens, cfg)
    aux = float(res[2]) if cfg.family == "moe" else None
    leaves, treedef = tree_lib.tree_flatten(params)
    req = [w.detach().clone().requires_grad_(True) for w in leaves]
    loss = model.loss(tree_lib.tree_unflatten(treedef, req),
                      {"tokens": tokens, "labels": labels})
    grads = torch.autograd.grad(loss, req)
    paths = [p for p, _ in tree_flatten_with_paths(params)]
    return (res[0].numpy(), aux, float(loss.detach()),
            {p: g.numpy() for p, g in zip(paths, grads)})


def test_ssd_chunks_equal_the_one_token_recurrence():
    """The chunked scan over S tokens equals S steps of the decode
    recurrence (float32, rtol 1e-5 of the largest magnitude)."""
    a = {k: torch.from_numpy(v)
         for k, v in _ssd_inputs("chunks-groups-state").items()}
    y, final = mamba2.ssd_chunked(a["x"], a["dt"], a["a_log"], a["b"],
                                  a["c"], chunk=64, init_state=a["init"])
    state, ys = a["init"], []
    for t in range(a["x"].shape[1]):
        yt, state = mamba2.ssd_step(state, a["x"][:, t], a["dt"][:, t],
                                    a["a_log"], a["b"][:, t], a["c"][:, t])
        ys.append(yt)
    steps = torch.stack(ys, dim=1)
    assert (steps - y).abs().max() <= SSD_RTOL * y.abs().max()
    assert (state - final).abs().max() <= SSD_RTOL * final.abs().max()


def test_hybrid_shared_block_is_one_leaf_summed_over_its_sites():
    """zamba2 with two sites: the shared block is one leaf per weight, and
    its gradient is the sum of the gradients of per-site copies."""
    model, params = _init("zamba2_7b:smoke", num_layers=4)
    cfg = model.cfg
    assert hybrid.sites_of(cfg) == (2, 0)
    params = tree_lib.tree_map(lambda w: w.clone(), params)
    assert all(leaf.shape[0] == 2 for _, leaf in tree_flatten_with_paths(
        params["sites"]))
    wq = params["shared_attn"]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.num_heads, cfg.head_dim)
    batch = {k: torch.from_numpy(v) for k, v in zip(
        ("tokens", "labels"), _batch("zamba2_7b:smoke"))}

    def grad_of(p, leaf):
        leaf.requires_grad_(True)
        (g,) = torch.autograd.grad(model.loss(p, batch), [leaf])
        return g

    shared = grad_of(params, wq)
    copies, block = [], T.transformer_block

    def per_site(p, *args, **kwargs):
        copy = tree_lib.tree_map(lambda w: w, p)
        copy["attn"] = dict(p["attn"], wq=p["attn"]["wq"].detach().clone()
                            .requires_grad_(True))
        copies.append(copy["attn"]["wq"])
        return block(copy, *args, **kwargs)

    T.transformer_block = per_site
    try:
        loss = model.loss(params, batch)
    finally:
        T.transformer_block = block
    assert len(copies) == 2
    summed = sum(torch.autograd.grad(loss, copies))
    assert shared.abs().max() > 0
    torch.testing.assert_close(shared, summed, rtol=1e-5, atol=1e-7)


def test_registry_builds_every_ported_family():
    """Every family builds: dense, moe, ssm, hybrid, and since item 8d's
    first half encdec and vlm; an unknown family raises KeyError."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.registry import family_module

    for arch, family in (("qwen2_0_5b", "dense"), ("mixtral_8x22b", "moe"),
                         ("mamba2_130m", "ssm"), ("zamba2_7b", "hybrid"),
                         ("seamless_m4t_medium", "encdec"),
                         ("llama_3_2_vision_90b", "vlm")):
        assert build_model(get_config(arch)).cfg.family == family
    for arch in ARCH_IDS:
        model = build_model(get_config(arch))
        assert model.module is family_module(model.cfg.family)
    with pytest.raises(KeyError):
        family_module("mlp")


def test_full_width_reference_record_matches_the_port_schema():
    """tests/torch_reference/mamba2_130m.json (written by the reference, its
    command in the file) names the port's full-width leaves with their
    shapes; chip_smoke.py holds the card's initial weights and loss to
    it."""
    with open(MAMBA2_REF, encoding="utf-8") as fh:
        record = json.load(fh)
    assert "--write-family-reference" in record["_command"]
    shapes = abstract_params(get_fl_model(record["model"]).schema())
    got = {p: list(leaf.shape) for p, leaf in tree_flatten_with_paths(shapes)}
    assert {p: v["shape"] for p, v in record["leaves"].items()} == got
    assert record["param_count"] == tree_count(shapes) == MAMBA2_PARAMS
    for leaf in record["leaves"].values():
        n = int(np.prod(leaf["shape"]))
        assert len(leaf["index"]) == len(leaf["values"]) >= 2
        assert all(0 <= i < n for i in leaf["index"])
    assert np.asarray(record["tokens"]).shape == (2, 16)
    assert np.isfinite(record["loss"]) and record["loss"] > 0


@pytest.mark.parametrize("name", MODELS)
def test_initial_parameters_equal_the_reference(port_params, reference, name):
    params = port_params[name]
    paths = [p for p, _ in tree_flatten_with_paths(params)]
    want = sorted(k[len(f"{name}/init/"):] for k in reference
                  if k.startswith(f"{name}/init/"))
    assert paths == want
    for path, leaf in tree_flatten_with_paths(params):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(),
                                      reference[f"{name}/init/{path}"],
                                      err_msg=path)


@pytest.mark.parametrize("name", MODELS)
def test_logits_loss_and_gradients_within_bf16_rounding(
        port_params, reference, name):
    bx, by = _batch(name)
    logits, aux, loss, grads = family_readings(name, port_params[name],
                                               bx, by)
    want = reference[f"0/{name}/logits"]
    assert logits.shape == want.shape and logits.dtype == np.float32
    assert np.abs(logits - want).max() <= LOGIT_ULPS * _bf16_ulp(
        np.abs(want).max())
    want_loss = float(reference[f"0/{name}/loss"])
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    if aux is not None:
        want_aux = float(reference[f"0/{name}/aux"])
        assert abs(aux - want_aux) <= AUX_RTOL * abs(want_aux)
    for path, g in grads.items():
        r = reference[f"0/{name}/grad/{path}"]
        assert g.shape == r.shape
        tol = GRAD_ULPS * _bf16_ulp(np.abs(r).max())
        assert np.abs(g - r).max() <= tol, (path, np.abs(g - r).max(), tol)


def _moe_params(p):
    return tree_lib.tree_map(torch.from_numpy, p)


@pytest.mark.parametrize("case", MOE_CASES, ids=_moe_key)
def test_moe_routing_is_the_references_exactly(reference, case):
    """The dispatch one-hot (expert ids, slots, kept and dropped tokens)
    and the combine operand equal the reference's; the output within one
    bf16 ulp of its largest magnitude, the aux loss within 1e-6."""
    name, skew = case
    cfg = get_fl_model(name).cfg
    x, p = _moe_inputs(case)
    xt, pt = torch.from_numpy(x), _moe_params(p)
    out, aux = moe.moe_block(pt, xt, cfg)
    b, s, d = x.shape
    group = min(moe.MOE_GROUP, s)
    xg = xt.reshape(b * s // group, group, d)
    probs = torch.softmax(torch.einsum("gtd,de->gte", xg, pt["router"]), -1)
    k = cfg.experts_per_token
    cap = int(group * k * cfg.capacity_factor / cfg.num_experts) + 1
    dispatch, combine, _ = moe.route(probs, k, cap)
    pre = f"moe/{_moe_key(case)}"
    np.testing.assert_array_equal(dispatch.numpy(), reference[pre + "/dispatch"])
    np.testing.assert_array_equal(
        combine.to(torch.bfloat16).float().numpy(), reference[pre + "/combine"])
    kept = dispatch.sum((2, 3))
    if skew:
        assert int((kept < k).sum()) > 0, "the skewed router dropped no token"
    assert int(dispatch.sum((1,)).max()) <= 1      # a slot holds one token
    want = reference[pre + "/out"]
    assert np.abs(out.float().numpy() - want).max() <= _bf16_ulp(
        np.abs(want).max())
    assert abs(float(aux) - float(reference[pre + "/aux"])) <= 1e-6


@pytest.mark.parametrize("key", list(SSD_CASES))
def test_ssd_within_float32_tolerance(reference, key):
    a = {k: torch.from_numpy(v) for k, v in _ssd_inputs(key).items()}
    c = SSD_CASES[key]
    ed = torch.bfloat16 if c[8] else torch.float32
    y, final = mamba2.ssd_chunked(a["x"], a["dt"], a["a_log"], a["b"],
                                  a["c"], chunk=c[6], init_state=a.get("init"),
                                  einsum_dtype=ed)
    state = a["init"] if "init" in a else torch.zeros_like(final)
    y1, s1 = mamba2.ssd_step(state, a["x"][:, 0], a["dt"][:, 0], a["a_log"],
                             a["b"][:, 0], a["c"][:, 0])
    for got, name in ((y, "y"), (final, "final"), (y1, "step_y"),
                      (s1, "step_state")):
        want = reference[f"ssd/{key}/{name}"]
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = np.abs(got.numpy() - want).max()
        assert err <= SSD_RTOL * np.abs(want).max(), (name, err)


def _decode(name, *, f32=False):
    """The port's (full forward, one decode step after an S-1 prefill)."""
    model, params = _init(name, 8.0 if f32 else None)
    cfg = model.cfg
    toks = torch.from_numpy(_decode_tokens(name))
    b, s = toks.shape
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks})[0]
        caches = model.init_cache(b, s + 4, device="cpu")
        out = model.module.forward(params, toks[:, :s - 1], cfg,
                                   caches=caches)
        step, _ = model.decode_step(params, out[1], toks[:, s - 1:])
    return full.float().numpy(), step.float().numpy()


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_full_forward(reference, name):
    full, step = _decode(name)
    for want in (full[:, -1], reference[f"dec/{name}/full"][:, -1]):
        err = float(np.abs(step[:, 0] - want).max())
        scale = float(np.abs(want).max()) + 1e-6
        assert err <= 0.05 * scale + 0.05, f"{name}: decode mismatch {err}"


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_exact_without_drops(reference, arch, monkeypatch):
    """In float32 compute with capacity factor 8 (no drops) the moe decode
    equals the full forward within the reference's 2e-4, and the
    reference's decode within the same."""
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    name = f"{arch}:smoke"
    full, step = _decode(name, f32=True)
    np.testing.assert_allclose(step[:, 0], full[:, -1], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(step, reference[f"dec/{name}-f32/step"],
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", MOE)
def test_moe_fl_payload_raises_the_references_error(reference, arch):
    """FLConfig accepts the moe payload, as the reference's does; the run
    raises the reference's ValueError at its first loss (two values
    unpacked from the three the moe forward returns)."""
    name = f"{arch}:smoke"
    want = str(reference[f"err/{name}"])
    assert want.startswith("ValueError: too many values to unpack")
    ds, cell, shards = token_world()
    cfg = FLConfig(num_devices=TOKEN_M, num_rounds=2, fl_engine="batched",
                   model=name)
    with pytest.raises(ValueError) as exc:
        fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert f"ValueError: {exc.value}" == want


@pytest.mark.parametrize("arch", IDS)
def test_full_width_schema_matches_the_reference(reference, arch):
    shapes = abstract_params(get_fl_model(arch).schema())
    got = {p: tuple(leaf.shape) for p, leaf in tree_flatten_with_paths(shapes)}
    want = {k[len(f"{arch}/shape/"):]: tuple(int(d) for d in v)
            for k, v in reference.items() if k.startswith(f"{arch}/shape/")}
    assert got == want
    if arch == "mamba2_130m":
        assert tree_count(shapes) == MAMBA2_PARAMS
        assert get_config(arch).param_count() == MAMBA2_CONFIG_COUNT
