"""The port's encoder-decoder and vision-language families against the JAX
package's: jax.random's bf16 normals (the modality features), initial
weights, cross-attention, logits, loss, gradients, decode, full-width
shapes and the FL payload's refusal.

The reference side runs in one shimmed subprocess for the file (the
worker's ``multimodal_parts`` task; ``repro.models`` does not import in
this process under JAX 0.9.0).  Models: the SMOKE SeamlessM4T (encdec)
and Llama-3.2-Vision (vlm) through the registry (shards=1).  The vlm's
tanh gates start at zero, which makes every cross layer the identity, so
every forward, gradient and decode case here runs with the gates set to
``GATES`` in both packages' parameters (the reference's tree, carried
across with ``convert.params_from_jax``).  The features are numpy normals
rounded to bf16, given to both sides.

- The bf16 normals equal ``jax.random.normal(key, (n,), bfloat16)`` bit
  for bit; initial parameters are bit-equal (the vlm's scalar gates and
  its doubly stacked self layers included).
- Cross-attention (``attention_block(kv_source=)``) is bit-equal.
- Measured by tests/_multimodal_measure.py before the bounds were set (the
  bound beside each).  XLA and torch round the bf16 products' float32
  sums in other orders (one element of the SMOKE encoder's first MLP
  gate in 8,192 differs by one bf16 ulp, which the next products carry),
  so the logits are not bit-equal, as Mixtral's were not in
  tests/test_torch_families.py; the residual sums XLA feeds its norms
  unrounded (``layers.add_norm``) are mirrored, and
  without them the SMOKE encdec's equal share of logits falls from 60% to
  21%.  The SMOKE vlm's logits are bit-equal at this batch.
- The vlm's two scalar gate gradients are the one exception to the
  gradient contract (F5, ROADMAP.md queue 3): the reference sums their
  bf16 products in bf16 (XLA's CPU tree reduction), 8% from the float64
  sum for gate_mlp; the port sums in float32, and its products summed as
  XLA sums them give the reference's gate_mlp gradient to the bit.
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    cached_plain_draws, one_torch_thread, start_reference,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.models import encdec, vlm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.fl_models import get_fl_model  # noqa: E402
from repro_torch.models.params import abstract_params  # noqa: E402
from repro_torch.models.registry import build_model, family_module  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_count, tree_flatten_with_paths,
)

ARCHS = ("seamless_m4t_medium", "llama_3_2_vision_90b")
GATES = (0.5, -0.7)         # the vlm's (gate_attn, gate_mlp) in every case
SEQ = 8
# bounds, each beside its reading (tests/_multimodal_measure.py)
LOGIT_ULPS = 3      # of the largest logit; measured 2 (encdec), 0 (vlm)
LOSS_RTOL = 5e-4    # measured 3.5e-4 (encdec), 6.6e-8 (vlm)
GRAD_ULPS = 6       # of each leaf's largest entry (test_torch_models.py's
                    # contract); measured 3 (encdec), 2 (vlm, no gate)
# the vlm's scalar gate gradients (F5, ROADMAP.md queue 3): the reference
# sums their B*S*D bf16 products in bf16, 32-wide windows of XLA's tree
# reduction, the port in float32; relative to the reference's, measured
# 0.024 (gate_attn) and 0.082 (gate_mlp); the zeroed cross-attention's
# gate_attn gradient is 0 (relative 1)
GATE_GRAD_RTOL = 0.12
GATE_LEAVES = ("cross_layers/gate_attn", "cross_layers/gate_mlp")
DECODE_ULPS = 3     # the step against the reference's step; measured 1.5
# (seed, fold_in data, n): odd sizes, sizes above 2^16, the serve draws'
NORMAL_CASES = ((0, 2, 1), (0, 2, 4096), (0, 3, 65_537), (3, 7, 12_345),
                (1, 0, 131_075), (5, 2, 4 * 16 * 256))
# attention_block(kv_source=) cases: (arch, queries, memory slots, kv_chunk)
XATTN_CASES = {"encdec": ("seamless_m4t_medium", 5, 16, 1024),
               "encdec-chunks": ("seamless_m4t_medium", 3, 13, 8),
               "vlm-gqa": ("llama_3_2_vision_90b", 4, 16, 1024),
               "vlm-gqa-chunks": ("llama_3_2_vision_90b", 1, 21, 8)}
RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_reference")


def bf16_values(shape, seed):
    """Numpy normals rounded to bf16, held in float32 (how the features
    cross to the reference, which casts them to bf16 exactly)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def feats_shape(arch, batch, seq):
    cfg = get_smoke(arch)
    frames = cfg.num_image_tokens if cfg.family == "vlm" else seq
    return (batch, frames, cfg.d_model)


def modal(arch, feats):
    """The batch entry a family's loss and forward read."""
    name = "img_feats" if get_smoke(arch).family == "vlm" else "enc_feats"
    return {name: _bf16(feats)}


def batch_arrays(arch):
    cfg = get_smoke(arch)
    rng = np.random.default_rng(ARCHS.index(arch))
    bx = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    by = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    by[1, SEQ // 2:] = -1
    return bx, by, bf16_values(feats_shape(arch, 2, SEQ), 10 + len(arch))


def decode_arrays(arch):
    cfg = get_smoke(arch)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    return toks, bf16_values(feats_shape(arch, 2, SEQ), 20 + len(arch))


@functools.lru_cache(maxsize=None)
def _init(arch):
    """The port's SMOKE registry model and its initial parameters from
    ``PRNGKey(0)`` (drawn once per module: the plain Threefry draw is
    thousands of tensor ops)."""
    model = build_model(get_smoke(arch))
    return model, model.init(prng.prng_key(0), device="cpu")


def gated(params, gates=GATES):
    """A copy of a vlm parameter tree with its gates set."""
    out = tree_lib.tree_map(lambda w: w, params)
    cross = dict(out["cross_layers"])
    for name, value in zip(("gate_attn", "gate_mlp"), gates):
        cross[name] = torch.full_like(cross[name], value)
    out["cross_layers"] = cross
    return out


def case_params(arch):
    model, params = _init(arch)
    return model, gated(params) if model.cfg.family == "vlm" else params


def xattn_arrays(key):
    """(x, memory, attention parameters as arrays) of a cross-attention
    case: the first cross layer of the SMOKE model's initial weights."""
    arch, sq, sm, _ = XATTN_CASES[key]
    model, params = _init(arch)
    p = (params["decoder"]["cross_attn"] if model.cfg.family == "encdec"
         else params["cross_layers"]["attn"])
    p = {k: v[0].numpy().copy() for k, v in p.items()}
    d = model.cfg.d_model
    return (bf16_values((2, sq, d), len(key)),
            bf16_values((2, sm, d), 100 + len(key)), p)


def reference_spec():
    """(spec, arrays) of the file's one reference subprocess."""
    arrays = {}
    for arch in ARCHS:
        (arrays[f"{arch}/bx"], arrays[f"{arch}/by"],
         arrays[f"{arch}/feats"]) = batch_arrays(arch)
        arrays[f"dec/{arch}/tokens"], arrays[f"dec/{arch}/feats"] = (
            decode_arrays(arch))
    for key in XATTN_CASES:
        x, src, p = xattn_arrays(key)
        arrays[f"xattn/{key}/x"], arrays[f"xattn/{key}/src"] = x, src
        for name, v in p.items():
            arrays[f"xattn/{key}/p/{name}"] = v
    spec = {
        "seed": 0, "models": list(ARCHS), "gates": list(GATES),
        "xattn": [dict(key=k, arch=c[0], kv_chunk=c[3])
                  for k, c in XATTN_CASES.items()],
        "normals": [list(c) for c in NORMAL_CASES],
        "schemas": list(ARCHS), "fl_errors": list(ARCHS),
    }
    return spec, arrays


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """The file's one reference subprocess, started with its first test so
    that it runs beside the port's tests; killed at the end if no test
    waited for it."""
    spec, arrays = reference_spec()
    job = start_reference(tmp_path_factory.mktemp("multimodal"),
                          "multimodal_parts", spec, arrays)
    yield job
    job.cancel()


@pytest.fixture(scope="module")
def reference(reference_job):
    return reference_job()


def bf16_ulp(x):
    """One bf16 ulp at |x| (the spacing of bf16 numbers in its binade)."""
    x = max(float(abs(x)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def reference_params(reference, arch):
    """The reference's initial tree (gates set for the vlm), carried across
    with ``convert.params_from_jax``."""
    pre = f"{arch}/init/"
    tree = {}
    for k, v in reference.items():
        if k.startswith(pre):
            node = tree
            *head, leaf = k[len(pre):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
    if get_smoke(arch).family == "vlm":
        for name, value in zip(("gate_attn", "gate_mlp"), GATES):
            tree["cross_layers"][name] = np.full_like(
                tree["cross_layers"][name], value)
    return params_from_jax(tree, device="cpu")


def readings(arch, params, bx, by, feats):
    """(logits, loss, {path: gradient}) of the port's model on one batch:
    the registry's forward and ``model.loss``, as the reference's
    ``jax.value_and_grad(model.loss)``."""
    model = build_model(get_smoke(arch))
    batch = {"tokens": torch.from_numpy(bx), "labels": torch.from_numpy(by),
             **modal(arch, feats)}
    with torch.no_grad():
        logits = model.forward(params, batch)[0]
    leaves, treedef = tree_lib.tree_flatten(params)
    req = [w.detach().clone().requires_grad_(True) for w in leaves]
    loss = model.loss(tree_lib.tree_unflatten(treedef, req), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    paths = [p for p, _ in tree_flatten_with_paths(params)]
    return (logits.numpy(), float(loss.detach()),
            {p: (torch.zeros_like(w) if g is None else g).numpy()
             for p, w, g in zip(paths, req, grads)})


def logit_ulps(logits, want):
    return float(np.abs(logits - want).max() / bf16_ulp(np.abs(want).max()))


def decode(arch, params, toks, feats):
    """The port's (full forward, one decode step after an S-1 prefill)."""
    model = build_model(get_smoke(arch))
    cfg = model.cfg
    toks = torch.from_numpy(toks)
    b, s = toks.shape
    batch = modal(arch, feats)
    with torch.no_grad():
        full = model.forward(params, {"tokens": toks, **batch})[0]
        caches = model.init_cache(b, s + 4, device="cpu")
        if cfg.family == "encdec":
            extra = {"enc_out": encdec.encode(params, batch["enc_feats"],
                                              cfg)}
        else:
            extra = batch
        out = model.module.forward(params, toks[:, :s - 1], cfg,
                                   caches=caches, **extra)
        step, _ = model.decode_step(params, out[1], toks[:, s - 1:],
                                    batch=extra)
    return full.float().numpy(), step.float().numpy()


def zeroed_cross_attention(monkeypatch):
    """Make every cross-attention output zero (a wrong port)."""
    real = L.attention_block

    def block(p, x, cfg, **kw):
        y, cache = real(p, x, cfg, **kw)
        if kw.get("kv_source") is not None:
            y = torch.zeros_like(y)
        return y, cache

    monkeypatch.setattr(L, "attention_block", block)


# --------------------------------------------------------------------------
# the draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(NORMAL_CASES)))
def test_bf16_normals_equal_the_reference(reference, i):
    seed, fold, n = NORMAL_CASES[i]
    key = prng.fold_in(prng.prng_key(seed), fold)
    got = prng.normal(key, n, device="cpu", dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (n,)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, reference[f"normal/{i}"])


def test_bf16_normal_takes_the_low_byte_of_the_bits():
    """The bf16 normal is a function of bits 1-7 of each index's hash:
    the 128 values of the table, monotone in k, symmetric but for the
    uniform's one-sided bound."""
    key = prng.fold_in(prng.prng_key(0), 2)
    n = 4096
    k = ((prng.random_bits(key, n, device="cpu") & 0xFF) >> 1)
    table = prng.bf16_normal_table("cpu")
    z = prng.normal(key, n, device="cpu", dtype=torch.bfloat16).float()
    assert torch.equal(z, table[k])
    assert table.shape == (128,) and bool(torch.all(table[1:] > table[:-1]))
    assert float(table[64]) > 0 > float(table[63])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prng.normal(key, 4, device="cpu", dtype=torch.float16)


# --------------------------------------------------------------------------
# parameters, cross-attention, forward, gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_initial_parameters_equal_the_reference(reference, arch):
    _, params = _init(arch)
    paths = [p for p, _ in tree_flatten_with_paths(params)]
    want = sorted(k[len(f"{arch}/init/"):] for k in reference
                  if k.startswith(f"{arch}/init/"))
    assert paths == want
    for path, leaf in tree_flatten_with_paths(params):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(),
                                      reference[f"{arch}/init/{path}"],
                                      err_msg=path)
    if arch == "llama_3_2_vision_90b":
        cfg = get_smoke(arch)
        n_sites, self_per = vlm.sites_of(cfg)
        assert params["cross_layers"]["gate_attn"].shape == (n_sites,)
        assert params["self_layers"]["attn"]["wq"].shape[:2] == (
            n_sites, self_per)
        assert not bool(params["cross_layers"]["gate_mlp"].any())


@pytest.mark.parametrize("key", list(XATTN_CASES))
def test_cross_attention_matches_the_reference(reference, key):
    arch, _, _, chunk = XATTN_CASES[key]
    x, src, p = xattn_arrays(key)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    y, cache = L.attention_block(pt, torch.from_numpy(x), get_smoke(arch),
                                 mask_spec=L.AttnMaskSpec(causal=True),
                                 kv_source=torch.from_numpy(src),
                                 kv_chunk=chunk)
    want = reference[f"xattn/{key}/out"]
    assert cache is None and y.shape == want.shape
    np.testing.assert_array_equal(y.float().numpy(), want)    # measured 0


def test_cross_attention_has_no_rope_no_mask_and_keeps_the_cache():
    """Positions move nothing, a causal spec is overridden (a query sees
    every memory slot), and a cache comes back as it went in."""
    arch = "seamless_m4t_medium"
    x, src, p = xattn_arrays("encdec")
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    cfg = get_smoke(arch)
    xt, st = torch.from_numpy(x), torch.from_numpy(src)
    base, _ = L.attention_block(pt, xt, cfg, mask_spec=L.AttnMaskSpec(
        causal=False), kv_source=st)
    moved, _ = L.attention_block(pt, xt, cfg, mask_spec=L.AttnMaskSpec(
        causal=True), positions=torch.arange(100, 105), kv_source=st)
    assert torch.equal(base, moved)
    cache = L.init_attn_cache(cfg, 2, 8, device="cpu")
    _, kept = L.attention_block(pt, xt, cfg, mask_spec=L.AttnMaskSpec(),
                                cache=cache, kv_source=st)
    assert kept is cache
    # the memory's last slot changes every query's output
    st2 = st.clone()
    st2[:, -1] += 1.0
    other, _ = L.attention_block(pt, xt, cfg, mask_spec=L.AttnMaskSpec(),
                                 kv_source=st2)
    assert bool((other - base).abs().amax(dim=-1).gt(0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_gradients_within_bf16_rounding(reference, arch):
    _, params = case_params(arch)
    bx, by, feats = batch_arrays(arch)
    logits, loss, grads = readings(arch, params, bx, by, feats)
    want = reference[f"{arch}/logits"]
    assert logits.shape == want.shape and logits.dtype == np.float32
    assert logit_ulps(logits, want) <= LOGIT_ULPS
    want_loss = float(reference[f"{arch}/loss"])
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for path, g in grads.items():
        r = reference[f"{arch}/grad/{path}"]
        assert g.shape == r.shape
        if path in GATE_LEAVES:
            assert np.abs(g - r).max() <= GATE_GRAD_RTOL * np.abs(r).max()
            continue
        tol = GRAD_ULPS * bf16_ulp(np.abs(r).max())
        assert np.abs(g - r).max() <= tol, (path, np.abs(g - r).max(), tol)


def xla_bf16_sum(prod):
    """XLA's CPU reduction of a (B, S, D) bf16 tensor to a scalar, as the
    reference's gate gradient takes it: windows of B x S x 32 along D,
    each summed in row-major order with every partial sum rounded to
    bf16, then the D / 32 window sums in order, rounded likewise."""
    b, s, d = prod.shape
    w = prod.reshape(b * s, d // 32, 32).permute(1, 0, 2).reshape(d // 32, -1)
    acc = torch.zeros(d // 32, dtype=torch.bfloat16)
    for j in range(w.shape[1]):
        acc = acc + w[:, j]
    total = torch.zeros((), dtype=torch.bfloat16)
    for v in acc:
        total = total + v
    return total


def test_gate_gradient_difference_is_xlas_bf16_sum(reference, monkeypatch):
    """F5's witness: the port's own cotangents and MLP outputs of the
    cross layer, summed as XLA's CPU reduction sums bf16 (partial sums
    rounded to bf16), give the reference's gate_mlp gradient to the bit;
    the port's float32 sum is nearer the float64 sum."""
    arch = "llama_3_2_vision_90b"
    _, params = case_params(arch)
    bx, by, feats = batch_arrays(arch)
    seen = {}
    real_block, real_mlp = vlm.cross_block, L.mlp_block

    def mlp(p, x):
        seen["m"] = real_mlp(p, x)
        return seen["m"]

    def block(*args, **kwargs):
        monkeypatch.setattr(L, "mlp_block", mlp)
        try:
            seen["y"] = real_block(*args, **kwargs)
        finally:
            monkeypatch.setattr(L, "mlp_block", real_mlp)
        if seen["y"].requires_grad:     # the backward pass's forward
            seen["y"].retain_grad()
            seen["kept"] = (seen["y"], seen["m"])
        return seen["y"]

    monkeypatch.setattr(vlm, "cross_block", block)
    _, _, grads = readings(arch, params, bx, by, feats)
    y, m = seen["kept"]
    dy, m = y.grad, m.detach()
    t = torch.tanh(torch.tensor(GATES[1]))
    red = xla_bf16_sum((dy.float() * m.float()).to(torch.bfloat16)).float()
    emulated = red * (1 - t) + red * (1 - t) * t       # jax's tanh jvp
    want = reference[f"{arch}/grad/cross_layers/gate_mlp"]
    np.testing.assert_array_equal(emulated.reshape(1).numpy(), want)
    exact = float((dy.double() * m.double()).sum()) * float(1 - t * t)
    got = float(grads["cross_layers/gate_mlp"][0])
    assert abs(got - exact) < abs(float(want[0]) - exact)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tree_carried_across_gives_the_same_logits(reference, arch):
    """The reference's own tree (gates set there), carried across with
    ``convert.params_from_jax``, is the port's tree: the same logits."""
    _, params = case_params(arch)
    bx, by, feats = batch_arrays(arch)
    theirs = reference_params(reference, arch)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten_with_paths(params), tree_flatten_with_paths(theirs)))
    ours = readings(arch, params, bx, by, feats)[0]
    carried = readings(arch, theirs, bx, by, feats)[0]
    np.testing.assert_array_equal(ours, carried)


@pytest.mark.parametrize("arch", ARCHS)
def test_limits_reject_a_port_without_the_memory(reference, arch,
                                                 monkeypatch):
    """A port whose cross-attention output is zeroed (vlm), or whose
    encoder output is zeroed (encdec), leaves the logit bound."""
    _, params = case_params(arch)
    bx, by, feats = batch_arrays(arch)
    cfg = get_smoke(arch)
    batch = {"tokens": torch.from_numpy(bx), **modal(arch, feats)}
    with torch.no_grad():
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, batch["enc_feats"], cfg)
            logits = encdec.forward(params, batch["tokens"], cfg,
                                    enc_out=torch.zeros_like(enc_out))[0]
        else:
            zeroed_cross_attention(monkeypatch)
            logits = vlm.forward(params, batch["tokens"], cfg,
                                 img_feats=batch["img_feats"])[0]
    assert logit_ulps(logits.numpy(), reference[f"{arch}/logits"]) \
        > LOGIT_ULPS
    if cfg.family == "vlm":     # and the gate's gradient leaves its bound
        _, _, grads = readings(arch, params, bx, by, feats)
        want = reference[f"{arch}/grad/{GATE_LEAVES[0]}"]
        assert np.abs(grads[GATE_LEAVES[0]] - want).max() \
            > GATE_GRAD_RTOL * np.abs(want).max()


def test_vlm_at_init_ignores_the_image():
    """The gates start at zero: tanh(0) = 0 makes every cross layer the
    identity, so the image features move no logit."""
    arch = "llama_3_2_vision_90b"
    _, params = _init(arch)
    bx, _, feats = batch_arrays(arch)
    cfg = get_smoke(arch)
    with torch.no_grad():
        a = vlm.forward(params, torch.from_numpy(bx), cfg,
                        img_feats=_bf16(feats))[0]
        b = vlm.forward(params, torch.from_numpy(bx), cfg,
                        img_feats=_bf16(feats * 0))[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(reference, arch):
    """The reference's contract (tests/test_models_smoke.py: within 0.05 *
    scale + 0.05) against the port's full forward and the reference's;
    the step within DECODE_ULPS of the reference's step."""
    _, params = case_params(arch)
    toks, feats = decode_arrays(arch)
    full, step = decode(arch, params, toks, feats)
    for want in (full[:, -1], reference[f"dec/{arch}/full"][:, -1]):
        err = float(np.abs(step[:, 0] - want).max())
        scale = float(np.abs(want).max()) + 1e-6
        assert err <= 0.05 * scale + 0.05, f"{arch}: decode mismatch {err}"
    assert logit_ulps(step, reference[f"dec/{arch}/step"]) <= DECODE_ULPS


def test_vlm_depth_must_be_a_multiple_of_its_sites():
    cfg = get_smoke("llama_3_2_vision_90b")
    import dataclasses

    with pytest.raises(AssertionError):
        vlm.sites_of(dataclasses.replace(cfg, num_layers=3))
    assert vlm.sites_of(get_config("llama_3_2_vision_90b")) == (20, 4)


# --------------------------------------------------------------------------
# registry, full-width schemas, FL payloads, records
# --------------------------------------------------------------------------

def test_registry_builds_every_family():
    """Every architecture id builds (dense, moe, ssm, hybrid, encdec,
    vlm); an unknown family raises KeyError."""
    families = set()
    for arch in ARCH_IDS:
        model = build_model(get_config(arch))
        families.add(model.cfg.family)
        assert family_module(model.cfg.family) is model.module
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    with pytest.raises(KeyError, match="unknown family"):
        family_module("mlp")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_schema_matches_the_reference(reference, arch):
    shapes = abstract_params(build_model(get_config(arch)).schema)
    got = {p: tuple(leaf.shape) for p, leaf in tree_flatten_with_paths(shapes)}
    want = {k[len(f"{arch}/shape/"):]: tuple(int(d) for d in v)
            for k, v in reference.items() if k.startswith(f"{arch}/shape/")}
    assert got == want


@pytest.mark.parametrize("name", [n for a in ARCHS
                                  for n in (a, f"{a}:smoke")])
def test_fl_payload_keeps_the_references_error(reference, name):
    """The registry builds these families, and the FL names still raise
    the reference's ValueError, word for word, at the same point: at once,
    from get_fl_model and from FLConfig (the client bank carries no
    modality features)."""
    for call, key in ((get_fl_model, "err"),
                      (lambda n: FLConfig(model=n), "cfgerr")):
        want = str(reference[f"{key}/{name}"])
        assert "vlm/encdec forwards need modality features" in want
        with pytest.raises(ValueError) as exc:
            call(name)
        assert f"ValueError: {exc.value}" == want


def _load(arch):
    with open(os.path.join(RECORDS, f"{arch}.json"), encoding="utf-8") as fh:
        return json.load(fh)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_records_match_the_port(arch):
    """tests/torch_reference/<arch>.json (written by the reference, its
    command in the file) names the port's leaves and shapes at the
    record's depth; its recorded feature elements are the port's bf16
    draw."""
    import dataclasses

    record = _load(arch)
    assert "--write-multimodal-reference" in record["_command"]
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=record["num_layers"])
    shapes = abstract_params(build_model(cfg).schema)
    got = {p: list(leaf.shape) for p, leaf in tree_flatten_with_paths(shapes)}
    assert {p: v["shape"] for p, v in record["leaves"].items()} == got
    assert record["param_count"] == tree_count(shapes)
    for leaf in record["leaves"].values():
        n = int(np.prod(leaf["shape"]))
        assert len(leaf["index"]) == len(leaf["values"]) >= 1
        assert all(0 <= i < n for i in leaf["index"])
    feats = record["feats"]
    key = prng.fold_in(prng.prng_key(record["seed"]), feats["fold_in"])
    idx = torch.tensor(feats["index"], dtype=torch.int64)
    x0, x1 = prng.threefry2x32(key, idx >> 32, idx & prng.MASK32)
    got = prng.bf16_normal_table("cpu")[((x0 ^ x1) & 0xFF) >> 1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(feats["values"],
                                                          np.float32))
    if max(feats["index"]) < 1 << 16:     # and the whole draw agrees
        n = max(feats["index"]) + 1
        draw = prng.normal(key, n, device="cpu", dtype=torch.bfloat16)
        np.testing.assert_array_equal(draw[idx].float().numpy(), got.numpy())
    if arch == "seamless_m4t_medium":
        assert record["num_layers"] == 12 and "sum" in next(iter(
            record["leaves"].values()))
        assert np.isfinite(record["loss"]) and record["loss"] > 0
    else:
        assert record["num_layers"] == 5
