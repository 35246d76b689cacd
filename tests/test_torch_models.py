"""The port's dense transformer and its parameter schemas against the JAX
package's: initial weights, logits, loss, gradients, decode, attention
masks and full-width shapes.

The reference side runs in one shimmed subprocess for the file
(test_torch_harness, the worker's ``token_parts`` task; ``repro.models``
does not import in this process under JAX 0.9.0).  Models: the two tiny
transformers and the SMOKE variant of every dense architecture id.

- Initial parameters are bit-equal: the same Threefry draws from the same
  path-derived keys (``params.leaf_key`` of JAX's ``keystr``), the fan-in
  counting the stacked layer axis and the head axis.
- Logits, loss and gradients of one seeded batch.  The reference computes
  in bf16 under XLA, which fuses the residual add into the next norm and
  feeds it the unrounded float32 sum (the port mirrors that), but its
  backward pass rounds in other places than torch's autograd.  Measured
  by tests/_token_measure.py before the bounds were set, over these six
  models and two batches each:
  the tiny transformer's logits and loss are bit-equal; elsewhere the
  logits differ by at most 1 bf16 ulp of the largest logit and the loss by
  at most 1.52e-4 relative; the gradients by at most 3 bf16 ulps of the
  leaf's largest entry.  The bounds are 2 ulps (logits), 5e-4 relative
  (loss) and 6 ulps (gradients): ROADMAP.md queue 3, F3.
- ``decode_step`` against the teacher-forced forward, the reference's own
  check (tests/test_models_smoke.py: max error within 0.05 * scale + 0.05),
  and the port's decode also against the reference's full forward.
- ``chunked_attention`` under sliding-window and block-local masks and a
  query offset, K/V padded to the chunk: within 1 bf16 ulp of the
  reference's outputs' largest magnitude (measured: equal).
- Every dense id's full-width FL schema (shards=1): leaf names and shapes
  equal the reference's, counted with no allocation (Qwen2-0.5B:
  494,147,456 parameters in 14 leaves).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    one_torch_thread, run_reference,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.fl_models import (  # noqa: E402
    TokenFLModel, available_fl_models, get_fl_model, register_fl_model,
)
from repro_torch.models.params import (  # noqa: E402
    abstract_params, init_params,
)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_bytes, tree_count, tree_flatten_with_paths, tree_global_norm,
)

DENSE_IDS = ("qwen2_0_5b", "qwen3_8b", "granite_34b", "mistral_large_123b")
MODELS = ("tiny-transformer", "tiny-transformer-1m") + tuple(
    f"{a}:smoke" for a in DENSE_IDS)
BATCHES = 2          # seeded batches per model
SEQ = 8
LOGIT_ULPS = 2       # measured: 1
LOSS_RTOL = 5e-4     # measured: 1.52e-4
GRAD_ULPS = 6        # measured: 3
ATTN_CASES = (
    dict(key="window", window=3, kv_chunk=8),
    dict(key="block", block_local=4, kv_chunk=8),
    dict(key="window-pad", window=5, kv_chunk=16),
    dict(key="offset", window=4, q_offset=3, kv_chunk=8),
    dict(key="noncausal", causal=False, kv_chunk=1024),
)
QWEN2_PARAMS = 494_147_456


def _batch(name, i):
    cfg = get_fl_model(name).cfg
    rng = np.random.default_rng(1000 * i + MODELS.index(name))
    bx = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    by = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    by[1, SEQ // 2:] = -1
    return bx, by


def _attn_inputs(key):
    rng = np.random.default_rng(len(key))
    shapes = ((2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One reference subprocess: every model at both batches, the
    full-width schemas and the attention cases."""
    arrays = {}
    for i in range(BATCHES):
        for name in MODELS:
            bx, by = _batch(name, i)
            arrays[f"{i}/{name}/bx"], arrays[f"{i}/{name}/by"] = bx, by
    for case in ATTN_CASES:
        q, k, v = _attn_inputs(case["key"])
        arrays.update({f"q/{case['key']}": q, f"k/{case['key']}": k,
                       f"v/{case['key']}": v})
    spec = {"models": list(MODELS), "seed": 0, "batches": BATCHES,
            "schemas": list(DENSE_IDS), "attention": list(ATTN_CASES)}
    return run_reference(tmp_path_factory.mktemp("models"), "token_parts",
                         spec, arrays)


@pytest.fixture(scope="module")
def port_params():
    return {name: get_fl_model(name).init(0, device="cpu") for name in MODELS}


def _bf16_ulp(x):
    """One bf16 ulp at |x| (the spacing of bf16 numbers in its binade)."""
    x = max(float(abs(x)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("name", MODELS)
def test_initial_parameters_equal_the_reference(reference, port_params, name):
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


def _logits_loss_grads(name, params, bx, by):
    model = get_fl_model(name)
    logits, _ = transformer.forward(params, torch.from_numpy(bx), model.cfg)
    leaves, treedef = tree_lib.tree_flatten(params)
    req = [w.detach().unsqueeze(0).requires_grad_(True) for w in leaves]
    loss = model.batch_loss(tree_lib.tree_unflatten(treedef, req),
                            torch.from_numpy(bx)[None],
                            torch.from_numpy(by)[None], None)
    grads = torch.autograd.grad(loss.sum(), req)
    paths = [p for p, _ in tree_flatten_with_paths(params)]
    acc = model.accuracy(params, torch.from_numpy(bx), torch.from_numpy(by))
    return (logits.detach().numpy(), float(loss[0].detach()), float(acc),
            {p: g[0].numpy() for p, g in zip(paths, grads)})


@pytest.mark.parametrize("batch", range(BATCHES))
@pytest.mark.parametrize("name", MODELS)
def test_logits_loss_and_gradients_within_bf16_rounding(
        reference, port_params, name, batch):
    bx, by = _batch(name, batch)
    logits, loss, _, grads = _logits_loss_grads(name, port_params[name],
                                                bx, by)
    pre = f"{batch}/{name}"
    want = reference[f"{pre}/logits"]
    assert logits.shape == want.shape and logits.dtype == np.float32
    ulp = _bf16_ulp(np.abs(want).max())
    assert np.abs(logits - want).max() <= LOGIT_ULPS * ulp
    want_loss = float(reference[f"{pre}/loss"])
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for path, g in grads.items():
        r = reference[f"{pre}/grad/{path}"]
        assert g.shape == r.shape
        tol = GRAD_ULPS * _bf16_ulp(np.abs(r).max())
        assert np.abs(g - r).max() <= tol, (path, np.abs(g - r).max(), tol)


@pytest.mark.parametrize("batch", range(BATCHES))
def test_tiny_transformer_forward_is_bit_equal(reference, port_params,
                                               batch):
    """F3's forward half: with the fused residual sum mirrored, the tiny
    transformer's logits, loss and accuracy equal the reference's."""
    name = "tiny-transformer"
    bx, by = _batch(name, batch)
    logits, loss, acc, _ = _logits_loss_grads(name, port_params[name], bx, by)
    np.testing.assert_array_equal(logits, reference[f"{batch}/{name}/logits"])
    assert np.float32(loss) == reference[f"{batch}/{name}/loss"]
    assert np.float32(acc) == reference[f"{batch}/{name}/acc"]


def test_all_padding_batch_has_zero_loss_and_zero_gradient(port_params):
    name = "qwen2_0_5b:smoke"
    bx, _ = _batch(name, 0)
    by = np.full_like(bx, -1)
    _, loss, _, grads = _logits_loss_grads(name, port_params[name], bx, by)
    assert loss == 0.0
    assert all(np.all(g == 0.0) for g in grads.values())


def test_batch_loss_trains_each_client_on_its_own_weights(port_params):
    """K clients through vmap equal K one-client calls, and moving one
    client's weights changes only that client's loss."""
    model = get_fl_model("tiny-transformer")
    params = port_params["tiny-transformer"]
    rows = [_batch("tiny-transformer", i) for i in range(3)]
    bx = torch.from_numpy(np.stack([r[0] for r in rows]))
    by = torch.from_numpy(np.stack([r[1] for r in rows]))
    stacked = tree_lib.tree_map(lambda w: torch.stack([w, w * 1.01, w]),
                                params)
    losses = model.batch_loss(stacked, bx, by, None)
    for k in range(3):
        one = tree_lib.tree_map(lambda w: w[k:k + 1], stacked)
        assert losses[k] == model.batch_loss(one, bx[k:k + 1],
                                             by[k:k + 1], None)[0]


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_decode_matches_full_forward(reference, port_params, arch):
    """tests/test_models_smoke.py's check on the port: prefill S-1 tokens
    into the cache, decode the last; against the port's full forward and
    the reference's."""
    name = f"{arch}:smoke"
    cfg = get_fl_model(name).cfg
    params = port_params[name]
    bx = torch.from_numpy(_batch(name, 0)[0])
    b, s = bx.shape
    full, _ = transformer.forward(params, bx, cfg)
    caches = transformer.init_cache(cfg, b, s + 4, shards=1,
                                    device="cpu")
    _, caches = transformer.forward(params, bx[:, :s - 1], cfg, caches=caches)
    assert int(caches["len"][0]) == s - 1
    step, caches = transformer.decode_step(params, caches, bx[:, s - 1:], cfg)
    assert int(caches["len"][0]) == s
    for want in (full[:, -1].numpy(), reference[f"0/{name}/logits"][:, -1]):
        err = float(np.abs(step[:, 0].numpy() - want).max())
        scale = float(np.abs(want).max()) + 1e-6
        assert err <= 0.05 * scale + 0.05, f"{arch}: decode mismatch {err}"


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c["key"])
def test_chunked_attention_masks_match_the_reference(reference, case):
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(case["key"]))
    got = L.chunked_attention(
        q, k, v, mask_spec=L.AttnMaskSpec(
            causal=case.get("causal", True), window=case.get("window"),
            block_local=case.get("block_local")),
        q_offset=case.get("q_offset", 0), kv_chunk=case["kv_chunk"])
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = reference[f"attn/{case['key']}"]
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bf16_ulp(np.abs(want).max())


def test_masked_slots_get_exactly_zero_weight():
    """A value vector at a masked slot never reaches the output: setting
    it to 1e30 changes nothing, and a row whose every slot is masked
    (block-local with a query past the keys) comes out zero."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 6, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 6, 1, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 6, 1, 8)).astype(np.float32))
    spec = L.AttnMaskSpec(causal=True, window=2)
    base = L.chunked_attention(q, k, v, mask_spec=spec, kv_chunk=4)
    v2 = v.clone()
    v2[:, 0] = 1e30          # outside every window but query 0's and 1's
    moved = L.chunked_attention(q, k, v2, mask_spec=spec, kv_chunk=4)
    assert torch.equal(base[:, 2:], moved[:, 2:])
    none = L.chunked_attention(q, k, v, mask_spec=L.AttnMaskSpec(
        causal=True, block_local=2), q_offset=100, kv_chunk=4)
    assert torch.all(none == 0)


def test_mask_blocks_match_the_reference_rules():
    """tests/test_models_smoke.py's window and block-local cases."""
    q = torch.arange(8)
    m = L._mask_block(q, q, L.AttnMaskSpec(causal=True, window=3))
    assert m[7, 7] and m[7, 5] and not m[7, 4] and not m[7, 0]
    assert not m[3, 4]
    m = L._mask_block(q, q, L.AttnMaskSpec(causal=True, block_local=4))
    assert m[5, 4] and not m[5, 3] and m[3, 0]


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_full_width_schema_matches_the_reference(reference, arch):
    model = get_fl_model(arch)
    shapes = abstract_params(model.schema())
    got = {p: tuple(leaf.shape) for p, leaf in tree_flatten_with_paths(shapes)}
    want = {k[len(f"{arch}/shape/"):]: tuple(int(d) for d in v)
            for k, v in reference.items() if k.startswith(f"{arch}/shape/")}
    assert got == want
    assert tree_count(shapes) == sum(int(np.prod(s)) for s in want.values())
    assert tree_bytes(shapes) == 4 * tree_count(shapes)


def test_qwen2_full_width_count_without_allocation():
    model = get_fl_model("qwen2_0_5b")
    shapes = abstract_params(model.schema())
    assert tree_count(shapes) == QWEN2_PARAMS
    leaves = tree_flatten_with_paths(shapes)
    assert len(leaves) == 14
    assert dict(leaves)["embed/tokens"].shape == (152_064, 896)
    assert dict(leaves)["layers/attn/wq"].shape == (24, 896, 14, 64)
    cfg = get_config("qwen2_0_5b")
    assert (cfg.padded_vocab, cfg.padded_heads(16), cfg.padded_kv_heads(16),
            cfg.padded_heads(1), cfg.padded_kv_heads(1)) == (
                152_064, 16, 16, 14, 2)


def test_fan_in_counts_the_layer_and_head_axes():
    """The reference's fan-in of a stacked (L, d, h, hd) weight is
    L * d * h: the draw's scale, mirrored, not fixed."""
    from repro_torch.models.params import ParamSpec, _fan_in

    assert _fan_in((24, 896, 14, 64)) == 24 * 896 * 14
    assert _fan_in((7,)) == 7
    spec = {"w": ParamSpec((3, 5, 2), (None, None, None))}
    w = init_params(spec, prng.prng_key(0), device="cpu")["w"]
    assert float(w.abs().max()) <= 3.0 / np.sqrt(15) * (1 + 1e-6)


def test_registry_resolves_names_as_the_reference():
    assert available_fl_models() == ("lenet", "tiny-transformer",
                                     "tiny-transformer-1m")
    assert get_fl_model("qwen2_0_5b").cfg.name == "qwen2-0.5b"
    assert get_fl_model("qwen2-0.5b:smoke").cfg.name == "qwen2-smoke"
    assert isinstance(get_fl_model("tiny-transformer"), TokenFLModel)
    with pytest.raises(ValueError, match="variant"):
        get_fl_model("qwen2_0_5b:large")
    with pytest.raises(ValueError, match="unknown FL model"):
        get_fl_model("no-such-model")
    with pytest.raises(ValueError, match="vlm/encdec"):
        get_fl_model("llama_3_2_vision_90b:smoke")
    for arch, family in (("mixtral_8x22b", "moe"),
                         ("llama4_scout_17b_a16e", "moe"),
                         ("mamba2_130m", "ssm"), ("zamba2_7b", "hybrid")):
        # ported by item 8c: resolved as the reference resolves them
        assert get_fl_model(arch).cfg.family == family
    register_fl_model("tiny-alias", lambda: get_fl_model("tiny-transformer"))
    try:
        assert "tiny-alias" in available_fl_models()
    finally:
        from repro_torch.models import fl_models

        fl_models._REGISTRY.pop("tiny-alias")
    assert set(ARCH_IDS) >= set(DENSE_IDS)


@pytest.mark.parametrize("name", MODELS)
def test_flconfig_accepts_every_ported_model(name):
    assert FLConfig(model=name).model == name


def test_model_facade_and_tree_utilities(port_params):
    cfg = get_fl_model("qwen3_8b:smoke").cfg
    model = build_model(cfg)
    params = model.init(prng.prng_key(0), device="cpu")
    want = port_params["qwen3_8b:smoke"]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_flatten_with_paths(params), tree_flatten_with_paths(want)))
    assert tree_count(params) == tree_count(model.abstract())
    bx, by = (torch.from_numpy(a) for a in _batch("qwen3_8b:smoke", 0))
    loss = model.loss(params, {"tokens": bx, "labels": by})
    logits, _ = model.forward(params, {"tokens": bx})
    assert torch.equal(loss, L.cross_entropy(logits, by,
                                             vocab_size=cfg.vocab_size))
    norm = tree_global_norm(params)
    assert torch.isclose(norm, torch.sqrt(sum(
        (w.double() ** 2).sum() for w in tree_lib.tree_flatten(params)[0]
    )).float(), rtol=1e-5)
    assert build_model(get_config("mixtral_8x22b")).cfg.family == "moe"
    assert build_model(get_config("seamless_m4t_medium")).cfg.family \
        == "encdec"
    with pytest.raises(KeyError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="mlp"))


def test_full_width_reference_record_matches_the_port_schema():
    """tests/torch_reference/qwen2_0_5b.json (written by the reference,
    its command in the file) names the port's full-width leaves with their
    shapes, and its recorded elements lie inside each leaf; chip_smoke.py
    holds the card's initial weights and loss to it."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_reference", "qwen2_0_5b.json")
    with open(path, encoding="utf-8") as fh:
        record = json.load(fh)
    assert "--write-qwen2-reference" in record["_command"]
    shapes = abstract_params(get_fl_model(record["model"]).schema())
    got = {p: list(leaf.shape) for p, leaf in tree_flatten_with_paths(shapes)}
    assert {p: v["shape"] for p, v in record["leaves"].items()} == got
    assert record["param_count"] == tree_count(shapes) == QWEN2_PARAMS
    for leaf in record["leaves"].values():
        n = int(np.prod(leaf["shape"]))
        assert len(leaf["index"]) == len(leaf["values"]) >= 2
        assert all(0 <= i < n for i in leaf["index"])
    assert np.asarray(record["tokens"]).shape == (2, 16)
    ds = make_token_dataset(vocab_size=151_936, num_samples=600, seq_len=16,
                            seed=0)
    np.testing.assert_array_equal(record["tokens"], ds.x_train[:2])
    np.testing.assert_array_equal(record["labels"], ds.y_train[:2])
    assert np.isfinite(record["loss"]) and record["loss"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_configs_equal_the_reference(arch):
    """Every architecture's CONFIG and SMOKE: the same fields and the same
    derived shapes and counts as the reference's (``repro.configs`` is
    plain data and imports here, but for ``lenet.py``, whose ``FLConfig()``
    reaches ``repro.models``; the port's constructs)."""
    import dataclasses

    from repro import configs as ref_configs
    from repro_torch.configs import canonical, get_smoke

    assert canonical(arch.replace("_", "-")) == ref_configs.canonical(
        arch.replace("_", "-"))
    for ours, theirs in ((get_config(arch), ref_configs.get_config(arch)),
                         (get_smoke(arch), ref_configs.get_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        for shards in (1, 16):
            assert ours.padded_heads(shards) == theirs.padded_heads(shards)
            assert (ours.padded_kv_heads(shards)
                    == theirs.padded_kv_heads(shards))
        assert ours.padded_vocab == theirs.padded_vocab
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
    from repro_torch.configs import lenet

    assert lenet.CONFIG.family == "mlp" and lenet.FL == FLConfig()
