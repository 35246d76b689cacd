"""The trainer's in-place step against a functional one.

``make_train_step`` (what ``launch.train.main`` runs) gives up its inputs
as the reference's jitted step under ``donate_argnums=(0, 1)`` does: each
gradient leaf is released once its quantized value exists, and AdamW's
``update_`` (under ``--ef`` the error-feedback wrapper's) overwrites the
parameters, the moments and the residual leaf by leaf.  The functional
reference here is the step as the port wrote it before it updated in
place: new trees at every stage, AdamW's expressions as whole-tree maps.
On SMOKE dense, moe and hybrid models with weights and tokens drawn by
numpy from a seed, with and without error feedback:

- three in-place steps give the functional step's parameters, ``m``,
  ``v``, ``step``, residual and losses, ``torch.equal``;
- each parameter and moment leaf keeps its storage across the steps;
- the in-place quantizers replace every leaf by its leaf quantizer's
  value;
- ``Optimizer.update`` (``update_`` on copies, for callers that keep the
  old values) leaves the trees it is given as they are;
- a run that clones the parameters before the step whose update it throws
  away (tests/test_torch_launch.py's wrong runs) still parts from the
  sound run at that step, and ``train.main`` steps in place.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.core import tree as tree_lib  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw, linear_warmup_cosine, momentum, sgd)

ARCHS = ["qwen2_0_5b", "mixtral_8x22b", "zamba2_7b"]
STEPS = 3
BITS = 4
F32 = torch.float32


def _setup(arch, seed=0):
    """(model, float32 weights of the SMOKE schema drawn by numpy, three
    (2, 16) token batches)."""
    model = build_model(get_smoke(arch))
    rng = np.random.default_rng(seed)
    params = tree_lib.tree_map(
        lambda leaf: torch.from_numpy(
            (0.05 * rng.standard_normal(tuple(leaf.shape))).astype(
                np.float32)), model.abstract())
    vocab = model.cfg.vocab_size
    batches = [{k: torch.from_numpy(rng.integers(0, vocab, (2, 16),
                                                 dtype=np.int32))
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    return model, params, batches


# the warmup's first steps at a learning rate large enough to move every
# leaf
def _schedule():
    return linear_warmup_cosine(3e-2, 2, 10)


def _optimizer(ef):
    opt = adamw(_schedule())
    return compression.error_feedback_optimizer(opt, BITS) if ef else opt


def _functional_adamw_update(lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """AdamW's update as new trees: ``adamw``'s defaults, each expression
    of the reference mapped over whole trees."""
    b1_, b2_ = float(np.float32(b1)), float(np.float32(b2))
    c1, c2 = float(np.float32(1 - b1)), float(np.float32(1 - b2))
    eps_, wd_ = float(np.float32(eps)), float(np.float32(wd))

    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr(step - 1)
        m = tree_lib.tree_map(lambda m_, g: b1_ * m_ + c1 * g.to(F32),
                              state["m"], grads)
        v = tree_lib.tree_map(
            lambda v_, g: b2_ * v_ + c2 * torch.square(g.to(F32)),
            state["v"], grads)
        sf = step.to(F32)
        bc1 = 1 - torch.pow(torch.full_like(sf, b1_), sf)
        bc2 = 1 - torch.pow(torch.full_like(sf, b2_), sf)

        def step_fn(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps_)
            upd = upd + wd_ * p.to(F32)
            return (p.to(F32) - eta * upd).to(p.dtype)

        new = tree_lib.tree_map(step_fn, params, m, v)
        return new, {"step": step, "m": m, "v": v}

    return update


def _functional_step(model, ef):
    """The train step with new trees at every stage: the gradients
    quantized into a new tree (under ``ef``: ``adj = g + r``, then the
    quantized tree and the new residual), then the functional AdamW."""
    update = _functional_adamw_update(_schedule())

    def split(pairs_tree, i):
        flat, treedef = tree_lib.tree_flatten(pairs_tree)
        return tree_lib.tree_unflatten(treedef, [pair[i] for pair in flat])

    def step(params, state, batch):
        loss, grads = steps._value_and_grad(model, params, batch, 1024)
        with torch.no_grad():
            if not ef:
                q = tree_lib.tree_map(
                    lambda g: compression.quantize_dequantize_leaf(g, BITS),
                    grads)
                params, state = update(q, state, params)
                return params, state, loss
            adj = tree_lib.tree_map(lambda g, r: g.to(F32) + r, grads,
                                    state["residual"])
            pairs = tree_lib.tree_map(
                lambda a: compression.quantize_dequantize_residual_leaf(
                    a, BITS), adj)
            params, inner = update(split(pairs, 0), state["inner"], params)
            return params, {"inner": inner,
                            "residual": split(pairs, 1)}, loss

    return step


def _run(arch, ef, functional=False, drop=None):
    """Three steps of ``make_train_step`` as ``train.main`` makes it (or,
    with ``functional``, of :func:`_functional_step`): each step's
    (parameters, state, loss), copied; ``drop``: the 1-based step whose
    parameter update is thrown away, the parameters cloned before it."""
    model, params, batches = _setup(arch)
    opt = _optimizer(ef)
    state = opt.init(params)
    step = (_functional_step(model, ef) if functional
            else steps.make_train_step(model, opt,
                                       fl_bits=None if ef else BITS))
    out = []
    for i, batch in enumerate(batches, 1):
        keep = tree_lib.tree_map(torch.clone, params) if i == drop else None
        params, state, loss = step(params, state, batch)
        if keep is not None:
            params = keep
        out.append(tree_lib.tree_map(torch.clone, {
            "params": params, "state": state, "loss": loss}))
    return out


def _assert_equal_trees(a, b):
    fa, fb = (dict(_paths(t)) for t in (a, b))
    assert fa.keys() == fb.keys()
    for path in fa:
        assert fa[path].dtype == fb[path].dtype, path
        assert torch.equal(fa[path], fb[path]), path


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("ef", [False, True], ids=["fl4", "ef"])
@pytest.mark.parametrize("arch", ARCHS)
def test_in_place_steps_equal_the_functional_update(arch, ef):
    """Parameters, m, v, step (and the residual) after each of three steps,
    and each step's loss, equal to the bit."""
    functional = _run(arch, ef, functional=True)
    in_place = _run(arch, ef)
    for f, p in zip(functional, in_place):
        _assert_equal_trees(f, p)
    state = in_place[-1]["state"]
    inner = state["inner"] if ef else state
    assert int(inner["step"]) == STEPS
    assert set(state) == ({"inner", "residual"} if ef else {"m", "v", "step"})
    # the steps moved every leaf
    _, start, _ = _setup(arch)
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_lib.tree_flatten(start)[0],
        tree_lib.tree_flatten(in_place[-1]["params"])[0])]
    assert all(moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_in_place_steps_keep_each_leafs_storage(arch):
    """The trees passed in come back, each parameter and moment leaf in
    its own storage across the steps (the residual's leaves are replaced,
    one at a time)."""
    model, params, batches = _setup(arch)
    opt = _optimizer(True)
    state = opt.init(params)
    trees = (params, state["inner"]["m"], state["inner"]["v"])
    ptrs = [[leaf.data_ptr() for leaf in tree_lib.tree_flatten(t)[0]]
            for t in trees]
    step = steps.make_train_step(model, opt)
    for batch in batches:
        new_params, new_state, _ = step(params, state, batch)
        assert new_params is params and new_state is state
    assert ptrs == [[leaf.data_ptr() for leaf in tree_lib.tree_flatten(t)[0]]
                    for t in trees]
    assert int(state["inner"]["step"]) == STEPS


@pytest.mark.parametrize("residual", [False, True],
                         ids=["quantized", "residual"])
def test_in_place_quantizers_equal_the_leaf_quantizers(residual):
    """``quantize_dequantize_tree_`` and ``quantize_dequantize_residual_
    tree_`` replace every leaf of the trees given by its leaf quantizer's
    value."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": {"c": (33,), "d": (2, 3, 4)}}
    tree = _tree_of(shapes, rng)
    given = tree_lib.tree_map(torch.clone, tree)
    old = tree_lib.tree_flatten(given)[0]
    if residual:
        pairs = [compression.quantize_dequantize_residual_leaf(g, BITS)
                 for g in tree_lib.tree_flatten(tree)[0]]
        res = tree_lib.tree_map(torch.zeros_like, tree)
        out = compression.quantize_dequantize_residual_tree_(given, res, BITS)
        for got, (_, want) in zip(tree_lib.tree_flatten(res)[0], pairs):
            assert torch.equal(got, want)
        want_q = [q for q, _ in pairs]
    else:
        want_q = [compression.quantize_dequantize_leaf(g, BITS)
                  for g in tree_lib.tree_flatten(tree)[0]]
        out = compression.quantize_dequantize_tree_(given, BITS)
    assert out is given
    new = tree_lib.tree_flatten(given)[0]
    assert all(torch.equal(a, b) for a, b in zip(new, want_q))
    assert all(a is not b for a, b in zip(old, new))


def _tree_of(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _tree_of(v, rng) for k, v in shapes.items()}
    return torch.from_numpy(rng.standard_normal(shapes).astype(np.float32))


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adamw",
                                  "ef-adamw"])
def test_update_leaves_its_inputs_as_they_are(name):
    """``Optimizer.update`` gives ``update_``'s values on copies: three
    updates equal to three in-place ones, the trees passed to ``update``
    unchanged, values and storage."""
    opt = {"sgd": lambda: sgd(0.1), "momentum": lambda: momentum(0.1),
           "nesterov": lambda: momentum(0.1, nesterov=True),
           "adamw": lambda: adamw(_schedule()),
           "ef-adamw": lambda: _optimizer(True)}[name]()
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": {"c": (33,)}}
    params = _tree_of(shapes, rng)
    state = opt.init(params)
    p_, s_ = (tree_lib.tree_map(torch.clone, t) for t in (params, state))
    for _ in range(STEPS):
        grads = _tree_of(shapes, rng)
        before = [tree_lib.tree_map(torch.clone, t)
                  for t in (grads, state, params)]
        ptrs = [leaf.data_ptr() for t in (grads, state, params)
                for leaf in tree_lib.tree_flatten(t)[0]]
        new_params, new_state = opt.update(grads, state, params)
        for a, b in zip(before, (grads, state, params)):
            _assert_equal_trees(a, b)
        assert ptrs == [leaf.data_ptr() for t in (grads, state, params)
                        for leaf in tree_lib.tree_flatten(t)[0]]
        p_, s_ = opt.update_(grads, s_, p_)
        _assert_equal_trees({"p": new_params, "s": new_state},
                            {"p": p_, "s": s_})
        params, state = new_params, new_state


@pytest.mark.parametrize("ef", [False, True], ids=["fl4", "ef"])
def test_a_dropped_step_still_parts_from_the_sound_run(ef):
    """The wrong run of tests/test_torch_launch.py (step 2's update thrown
    away, the parameters cloned before it) equals the sound run's losses
    through step 2 and parts from them at step 3; its parameters after
    step 2 are its parameters after step 1."""
    sound = _run("qwen2_0_5b", ef)
    wrong = _run("qwen2_0_5b", ef, drop=2)
    for i in (0, 1):
        assert torch.equal(sound[i]["loss"], wrong[i]["loss"])
    assert not torch.equal(sound[2]["loss"], wrong[2]["loss"])
    _assert_equal_trees(wrong[1]["params"], sound[0]["params"])


def test_train_main_steps_in_place():
    """``launch.train.main``'s step hands back the parameter tree and the
    optimizer state it was given."""
    real, seen = steps.make_train_step, []

    def make(model, opt, **kw):
        inner = real(model, opt, **kw)

        def step(params, state, batch):
            out = inner(params, state, batch)
            seen.append((out[0] is params, out[1] is state))
            return out

        return step

    steps.make_train_step = make
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            losses = train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps",
                                 "2", "--batch", "2", "--seq", "16",
                                 "--fl-bits", "4", "--device", "cpu"])
    finally:
        steps.make_train_step = real
    assert len(losses) == 2 and seen == [(True, True)] * 2
