"""Reference side of the PyTorch-port parity tests, run as a subprocess.

    python tests/_torch_reference_worker.py <task> <spec.json> <in.npz> <out.npz>
    python tests/_torch_reference_worker.py --write-qwen2-reference <out.json>
    python tests/_torch_reference_worker.py --write-family-reference <dir>
    python tests/_torch_reference_worker.py --write-train-reference <out.json>
    python tests/_torch_reference_worker.py --write-train-reference <dir> --arch NAME
    python tests/_torch_reference_worker.py --write-multimodal-reference <dir>
    python tests/_torch_reference_worker.py --write-multimodal-train-reference <out.json>
    python tests/_torch_reference_worker.py --write-paper-cell-reference <out.json>
    python tests/_torch_reference_worker.py --write-serve-reference <dir> [--smoke]

The JAX package cannot import ``repro.models`` (and hence ``repro.core.fl``)
under JAX 0.9.0: ``models/layers.py`` asks ``x not in
batching.primitive_batchers``, which the 0.9.0 proxy object no longer
supports, and ``jax.experimental.enable_x64`` is gone; and its dry-run's
production mesh gets 0.9.0's Explicit axis types, under which its
embedding gather fails.  This script applies a compatibility shim for these
faults *in its own process only* and then runs
one reference task, exchanging arrays through ``.npz`` files.  The shim is
never applied inside the pytest process: there it would turn the reference's
own failing tests green without any fix to the package.

Tasks (``TASKS`` below) take the JSON ``spec`` and the input arrays and
return a dict of numpy arrays.
"""
from __future__ import annotations

import contextlib
import json
import sys


def apply_shim() -> None:
    """Patch the two JAX 0.9.0 API removals the reference package trips on."""
    import jax
    import jax.experimental
    from jax._src.interpreters import batching

    proxy = type(batching.primitive_batchers)

    def _contains(self, prim):
        return prim in batching.fancy_primitive_batchers

    proxy.__contains__ = _contains

    @contextlib.contextmanager
    def enable_x64(new_val: bool = True):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", new_val)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)

    jax.experimental.enable_x64 = enable_x64

    # Under 0.9.0 jax.make_mesh defaults to Explicit axis types, and the
    # reference's dry-run fails at its embedding gather ("ShardingTypeError:
    # Use .at[...].get(out_sharding=)"): its production mesh is rebuilt with
    # Auto axes, the type the reference was written for.
    from jax.sharding import AxisType

    import repro.launch.mesh as mesh_mod

    def make_production_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))

    mesh_mod.make_production_mesh = make_production_mesh


LEAVES = ("fc1/b", "fc1/w", "fc2/b", "fc2/w", "fc3/b", "fc3/w")


def _params_from_arrays(arrays, prefix):
    import jax.numpy as jnp

    params = {}
    for name in LEAVES:
        layer, leaf = name.split("/")
        params.setdefault(layer, {})[leaf] = jnp.asarray(arrays[prefix + name])
    return params


def _params_to_arrays(params, prefix):
    import numpy as np

    return {
        prefix + name: np.asarray(params[name.split("/")[0]][name.split("/")[1]])
        for name in LEAVES
    }


def task_lenet_grad(spec, arrays):
    """LenetFLModel.batch_loss and its gradient on one minibatch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models.fl_models import LenetFLModel

    model = LenetFLModel()
    params = _params_from_arrays(arrays, "p/")
    bx = jnp.asarray(arrays["bx"])
    by = jnp.asarray(arrays["by"])
    valid = (by >= 0).astype(jnp.float32)
    loss, grads = jax.value_and_grad(model.batch_loss)(params, bx, by, valid)
    out = _params_to_arrays(grads, "g/")
    out["loss"] = np.asarray(loss)
    out["acc"] = np.asarray(model.accuracy(params, bx, jnp.maximum(by, 0)))
    return out


def task_lenet_parts(spec, arrays):
    """``repro.models.lenet``'s ``schema`` (per leaf its shape, axes,
    init, scale and dtype) and ``loss_fn`` of the weights ``p/...`` on the
    batch ``x``, ``y``."""
    import jax.numpy as jnp
    import numpy as np

    from repro.models import lenet
    from repro.utils.tree import tree_flatten_with_paths

    out = {}
    for path, leaf in tree_flatten_with_paths(lenet.schema()):
        out[f"schema/{path}"] = np.asarray(json.dumps(
            [list(leaf.shape), list(leaf.axes), leaf.init, leaf.scale,
             leaf.dtype]))
    params = _params_from_arrays(arrays, "p/")
    out["loss"] = np.asarray(lenet.loss_fn(params, {
        "x": jnp.asarray(arrays["x"]), "y": jnp.asarray(arrays["y"])}))
    return out


def task_sgd_epoch(spec, arrays):
    """fl_engine.sgd_epoch over one client's (nb, bs, D) padded shard."""
    import jax.numpy as jnp

    from repro.core import fl_engine
    from repro.models.fl_models import LenetFLModel

    params = _params_from_arrays(arrays, "p/")
    new = fl_engine.sgd_epoch(
        params, jnp.asarray(arrays["x"]), jnp.asarray(arrays["y"]),
        float(spec["lr"]), model=LenetFLModel(),
    )
    return _params_to_arrays(new, "p/")


def task_init_params(spec, arrays):
    """LenetFLModel.init(PRNGKey(seed)) — the reference's initial weights."""
    import jax

    from repro.models.fl_models import LenetFLModel

    params = LenetFLModel().init(jax.random.PRNGKey(int(spec["seed"])))
    return _params_to_arrays(params, "p/")


def _perturbed_init(init, perturb):
    """A model's ``init`` with one initial weight moved by ``ulps`` float32
    ulps: ``perturb = {"leaf": "fc2/w", "index": [i, j], "ulps": n}``, the
    leaf named by its '/'-joined dict keys at any depth
    (``layers/attn/wq``)."""
    import jax.numpy as jnp
    import numpy as np

    def perturbed(self, key):
        params = init(self, key)
        *parents, leaf = perturb["leaf"].split("/")
        node = params
        for name in parents:
            node = node[name]
        w = np.array(node[leaf])
        idx = tuple(perturb["index"])
        for _ in range(abs(int(perturb["ulps"]))):
            w[idx] = np.nextafter(w[idx], np.float32(
                np.inf if perturb["ulps"] > 0 else -np.inf))
        node[leaf] = jnp.asarray(w)
        return params

    return perturbed


def task_fl_run(spec, arrays):
    """run_federated_learning on the paper's world, plus every random draw
    the port needs injected (distances, gains, large-scale gains, initial
    weights) so both packages simulate the same system.  ``spec["cfg"]``
    holds the FLConfig fields, ``scheduler_backend`` included (the device
    greedy needs the shim's ``enable_x64``).  ``spec["perturb"]`` (optional,
    see :func:`_perturbed_init`) moves one initial weight of the run by a
    few ulps; the exported ``init/`` weights are then the unperturbed
    draw's.  With ``spec["keep_rounds"]`` the parameters after every round
    are returned too (``round/<t>/<leaf>``): ``progress=`` sees only the
    round's log, so the batched engine's ``run_round`` is wrapped in this
    process to keep what it returns."""
    import jax
    import numpy as np

    from repro.config import FLConfig
    from repro.core import channel, fl, fl_engine
    from repro.data import dirichlet_partition, make_mnist_like
    from repro.models.fl_models import LenetFLModel

    m = int(spec["num_devices"])
    ds = make_mnist_like(num_samples=int(spec["num_samples"]), seed=0)
    cell = channel.CellConfig(num_devices=m)
    shards = dirichlet_partition(ds.y_train, m, seed=0)
    cfg = FLConfig(**spec["cfg"])
    init = LenetFLModel.init
    run_round = fl_engine.BatchedRoundEngine.run_round
    kept = []

    def keep(self, params, *args, **kwargs):
        out = run_round(self, params, *args, **kwargs)
        kept.append(_params_to_arrays(out[0], f"round/{len(kept)}/"))
        return out

    if spec.get("perturb"):
        LenetFLModel.init = _perturbed_init(init, spec["perturb"])
    if spec.get("keep_rounds"):
        fl_engine.BatchedRoundEngine.run_round = keep
    try:
        res = fl.run_federated_learning(ds, shards, cell, cfg)
    finally:
        LenetFLModel.init = init
        fl_engine.BatchedRoundEngine.run_round = run_round

    key = jax.random.PRNGKey(cfg.seed)
    dist = channel.sample_positions(jax.random.fold_in(key, 1), cell)
    gains = channel.sample_round_channels(
        jax.random.fold_in(key, 2), dist, cell, cfg.num_rounds
    )
    out = _params_to_arrays(LenetFLModel().init(key), "init/")
    out.update(_params_to_arrays(res.final_params, "final/"))
    out["distances"] = np.asarray(dist)
    out["gains"] = np.asarray(gains)
    out["dl_gains"] = np.asarray(channel.large_scale_gain(dist, cell))
    out["acc"] = res.accuracies()
    out["times"] = res.times()
    for log in res.logs:
        t = log.round
        out[f"devices/{t}"] = np.asarray(log.devices, np.int64)
        out[f"bits/{t}"] = np.asarray(log.bits)
        out[f"rates/{t}"] = np.asarray(log.rates)
        out[f"ratios/{t}"] = np.asarray(log.compression_ratios)
    for rnd in kept:
        out.update(rnd)
    return out


def task_fl_runs(spec, arrays):
    """task_fl_run for each run of ``spec["runs"]`` in this one process (a
    reference FL run costs seconds; the process start and the JAX import are
    paid once); each run's arrays are prefixed with ``<key>/``."""
    out = {}
    for run in spec["runs"]:
        for name, value in task_fl_run(run, arrays).items():
            out[f"{run['key']}/{name}"] = value
    return out


def _run_arrays(res, prefix):
    """One FLResult's logs and final parameters, ``prefix``-named."""
    import numpy as np

    out = _params_to_arrays(res.final_params, prefix + "final/")
    out[prefix + "acc"] = res.accuracies()
    out[prefix + "times"] = res.times()
    for log in res.logs:
        t = log.round
        out[f"{prefix}devices/{t}"] = np.asarray(log.devices, np.int64)
        out[f"{prefix}bits/{t}"] = np.asarray(log.bits)
        out[f"{prefix}rates/{t}"] = np.asarray(log.rates)
        out[f"{prefix}ratios/{t}"] = np.asarray(log.compression_ratios)
    return out


def task_horizon_runs(spec, arrays):
    """The reference's scanned drivers for each run of ``spec["runs"]``,
    all in this one process: ``kind`` ``"scan"`` is
    ``run_federated_learning`` with the run's FLConfig fields ``cfg``
    (``horizon="scan"`` among them), ``"seeds"`` is
    ``run_horizon_vmapped(seeds=...)`` and ``"cells"`` is
    ``run_cell_sweep(num_cells=..., seeds_per_cell=..., cell_shards=...)``
    (``cell_shards`` where the run gives it), each on the
    world of ``num_devices`` devices and ``num_samples`` samples with
    ``eval_every``.  A run's arrays are prefixed ``<key>/``, a sweep's
    instances ``<key>/<s>/`` and ``<key>/<c>/<s>/``; every instance draws
    from its own seed."""
    from repro.config import FLConfig
    from repro.core import channel, fl
    from repro.data import dirichlet_partition, make_mnist_like

    out = {}
    for run in spec["runs"]:
        m = int(run["num_devices"])
        ds = make_mnist_like(num_samples=int(run["num_samples"]), seed=0)
        cell = channel.CellConfig(num_devices=m)
        shards = dirichlet_partition(ds.y_train, m, seed=0)
        cfg = FLConfig(**run["cfg"])
        every = int(run.get("eval_every", 1))
        key = run["key"]
        if run["kind"] == "scan":
            res = fl.run_federated_learning(ds, shards, cell, cfg,
                                            eval_every=every)
            out.update(_run_arrays(res, f"{key}/"))
        elif run["kind"] == "seeds":
            sweep = fl.run_horizon_vmapped(ds, shards, cell, cfg,
                                           seeds=run["seeds"],
                                           eval_every=every)
            for s, res in enumerate(sweep):
                out.update(_run_arrays(res, f"{key}/{s}/"))
        else:
            grid = fl.run_cell_sweep(
                ds, shards, cell, cfg, num_cells=int(run["num_cells"]),
                seeds_per_cell=int(run["seeds_per_cell"]), eval_every=every,
                cell_shards=run.get("cell_shards"))
            for c, row in enumerate(grid):
                for s, res in enumerate(row):
                    out.update(_run_arrays(res, f"{key}/{c}/{s}/"))
    return out


def task_online_runs(spec, arrays):
    """task_horizon_runs for online-policy runs, each run in turn; a
    per-round run also returns the update norms its policy was fed after
    every round (``<key>/norms/<t>``, empty where the policy reads none):
    ``scheduling.Observation.record_round`` is wrapped in this process to
    keep them (the scanned drivers feed norms on the device and record
    nothing)."""
    import numpy as np

    from repro.core import scheduling

    record = scheduling.Observation.record_round
    fed = []

    def keep(self, t, group, rates_k, update_norms_k=None):
        fed.append(np.zeros(0) if update_norms_k is None
                   else np.asarray(update_norms_k, np.float64))
        return record(self, t, group, rates_k, update_norms_k)

    scheduling.Observation.record_round = keep
    out = {}
    try:
        for run in spec["runs"]:
            fed.clear()
            out.update(task_horizon_runs({"runs": [run]}, arrays))
            for t, norms in enumerate(fed):
                out[f"{run['key']}/norms/{t}"] = norms
    finally:
        scheduling.Observation.record_round = record
    return out


def task_legacy_parts(spec, arrays):
    """The legacy round body's parts, and whole runs, in one process.

    ``spec["local"]``: ``fl.local_update`` (and ``fl._tree_l2`` of its
    delta) from the weights ``p/`` on the shard ``x/<key>``, ``y/<key>``
    under the FLConfig fields ``cfg``.  ``spec["rounds"]``:
    ``fl._legacy_round`` on the weights ``p/`` (``zero_params``: zeros)
    with ``local_update`` replaced by a hand-over of the given deltas
    ``d/<key>/<j>/`` for the devices ``devs``, the float64 budgets
    ``budgets/<key>`` and weights ``aggw/<key>`` and, with ``ota``, the
    gains ``gains/<key>`` and noise key ``okey/<key>``; the new weights,
    bits, ratios and norms come back.  ``spec["runs"]`` (optional) adds
    task_fl_runs' output."""
    import types

    import jax.numpy as jnp
    import numpy as np

    from repro.config import FLConfig
    from repro.core import fl
    from repro.models.fl_models import LenetFLModel

    model = LenetFLModel()
    params = _params_from_arrays(arrays, "p/")
    out = {}
    for run in spec.get("local", []):
        key = run["key"]
        cfg = FLConfig(**run["cfg"])
        delta = fl.local_update(params, arrays[f"x/{key}"],
                                arrays[f"y/{key}"], cfg, model)
        out.update(_params_to_arrays(delta, f"delta/{key}/"))
        out[f"l2/{key}"] = np.asarray(fl._tree_l2(delta))
    local_update = fl.local_update
    try:
        for run in spec.get("rounds", []):
            key, devs = run["key"], tuple(run["devs"])
            given = iter([_params_from_arrays(arrays, f"d/{key}/{j}/")
                          for j in range(len(devs))])
            fl.local_update = lambda *args, **kwargs: next(given)
            start = params
            if run.get("zero_params"):
                start = {a: {c: jnp.zeros_like(v) for c, v in d.items()}
                         for a, d in params.items()}
            ota = None
            if run.get("ota"):
                ota = dict(gains=arrays[f"gains/{key}"],
                           key=arrays[f"okey/{key}"], pmax=float(run["pmax"]))
            dataset = types.SimpleNamespace(
                x_train=np.zeros((1, 1), np.float32),
                y_train=np.zeros(1, np.int32))
            shards = [[0]] * (max(devs, default=0) + 1)
            new, bits, ratios, norms = fl._legacy_round(
                start, devs, arrays[f"budgets/{key}"], arrays[f"aggw/{key}"],
                dataset, shards, FLConfig(**run["cfg"]), int(spec["payload"]),
                need_norms=True, model=model, ota=ota,
            )
            out.update(_params_to_arrays(new, f"round/{key}/"))
            out[f"bits/{key}"] = np.asarray(bits, np.int64)
            out[f"ratios/{key}"] = np.asarray(ratios, np.float64)
            out[f"norms/{key}"] = np.asarray(norms, np.float64)
    finally:
        fl.local_update = local_update
    if spec.get("runs"):
        out.update(task_fl_runs(spec, arrays))
    return out


def task_lazy_greedy(spec, arrays):
    """scheduling.lazy_greedy_schedule for each run of ``spec["runs"]``
    (backend, scorer, shards, power mode) on the gains ``g/<key>`` and
    weights ``w/<key>``; returns each schedule's rounds as a (T, K) array
    padded with -1 and its weighted sum rate."""
    import numpy as np

    from repro.core import scheduling

    out = {}
    for run in spec["runs"]:
        key = run["key"]
        sched = scheduling.lazy_greedy_schedule(
            arrays["g/" + key], arrays["w/" + key], int(run["k"]),
            power_mode=run["power_mode"], noise_power=float(spec["noise"]),
            candidate_pool=int(run["pool"]), backend=run["backend"],
            scorer=run["scorer"], shards=run["shards"],
        )
        rounds = np.full((len(sched.rounds), int(run["k"])), -1, np.int64)
        for t, grp in enumerate(sched.rounds):
            rounds[t, :len(grp)] = grp
        out["rounds/" + key] = rounds
        out["wsum/" + key] = np.asarray(sched.weighted_sum_rate)
    return out


SPLIT_HOST_DEVICES = 4


def task_split_parts(spec, arrays):
    """The reference's two splits across devices, on
    ``SPLIT_HOST_DEVICES`` forced host devices (``XLA_FLAGS`` is set here,
    before the first use of a JAX backend): ``spec["greedy"]`` is
    :func:`task_lazy_greedy`'s spec (its runs' ``shards`` shard the vertex
    axis over a mesh), ``spec["sweeps"]`` :func:`task_horizon_runs`' runs
    (``cell_shards`` shards the cell axis); also ``device_count``."""
    import os

    import numpy as np

    os.environ["XLA_FLAGS"] = " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"),
        f"--xla_force_host_platform_device_count={SPLIT_HOST_DEVICES}")))
    import jax

    out = {"device_count": np.asarray(jax.local_device_count())}
    out.update(task_lazy_greedy(spec["greedy"], arrays))
    out.update(task_horizon_runs({"runs": spec["sweeps"]}, arrays))
    return out


def task_draws(spec, arrays):
    """The reference's random draws for each seed of ``spec["seeds"]``
    (``<seed>/``-prefixed): the keys of ``repro/core/fl.py``
    (``PRNGKey(seed)``, ``fold_in`` 1 and 2, the position key
    ``split(fold_in(key, 1))`` and the per-round keys ``split(fold_in(key,
    2), T)``), the positions, gains and large-scale gains of an
    ``spec["num_devices"]``-device cell over ``spec["num_rounds"]`` rounds,
    and LeNet's initial weights.  ``spec["runs"]`` (optional) adds
    task_fl_runs' output in the same process."""
    import jax
    import numpy as np

    from repro.core import channel
    from repro.models.fl_models import LenetFLModel

    cell = channel.CellConfig(num_devices=int(spec["num_devices"]))
    t = int(spec["num_rounds"])
    out = {}
    for seed in spec["seeds"]:
        key = jax.random.PRNGKey(int(seed))
        k1, k2 = jax.random.fold_in(key, 1), jax.random.fold_in(key, 2)
        dist = channel.sample_positions(k1, cell)
        gains = channel.sample_round_channels(k2, dist, cell, t)
        draws = {
            "key": key, "fold1": k1, "fold2": k2,
            "split1": jax.random.split(k1), "split2": jax.random.split(k2, t),
            "distances": dist, "gains": gains,
            "dl_gains": channel.large_scale_gain(dist, cell),
        }
        draws.update(_params_to_arrays(LenetFLModel().init(key), "init/"))
        out.update({f"{seed}/{k}": np.asarray(v) for k, v in draws.items()})
    if spec.get("runs"):
        out.update(task_fl_runs(spec, arrays))
    return out


def _tree_to_arrays(tree, prefix):
    """Any nested dict of arrays -> flat numpy dict, keys ``prefix`` plus
    the '/'-joined dict keys (``layers/attn/wq``)."""
    import numpy as np

    from repro.utils.tree import tree_flatten_with_paths

    return {prefix + path: np.asarray(leaf)
            for path, leaf in tree_flatten_with_paths(tree)}


def task_token_parts(spec, arrays):
    """The token payload's parts in one process.

    ``spec["models"]``: for each FL model name, its initial parameters
    (``<name>/init/<path>``) from ``PRNGKey(spec["seed"])``, and on each
    batch ``<i>/<name>/bx``, ``<i>/<name>/by`` (i < ``spec["batches"]``)
    the logits, ``batch_loss``, its gradient (``<i>/<name>/grad/<path>``)
    and ``accuracy``, all under ``<i>/<name>/``.
    ``spec["schemas"]``: each arch id's full-width FL schema, shapes only
    (``<id>/shape/<path>``).  ``spec["attention"]``: ``chunked_attention``
    on ``q/<key>``, ``k/<key>``, ``v/<key>`` with each case's mask spec,
    ``kv_chunk`` and ``q_offset``.  ``spec["datasets"]``: the arrays of
    ``make_token_dataset`` for each keyword set."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.data.tokens import make_token_dataset
    from repro.models import layers as L
    from repro.models.fl_models import get_fl_model
    from repro.models.params import abstract_params
    from repro.utils.tree import tree_flatten_with_paths

    out = {}
    for name in spec.get("models", []):
        model = get_fl_model(name)
        params = model.init(jax.random.PRNGKey(int(spec["seed"])))
        out.update(_tree_to_arrays(params, f"{name}/init/"))
        for i in range(int(spec.get("batches", 1))):
            pre = f"{i}/{name}"
            bx = jnp.asarray(arrays[f"{pre}/bx"])
            by = jnp.asarray(arrays[f"{pre}/by"])
            valid = (by >= 0).astype(jnp.float32)
            logits, _ = model._module().forward(params, bx, model.cfg)
            loss, grads = jax.value_and_grad(model.batch_loss)(
                params, bx, by, valid)
            out[f"{pre}/logits"] = np.asarray(logits)
            out[f"{pre}/loss"] = np.asarray(loss)
            out[f"{pre}/acc"] = np.asarray(model.accuracy(params, bx, by))
            out.update(_tree_to_arrays(grads, f"{pre}/grad/"))
    for name in spec.get("schemas", []):
        shapes = abstract_params(get_fl_model(name).schema())
        for path, leaf in tree_flatten_with_paths(shapes):
            out[f"{name}/shape/{path}"] = np.asarray(leaf.shape, np.int64)
    for case in spec.get("attention", []):
        key = case["key"]
        got = L.chunked_attention(
            jnp.asarray(arrays[f"q/{key}"]), jnp.asarray(arrays[f"k/{key}"]),
            jnp.asarray(arrays[f"v/{key}"]),
            mask_spec=L.AttnMaskSpec(causal=case.get("causal", True),
                                     window=case.get("window"),
                                     block_local=case.get("block_local")),
            q_offset=int(case.get("q_offset", 0)),
            kv_chunk=int(case.get("kv_chunk", 1024)),
        )
        out[f"attn/{key}"] = np.asarray(got.astype(jnp.float32))
    for i, kw in enumerate(spec.get("datasets", [])):
        ds = make_token_dataset(**kw)
        for field in ("x_train", "y_train", "x_test", "y_test",
                      "class_train", "class_test"):
            out[f"ds/{i}/{field}"] = np.asarray(getattr(ds, field))
    return out


def _record_moe_routing(moe_mod, rec):
    """Wrap ``moe_mod.jnp`` so that ``moe_block``'s dispatch and combine
    operands (the one-hot einsums' second operands) land in ``rec``."""
    real = moe_mod.jnp

    class Recording:
        def __getattr__(self, name):
            return getattr(real, name)

        def einsum(self, spec, *ops, **kw):
            if spec == "gtd,gtec->gecd":
                rec["dispatch"] = ops[1]
            if spec == "gecd,gtec->gtd":
                rec["combine"] = ops[1]
            return real.einsum(spec, *ops, **kw)

    moe_mod.jnp = Recording()
    return real


def task_family_parts(spec, arrays):
    """The moe, ssm and hybrid families' parts in one process.

    ``spec["models"]``: for each FL model name (a ``<id>:smoke``), the
    registry model (``build_model(cfg)``, shards=1): its initial parameters
    from ``PRNGKey(spec["seed"])`` (``<name>/init/<path>``) and on each
    batch ``<i>/<name>/bx``, ``by`` the forward's logits (and the moe aux),
    ``model.loss`` and its gradient.  ``spec["decode"]``: prefill all but
    the last of ``dec/<name>/tokens`` into a cache, decode the last
    (``dec/<name>/step``) beside the full forward (``dec/<name>/full``);
    with ``f32`` under ``COMPUTE_DTYPE = float32`` and capacity factor 8
    (the reference's test_moe_decode_exact_without_drops).
    ``spec["moe_blocks"]``: ``moe_block`` of a model's config on the
    arrays ``moe/<key>/x`` and ``moe/<key>/p/<path>``: its output, aux,
    and the dispatch and combine operands it built.  ``spec["ssd"]``:
    ``ssd_chunked`` (and ``ssd_step`` on the first position) on
    ``ssd/<key>/{x,dt,a_log,b,c[,init]}``.  ``spec["fl_errors"]``: the
    batched FL run of each name on the token world, whose error message
    comes back as ``err/<name>``.  ``spec["schemas"]``: each arch id's
    full-width FL schema, shapes only (``<id>/shape/<path>``).
    ``spec["runs"]``: :func:`task_token_runs`'s runs."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models import layers as L
    from repro.models import mamba2, moe
    from repro.models.fl_models import get_fl_model
    from repro.models.registry import build_model

    out = {}
    key = jax.random.PRNGKey(int(spec.get("seed", 0)))
    for name in spec.get("models", []):
        cfg = get_fl_model(name).cfg
        model = build_model(cfg)
        params = model.init(key)
        out.update(_tree_to_arrays(params, f"{name}/init/"))
        for i in range(int(spec.get("batches", 1))):
            pre = f"{i}/{name}"
            batch = {"tokens": jnp.asarray(arrays[f"{pre}/bx"]),
                     "labels": jnp.asarray(arrays[f"{pre}/by"])}
            res = model.module.forward(params, batch["tokens"], cfg)
            out[f"{pre}/logits"] = np.asarray(res[0])
            if cfg.family == "moe":
                out[f"{pre}/aux"] = np.asarray(res[2])
            loss, grads = jax.value_and_grad(model.loss)(params, batch)
            out[f"{pre}/loss"] = np.asarray(loss)
            out.update(_tree_to_arrays(grads, f"{pre}/grad/"))
    for case in spec.get("decode", []):
        name = case["name"]
        cfg = get_fl_model(name).cfg
        saved = L.COMPUTE_DTYPE
        if case.get("f32"):
            L.COMPUTE_DTYPE = jnp.float32
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        try:
            model = build_model(cfg)
            params = model.init(key)
            toks = jnp.asarray(arrays[f"dec/{case['key']}/tokens"])
            b, s = toks.shape
            full = model.forward(params, {"tokens": toks}, remat=False)[0]
            caches = model.init_cache(b, s + 4)
            res = model.module.forward(params, toks[:, :s - 1], cfg,
                                       caches=caches, remat=False)
            step, _ = model.decode_step(params, res[1], toks[:, s - 1:])
        finally:
            L.COMPUTE_DTYPE = saved
        out[f"dec/{case['key']}/full"] = np.asarray(full, np.float32)
        out[f"dec/{case['key']}/step"] = np.asarray(step, np.float32)
    for case in spec.get("moe_blocks", []):
        pre = f"moe/{case['key']}"
        cfg = get_fl_model(case["model"]).cfg
        p = {}
        for k, v in arrays.items():
            if k.startswith(pre + "/p/"):
                node = p
                *head, leaf = k[len(pre) + 3:].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[leaf] = jnp.asarray(v)
        rec = {}
        real = _record_moe_routing(moe, rec)
        try:
            y, aux = moe.moe_block(p, jnp.asarray(arrays[pre + "/x"]), cfg)
        finally:
            moe.jnp = real
        out[pre + "/out"] = np.asarray(y, np.float32)
        out[pre + "/aux"] = np.asarray(aux)
        out[pre + "/dispatch"] = np.asarray(rec["dispatch"], np.float32)
        out[pre + "/combine"] = np.asarray(rec["combine"], np.float32)
    for case in spec.get("ssd", []):
        pre = f"ssd/{case['key']}"
        a = {n: jnp.asarray(arrays[f"{pre}/{n}"])
             for n in ("x", "dt", "a_log", "b", "c")}
        init = (jnp.asarray(arrays[pre + "/init"]) if case.get("init")
                else None)
        ed = jnp.bfloat16 if case.get("bf16") else jnp.float32
        y, final = mamba2.ssd_chunked(a["x"], a["dt"], a["a_log"], a["b"],
                                      a["c"], chunk=int(case["chunk"]),
                                      init_state=init, einsum_dtype=ed)
        out[pre + "/y"] = np.asarray(y)
        out[pre + "/final"] = np.asarray(final)
        state = (init if init is not None else jnp.zeros_like(final))
        y1, s1 = mamba2.ssd_step(state, a["x"][:, 0], a["dt"][:, 0],
                                 a["a_log"], a["b"][:, 0], a["c"][:, 0])
        out[pre + "/step_y"] = np.asarray(y1)
        out[pre + "/step_state"] = np.asarray(s1)
    if spec.get("fl_errors"):
        from repro.config import FLConfig
        from repro.core import channel, fl
        from repro.data import dirichlet_partition
        from repro.data.tokens import make_token_dataset

        ds = make_token_dataset(**spec["fl_data"])
        m = int(spec["fl_devices"])
        shards = dirichlet_partition(ds.class_train, m, seed=0)
        for name in spec["fl_errors"]:
            cfg = FLConfig(num_devices=m, num_rounds=2, fl_engine="batched",
                           model=name)
            try:
                fl.run_federated_learning(ds, shards,
                                          channel.CellConfig(num_devices=m),
                                          cfg)
                msg = "no error"
            except ValueError as exc:
                msg = f"ValueError: {exc}"
            out[f"err/{name}"] = np.asarray(msg)
    for name in spec.get("schemas", []):
        from repro.models.params import abstract_params
        from repro.utils.tree import tree_flatten_with_paths

        shapes = abstract_params(get_fl_model(name).schema())
        for path, leaf in tree_flatten_with_paths(shapes):
            out[f"{name}/shape/{path}"] = np.asarray(leaf.shape, np.int64)
    if spec.get("runs"):
        out.update(task_token_runs(spec, arrays))
    return out


def task_launch_parts(spec, arrays):
    """The LLM trainer's and server's parts in one process.

    ``spec["bits"]``: ``train.fl_bits_schedule(fold_in(PRNGKey(seed), 99),
    payload, rounds, CellConfig())`` (``bits/<i>``).  ``spec["randint"]``:
    ``randint(fold_in(PRNGKey(seed), 1), shape, lo, hi)``
    (``randint/<i>``).  ``spec["train_steps"]``: ``steps.make_train_step``
    (jitted, AdamW under ``linear_warmup_cosine(3e-4, 10, 20)``, with the
    case's ``fl_bits`` and ``grad_accum``) from the model's
    ``init(PRNGKey(0))``, one step per batch ``step/<key>/<i>/tokens``,
    ``labels``: each step's loss and the final parameters
    (``step/<key>/loss/<i>``, ``step/<key>/final/<path>``).
    ``spec["train_main"]`` / ``spec["serve_main"]``: ``train.main(argv)``'s
    losses (``train/<key>``) and ``serve.main(argv)``'s tokens
    (``serve/<key>``), a vlm's initial gates set to the case's ``gates``
    where given (:func:`_gated_init`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import channel
    from repro.launch import serve, steps, train
    from repro.models.fl_models import get_fl_model
    from repro.models.registry import build_model
    from repro.optim import adamw, linear_warmup_cosine

    out = {}
    for i, case in enumerate(spec.get("bits", [])):
        key = jax.random.fold_in(jax.random.PRNGKey(int(case["seed"])), 99)
        out[f"bits/{i}"] = np.asarray(train.fl_bits_schedule(
            key, case["payload"], int(case["rounds"]), channel.CellConfig()))
    for i, case in enumerate(spec.get("randint", [])):
        key = jax.random.fold_in(jax.random.PRNGKey(int(case["seed"])), 1)
        out[f"randint/{i}"] = np.asarray(jax.random.randint(
            key, tuple(case["shape"]), case["lo"], case["hi"]))
    for case in spec.get("train_steps", []):
        pre = f"step/{case['key']}"
        model = build_model(get_fl_model(case["model"]).cfg)
        params = model.init(jax.random.PRNGKey(0))
        opt = adamw(linear_warmup_cosine(3e-4, 10, 20))
        state = opt.init(params)
        step = jax.jit(steps.make_train_step(
            model, opt, fl_bits=case.get("fl_bits"),
            grad_accum=int(case.get("grad_accum", 1))))
        for i in range(int(case["steps"])):
            batch = {"tokens": jnp.asarray(arrays[f"{pre}/{i}/tokens"]),
                     "labels": jnp.asarray(arrays[f"{pre}/{i}/labels"])}
            params, state, loss = step(params, state, batch)
            out[f"{pre}/loss/{i}"] = np.asarray(loss)
        out.update(_tree_to_arrays(params, f"{pre}/final/"))
    out.update(_quantized_steps(spec.get("quantized_steps", []), arrays))
    for case in spec.get("train_main", []):
        with _gated_init(case.get("gates")):
            out[f"train/{case['key']}"] = np.asarray(
                train.main(case["argv"]), np.float64)
    for case in spec.get("serve_main", []):
        with _gated_init(case.get("gates")):
            out[f"serve/{case['key']}"] = np.asarray(serve.main(case["argv"]))
    return out


class _GivenGrads:
    """A stand-in model whose loss is ``batch["l"][0] + sum_k sum(p_k *
    batch[k][0])``: at zero parameters the loss is ``l`` and the gradient
    of leaf k is ``batch[k][0]``, both exactly, so a train step's
    quantizer and mean see given values."""

    def loss(self, params, batch, **_):
        import jax.numpy as jnp

        tot = batch["l"][0]
        for k in sorted(params):
            tot = tot + jnp.sum(params[k] * batch[k][0])
        return tot


def _quantized_steps(cases, arrays):
    """``spec["quantized_steps"]``: the reference's jitted
    ``steps.make_train_step`` on :class:`_GivenGrads` with an optimizer that
    returns the gradients it is given as the new parameters: the case's
    ``fl_bits`` and ``grad_accum``, or with ``ef`` the
    ``error_feedback_optimizer`` around it (``fl_bits=None``), one step per
    batch ``qstep/<key>/<i>/<leaf>`` (leading axis ``grad_accum``, and
    ``l``).  Returns ``qstep/<key>/q/<i>/<leaf>`` (the quantized
    gradients), ``qstep/<key>/loss/<i>`` and, with ``ef``,
    ``qstep/<key>/r/<i>/<leaf>`` (the residual after step i)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core.compression import error_feedback_optimizer
    from repro.launch import steps
    from repro.optim.optimizers import Optimizer

    capture = Optimizer(lambda p: {"step": jnp.zeros((), jnp.int32)},
                        lambda g, s, p: (g, {"step": s["step"] + 1}))
    out = {}
    for case in cases:
        pre = f"qstep/{case['key']}"
        names = case["leaves"]
        opt = capture
        if case.get("ef"):
            opt = error_feedback_optimizer(capture, int(case["fl_bits"]))
        step = jax.jit(steps.make_train_step(
            _GivenGrads(), opt,
            fl_bits=None if case.get("ef") else int(case["fl_bits"]),
            grad_accum=int(case["grad_accum"])))
        state = None
        for i in range(int(case["steps"])):
            batch = {k: jnp.asarray(arrays[f"{pre}/{i}/{k}"])
                     for k in names + ["l"]}
            params = {k: jnp.zeros(batch[k].shape[1:], jnp.float32)
                      for k in names}
            if state is None:
                state = opt.init(params)
            q, state, loss = step(params, state, batch)
            out[f"{pre}/loss/{i}"] = np.asarray(loss)
            for k in names:
                out[f"{pre}/q/{i}/{k}"] = np.asarray(q[k])
                if case.get("ef"):
                    out[f"{pre}/r/{i}/{k}"] = np.asarray(
                        state["residual"][k])
    return out


def _set_gates(params, gates):
    """A vlm parameter tree with its cross layers' tanh gates set to
    ``gates = (attn, mlp)`` (zero at init, which makes every cross layer
    the identity)."""
    import jax.numpy as jnp

    cross = dict(params["cross_layers"])
    for name, value in zip(("gate_attn", "gate_mlp"), gates):
        cross[name] = jnp.full_like(cross[name], float(value))
    return dict(params, cross_layers=cross)


@contextlib.contextmanager
def _gated_init(gates):
    """``repro.models.registry.Model.init`` setting a vlm's gates to
    ``gates`` (nothing when ``gates`` is None)."""
    from repro.models import registry

    real = registry.Model.init

    def init(self, key):
        params = real(self, key)
        if self.cfg.family == "vlm":
            params = _set_gates(params, gates)
        return params

    if gates is not None:
        registry.Model.init = init
    try:
        yield
    finally:
        registry.Model.init = real


def _modal_batch(cfg, arrays, pre):
    """The modality input of a batch from float32 arrays holding bf16
    values (``<pre>/feats``), as the family's loss reads it."""
    import jax.numpy as jnp

    feats = jnp.asarray(arrays[f"{pre}/feats"]).astype(jnp.bfloat16)
    return {"img_feats" if cfg.family == "vlm" else "enc_feats": feats}


def task_multimodal_parts(spec, arrays):
    """The encdec and vlm families' parts in one process.

    ``spec["models"]``: for each arch id, its SMOKE registry model
    (``build_model(get_smoke(id))``, shards=1): the initial parameters
    from ``PRNGKey(spec["seed"])`` (``<id>/init/<path>``); then, with a
    vlm's gates set to ``spec["gates"]``, on the batch ``<id>/bx``,
    ``by``, ``feats`` (float32 holding bf16 features) the forward's
    logits, ``model.loss`` and its gradient (``<id>/logits``, ``loss``,
    ``grad/<path>``); the decode of ``dec/<id>/tokens`` and ``feats``:
    the full forward (``dec/<id>/full``) and one step after prefilling
    all but the last token (``dec/<id>/step``; an encdec encodes its
    features once).  ``spec["xattn"]``: ``attention_block(kv_source=)``
    of an arch's SMOKE config on ``xattn/<key>/x``, ``src`` and the
    parameters ``xattn/<key>/p/<path>``, with the case's ``kv_chunk``
    (``xattn/<key>/out``).  ``spec["normals"]``: ``jax.random.normal(
    fold_in(PRNGKey(seed), fold), (n,), bfloat16)``'s bits
    (``normal/<i>``, uint16).  ``spec["schemas"]``: each arch id's
    full-width schema, shapes only (``<id>/shape/<path>``).
    ``spec["fl_errors"]``: the message of the ``ValueError`` that
    ``get_fl_model`` and ``FLConfig(model=)`` raise for each arch id and
    its ``:smoke`` (``err/<name>``, ``cfgerr/<name>``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config, get_smoke
    from repro.models import encdec
    from repro.models import layers as L
    from repro.models.params import abstract_params
    from repro.models.registry import build_model
    from repro.utils.tree import tree_flatten_with_paths

    out = {}
    key = jax.random.PRNGKey(int(spec.get("seed", 0)))
    for arch in spec.get("models", []):
        cfg = get_smoke(arch)
        model = build_model(cfg)
        params = model.init(key)
        out.update(_tree_to_arrays(params, f"{arch}/init/"))
        if cfg.family == "vlm":
            params = _set_gates(params, spec["gates"])
        batch = {"tokens": jnp.asarray(arrays[f"{arch}/bx"]),
                 "labels": jnp.asarray(arrays[f"{arch}/by"]),
                 **_modal_batch(cfg, arrays, arch)}
        out[f"{arch}/logits"] = np.asarray(model.forward(params, batch)[0])
        loss, grads = jax.value_and_grad(model.loss)(params, batch)
        out[f"{arch}/loss"] = np.asarray(loss)
        out.update(_tree_to_arrays(grads, f"{arch}/grad/"))
        pre = f"dec/{arch}"
        toks = jnp.asarray(arrays[f"{pre}/tokens"])
        b, s = toks.shape
        feats = _modal_batch(cfg, arrays, pre)
        full = model.forward(params, {"tokens": toks, **feats},
                             remat=False)[0]
        caches = model.init_cache(b, s + 4)
        if cfg.family == "encdec":
            extra = {"enc_out": encdec.encode(params, feats["enc_feats"],
                                              cfg)}
        else:
            extra = feats
        res = model.module.forward(params, toks[:, :s - 1], cfg,
                                   caches=caches, remat=False, **extra)
        step, _ = model.decode_step(params, res[1], toks[:, s - 1:],
                                    batch=extra)
        out[f"{pre}/full"] = np.asarray(full, np.float32)
        out[f"{pre}/step"] = np.asarray(step, np.float32)
    for case in spec.get("xattn", []):
        pre = f"xattn/{case['key']}"
        cfg = get_smoke(case["arch"])
        p = {k[len(pre) + 3:]: jnp.asarray(v) for k, v in arrays.items()
             if k.startswith(pre + "/p/")}
        y, cache = L.attention_block(
            p, jnp.asarray(arrays[pre + "/x"]), cfg,
            mask_spec=L.AttnMaskSpec(causal=True),
            kv_source=jnp.asarray(arrays[pre + "/src"]),
            kv_chunk=int(case["kv_chunk"]))
        assert cache is None
        out[pre + "/out"] = np.asarray(y, np.float32)
    for i, (seed, fold, n) in enumerate(spec.get("normals", [])):
        k = jax.random.fold_in(jax.random.PRNGKey(int(seed)), int(fold))
        x = jax.random.normal(k, (int(n),), jnp.bfloat16)
        out[f"normal/{i}"] = np.asarray(x).view(np.uint16)
    for arch in spec.get("schemas", []):
        shapes = abstract_params(build_model(get_config(arch)).schema)
        for path, leaf in tree_flatten_with_paths(shapes):
            out[f"{arch}/shape/{path}"] = np.asarray(leaf.shape, np.int64)
    for arch in spec.get("fl_errors", []):
        from repro.config import FLConfig
        from repro.models.fl_models import get_fl_model

        for name in (arch, f"{arch}:smoke"):
            for key, call in (("err", get_fl_model),
                              ("cfgerr", lambda n: FLConfig(model=n))):
                try:
                    call(name)
                    msg = "no error"
                except ValueError as exc:
                    msg = f"ValueError: {exc}"
                out[f"{key}/{name}"] = np.asarray(msg)
    return out


def task_token_runs(spec, arrays):
    """Reference FL runs on token shards, each run of ``spec["runs"]`` in
    this one process: the world is ``make_token_dataset`` with the run's
    ``data`` keywords, ``num_devices`` devices and Dirichlet shards by the
    pseudo-class, and the run ``run_federated_learning`` with the run's
    FLConfig fields ``cfg``; a run's ``perturb`` (optional, see
    :func:`_perturbed_init`) moves one of its initial weights by a few
    ulps.  A run's logs, final parameters and the norms its online policy
    was fed (``<key>/norms/<t>``, empty where it reads none) come back
    prefixed ``<key>/``, its initial parameters (the unperturbed draw)
    ``<key>/init/``."""
    import contextlib

    import jax
    import numpy as np

    from repro.config import FLConfig
    from repro.core import channel, fl, scheduling
    from repro.data import dirichlet_partition
    from repro.data.tokens import make_token_dataset
    from repro.models.fl_models import TokenFLModel, get_fl_model

    record = scheduling.Observation.record_round
    init = TokenFLModel.init
    fed = []

    def keep(self, t, group, rates_k, update_norms_k=None):
        fed.append(np.zeros(0) if update_norms_k is None
                   else np.asarray(update_norms_k, np.float64))
        return record(self, t, group, rates_k, update_norms_k)

    out = {}
    scheduling.Observation.record_round = keep
    try:
        for run in spec["runs"]:
            m = int(run["num_devices"])
            ds = make_token_dataset(**run["data"])
            cell = channel.CellConfig(num_devices=m)
            shards = dirichlet_partition(ds.class_train, m, seed=0)
            cfg = FLConfig(**run["cfg"])
            key = run["key"]
            fed.clear()
            if run.get("perturb"):
                TokenFLModel.init = _perturbed_init(init, run["perturb"])
            try:
                with (jax.disable_jit() if run.get("eager")
                      else contextlib.nullcontext()):
                    res = fl.run_federated_learning(ds, shards, cell, cfg)
            finally:
                TokenFLModel.init = init
            out.update(_token_run_arrays(res, f"{key}/"))
            for t, norms in enumerate(fed):
                out[f"{key}/norms/{t}"] = norms
            out.update(_tree_to_arrays(
                get_fl_model(cfg.model).init(jax.random.PRNGKey(cfg.seed)),
                f"{key}/init/"))
    finally:
        scheduling.Observation.record_round = record
    return out


def _token_run_arrays(res, prefix):
    """One FLResult's logs and final parameters (any tree), ``prefix``-
    named."""
    import numpy as np

    out = _tree_to_arrays(res.final_params, prefix + "final/")
    out[prefix + "acc"] = res.accuracies()
    out[prefix + "times"] = res.times()
    for log in res.logs:
        t = log.round
        out[f"{prefix}devices/{t}"] = np.asarray(log.devices, np.int64)
        out[f"{prefix}bits/{t}"] = np.asarray(log.bits)
        out[f"{prefix}rates/{t}"] = np.asarray(log.rates)
        out[f"{prefix}ratios/{t}"] = np.asarray(log.compression_ratios)
    return out


def sample_indices(n: int):
    """The flat indices of the elements recorded per leaf of n elements:
    both ends and six points between them (repeats removed)."""
    pts = [0, 1, n // 7, n // 3, n // 2, (2 * n) // 3, n - 2, n - 1]
    return sorted({min(max(i, 0), n - 1) for i in pts})


def task_qwen2_reference(spec, arrays):
    """Qwen2-0.5B at full width (``get_fl_model("qwen2_0_5b")``, shards=1)
    from ``PRNGKey(seed)``: each leaf's float64 sum and sum of squares and
    its elements at :func:`sample_indices`, and ``batch_loss`` of the
    fixed token batch ``bx``, ``by``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.models.fl_models import get_fl_model
    from repro.utils.tree import tree_flatten_with_paths

    model = get_fl_model("qwen2_0_5b")
    params = model.init(jax.random.PRNGKey(int(spec["seed"])))
    out = {}
    for path, leaf in tree_flatten_with_paths(params):
        x = np.asarray(leaf).reshape(-1).astype(np.float64)
        idx = sample_indices(x.size)
        out[f"{path}/shape"] = np.asarray(leaf.shape, np.int64)
        out[f"{path}/sum"] = np.asarray(x.sum())
        out[f"{path}/sumsq"] = np.asarray(np.square(x).sum())
        out[f"{path}/index"] = np.asarray(idx, np.int64)
        out[f"{path}/values"] = np.asarray(leaf).reshape(-1)[idx]
    bx, by = jnp.asarray(arrays["bx"]), jnp.asarray(arrays["by"])
    out["loss"] = np.asarray(model.batch_loss(
        params, bx, by, (by >= 0).astype(jnp.float32)))
    return out


def write_qwen2_reference(path: str) -> None:
    """Run :func:`task_qwen2_reference` at seed 0 on the first two rows of
    ``make_token_dataset(vocab_size=151936, num_samples=600, seq_len=16,
    seed=0)`` and write the record as JSON to ``path``."""
    import numpy as np

    from repro.data.tokens import make_token_dataset

    ds = make_token_dataset(vocab_size=151_936, num_samples=600, seq_len=16,
                            seed=0)
    arrays = {"bx": ds.x_train[:2], "by": ds.y_train[:2]}
    out = task_qwen2_reference({"seed": 0}, arrays)
    leaves = {}
    for key in out:
        if key.endswith("/shape"):
            leaf = key[:-len("/shape")]
            leaves[leaf] = {
                "shape": [int(d) for d in out[key]],
                "sum": float(out[f"{leaf}/sum"]),
                "sumsq": float(out[f"{leaf}/sumsq"]),
                "index": [int(i) for i in out[f"{leaf}/index"]],
                "values": [float(v) for v in out[f"{leaf}/values"]],
            }
    record = {
        "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                     "tests/_torch_reference_worker.py "
                     "--write-qwen2-reference "
                     "tests/torch_reference/qwen2_0_5b.json"),
        "_what": ("repro.models.fl_models.get_fl_model('qwen2_0_5b') at "
                  "full width (shards=1), init(PRNGKey(0)): per leaf the "
                  "float64 sum and sum of squares and the float32 elements "
                  "at the flat indices 'index'; 'loss' is batch_loss of "
                  "'tokens' / 'labels', the first two rows of "
                  "make_token_dataset(vocab_size=151936, num_samples=600, "
                  "seq_len=16, seed=0)"),
        "model": "qwen2_0_5b",
        "seed": 0,
        "param_count": int(sum(np.prod(v["shape"]) for v in leaves.values())),
        "tokens": np.asarray(arrays["bx"]).tolist(),
        "labels": np.asarray(arrays["by"]).tolist(),
        "loss": float(out["loss"]),
        "leaves": leaves,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


# the full-width records of the moe, ssm and hybrid slice: Mamba2-130M in
# full (its FL payload), and the depth-cut serving models by sampled
# elements only (their leaves reach 1.6e9 elements)
FAMILY_RECORDS = {
    "mamba2_130m": dict(num_layers=None, full=True),
    "zamba2_7b": dict(num_layers=6, full=False),
    "mixtral_8x22b": dict(num_layers=2, full=False),
}


def sampled_materialize(spec, key, idx):
    """The reference's ``params._materialize(spec, key)`` at the flat
    indices ``idx`` only: a (len(idx),) leaf with ``spec``'s own scale,
    drawn with jax.random's counters replaced by ``idx`` (partitionable
    Threefry draws element i from the counter pair (i >> 32, i & 0xFFFFFFFF)
    alone).  Run as the full draw runs (jax.random's own jitted draw, then
    the eager scale), with JAX's caches cleared around it so no earlier
    trace's counters are reused."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax._src import prng as jprng

    from repro.models import params as P

    idx = np.asarray(idx, np.int64)
    n = len(idx)
    scale = spec.scale
    if spec.init == "normal" and scale is None:
        scale = 1.0 / np.sqrt(max(P._fan_in(spec.shape), 1))
    small = dataclasses.replace(spec, shape=(n,), axes=(None,), scale=scale)
    real = jprng.iota_2x32_shape

    def iota(shape):
        if tuple(shape) != (n,):
            return real(shape)
        return (jnp.asarray((idx >> 32).astype(np.uint32)),
                jnp.asarray((idx & 0xFFFFFFFF).astype(np.uint32)))

    jax.clear_caches()
    jprng.iota_2x32_shape = iota
    try:
        return np.asarray(P._materialize(small, key))
    finally:
        jprng.iota_2x32_shape = real
        jax.clear_caches()


def write_family_reference(directory: str) -> None:
    """The full-width records of ``FAMILY_RECORDS`` at seed 0, one JSON
    file per model in ``directory``: per leaf its shape and the float32
    elements at :func:`sample_indices`; for a full record also each leaf's
    float64 sum and sum of squares and ``batch_loss`` of the first two rows
    of ``make_token_dataset(vocab_size, num_samples=600, seq_len=16,
    seed=0)``.  Sampled records draw only the recorded elements
    (:func:`sampled_materialize`, checked here against a full draw of a
    small leaf)."""
    import dataclasses
    import os
    import zlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.data.tokens import make_token_dataset
    from repro.models import params as P
    from repro.models.fl_models import TokenFLModel
    from repro.utils.tree import tree_flatten_with_paths

    key = jax.random.PRNGKey(0)
    for probe in (P.ParamSpec((3, 50, 7), (None, None, None)),
                  P.ParamSpec((2, 1000, 999), (None, None, None)),
                  P.ParamSpec((5000, 64), (None, None), init="embed"),
                  P.ParamSpec((24,), (None,), init="ssm_a")):
        full = np.asarray(P._materialize(probe, key)).reshape(-1)
        idx = sample_indices(full.size)
        assert np.array_equal(sampled_materialize(probe, key, idx),
                              full[idx]), probe
    for arch, how in FAMILY_RECORDS.items():
        cfg = get_config(arch)
        if how["num_layers"]:
            cfg = dataclasses.replace(cfg, num_layers=how["num_layers"])
        model = TokenFLModel(cfg=cfg, name=arch)
        schema = model.schema()
        specs = tree_flatten_with_paths(schema)
        leaves, record = {}, {}
        if how["full"]:
            params = model.init(key)
            for path, leaf in tree_flatten_with_paths(params):
                x = np.asarray(leaf).reshape(-1).astype(np.float64)
                ix = sample_indices(x.size)
                leaves[path] = {
                    "shape": [int(d) for d in leaf.shape],
                    "sum": float(x.sum()), "sumsq": float(np.square(x).sum()),
                    "index": [int(i) for i in ix],
                    "values": [float(v) for v in
                               np.asarray(leaf).reshape(-1)[ix]],
                }
            ds = make_token_dataset(vocab_size=cfg.vocab_size,
                                    num_samples=600, seq_len=16, seed=0)
            bx, by = jnp.asarray(ds.x_train[:2]), jnp.asarray(ds.y_train[:2])
            record["tokens"] = np.asarray(bx).tolist()
            record["labels"] = np.asarray(by).tolist()
            record["loss"] = float(model.batch_loss(
                params, bx, by, (by >= 0).astype(jnp.float32)))
        else:
            for path, spec in specs:
                n = int(np.prod(spec.shape))
                ix = sample_indices(n)
                h = zlib.crc32(("".join(f"[{k!r}]" for k in path.split("/")))
                               .encode()) % (2 ** 31)
                vals = sampled_materialize(spec, jax.random.fold_in(key, h),
                                           ix)
                leaves[path] = {"shape": [int(d) for d in spec.shape],
                                "index": [int(i) for i in ix],
                                "values": [float(v) for v in vals]}
        record.update({
            "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                         "tests/_torch_reference_worker.py "
                         "--write-family-reference tests/torch_reference"),
            "_what": (f"repro.configs.get_config({arch!r})"
                      + (f" cut to num_layers={how['num_layers']}"
                         if how["num_layers"] else "")
                      + " as the FL payload (TokenFLModel, shards=1), "
                      "init(PRNGKey(0)): per leaf the float32 elements at "
                      "the flat indices 'index'"
                      + ("; the float64 sum and sum of squares; 'loss' is "
                         "batch_loss of 'tokens' / 'labels', the first two "
                         "rows of make_token_dataset(vocab_size, "
                         "num_samples=600, seq_len=16, seed=0)"
                         if how["full"] else
                         ", drawn alone with jax.random's counters set to "
                         "those indices (sampled_materialize)")),
            "model": arch, "seed": 0, "num_layers": cfg.num_layers,
            "param_count": int(sum(np.prod(v["shape"])
                                   for v in leaves.values())),
            "leaves": leaves,
        })
        with open(os.path.join(directory, f"{arch}.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(record, fh, indent=1, sort_keys=True)
            fh.write("\n")


# the encdec and vlm records: SeamlessM4T-medium in full (served and
# trained at full width on the card), Llama-3.2-Vision-90B cut to one site
# of 5 layers (served at its published widths) by sampled elements only
MULTIMODAL_RECORDS = {
    "seamless_m4t_medium": dict(num_layers=None, full=True, fold_in=3,
                                feats=(4, 32, 1024)),
    "llama_3_2_vision_90b": dict(num_layers=5, full=False, fold_in=2,
                                 feats=(4, 1600, 8192)),
}
# the fixed batch of the full record's loss: 2 rows of 16 tokens, frame
# embeddings drawn as serve draws them for batch 2, prompt 16
MULTIMODAL_LOSS_FEATS = (2, 16, 1024)


def sampled_normal_bf16(key, idx):
    """``jax.random.normal(key, shape, bfloat16)`` at the flat indices
    ``idx`` only, jax.random's counters replaced by ``idx`` (as
    :func:`sampled_materialize` draws)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax._src import prng as jprng

    idx = np.asarray(idx, np.int64)
    n = len(idx)
    real = jprng.iota_2x32_shape

    def iota(shape):
        if tuple(shape) != (n,):
            return real(shape)
        return (jnp.asarray((idx >> 32).astype(np.uint32)),
                jnp.asarray((idx & 0xFFFFFFFF).astype(np.uint32)))

    jax.clear_caches()
    jprng.iota_2x32_shape = iota
    try:
        return np.asarray(jax.random.normal(key, (n,), jnp.bfloat16),
                          np.float32)
    finally:
        jprng.iota_2x32_shape = real
        jax.clear_caches()


def write_multimodal_reference(directory: str) -> None:
    """The records of ``MULTIMODAL_RECORDS`` at seed 0, one JSON file per
    model in ``directory``: the registry model (``build_model(cfg)``,
    shards=1) at the record's depth, per leaf its shape and the float32
    elements at :func:`sample_indices`; ``feats``: the serve draw's bf16
    modality features (``fold_in(PRNGKey(0), fold_in)``, shape ``shape``)
    at recorded flat indices.  A full record also has each leaf's float64
    sum and sum of squares and ``loss``: ``model.loss`` of the first two
    rows of ``make_token_dataset(vocab_size, num_samples=600, seq_len=16,
    seed=0)`` with the frame embeddings of MULTIMODAL_LOSS_FEATS.  Sampled
    records draw only the recorded elements (checked here against full
    draws of small leaves and features)."""
    import dataclasses
    import os
    import zlib

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config
    from repro.data.tokens import make_token_dataset
    from repro.models import params as P
    from repro.models.registry import build_model
    from repro.utils.tree import tree_flatten_with_paths

    key = jax.random.PRNGKey(0)
    for probe in (P.ParamSpec((), (), init="zeros"),
                  P.ParamSpec((2, 3, 50, 7), (None,) * 4)):
        full = np.asarray(P._materialize(probe, key)).reshape(-1)
        idx = sample_indices(full.size)
        assert np.array_equal(sampled_materialize(probe, key, idx),
                              full[idx]), probe
    full = np.asarray(jax.random.normal(key, (3, 1001), jnp.bfloat16),
                      np.float32).reshape(-1)
    idx = sample_indices(full.size)
    assert np.array_equal(sampled_normal_bf16(key, idx), full[idx])
    for arch, how in MULTIMODAL_RECORDS.items():
        cfg = get_config(arch)
        if how["num_layers"]:
            cfg = dataclasses.replace(cfg, num_layers=how["num_layers"])
        model = build_model(cfg)
        fkey = jax.random.fold_in(key, how["fold_in"])
        n_feats = int(np.prod(how["feats"]))
        leaves, record = {}, {}
        if how["full"]:
            params = model.init(key)
            for path, leaf in tree_flatten_with_paths(params):
                x = np.asarray(leaf).reshape(-1).astype(np.float64)
                ix = sample_indices(x.size)
                leaves[path] = {
                    "shape": [int(d) for d in leaf.shape],
                    "sum": float(x.sum()), "sumsq": float(np.square(x).sum()),
                    "index": [int(i) for i in ix],
                    "values": [float(v) for v in
                               np.asarray(leaf).reshape(-1)[ix]],
                }
            feats = jax.random.normal(fkey, how["feats"], jnp.bfloat16)
            fidx = list(range(256))
            fvals = np.asarray(feats, np.float32).reshape(-1)[fidx]
            ds = make_token_dataset(vocab_size=cfg.vocab_size,
                                    num_samples=600, seq_len=16, seed=0)
            bx, by = jnp.asarray(ds.x_train[:2]), jnp.asarray(ds.y_train[:2])
            batch = {"tokens": bx, "labels": by,
                     "enc_feats": jax.random.normal(
                         fkey, MULTIMODAL_LOSS_FEATS, jnp.bfloat16)}
            record["tokens"] = np.asarray(bx).tolist()
            record["labels"] = np.asarray(by).tolist()
            record["loss_feats_shape"] = list(MULTIMODAL_LOSS_FEATS)
            record["loss"] = float(model.loss(params, batch))
            del params
        else:
            for path, spec in tree_flatten_with_paths(model.schema):
                n = int(np.prod(spec.shape))
                ix = sample_indices(n)
                h = zlib.crc32(("".join(f"[{k!r}]" for k in path.split("/")))
                               .encode()) % (2 ** 31)
                vals = sampled_materialize(spec, jax.random.fold_in(key, h),
                                           ix)
                leaves[path] = {"shape": [int(d) for d in spec.shape],
                                "index": [int(i) for i in ix],
                                "values": [float(v) for v in vals]}
            fidx = sample_indices(n_feats)
            fvals = sampled_normal_bf16(fkey, fidx)
        record.update({
            "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                         "tests/_torch_reference_worker.py "
                         "--write-multimodal-reference tests/torch_reference"),
            "_what": (f"repro.models.registry.build_model(get_config({arch!r})"
                      + (f" cut to num_layers={how['num_layers']}"
                         if how["num_layers"] else "")
                      + ") (shards=1), init(PRNGKey(0)): per leaf the "
                      "float32 elements at the flat indices 'index'"
                      + ("; the float64 sum and sum of squares; 'loss' is "
                         "model.loss of 'tokens' / 'labels', the first two "
                         "rows of make_token_dataset(vocab_size, "
                         "num_samples=600, seq_len=16, seed=0), with "
                         "enc_feats = jax.random.normal(fold_in(PRNGKey(0), "
                         "3), loss_feats_shape, bfloat16)"
                         if how["full"] else
                         ", drawn alone with jax.random's counters set to "
                         "those indices (sampled_materialize)")
                      + "; 'feats': launch/serve.py's bf16 modality draw "
                      "(jax.random.normal(fold_in(PRNGKey(0), fold_in), "
                      "shape, bfloat16)) at the flat indices 'index'"),
            "model": arch, "seed": 0, "num_layers": cfg.num_layers,
            "param_count": int(sum(np.prod(v["shape"])
                                   for v in leaves.values())),
            "feats": {"fold_in": how["fold_in"],
                      "shape": list(how["feats"]),
                      "index": [int(i) for i in fidx],
                      "values": [float(v) for v in fvals]},
            "leaves": leaves,
        })
        with open(os.path.join(directory, f"{arch}.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(record, fh, indent=1, sort_keys=True)
            fh.write("\n")


# the SMOKE encdec and vlm trainer runs of chip_smoke.py's [train:*]
# phases: (argv, the vlm's initial gates: zero gates leave its cross
# layers out of the loss)
MULTIMODAL_TRAIN_RECORDS = {
    "seamless-smoke": (["--arch", "seamless-m4t-medium", "--smoke",
                        "--steps", "12", "--batch", "4", "--seq", "32"],
                       None),
    "llama-vision-smoke": (["--arch", "llama-3.2-vision-90b", "--smoke",
                            "--steps", "12", "--batch", "4", "--seq", "32"],
                           [0.5, -0.7]),
}


def write_multimodal_train_reference(path: str) -> None:
    """:func:`write_train_reference` for ``MULTIMODAL_TRAIN_RECORDS``: each
    run's losses beside the run that threw away step TRAIN_DROPPED_STEP's
    update, and both runs' final parameters at 512 sampled elements a
    leaf, a vlm's initial gates set to the run's ``gates``."""
    runs = {}
    for name, (argv, gates) in MULTIMODAL_TRAIN_RECORDS.items():
        with _gated_init(gates):
            losses, params = _train_run(argv)
            dropped, wrong = _train_run(argv, drop=TRAIN_DROPPED_STEP)
        runs[name] = {"argv": argv, "gates": gates, "losses": losses,
                      "dropped_losses": dropped,
                      "final": _final_samples(params, wrong, 512)}
    record = {
        "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                     "tests/_torch_reference_worker.py "
                     "--write-multimodal-train-reference "
                     "tests/torch_reference/train_losses_multimodal.json"),
        "_what": ("repro.launch.train.main(argv) on the CPU, a vlm's "
                  "initial gates set to 'gates': each step's loss; "
                  "dropped_losses: the same run with step dropped_step's "
                  "parameter update thrown away; final: both runs' final "
                  "parameters at sampled flat indices"),
        "dropped_step": TRAIN_DROPPED_STEP,
        "runs": runs,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


# the trainer runs of chip_smoke.py's [train:*] phases held to the
# reference's: Mamba2-130M at full width, and the SMOKE Mixtral long enough
# for its loss to fall (over 4 steps it rises, 6.712 -> 6.908)
TRAIN_RECORDS = {
    "mamba2-130m": ["--arch", "mamba2-130m", "--steps", "20", "--batch",
                    "8", "--seq", "128"],
    "mixtral-8x22b-smoke": ["--arch", "mixtral-8x22b", "--smoke", "--steps",
                            "12", "--batch", "4", "--seq", "32"],
}
# the wrong run beside each: this (1-based) step's update thrown away
TRAIN_DROPPED_STEP = 3
# the runs whose final parameters are recorded too, at this many sampled
# elements a leaf (every element of a smaller leaf)
TRAIN_FINAL_SAMPLES = {"mamba2-130m": 512}


def _train_run(argv, drop=None, donate=()):
    """``repro.launch.train.main(argv)``'s losses (float64) and final
    parameters; ``drop``: the 1-based step whose parameter update is
    thrown away (its optimizer state kept), as tests/test_torch_launch.py's
    wrong runs; ``donate``: the jitted step's ``donate_argnums``, ``(1,)``
    its optimizer state, ``(0, 1)`` the parameters too (the same values, a
    copy fewer of each at the peak).  Where the parameters are donated, the
    dropped step's input parameters are spilled to a temporary file leaf by
    leaf before that step and read back after it (:func:`_spill`)."""
    import contextlib
    import io

    import numpy as np

    from repro.launch import train

    real, calls, last = train.jax, [], {}

    class Dropping:
        def __getattr__(self, name):
            return getattr(real, name)

        def jit(self, fn, *args, **kwargs):
            if donate:
                kwargs["donate_argnums"] = tuple(donate)
            inner = real.jit(fn, *args, **kwargs)

            def step(params, state, batch):
                calls.append(1)
                dropped = len(calls) == drop
                spill = None
                if dropped and 0 in donate:
                    # the steps run asynchronously: the spill and the read
                    # back wait for them, or a step's temporaries and the
                    # spilled copy would be held at once
                    spill = _spill(real.block_until_ready(params))
                new, new_state, loss = inner(params, state, batch)
                if dropped:
                    real.block_until_ready((new, new_state, loss))
                    del new
                    new = params if spill is None else _unspill(spill)
                last["params"] = new
                return new, new_state, loss

            return step

    train.jax = Dropping()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            losses = np.asarray(train.main(list(argv)), np.float64)
    finally:
        train.jax = real
    return [float(x) for x in losses], last["params"]


def _spill(tree):
    """``tree``'s leaves written one after another to a temporary file,
    each from a copy of its own (a view of a leaf would keep a donated
    buffer from being reused): (the open file, the tree's structure, the
    leaf count), for :func:`_unspill`."""
    import tempfile

    import jax
    import numpy as np

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    fh = tempfile.TemporaryFile()
    for leaf in leaves:
        copy = jax.numpy.array(leaf, copy=True)
        np.save(fh, np.asarray(copy))
        del copy
    return fh, treedef, len(leaves)


def _unspill(spill):
    """The tree :func:`_spill` wrote, read back one leaf at a time into
    arrays of their own; the file is closed (and so removed)."""
    import jax
    import numpy as np

    fh, treedef, count = spill
    fh.seek(0)
    leaves = [jax.numpy.array(np.load(fh), copy=True) for _ in range(count)]
    fh.close()
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _final_values(params, count, fmt=float):
    """Per leaf: ``count`` flat indices (every index of a smaller leaf;
    else drawn without repeats by ``default_rng(0)``) and the final
    elements there, each written as ``fmt`` gives it."""
    import numpy as np

    from repro.utils.tree import tree_flatten_with_paths

    out = {}
    for path, leaf in tree_flatten_with_paths(params):
        flat = np.asarray(leaf, np.float32).reshape(-1)
        n = flat.size
        idx = (np.arange(n) if n <= count else np.sort(
            np.random.default_rng(0).choice(n, count, replace=False)))
        out[path] = {"index": [int(i) for i in idx],
                     "values": [fmt(v) for v in flat[idx]]}
    return out


def _add_dropped(samples, dropped, fmt=float):
    """``samples`` (:func:`_final_values`) with the dropped run's final
    elements at the same indices, ``dropped``, written as ``fmt`` gives
    them."""
    import numpy as np

    from repro.utils.tree import tree_flatten_with_paths

    for path, leaf in tree_flatten_with_paths(dropped):
        bad = np.asarray(leaf, np.float32).reshape(-1)
        samples[path]["dropped"] = [fmt(v) for v in
                                    bad[samples[path]["index"]]]
    return samples


def _final_samples(params, dropped, count):
    """:func:`_final_values` of the sound run's ``params`` with the
    dropped run's elements beside them."""
    return _add_dropped(_final_values(params, count), dropped)


def write_train_reference(path: str) -> None:
    """The reference's ``launch.train.main`` losses for each run of
    ``TRAIN_RECORDS`` (seed 0, adaptive NOMA bits) and for the same run
    with step ``TRAIN_DROPPED_STEP``'s update thrown away, and for the runs
    of ``TRAIN_FINAL_SAMPLES`` both runs' final parameters at sampled
    elements, written as JSON to ``path``."""
    runs = {}
    for name, argv in TRAIN_RECORDS.items():
        losses, params = _train_run(argv)
        dropped, wrong = _train_run(argv, drop=TRAIN_DROPPED_STEP)
        runs[name] = {"argv": argv, "losses": losses,
                      "dropped_losses": dropped}
        if name in TRAIN_FINAL_SAMPLES:
            runs[name]["final"] = _final_samples(
                params, wrong, TRAIN_FINAL_SAMPLES[name])
    record = {
        "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                     "tests/_torch_reference_worker.py "
                     "--write-train-reference "
                     "tests/torch_reference/train_losses.json"),
        "_what": ("repro.launch.train.main(argv) on the CPU: each step's "
                  "loss; dropped_losses: the same run with step "
                  "dropped_step's parameter update thrown away; final: "
                  "both runs' final parameters at sampled flat indices"),
        "dropped_step": TRAIN_DROPPED_STEP,
        "runs": runs,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


# the full-width trainer runs of chip_smoke.py's [train:<name>] phases,
# one record each (tests/torch_reference/train_<name>.json): (argv, the
# depth cut: the config's num_layers replaced, None for the whole model).
# Seed 0; --fl-bits 4 keeps kernel #5 on the path and lets the loss fall
# within 8-12 steps (1-bit adaptive codes do not): Granite's single layer
# of width 6144 climbs to 14.7 at step 8 of its warmup and falls below its
# first loss from step 10.  At the trainer's default learning rate, 3e-4,
# Mixtral's single layer (8 experts) swings from 9.20 to 12.79 and 13.14
# within the warmup, where a card's run parts from the record by 0.075,
# and Mistral-Large's (width 12288) climbs to 24.7 at step 7 and ends
# above its first loss at every count from 8 to 12; at 3e-5 both fall from
# step 3 on (Mixtral 10.95 -> 8.11 in 12 steps)
TRAIN_ARCH_RECORDS = {
    "qwen2-0.5b": (["--arch", "qwen2-0.5b", "--steps", "10", "--fl-bits",
                    "4", "--batch", "8", "--seq", "128"], None),
    "qwen2-0.5b-ef": (["--arch", "qwen2-0.5b", "--steps", "10", "--ef",
                       "--fl-bits", "4", "--batch", "8", "--seq", "128"],
                      None),
    "granite-34b-1": (["--arch", "granite-34b", "--steps", "12",
                       "--fl-bits", "4", "--batch", "4", "--seq", "128"], 1),
    "zamba2-7b-6": (["--arch", "zamba2-7b", "--steps", "8", "--fl-bits", "4",
                     "--batch", "4", "--seq", "128"], 6),
    "qwen3-8b-1": (["--arch", "qwen3-8b", "--steps", "8", "--fl-bits", "4",
                    "--batch", "4", "--seq", "128"], 1),
    "mixtral-8x22b-1": (["--arch", "mixtral-8x22b", "--steps", "12",
                         "--lr", "3e-5", "--fl-bits", "4", "--batch", "4",
                         "--seq", "128"], 1),
    "mistral-large-123b-1": (["--arch", "mistral-large-123b", "--steps",
                              "12", "--lr", "3e-5", "--fl-bits", "4",
                              "--batch", "4", "--seq", "128"], 1),
}


@contextlib.contextmanager
def _train_depth(num_layers):
    """``repro.launch.train.get_config`` cutting every config to
    ``num_layers`` layers (``dataclasses.replace``; the reference's trainer
    has no such flag); nothing changed for None."""
    import dataclasses

    from repro.launch import train

    real = train.get_config
    if num_layers:
        train.get_config = lambda name: dataclasses.replace(
            real(name), num_layers=num_layers)
    try:
        yield
    finally:
        train.get_config = real


def write_train_arch_record(directory: str, name: str) -> None:
    """``train_<name>.json`` in ``directory``: run ``name`` of
    ``TRAIN_ARCH_RECORDS`` through the reference's ``launch.train.main``
    (depth cut by :func:`_train_depth`, large leaves drawn in chunks, the
    same bits), its losses and final parameters at 512 sampled elements a
    leaf (as the shortest decimals that read back to the float32
    values); then the run that threw away step TRAIN_DROPPED_STEP's
    update, its losses and final elements at the same indices.  The sound
    run's parameters are freed before the dropped run starts.  Both runs'
    jitted steps donate the parameters and the optimizer state (XLA's
    memory_analysis of Mixtral's step at one layer, batch 4 x 128, reads
    60.11 GiB with the state alone donated, 53.22 GiB with both; the
    values are the same)."""
    import os

    argv, layers = TRAIN_ARCH_RECORDS[name]
    with _train_depth(layers), _chunked_init():
        losses, params = _train_run(argv, donate=(0, 1))
        final = _final_values(params, 512, _f32)
        del params
        dropped, wrong = _train_run(argv, drop=TRAIN_DROPPED_STEP,
                                    donate=(0, 1))
    record = {
        "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                     "tests/_torch_reference_worker.py "
                     "--write-train-reference tests/torch_reference "
                     f"--arch {name}"),
        "_what": ("repro.launch.train.main(argv) on the CPU, the config's "
                  "depth cut to num_layers where given (null: the whole "
                  "model): each step's loss; dropped_losses: the same run "
                  "with step dropped_step's parameter update thrown away; "
                  "final: both runs' final parameters at sampled flat "
                  "indices"),
        "name": name, "argv": argv, "num_layers": layers,
        "dropped_step": TRAIN_DROPPED_STEP,
        "losses": losses, "dropped_losses": dropped,
        "final": _add_dropped(final, wrong, _f32),
    }
    with open(os.path.join(directory, f"train_{name}.json"), "w",
              encoding="utf-8") as fh:
        json.dump(record, fh, sort_keys=True, separators=(",", ":"))
        fh.write("\n")


def write_train_reference_main(argv) -> int:
    """``--write-train-reference PATH``: train_losses.json
    (:func:`write_train_reference`); ``--write-train-reference DIR --arch
    NAME``: one record of TRAIN_ARCH_RECORDS, printing its peak RSS and
    seconds (one process a record: a run's arrays are freed with it)."""
    import resource
    import time

    if "--arch" not in argv:
        write_train_reference(argv[0])
        return 0
    t0 = time.time()
    write_train_arch_record(argv[0], argv[argv.index("--arch") + 1])
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"peak RSS {peak:.2f} GiB, {time.time() - t0:.1f} s", flush=True)
    return 0


def _json_array(obj):
    import numpy as np

    return np.asarray(json.dumps(obj))


def _shapes_of(tree):
    """{path: [shape, dtype name]} of a tree of arrays or shape structs."""
    from repro.utils.tree import tree_flatten_with_paths

    return {path: [list(leaf.shape), str(leaf.dtype)]
            for path, leaf in tree_flatten_with_paths(tree)}


def _depth_override(cfg, layers):
    """The reference dry-run's probe configs at ``layers`` layers: the
    encdec's encoder cut alike, the vlm and hybrid with a site every 2."""
    over = {"num_layers": layers}
    if cfg.family == "encdec":
        over["encoder_layers"] = layers
    if cfg.family == "vlm":
        over["cross_attn_every"] = 2
    if cfg.family == "hybrid":
        over["hybrid_attn_every"] = 2
    return over


def task_sharding_parts(spec, arrays):
    """``spec["archs"]``: each architecture's full-width schema as
    ``build_model(get_config(arch), shards=16)`` gives it: its logical axes
    and shapes (``schema/<arch>``, JSON {path: [axes, shape]}).
    ``spec["caches"]``: ``[arch, shape name]`` pairs, the abstract cache
    ``jax.eval_shape(model.init_cache(B, S))`` at that shape
    (``cache/<arch>/<shape>``, JSON {path: [shape, dtype]})."""
    import jax
    import numpy as np

    from repro.config import INPUT_SHAPES
    from repro.configs import get_config
    from repro.models.params import abstract_params
    from repro.models.registry import build_model
    from repro.utils.tree import tree_flatten_with_paths

    out = {}
    for arch in spec.get("archs", []):
        model = build_model(get_config(arch), shards=16)
        boxed = jax.tree_util.tree_map(
            lambda a: np.asarray(json.dumps(list(a))),
            model.param_logical_specs(),
            is_leaf=lambda x: isinstance(x, tuple))
        axes = {p: json.loads(str(a))
                for p, a in tree_flatten_with_paths(boxed)}
        shapes = dict(tree_flatten_with_paths(abstract_params(model.schema)))
        out[f"schema/{arch}"] = _json_array(
            {p: [axes[p], list(shapes[p].shape)] for p in shapes})
    for arch, name in spec.get("caches", []):
        model = build_model(get_config(arch), shards=16)
        shape = INPUT_SHAPES[name]
        out[f"cache/{arch}/{name}"] = _json_array(_shapes_of(jax.eval_shape(
            lambda: model.init_cache(shape.global_batch, shape.seq_len))))
    return out


def task_dryrun_parts(spec, arrays):
    """The reference's dry-run pieces, its production mesh on 512 fake XLA
    devices with Auto axes (the shim).  ``spec["runs"]``: ``run_one(arch,
    shape, cfg_override=<depth>, fl_bits=..., multi_pod=...)``'s result
    (``run/<i>``, JSON of its dataclass).  ``spec["inputs"]``: ``[arch,
    shape]`` pairs, ``steps.input_specs`` and ``steps.abstract_cache``
    (``inputs/<arch>/<shape>``, ``acache/...``, JSON {path: [shape,
    dtype]}).  ``spec["prefill"]``: SMOKE prefill steps,
    ``steps.make_prefill_step(model, ShapeConfig(S, B, "prefill"))`` on the
    model's ``init(PRNGKey(0))`` (a vlm's gates set to ``gates``) and the
    batch ``prefill/<arch>/<k>``: the last logits and the caches
    (``prefill/<arch>/out/...``).  Also ``skips``: the reference's
    ``SKIPS``."""
    import dataclasses

    import repro.launch.dryrun as dr   # sets XLA_FLAGS before jax's init
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.config import INPUT_SHAPES, ShapeConfig
    from repro.configs import get_config, get_smoke
    from repro.launch import steps
    from repro.models.registry import build_model

    out = {"skips": _json_array(sorted([list(k), v]
                                       for k, v in dr.SKIPS.items()))}
    for i, case in enumerate(spec.get("runs", [])):
        cfg = get_config(case["arch"])
        res = dr.run_one(case["arch"], case["shape"],
                         cfg_override=_depth_override(cfg, case["layers"]),
                         fl_bits=case.get("fl_bits", 8),
                         multi_pod=bool(case.get("multi_pod")),
                         verbose=False)
        out[f"run/{i}"] = _json_array(dataclasses.asdict(res))
    for arch, name in spec.get("inputs", []):
        cfg = get_config(arch)
        shape = INPUT_SHAPES[name]
        out[f"inputs/{arch}/{name}"] = _json_array(
            _shapes_of(steps.input_specs(cfg, shape)))
        model = build_model(cfg, shards=16)
        out[f"acache/{arch}/{name}"] = _json_array(
            _shapes_of(steps.abstract_cache(model, shape)))
    for case in spec.get("prefill", []):
        arch = case["arch"]
        pre = f"prefill/{arch}"
        model = build_model(get_smoke(arch))
        with _gated_init(case.get("gates")):
            params = model.init(jax.random.PRNGKey(0))
        batch = {k[len(pre) + 1:]: jnp.asarray(v) for k, v in arrays.items()
                 if k.startswith(pre + "/")}
        batch = {k: v if k == "tokens" else v.astype(jnp.bfloat16)
                 for k, v in batch.items()}
        b, s = batch["tokens"].shape
        step = steps.make_prefill_step(model, ShapeConfig("p", s, b,
                                                          "prefill"))
        logits, caches = step(params, batch)
        out[f"{pre}/out/logits"] = np.asarray(logits)
        out.update(_tree_to_arrays(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16
            else x, caches), f"{pre}/out/cache/"))
    return out


# --------------------------------------------------------------------------
# the reference's example scripts (examples/*.py), run as a user runs them
# --------------------------------------------------------------------------

def _examples_dir() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples")


@contextlib.contextmanager
def _patched(module, name, make):
    """``module.<name>`` replaced by ``make(<the real one>)`` in the
    block."""
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _run_script(script, argv) -> str:
    """``python examples/<script> *argv`` in this process (``runpy`` as
    ``__main__``); returns its standard output."""
    import io
    import os
    import runpy

    path = os.path.join(_examples_dir(), script)
    buf, argv0 = io.StringIO(), sys.argv
    sys.argv = [path] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv0
    return buf.getvalue()


def _keeping(kept):
    """A ``make`` for :func:`_patched`: the real function, each return
    value appended to ``kept``."""
    def make(real):
        def keep(*args, **kwargs):
            out = real(*args, **kwargs)
            kept.append(out)
            return out
        return keep
    return make


class _ParserSeen(Exception):
    pass


def parser_actions(parser):
    """An ``argparse`` parser's arguments as JSON-able dicts: option
    strings, dest, default, choices, type name, action class, nargs."""
    return [dict(options=list(a.option_strings), dest=a.dest,
                 default=a.default,
                 choices=None if a.choices is None else list(a.choices),
                 type=None if a.type is None else a.type.__name__,
                 action=type(a).__name__, nargs=a.nargs)
            for a in parser._actions]


def _example_parser(script):
    """:func:`parser_actions` of the parser ``examples/<script>`` builds:
    the script runs up to its ``parse_args``, which stops it."""
    import argparse

    seen = {}

    def make(real):
        def stop(self, *args, **kwargs):
            seen["parser"] = self
            raise _ParserSeen
        return stop

    with _patched(argparse.ArgumentParser, "parse_args", make):
        try:
            _run_script(script, [])
        except _ParserSeen:
            pass
    return parser_actions(seen["parser"])


def fl_example(argv):
    """``examples/fl_noma_mnist.py``'s run of ``argv`` (its own ``main``):
    (the FLResults it ran, one per seed; its standard output; the FLConfig
    and sample count of its call).  ``fl.run_federated_learning`` and
    ``fl.run_horizon_vmapped`` are wrapped in this process to keep them:
    ``main`` prints its results and returns nothing."""
    from repro.core import fl

    calls, results = [], []

    def make(real):
        def run(dataset, shards, cell, cfg, **kwargs):
            calls.append((cfg, len(dataset.x_train) + len(dataset.x_test)))
            out = real(dataset, shards, cell, cfg, **kwargs)
            results.extend(out if isinstance(out, list) else [out])
            return out
        return run

    with _patched(fl, "run_federated_learning", make), \
            _patched(fl, "run_horizon_vmapped", make):
        stdout = _run_script("fl_noma_mnist.py", argv)
    (call,) = calls
    return results, stdout, call


def task_example_runs(spec, arrays):
    """The reference's example scripts, each run by its own ``main``.

    ``spec["fl"]``: ``examples/fl_noma_mnist.py`` with each case's
    ``argv``: every FLResult's logs and final parameters (``fl/<key>/<i>/``,
    i the seed's index, 0 without ``--seeds``) and the script's output
    lines (``fl/<key>/stdout``, JSON).  ``spec["serve"]``:
    ``examples/serve_decode.py``: the tokens ``launch.serve.main`` returned
    (``serve/<key>``).  ``spec["train"]``: ``examples/train_llm.py``: the
    losses ``launch.train.main`` returned (``train/<key>``), its argv
    extended by ``--save <the case's save>``.  ``spec["parsers"]``: each
    script's parser (``parser/<script>``, JSON of :func:`parser_actions`)."""
    import numpy as np

    from repro.launch import serve, train

    out = {}
    for case in spec.get("fl", []):
        results, stdout, _ = fl_example(case["argv"])
        for i, res in enumerate(results):
            out.update(_token_run_arrays(res, f"fl/{case['key']}/{i}/"))
        out[f"fl/{case['key']}/stdout"] = _json_array(stdout.splitlines())
    for case in spec.get("serve", []):
        kept = []
        with _patched(serve, "main", _keeping(kept)):
            _run_script("serve_decode.py", case["argv"])
        out[f"serve/{case['key']}"] = np.asarray(kept[0])
    for case in spec.get("train", []):
        kept, save = [], ["--save", case["save"]]

        def saving(real):
            def run(argv):
                kept.append(real(list(argv) + save))
                return kept[-1]
            return run

        with _patched(train, "main", saving):
            _run_script("train_llm.py", case["argv"])
        out[f"train/{case['key']}"] = np.asarray(kept[0], np.float64)
    for script in spec.get("parsers", []):
        out[f"parser/{script}"] = _json_array(_example_parser(script))
    return out


# the paper cell's runs (no --fast: M=300, K=3, T=35, 12,000 samples, seed
# 0) recorded by write_paper_cell_reference, name: argv
PAPER_CELL_RUNS = {
    "noma": ["--pallas-agg"],
    "tdma": ["--uplink", "tdma", "--pallas-agg"],
    "ota": ["--uplink", "ota", "--ota-noise", "1e-9", "--pallas-agg"],
    "legacy": ["--engine", "legacy"],
}


def write_paper_cell_reference(path: str) -> None:
    """``examples/fl_noma_mnist.py``'s own ``main`` at the paper cell for
    each argv of ``PAPER_CELL_RUNS`` (:func:`fl_example`): per round the
    scheduled devices, bit widths, rates, compression ratios, simulated
    time and test accuracy (floats through ``json``'s repr, which round-
    trips them exactly), the config ``main`` built and its output lines,
    written as JSON to ``path``.  No parameters: the drift at this cell is
    F1's business (ROADMAP.md queue 3)."""
    import dataclasses
    import time

    import numpy as np

    runs = {}
    for name, argv in PAPER_CELL_RUNS.items():
        t0 = time.time()
        (res,), stdout, (cfg, samples) = fl_example(argv)
        rounds = [dict(devices=[int(d) for d in log.devices],
                       bits=[int(b) for b in log.bits],
                       rates=[float(r) for r in log.rates],
                       ratios=[float(r) for r in log.compression_ratios],
                       time=float(log.wall_time_s),
                       acc=float(log.test_accuracy))
                  for log in res.logs]
        first = res.logs[0]
        runs[name] = dict(
            argv=argv, cfg=dataclasses.asdict(cfg), samples=samples,
            scheme=res.scheme, rounds=rounds,
            dtypes=dict(bits=str(np.asarray(first.bits).dtype),
                        rates=str(np.asarray(first.rates).dtype),
                        ratios=str(np.asarray(
                            first.compression_ratios).dtype)),
            stdout=stdout.splitlines(),
            seconds=round(time.time() - t0, 1))
    record = {
        "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                     "tests/_torch_reference_worker.py "
                     "--write-paper-cell-reference "
                     "tests/torch_reference/paper_cell.json"),
        "_what": ("examples/fl_noma_mnist.py's main(argv) on the CPU at "
                  "the paper cell: each round's devices, bits, rates, "
                  "compression ratios, simulated time and test accuracy; "
                  "cfg: the FLConfig main built; seconds: the run's wall "
                  "time on the CPU that wrote the record"),
        "runs": runs,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")


# the seeded draw that sets a dense model's QKV biases after init (they
# start at zero, where a forward that ignores them reads the same):
# (seed, scale) of serve_bias_values
QWEN2_BIASES = (31, 1.0)
# chip_smoke.py's serving runs ([serve:*]): per record file, its runs as
# (arch id, depth cut, what is set after init: a vlm's gates (attn, mlp)
# as a list, or the QKV biases' draw as {"biases": (seed, scale)});
# every run serves batch 4, a 32-token prompt and 16 tokens from seed 0
# (SERVE_ARGV)
SERVE_RECORDS = {
    "mamba2_130m": (("mamba2-130m", None, None),),
    "zamba2_7b": (("zamba2-7b", 6, None),),
    "mixtral_8x22b": (("mixtral-8x22b", 2, None),),
    "seamless_m4t_medium": (("seamless-m4t-medium", None, None),),
    "llama_3_2_vision_90b": (("llama-3.2-vision-90b", 5, None),
                             ("llama-3.2-vision-90b", 5, [0.5, -0.7])),
    "qwen2_0_5b": (("qwen2-0.5b", None, None),
                   ("qwen2-0.5b", None, {"biases": QWEN2_BIASES})),
    "qwen3_8b": (("qwen3-8b", 4, None),),
    "granite_34b": (("granite-34b", 2, None),),
    "llama4_scout_17b_a16e": (("llama4-scout-17b-a16e", 2, None),),
    "mistral_large_123b": (("mistral-large-123b", 2, None),),
}
# the records that also hold the served model's initial weights at
# sample_indices ('leaves'): these models have no init record of their
# own at the served shapes
SERVE_INIT_LEAVES = ("qwen2_0_5b", "qwen3_8b", "granite_34b",
                     "llama4_scout_17b_a16e", "mistral_large_123b")
SERVE_ARGV = ["--batch", "4", "--prompt-len", "32", "--gen", "16",
              "--seed", "0"]
# SMOKE runs served with a longer prompt: Llama-4-Scout's SMOKE
# attention_chunk is 64, so 72 + 16 positions cross a chunk boundary
SERVE_SMOKE_PROMPT = {"llama4-scout-17b-a16e": 72}
SERVE_TOP = 8            # the largest logits recorded per position
SERVE_LOGIT_IDS = 64     # fixed ids recorded per position (serve_logit_ids)
# leaves above this many elements are drawn this many at a time
SERVE_CHUNK = 1 << 26


def serve_logit_ids(vocab: int):
    """``SERVE_LOGIT_IDS`` token ids spread evenly over ``[0, vocab)``,
    both ends included."""
    n = SERVE_LOGIT_IDS - 1
    return sorted({(i * (vocab - 1)) // n for i in range(n + 1)})


def _f32(v) -> float:
    """A float32 value as the shortest decimal that reads back to it."""
    import numpy as np

    return float(str(np.float32(v)))


def chunked_materialize(spec, key, chunk=SERVE_CHUNK):
    """``params._materialize(spec, key)`` drawn ``chunk`` elements at
    a time (:func:`sampled_materialize` over consecutive flat ranges): the
    same array without the whole draw's transient buffers, which reach
    ~16 bytes an element (a 1.6e9-element Mixtral leaf drawn whole takes
    ~25 GB)."""
    import jax.numpy as jnp
    import numpy as np

    n = int(np.prod(spec.shape))
    if n <= chunk or spec.init in ("zeros", "ones"):
        return _REAL_MATERIALIZE[0](spec, key)
    out = np.empty(n, np.float32)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        out[lo:hi] = sampled_materialize(spec, key, np.arange(lo, hi))
    return jnp.asarray(out.reshape(spec.shape), jnp.dtype(spec.dtype))


_REAL_MATERIALIZE = []


@contextlib.contextmanager
def _chunked_init(chunk=SERVE_CHUNK):
    """The reference's ``init_params`` drawing every large leaf by
    :func:`chunked_materialize`."""
    import functools

    from repro.models import params as P

    _REAL_MATERIALIZE[:] = [P._materialize]
    P._materialize = functools.partial(chunked_materialize, chunk=chunk)
    try:
        yield
    finally:
        P._materialize = _REAL_MATERIALIZE[0]


def serve_bias_values(shapes, seed, scale):
    """The QKV biases set after init, for ``shapes`` = the shapes of
    (bq, bk, bv): standard normals of ``np.random.default_rng(seed)`` in
    that order, float32, times ``scale``.  chip_smoke.py's
    ``serve_bias_values`` draws the same arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(shape), dtype=np.float32)
            * np.float32(scale) for shape in shapes]


def _set_biases(params, seed, scale):
    """A dense parameter tree with its stacked QKV biases set to
    :func:`serve_bias_values`."""
    import jax.numpy as jnp

    attn = dict(params["layers"]["attn"])
    names = ("bq", "bk", "bv")
    for name, value in zip(names, serve_bias_values(
            [attn[n].shape for n in names], seed, scale)):
        attn[name] = jnp.asarray(value, attn[name].dtype)
    return dict(params, layers=dict(params["layers"], attn=attn))


@contextlib.contextmanager
def _serve_init(setting):
    """``repro.models.registry.Model.init`` changed as a serving run's
    ``setting`` asks: a vlm's gates (a list, :func:`_gated_init`), or a
    dense model's QKV biases (``{"biases": (seed, scale)}``)."""
    if not isinstance(setting, dict):
        with _gated_init(setting):
            yield
        return
    from repro.models import registry

    real = registry.Model.init
    seed, scale = setting["biases"]

    def init(self, key):
        return _set_biases(real(self, key), seed, scale)

    registry.Model.init = init
    try:
        yield
    finally:
        registry.Model.init = real


def serve_run_label(arch, setting):
    """A serving run's name: the arch id, ``-gated`` where a vlm's gates
    are set, ``-biased`` where the QKV biases are."""
    if isinstance(setting, dict):
        return f"{arch}-biased"
    return f"{arch}{'-gated' if setting else ''}"


def _init_leaves(params):
    """Per leaf of ``params``: its shape and its float32 elements at
    :func:`sample_indices`."""
    import numpy as np

    from repro.utils.tree import tree_flatten_with_paths

    leaves = {}
    for path, leaf in tree_flatten_with_paths(params):
        flat = np.asarray(leaf).reshape(-1)
        ix = sample_indices(flat.size)
        leaves[path] = {"shape": [int(d) for d in leaf.shape],
                        "index": [int(i) for i in ix],
                        "values": [_f32(v) for v in
                                   flat[ix].astype(np.float32)]}
    return leaves


def serve_record_run(arch, num_layers, setting, smoke, leaves=False):
    """One serving run of the reference: ``repro.launch.serve.main`` on
    ``arch`` (``--smoke`` where asked, the SMOKE config at the published
    config's rope_theta, so that a non-default theta shows, and at the
    prompt length of SERVE_SMOKE_PROMPT where it names the arch; depth cut
    to ``num_layers`` by replacing ``serve.get_config`` with
    ``dataclasses.replace(cfg, num_layers=n)``, as the reference's server
    has no such flag; a vlm's gates or a dense model's QKV biases set after
    init as ``setting`` asks, :func:`_serve_init`), then one uncached
    ``module.forward`` over the prompts and the served tokens (teacher
    forcing) read at the positions that predict each served token.  Returns
    the record's run entry; with ``leaves``, it also holds the served
    weights at sample_indices (:func:`_init_leaves`)."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from repro.launch import serve

    argv = ["--arch", arch] + (["--smoke"] if smoke else []) + SERVE_ARGV
    if smoke and arch in SERVE_SMOKE_PROMPT:
        argv[argv.index("--prompt-len") + 1] = str(SERVE_SMOKE_PROMPT[arch])
    prompt_len = int(argv[argv.index("--prompt-len") + 1])
    gen = int(argv[argv.index("--gen") + 1])
    seen = {}
    real_get, real_build = serve.get_config, serve.build_model
    real_smoke = serve.get_smoke

    def get_config(name):
        return dataclasses.replace(real_get(name), num_layers=num_layers)

    def get_smoke(name):
        return dataclasses.replace(real_smoke(name),
                                   rope_theta=real_get(name).rope_theta)

    def build_model(cfg):
        model = real_build(cfg)
        module, real_fwd = model.module, model.module.forward
        seen.update(model=model, module=module, forward=real_fwd)

        def forward(params, tokens, cfg, **kw):
            if "params" not in seen and kw.get("caches") is not None:
                seen.update(params=params, prompts=tokens, kw={
                    k: v for k, v in kw.items()
                    if k in ("img_feats", "enc_out")})
            return real_fwd(params, tokens, cfg, **kw)

        module.forward = forward
        return model

    if num_layers:
        serve.get_config = get_config
    serve.get_smoke = get_smoke
    serve.build_model = build_model
    try:
        with _serve_init(setting), _chunked_init():
            tokens = np.asarray(serve.main(argv))
    finally:
        serve.get_config, serve.build_model = real_get, real_build
        serve.get_smoke = real_smoke
        if "module" in seen:
            seen["module"].forward = seen["forward"]
    cfg = seen["model"].cfg
    prompts = np.asarray(seen["prompts"])
    init = _init_leaves(seen["params"]) if leaves else None
    seq = jnp.concatenate([seen["prompts"], jnp.asarray(tokens[:, :-1])], 1)
    out = seen["forward"](seen["params"], seq, cfg, remat=False, **seen["kw"])
    logits = np.asarray(out[0][:, prompt_len - 1:prompt_len - 1 + gen,
                               :cfg.vocab_size], np.float32)
    del out, seen
    logits = logits.transpose(1, 0, 2)            # (gen, batch, vocab)
    order = np.argsort(-logits, axis=-1, kind="stable")[..., :SERVE_TOP]
    top = np.take_along_axis(logits, order, -1)
    ids = serve_logit_ids(cfg.vocab_size)
    absmax = np.abs(logits).max(-1)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
        absmax.astype(np.float64), np.finfo(np.float32).tiny))) - 7)
    entry = {
        "argv": argv, "gates": None if isinstance(setting, dict) else setting,
        "num_layers": cfg.num_layers,
        "vocab_size": cfg.vocab_size,
        "prompts": prompts.tolist(), "tokens": tokens.tolist(),
        "positions": list(range(prompt_len - 1, prompt_len - 1 + gen)),
        "top_ids": order.tolist(),
        "top_values": [[[_f32(v) for v in r] for r in s] for s in top],
        "ids": ids,
        "values": [[[_f32(v) for v in r[ids]] for r in s] for s in logits],
        "absmax": [[_f32(v) for v in s] for s in absmax],
        "gap_ulps": ((top[..., 0].astype(np.float64) - top[..., 1]) / ulp
                     ).tolist(),
    }
    if isinstance(setting, dict):
        entry["biases"] = list(setting["biases"])
    if init is not None:
        entry["leaves"] = init
    return entry


_SERVE_WHAT = {
    "mixtral_8x22b": "; Mixtral's sliding_window=4096 is never reached in "
                     "these 48 positions, so nothing here holds it",
    "llama4_scout_17b_a16e": (
        "; Llama-4-Scout's attention_chunk=8192 is never reached in these "
        "48 positions, so nothing here holds the chunked mask: the SMOKE "
        "record (attention_chunk 64) serves a 72-token prompt, whose 88 "
        "positions cross it"),
}


def write_serve_records(directory, names, smoke):
    """The records of ``SERVE_RECORDS[name]`` for each of ``names``, one
    ``serve_<name>.json`` each in ``directory`` (``--smoke``: the SMOKE
    configs at the published rope_theta, no depth cut; their leaves are
    never drawn in chunks, so the check of :func:`chunked_materialize`
    against whole draws is left out)."""
    import os

    import jax
    import numpy as np

    from repro.models import params as P

    key = jax.random.PRNGKey(0)
    for probe in () if smoke else (
            P.ParamSpec((3, 50, 999), (None,) * 3),
            P.ParamSpec((500, 64), (None, None), init="embed")):
        with _chunked_init(chunk=1 << 14):
            got = np.asarray(P._materialize(probe, key))
        assert np.array_equal(got, np.asarray(P._materialize(probe, key)))
    for name in names:
        runs = {}
        for arch, layers, setting in SERVE_RECORDS[name]:
            runs[serve_run_label(arch, setting)] = serve_record_run(
                arch, None if smoke else layers, setting, smoke,
                leaves=name in SERVE_INIT_LEAVES)
        record = {
            "_command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                         "tests/_torch_reference_worker.py "
                         "--write-serve-reference tests/torch_reference"
                         + (" --smoke" if smoke else "")),
            "_what": (
                "repro.launch.serve.main(argv) on the CPU (the config's "
                "depth cut to num_layers where argv's model is deeper; a "
                "vlm's gates set after init where 'gates' is given): "
                "'prompts' and the greedy 'tokens' of the cached decode; "
                "then one uncached module.forward over prompts + tokens[:, "
                ":-1] (teacher forcing) read at 'positions', the positions "
                "that predict each served token, over [:vocab_size]: per "
                "(step, row) the top_ids / top_values (float32, ties by "
                "the lower id), the values at the fixed 'ids', the row's "
                "largest |logit| 'absmax' and the top-2 gap in bf16 ulps "
                "of it (2^(floor(log2 absmax) - 7))"
                + ("; a run with 'biases' (seed, scale) has its QKV biases "
                   "set after init to serve_bias_values (standard normals "
                   "of numpy's default_rng(seed), bq, bk, bv in turn, times "
                   "scale); 'leaves' holds the served weights at "
                   "sample_indices" if name in SERVE_INIT_LEAVES else "")
                + ("" if smoke else _SERVE_WHAT.get(name, ""))),
            "model": name, "seed": 0, "runs": runs,
        }
        with open(os.path.join(directory, f"serve_{name}.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(record, fh, sort_keys=True, separators=(",", ":"))
            fh.write("\n")


def write_serve_reference(argv) -> int:
    """``--write-serve-reference DIR [--smoke] [--arch NAME]``: with
    ``--smoke``, every SMOKE record in this process; with ``--arch``, that
    record; else every full-width record, each in its own subprocess (one
    model's arrays are freed before the next), printing each one's peak
    RSS and seconds."""
    import os
    import resource
    import subprocess
    import time

    directory = argv[0]
    if "--smoke" in argv:
        write_serve_records(directory, list(SERVE_RECORDS), True)
        return 0
    if "--arch" in argv:
        t0 = time.time()
        write_serve_records(directory, [argv[argv.index("--arch") + 1]],
                            False)
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f"peak RSS {peak:.2f} GiB, {time.time() - t0:.1f} s",
              flush=True)
        return 0
    for name in SERVE_RECORDS:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, __file__,
                                 "--write-serve-reference", directory,
                                 "--arch", name])
        _, status, usage = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        print(f"serve_{name}.json: peak RSS {usage.ru_maxrss / 2**20:.2f} "
              f"GiB, {time.time() - t0:.1f} s, exit {proc.returncode}",
              flush=True)
        if proc.returncode:
            return proc.returncode
    return 0


TASKS = {
    "lenet_grad": task_lenet_grad,
    "lenet_parts": task_lenet_parts,
    "sgd_epoch": task_sgd_epoch,
    "init_params": task_init_params,
    "fl_run": task_fl_run,
    "fl_runs": task_fl_runs,
    "draws": task_draws,
    "lazy_greedy": task_lazy_greedy,
    "legacy_parts": task_legacy_parts,
    "horizon_runs": task_horizon_runs,
    "online_runs": task_online_runs,
    "token_parts": task_token_parts,
    "token_runs": task_token_runs,
    "family_parts": task_family_parts,
    "launch_parts": task_launch_parts,
    "multimodal_parts": task_multimodal_parts,
    "qwen2_reference": task_qwen2_reference,
    "sharding_parts": task_sharding_parts,
    "dryrun_parts": task_dryrun_parts,
    "split_parts": task_split_parts,
    "example_runs": task_example_runs,
}


def main(argv) -> int:
    import numpy as np

    if argv[1] == "--write-train-reference":
        apply_shim()
        return write_train_reference_main(argv[2:])
    if argv[1] == "--write-family-reference":
        apply_shim()
        write_family_reference(argv[2])
        return 0
    if argv[1] == "--write-multimodal-reference":
        apply_shim()
        write_multimodal_reference(argv[2])
        return 0
    if argv[1] == "--write-multimodal-train-reference":
        apply_shim()
        write_multimodal_train_reference(argv[2])
        return 0
    if argv[1] == "--write-paper-cell-reference":
        apply_shim()
        write_paper_cell_reference(argv[2])
        return 0
    if argv[1] == "--write-serve-reference":
        apply_shim()
        return write_serve_reference(argv[2:])
    if argv[1] == "--write-qwen2-reference":
        apply_shim()
        write_qwen2_reference(argv[2])
        return 0
    task, spec_path, in_path, out_path = argv[1:5]
    apply_shim()
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    with np.load(in_path) as data:
        arrays = {k: data[k] for k in data.files}
    out = TASKS[task](spec, arrays)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
