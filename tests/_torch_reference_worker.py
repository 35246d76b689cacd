"""Reference side of the PyTorch-port parity tests, run as a subprocess.

    python tests/_torch_reference_worker.py <task> <spec.json> <in.npz> <out.npz>

The JAX package cannot import ``repro.models`` (and hence ``repro.core.fl``)
under JAX 0.9.0: ``models/layers.py`` asks ``x not in
batching.primitive_batchers``, which the 0.9.0 proxy object no longer
supports, and ``jax.experimental.enable_x64`` is gone.  This script applies
a compatibility shim for both faults *in its own process only* and then runs
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
    """LenetFLModel.init with one initial weight moved by ``ulps`` float32
    ulps: ``perturb = {"leaf": "fc2/w", "index": [i, j], "ulps": n}``."""
    import jax.numpy as jnp
    import numpy as np

    def perturbed(self, key):
        params = init(self, key)
        layer, leaf = perturb["leaf"].split("/")
        w = np.array(params[layer][leaf])
        idx = tuple(perturb["index"])
        for _ in range(abs(int(perturb["ulps"]))):
            w[idx] = np.nextafter(w[idx], np.float32(
                np.inf if perturb["ulps"] > 0 else -np.inf))
        params[layer][leaf] = jnp.asarray(w)
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


TASKS = {
    "lenet_grad": task_lenet_grad,
    "sgd_epoch": task_sgd_epoch,
    "init_params": task_init_params,
    "fl_run": task_fl_run,
    "fl_runs": task_fl_runs,
    "draws": task_draws,
    "lazy_greedy": task_lazy_greedy,
    "legacy_parts": task_legacy_parts,
}


def main(argv) -> int:
    import numpy as np

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
