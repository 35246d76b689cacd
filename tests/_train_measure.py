"""Measure the port's full-width trainer runs against the reference's
training records.

    PYTHONPATH=src python tests/_train_measure.py [NAME ...]

NAME is a run of tests/torch_reference/train_<NAME>.json (default: every
run of chip_smoke.TRAIN_ARCH_RUNS, each in its own process, one after
another; the parent prints each one's peak RSS and seconds).  For each it
trains the port on the CPU as ``[train:<NAME>]`` does on the card
(``launch.train.main`` on the record's argv, the depth cut by
``chip_smoke.train_depth``), and again with step ``dropped_step``'s
update thrown away, and prints what chip_smoke.py's limits are read from:
each run's largest relative loss difference from the reference's losses
and its final parameters' worst leaf mean drift over the record's sampled
elements (``chip_smoke._sampled_drift``), beside the record's own dropped
run's.  ``chip_smoke.TRAIN_LOSS_LIMITS`` / ``TRAIN_DRIFT_LIMITS`` lie
between the sound readings and the dropped ones.

The initial weights are the reference's own draws (jax.random on the
CPU, leaf by leaf in chunks): the port's plain Threefry draw computes the
same bits (tests/test_torch_draws.py; on the card ``[train:*]`` counts
its kernel's launches), but at 1e8-1e9 elements a leaf it takes hours on
a CPU.  A run holds about 23 bytes a parameter at its peak, the step
updating in place (Mistral-Large-123B cut to 1 layer, 2.19e9 parameters:
46.5 GiB), so Mixtral-8x22B at 1 layer (2.91e9) needs about 62 GiB.
"""
from __future__ import annotations

import contextlib
import io
import os
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


@contextlib.contextmanager
def reference_init():
    """``Model.init`` of the port returning the reference's draw of the
    same schema under the same key (:func:`_serve_measure.
    _reference_params`, which draws under ``PRNGKey(0)``: the runs' seed)."""
    sys.path.insert(0, TESTS)
    import _serve_measure

    from repro_torch.models import registry

    real = registry.Model.init

    def init(self, key, *, device=None):
        return _serve_measure._reference_params(self.schema, None)

    registry.Model.init = init
    try:
        yield
    finally:
        registry.Model.init = real


def port_run(argv, drop=None):
    """``launch.train.main(argv)`` on the CPU: (losses, final parameters);
    ``drop``: the 1-based step whose parameter update is thrown away (its
    optimizer state kept)."""
    import torch

    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import steps, train

    real, calls, last = steps.make_train_step, [], {}

    def make(model, opt, **kw):
        inner = real(model, opt, **kw)

        def step(params, state, batch):
            calls.append(1)
            # the trainer's step updates in place: keep the parameters of
            # the step whose update is thrown away
            keep = (tree_lib.tree_map(torch.clone, params)
                    if len(calls) == drop else None)
            new, new_state, loss = inner(params, state, batch)
            last["params"] = new if keep is None else keep
            return last["params"], new_state, loss

        return step

    steps.make_train_step = make
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            losses = train.main(list(argv) + ["--device", "cpu"])
    finally:
        steps.make_train_step = real
    return losses, last["params"]


def readings(name, losses, params, record):
    """(largest relative loss difference from the record's losses, worst
    leaf mean drift over the record's sampled elements)."""
    import chip_smoke
    from repro_torch.utils.tree import tree_flatten_with_paths

    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, record["losses"]))
    flat = dict(tree_flatten_with_paths(params))
    got = {path: flat[path].reshape(-1)[rec["index"]].double().numpy()
           for path, rec in record["final"].items()}
    return rel, chip_smoke._sampled_drift(got, record["final"])


def measure(name):
    sys.path.insert(0, REPO)
    sys.path.insert(0, TESTS)
    import _torch_reference_worker as worker

    worker.apply_shim()
    import chip_smoke
    import torch

    torch.set_num_threads(os.cpu_count() or 1)
    layers = dict(chip_smoke.TRAIN_ARCH_RUNS)[name]
    record = chip_smoke.train_record(name)
    final = record["final"]
    wrong_rel = max(abs(a - b) / abs(b) for a, b in zip(
        record["dropped_losses"], record["losses"]))
    wrong_drift = chip_smoke._sampled_drift(
        {p: r["dropped"] for p, r in final.items()}, final)
    print(f"[{name}] the record's dropped run (step "
          f"{record['dropped_step']}): loss rel {wrong_rel:.4g}, drift "
          f"{wrong_drift:.4g}", flush=True)
    for drop in (None, record["dropped_step"]):
        t0 = time.time()
        with chip_smoke.train_depth(layers), reference_init():
            losses, params = port_run(record["argv"], drop)
        rel, drift = readings(name, losses, params, record)
        del params
        what = "sound" if drop is None else f"step {drop} dropped"
        print(f"[{name}] port on the CPU, {what}: {time.time() - t0:.1f} s, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; loss rel "
              f"{rel:.4g}, drift {drift:.4g}", flush=True)


def main(argv):
    import resource
    import subprocess

    if argv[:1] == ["--one"]:
        t0 = time.time()
        measure(argv[1])
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        print(f"{argv[1]}: peak RSS {peak:.2f} GiB, {time.time() - t0:.1f} s",
              flush=True)
        return 0
    if not argv:
        sys.path.insert(0, REPO)
        import chip_smoke

        argv = [name for name, _ in chip_smoke.TRAIN_ARCH_RUNS]
    for name in argv:
        t0 = time.time()
        proc = subprocess.Popen([sys.executable, __file__, "--one", name])
        _, status, usage = os.wait4(proc.pid, 0)
        code = os.waitstatus_to_exitcode(status)
        print(f"{name}: peak RSS {usage.ru_maxrss / 2 ** 20:.2f} GiB, "
              f"{time.time() - t0:.1f} s, exit {code}", flush=True)
        if code:
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
