"""Reference runner for the PyTorch-port parity tests (and its own test).

``run_reference`` runs one task of ``tests/_torch_reference_worker.py`` in a
subprocess: that process applies the JAX 0.9.0 compatibility shim (which
``repro.models`` and ``repro.core.fl`` need here) and returns numpy arrays
through an ``.npz`` file in ``tmp_path``.  The shim never touches the pytest
process.  Other test files import the helpers with
``from test_torch_harness import ...``; those that import
``one_torch_thread`` run torch on one thread.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test module: the plain versions of the port
    (the float64 fused multiply-adds, the Threefry draws) are thousands of
    small tensor ops, and parallel test workers each running torch's full
    thread pool oversubscribe the host's cores.  A module that imports this
    fixture from here runs with it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REPO = os.path.dirname(TESTS_DIR)
WORKER = os.path.join(TESTS_DIR, "_torch_reference_worker.py")
LEAVES = ("fc1/b", "fc1/w", "fc2/b", "fc2/w", "fc3/b", "fc3/w")

# The whole-slice contract of tests/test_fl_engine.py:_assert_equal_runs:
# schedules, bits, rates, ratios and times exact; accuracy within 0.02;
# parameter drift below these mean / max bounds.
ACC_ATOL = 0.02
PARAM_MEAN_ATOL = 1e-6
PARAM_MAX_ATOL = 2e-2


def run_reference(tmp_path, task, spec=None, arrays=None, *, timeout=600):
    """Run reference ``task`` in a shimmed subprocess; returns a dict of
    numpy arrays."""
    return start_reference(tmp_path, task, spec, arrays, timeout=timeout)()


def start_reference(tmp_path, task, spec=None, arrays=None, *, timeout=600):
    """:func:`run_reference` started in the background, so the caller can
    work meanwhile: returns a function that waits for the subprocess (at
    most ``timeout`` seconds) and returns its arrays; its ``cancel()``
    kills a subprocess still running."""
    tag = f"{task}_{len(os.listdir(tmp_path))}"
    spec_path = tmp_path / f"{tag}.json"
    in_path = tmp_path / f"{tag}_in.npz"
    out_path = tmp_path / f"{tag}_out.npz"
    spec_path.write_text(json.dumps(spec or {}))
    np.savez(in_path, **(arrays or {"_": np.zeros(1)}))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, WORKER, task, str(spec_path), str(in_path),
         str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )

    def result():
        try:
            _, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        assert proc.returncode == 0, stderr[-4000:]
        with np.load(out_path) as data:
            return {k: data[k] for k in data.files}

    def cancel():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()

    result.cancel = cancel
    return result


def tree(arrays, prefix):
    """Flat ``prefix + "fc1/w"`` arrays -> nested ``{"fc1": {"w": ...}}``."""
    out = {}
    for name in LEAVES:
        layer, leaf = name.split("/")
        out.setdefault(layer, {})[leaf] = arrays[prefix + name]
    return out


def flat(params, prefix):
    """Nested port parameters (tensors or arrays) -> flat numpy dict."""
    out = {}
    for name in LEAVES:
        layer, leaf = name.split("/")
        v = params[layer][leaf]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[prefix + name] = np.asarray(v)
    return out


def assert_param_drift(got, want, *, mean_atol=PARAM_MEAN_ATOL,
                       max_atol=PARAM_MAX_ATOL):
    """The reference's distribution check on final parameters: a DoReFa
    rounding-boundary flip moves one element by a quantization step, a
    systematic fault moves the mean."""
    for name in LEAVES:
        d = np.abs(np.asarray(got[name], np.float64)
                   - np.asarray(want[name], np.float64))
        assert d.mean() < mean_atol, f"{name}: mean param drift {d.mean()}"
        assert d.max() < max_atol, f"{name}: max param drift {d.max()}"


def _ulps(a, b):
    """Elementwise distance in float32 ulps (same-sign finite values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def assert_equal_runs(got, want, num_rounds, *, rate_ulp=0, drift=True):
    """tests/test_fl_engine.py:_assert_equal_runs against the reference's
    exported logs: schedules, bits, rates, ratios and times exact (rates and
    ratios within ``rate_ulp`` float32 ulps where a known difference says
    so, the TDMA rates' 2), accuracy within ACC_ATOL, parameter drift
    within the mean / max bounds (``drift=False`` leaves the drift to a
    test of its own)."""
    for t in range(num_rounds):
        log = got.logs[t]
        assert log.devices == tuple(int(d) for d in want[f"devices/{t}"])
        np.testing.assert_array_equal(log.bits, want[f"bits/{t}"])
        if rate_ulp:
            assert log.rates.dtype == want[f"rates/{t}"].dtype == np.float32
            # initial=0: an empty tail round has no rates to compare
            assert _ulps(log.rates, want[f"rates/{t}"]).max(
                initial=0) <= rate_ulp
            assert _ulps(log.compression_ratios,
                         want[f"ratios/{t}"]).max(initial=0) <= rate_ulp
        else:
            np.testing.assert_array_equal(log.rates, want[f"rates/{t}"])
            np.testing.assert_array_equal(log.compression_ratios,
                                          want[f"ratios/{t}"])
    np.testing.assert_array_equal(got.times(), want["times"])
    np.testing.assert_allclose(got.accuracies(), want["acc"], atol=ACC_ATOL)
    if not drift:
        return
    assert_param_drift(flat(got.final_params, ""), {
        name: want["final/" + name] for name in LEAVES
    })


def test_reference_runner_returns_reference_init(tmp_path):
    """The shimmed subprocess imports repro.models (which fails in this
    process under JAX 0.9.0) and returns LeNet's initial weights: the
    reference's shapes, zero biases, weights inside 3 fan-in stds."""
    out = run_reference(tmp_path, "init_params", {"seed": 0})
    assert set(out) == {"p/" + name for name in LEAVES}
    for name, (fan_in, fan_out) in {
        "fc1": (784, 300), "fc2": (300, 100), "fc3": (100, 10),
    }.items():
        w, b = out[f"p/{name}/w"], out[f"p/{name}/b"]
        assert w.shape == (fan_in, fan_out) and w.dtype == np.float32
        assert np.all(b == 0.0) and b.shape == (fan_out,)
        assert np.abs(w).max() <= 3.0 / np.sqrt(fan_in) * (1 + 1e-6)


# --------------------------------------------------------------------------
# token payloads (tests/test_torch_tokens*.py)
# --------------------------------------------------------------------------

# the reference's token world (tests/test_fl_engine.py:token_world)
TOKEN_DATA = dict(vocab_size=64, num_samples=400, seq_len=8, seed=0)
TOKEN_M = 12


def token_world(m=TOKEN_M, **data):
    """(dataset, cell, shards) of the port on the reference's token world:
    Dirichlet shards by the rows' pseudo-class."""
    from repro_torch.core import channel
    from repro_torch.data import dirichlet_partition, make_token_dataset

    ds = make_token_dataset(**(data or TOKEN_DATA))
    return (ds, channel.CellConfig(num_devices=m),
            dirichlet_partition(ds.class_train, m, seed=0))


def tree_arrays(params, prefix=""):
    """Any nested port parameter tree -> flat numpy dict keyed ``prefix``
    + '/'-joined path, as the worker's ``_tree_to_arrays`` names them."""
    from repro_torch.utils.tree import tree_flatten_with_paths

    return {prefix + path: leaf.detach().cpu().numpy()
            for path, leaf in tree_flatten_with_paths(params)}


def param_drift(got, want, prefix):
    """Per leaf (mean, max) |got - want| of the port's final parameters
    against the reference arrays under ``prefix``."""
    out = {}
    for path, leaf in tree_arrays(got).items():
        d = np.abs(np.asarray(leaf, np.float64)
                   - np.asarray(want[prefix + path], np.float64))
        out[path] = (d.mean(), d.max())
    return out
