"""The port's runtime sanitizers (``repro_torch.utils.sanitizers``), the
counterparts of the reference's ``tools/flcheck/sanitizers.py``.

``nan_guard`` holds ``jax_debug_nans``' contract: inside the block the
first ATen op whose floating-point output holds a NaN raises
``FloatingPointError`` naming the op, in the forward, in the backward and
under ``vmap``; a kernel wrapper's launch is checked by the wrapper
(``check_kernel_outputs``, naming it), and its CPU path, the plain
version's ATen ops, by the mode.  The mode stack and ``NAN_CHECK`` are as
before after the block, also after a raise; ``enable=False`` passes NaNs
through; a guarded run equals the unguarded one to the bit.
``build_count`` counts ``nvcc`` runs and library loads: 0 over runs on the
CPU, whatever their rounds, and one per stubbed build, 0 on the rebuild.
The reference's guard is held through the example worker
(tests/test_torch_examples.py, ``--sanitize-nans``): it does not import in
this process under JAX 0.9.0.
"""
import contextlib
import io
import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import load_example, one_torch_thread  # noqa: E402,F401

from torch.utils._python_dispatch import (  # noqa: E402
    _get_current_dispatch_mode_stack,
)

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, prng  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.kernels import aggregate, cuda_build, dorefa  # noqa: E402
from repro_torch.kernels import ota_aggregate  # noqa: E402
from repro_torch.utils import sanitizers  # noqa: E402
from repro_torch.utils.sanitizers import build_count, nan_guard  # noqa: E402


def _state():
    return len(_get_current_dispatch_mode_stack()), sanitizers.NAN_CHECK


def test_nan_guard_raises_at_the_op_that_makes_the_nan():
    a, b = torch.zeros(()), torch.zeros(())
    with pytest.raises(FloatingPointError, match=r"aten\.div\.Tensor"):
        with nan_guard():
            a / b


def test_nan_guard_restores_the_mode_stack_and_flag():
    before = _state()
    assert before == (0, False)
    with nan_guard():
        assert _state() == (1, True)
        torch.ones(3) + 1.0
    assert _state() == before
    with pytest.raises(FloatingPointError):
        with nan_guard():
            torch.log(-torch.ones(2))
    assert _state() == before
    with nan_guard(), pytest.raises(FloatingPointError):
        with nan_guard():          # nested: the inner exit restores the outer
            assert _state() == (2, True)
            torch.zeros(()) / torch.zeros(())
    assert _state() == before


def test_nan_guard_disabled_passes_nans_through():
    with nan_guard(enable=False):
        assert _state() == (0, False)
        out = torch.zeros(()) / torch.zeros(())
    assert bool(torch.isnan(out))


def test_nan_guard_raises_in_a_backward_op():
    """The forward is finite (sqrt(0) behind a where); sqrt's backward
    divides 0 by 0."""
    x = torch.zeros((), requires_grad=True)
    with nan_guard():
        y = torch.where(x > 0, torch.sqrt(x), torch.zeros(()))
        assert not bool(torch.isnan(y))
        with pytest.raises(FloatingPointError, match=r"aten\.div"):
            y.backward()


def test_nan_guard_sees_the_unwrapped_tensors_under_vmap():
    with nan_guard(), pytest.raises(FloatingPointError,
                                    match=r"aten\.div.*\(2, 3\)"):
        torch.func.vmap(lambda a: a / a)(torch.zeros(2, 3))


def test_views_and_uninitialized_allocations_are_not_checked():
    """A view computes nothing (its NaN came from its base); ``empty``'s
    memory is garbage, not a value.  The first op that computes from the
    NaN raises."""
    x = torch.tensor([1.0, float("nan")])
    with nan_guard():
        x.reshape(2, 1)[1:]
        torch.empty(1024)
        with pytest.raises(FloatingPointError, match=r"aten\.mul"):
            x * 2.0


def _nan_codes():
    codes = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    codes[1, 2] = float("nan")
    return codes


@pytest.mark.parametrize("wrapper", ["weighted_aggregate",
                                     "ota_aggregate_keyed",
                                     "quantize_dequantize"])
def test_a_kernel_wrappers_cpu_path_fed_a_nan_raises(wrapper):
    """On the CPU a wrapper runs its plain version, whose ATen ops the
    mode checks; unguarded the NaN passes through to the output."""
    coeff = torch.tensor([0.5, 0.25, 0.25])
    calls = {
        "weighted_aggregate": lambda: aggregate.weighted_aggregate_group(
            [_nan_codes()], [coeff])[0],
        "ota_aggregate_keyed": lambda: ota_aggregate.ota_aggregate_keyed(
            _nan_codes(), coeff, prng.prng_key(0), torch.tensor(1e-3)),
        "quantize_dequantize": lambda: dorefa.quantize_dequantize(
            _nan_codes().reshape(-1), torch.tensor(11.0), 4),
    }
    assert bool(torch.isnan(calls[wrapper]()).any())
    with nan_guard(), pytest.raises(FloatingPointError, match="aten"):
        calls[wrapper]()


def test_check_kernel_outputs_names_the_wrapper():
    """What a wrapper calls after a launch on the card while the guard is
    on: it names the wrapper, and its own isnan runs with the mode off."""
    fine, bad = torch.ones(5), _nan_codes()
    with nan_guard():
        sanitizers.check_kernel_outputs("weighted_aggregate", fine)
        with pytest.raises(FloatingPointError,
                           match="kernel wrapper ota_aggregate_keyed"):
            sanitizers.check_kernel_outputs("ota_aggregate_keyed", fine, bad)
        assert _state() == (1, True)


def _poisoned_world():
    ds = make_mnist_like(num_samples=400, seed=0)
    ds.x_train[:, 100] = np.nan
    cell = channel.CellConfig(num_devices=4)
    shards = dirichlet_partition(ds.y_train, 4, seed=0)
    cfg = FLConfig(num_devices=4, group_size=4, num_rounds=1,
                   fl_engine="batched", power_mode="max")
    return ds, cell, shards, cfg


def test_nan_guard_stops_a_poisoned_run_at_the_source():
    """A NaN pixel in every training image: unguarded the run ends with
    NaN weights; under the guard the first op that takes it up raises."""
    ds, cell, shards, cfg = _poisoned_world()
    res = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    assert bool(torch.isnan(res.final_params["fc1"]["w"]).any())
    with nan_guard(), pytest.raises(FloatingPointError, match="aten"):
        fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


@pytest.mark.parametrize("argv", [[], ["--model", "tiny-transformer"]],
                         ids=["lenet", "tiny-transformer"])
def test_a_guarded_twin_run_equals_the_unguarded_one(argv):
    """``--sanitize-nans`` on the example twin: the port's FL math makes
    no NaN at ``--fast`` (the token payload's client axis runs under
    ``vmap``), and the guard changes no bit."""
    twin = load_example("fl_noma_mnist_torch")
    base = ["--fast", "--rounds", "1", "--device", "cpu"] + argv
    plain = _quiet(lambda: twin.main(base))
    guarded = _quiet(lambda: twin.main(base + ["--sanitize-nans"]))
    for a, b in zip(plain.logs, guarded.logs):
        assert a.devices == b.devices and a.test_accuracy == b.test_accuracy
        for field in ("rates", "bits", "compression_ratios"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    np.testing.assert_array_equal(plain.times(), guarded.times())
    from repro_torch.utils.tree import tree_flatten_with_paths

    want = dict(tree_flatten_with_paths(plain.final_params))
    for path, leaf in tree_flatten_with_paths(guarded.final_params):
        assert torch.equal(leaf, want[path]), path


def test_build_count_reads_zero_over_cpu_runs():
    """No kernel is built on the CPU, at any number of rounds."""
    ds = make_mnist_like(num_samples=400, seed=0)
    cell = channel.CellConfig(num_devices=6)
    shards = dirichlet_partition(ds.y_train, 6, seed=0)
    counts = []
    for t in (1, 2):
        cfg = FLConfig(num_devices=6, num_rounds=t, fl_engine="batched",
                       use_pallas=True)
        with build_count() as tally:
            assert tally.count is None
            fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
        counts.append((tally.count, tally.builds, tally.loads))
    assert counts == [(0, 0, 0), (0, 0, 0)]


def test_build_count_counts_a_stubbed_build_and_a_load(tmp_path,
                                                       monkeypatch):
    """nvcc replaced by a stub that writes the library: the first build
    runs it once, the rebuild finds the library and runs nothing; a load
    counts apart from the build it may run."""
    ran = []

    def fake_run(cmd, **kwargs):
        ran.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as fh:
            fh.write(b"\0")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "subprocess",
                        types.SimpleNamespace(run=fake_run))
    monkeypatch.setattr(cuda_build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: path))
    with build_count() as first:
        path = cuda_build.build("aggregate")
    with build_count() as again:
        assert cuda_build.build("aggregate") == path
    with build_count() as loaded:
        assert cuda_build.load("aggregate") == str(path)
    assert len(ran) == 1 and ran[0][0] == "nvcc"
    assert (first.count, first.builds, first.loads) == (1, 1, 0)
    assert (again.count, loaded.count, loaded.loads) == (0, 1, 1)
