"""The port's legacy round body (``fl_engine="legacy"``) against the JAX
package's, and against the port's own batched engine.

The reference side runs in one shimmed subprocess of test_torch_harness
(``repro.core.fl`` does not import in this process under JAX 0.9.0):

  * ``local_update`` on one padded shard, within the one-epoch tolerance of
    tests/test_torch_fl.py (rtol 1e-4 / atol 1e-6: XLA's and PyTorch's
    float32 matmuls sum in another order); ``_tree_l2`` on the reference's
    own delta within rtol 1e-4: XLA's CPU ``vdot`` is one sequential chain
    of float32 fused multiply-adds over a whole leaf (it equalled such a
    chain on 30 of 30 vectors tried), whose rounding error reaches 5e-5
    relative over fc1/w's 235,200 squares, where ``torch.dot`` sums in
    blocks (within 1e-6 of the float64 sum here);
  * ``_legacy_round`` with ``local_update`` replaced by a hand-over of the
    same deltas: under NOMA, at K = 0, 1 and 3 with float64 weights that
    float32 does not hold exactly, the new weights are bit-equal to the
    reference's, with and without adaptive DoReFa (the eager codec), and
    bits, ratios and norms equal; under OTA (ota-align, noise 1e-9) the
    update within rtol 1e-5, and atol 1e-5 of its largest element where
    noise and sum cancel (tests/test_torch_ota.py: the energy sums behind
    eta run in another order), through the keyed kernel's plain version
    and through the einsum;
  * whole legacy runs on the tests/test_fl_engine.py worlds under
    tests/test_fl_engine.py:_assert_equal_runs (schedules, bits, rates,
    ratios and times exact, TDMA rates and ratios within 2 ulp; accuracy
    within 0.02; parameter drift mean < 1e-6, max < 2e-2).

The port's legacy driver is held to the port's batched engine under the
same contract, over the reference's engine-equality grid restricted to
precomputed policies, and the empty-tail round-robin horizon.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    LEAVES, assert_equal_runs, assert_param_drift, flat, one_torch_thread,
    run_reference, tree,
)

from repro_torch import convert  # noqa: E402
from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, fl_engine, ota  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models.fl_models import LenetFLModel  # noqa: E402

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
L2_RTOL = 1e-4
L2_EXACT_RTOL = 1e-6
OTA_RTOL = 1e-5
RATE_ULP = 2            # the TDMA rates' known difference (test_torch_tdma)
PAYLOAD = lenet.NUM_PARAMS * 32
PMAX = 0.01

# (n samples, batch size, local epochs): a padded last batch, a shard
# shorter than one batch, and two epochs
LOCAL = {"pad": (37, 10, 1), "short": (4, 10, 1), "two-epochs": (25, 10, 2)}

# the float64 FedAvg weights of three shards of 37, 52 and 80 samples: none
# is a float32 value
SIZES = np.array([37.0, 52.0, 80.0])
# bit budgets giving b = 4, 1 and 32 (passthrough) against LeNet's payload
BUDGETS = np.array([1.3e6 + 0.37, 4.1e5, 3.0e7])
ROUNDS = {
    "k0-none": dict(k=0, compression="none"),
    "k1-none": dict(k=1, compression="none"),
    "k3-none": dict(k=3, compression="none"),
    "k0-adaptive": dict(k=0, compression="adaptive"),
    "k1-adaptive": dict(k=1, compression="adaptive"),
    "k3-adaptive": dict(k=3, compression="adaptive"),
    "k3-paper-exact": dict(k=3, compression="adaptive", paper_exact=True),
    "k3-ota-kernel": dict(k=3, ota=True, use_pallas=True),
    "k3-ota-einsum": dict(k=3, ota=True, use_pallas=False),
}

WORLD = dict(m=12, samples=800, k=3, t=3)
TAIL = dict(m=4, samples=400, k=2, t=3)
OTA = dict(uplink="ota", compression="none", power_mode="ota-align",
           ota_noise=1e-9)
RUNS = {
    "lazy-max": dict(power_mode="max"),
    "lazy-mapel": dict(power_mode="mapel"),
    "round-robin-tail": dict(scheduler="round-robin", power_mode="max"),
    "tdma": dict(uplink="tdma", power_mode="max"),
    "uncompressed": dict(power_mode="max", compression="none"),
    "ota-kernel": dict(OTA, use_pallas=True),
    "ota-einsum": dict(OTA, use_pallas=False),
}


def _world_of(key):
    return TAIL if key == "round-robin-tail" else WORLD


def _cfg_args(key):
    w = _world_of(key)
    return {**dict(num_devices=w["m"], group_size=w["k"], num_rounds=w["t"],
                   scheduler="lazy-gwmin", fl_engine="legacy", seed=0),
            **RUNS[key]}


def _numpy_params(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, fan_in, fan_out in lenet.LAYERS:
        out[f"p/{name}/w"] = (rng.standard_normal((fan_in, fan_out))
                              / np.sqrt(fan_in)).astype(np.float32)
        out[f"p/{name}/b"] = (rng.standard_normal(fan_out)
                              * 0.1).astype(np.float32)
    return out


def _round_cfg(case):
    if case.get("ota"):
        return dict(uplink="ota", compression="none", power_mode="ota-align",
                    ota_noise=1e-9, use_pallas=case["use_pallas"])
    return dict(compression=case["compression"],
                paper_exact_range=bool(case.get("paper_exact")))


def _inputs():
    """The reference's spec and arrays, made from seeds with numpy."""
    arrays = _numpy_params(0)
    ds = make_mnist_like(num_samples=400, seed=1)
    spec = {"payload": PAYLOAD, "local": [], "rounds": []}
    start = 0
    for key, (n, bs, epochs) in LOCAL.items():
        arrays[f"x/{key}"] = ds.x_train[start:start + n]
        arrays[f"y/{key}"] = ds.y_train[start:start + n]
        start += n
        spec["local"].append(dict(key=key, cfg=dict(
            batch_size=bs, local_epochs=epochs, learning_rate=0.05)))
    rng = np.random.default_rng(2)
    for key, case in ROUNDS.items():
        k = case["k"]
        for j in range(k):
            for name in LEAVES:
                shape = arrays["p/" + name].shape
                arrays[f"d/{key}/{j}/{name}"] = (
                    rng.standard_normal(shape) * 0.01).astype(np.float32)
        devs = [5, 0, 9][:k]
        arrays[f"budgets/{key}"] = BUDGETS[:k].copy()
        arrays[f"aggw/{key}"] = SIZES[:k] / max(SIZES[:k].sum(), 1.0)
        arrays[f"gains/{key}"] = np.array([1e-6, 2.5e-6, 7e-7])[:k]
        arrays[f"okey/{key}"] = ota.horizon_keys(3, 2)[1]
        spec["rounds"].append(dict(
            key=key, devs=devs, cfg=_round_cfg(case), ota=case.get("ota"),
            pmax=PMAX, zero_params=bool(case.get("ota"))))
    spec["runs"] = [
        dict(key=key, num_devices=_world_of(key)["m"],
             num_samples=_world_of(key)["samples"], cfg=_cfg_args(key))
        for key in RUNS
    ]
    return spec, arrays


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference result of this file, from one subprocess."""
    spec, arrays = _inputs()
    return arrays, run_reference(tmp_path_factory.mktemp("legacy"),
                                 "legacy_parts", spec, arrays)


def _params(arrays, prefix, device="cpu"):
    return convert.params_from_jax(tree(arrays, prefix), device=device)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# --------------------------------------------------------------------------
# The parts of the round
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(LOCAL))
def test_local_update_matches_reference(reference, key):
    arrays, want = reference
    n, bs, epochs = LOCAL[key]
    cfg = FLConfig(batch_size=bs, local_epochs=epochs, learning_rate=0.05)
    delta = fl.local_update(_params(arrays, "p/"), arrays[f"x/{key}"],
                            arrays[f"y/{key}"], cfg, LenetFLModel())
    got = flat(delta, "")
    for name in LEAVES:
        assert got[name].shape == arrays["p/" + name].shape
        np.testing.assert_allclose(got[name], want[f"delta/{key}/{name}"],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert any(np.any(got[name] != 0.0) for name in LEAVES)


@pytest.mark.parametrize("key", list(LOCAL))
def test_tree_l2_matches_reference(reference, key):
    """On the reference's own delta: only the float32 summation order
    differs, and the port's sum stays within 1e-6 of the float64 one."""
    _, want = reference
    delta = _params(want, f"delta/{key}/")
    got = fl._tree_l2(delta)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, float(want[f"l2/{key}"]), rtol=L2_RTOL)
    exact = np.sqrt(sum(np.sum(want[f"delta/{key}/{name}"].astype(
        np.float64) ** 2) for name in LEAVES))
    np.testing.assert_allclose(got, exact, rtol=L2_EXACT_RTOL)


def _port_round(arrays, key, monkeypatch):
    case = ROUNDS[key]
    k = case["k"]
    given = iter([_params(arrays, f"d/{key}/{j}/") for j in range(k)])
    monkeypatch.setattr(fl, "local_update", lambda *a, **kw: next(given))
    start = _params(arrays, "p/")
    if case.get("ota"):
        start = {a: {c: torch.zeros_like(v) for c, v in d.items()}
                 for a, d in start.items()}
    ota_round = None
    if case.get("ota"):
        ota_round = dict(gains=arrays[f"gains/{key}"],
                         key=arrays[f"okey/{key}"], pmax=PMAX)
    dataset = type("D", (), dict(x_train=np.zeros((1, 1), np.float32),
                                 y_train=np.zeros(1, np.int32)))
    return fl._legacy_round(
        start, tuple([5, 0, 9][:k]), arrays[f"budgets/{key}"],
        arrays[f"aggw/{key}"], dataset, [[0]] * 10, FLConfig(**_round_cfg(case)),
        PAYLOAD, need_norms=True, model=LenetFLModel(), ota=ota_round,
    )


@pytest.mark.parametrize("key", [k for k in ROUNDS if "ota" not in k])
def test_legacy_dense_round_bit_equal_to_reference(reference, key,
                                                   monkeypatch):
    """The same deltas give the reference's new weights to the bit: each
    product w * d and each sum one float32 op, in client order, from 0."""
    arrays, want = reference
    new, bits, ratios, norms = _port_round(arrays, key, monkeypatch)
    got = flat(new, "")
    for name in LEAVES:
        np.testing.assert_array_equal(
            _bits(got[name]), _bits(want[f"round/{key}/{name}"]), err_msg=name)
    np.testing.assert_array_equal(np.asarray(bits, np.int64),
                                  want[f"bits/{key}"])
    np.testing.assert_array_equal(np.asarray(ratios, np.float64),
                                  want[f"ratios/{key}"])
    np.testing.assert_allclose(norms, want[f"norms/{key}"], rtol=L2_RTOL)
    if ROUNDS[key]["k"] == 0:
        for name in LEAVES:
            np.testing.assert_array_equal(got[name], arrays["p/" + name])
    elif ROUNDS[key]["compression"] == "adaptive":
        assert list(bits) == [4, 1, 32][:ROUNDS[key]["k"]]


@pytest.mark.parametrize("key", [k for k in ROUNDS if "ota" in k])
def test_legacy_ota_round_matches_reference(reference, key, monkeypatch):
    arrays, want = reference
    new, bits, ratios, _ = _port_round(arrays, key, monkeypatch)
    got = flat(new, "")
    for name in LEAVES:
        ref = want[f"round/{key}/{name}"]
        # an element where the noise cancels the weighted sum keeps the
        # absolute error of its terms: atol is rtol of the largest one
        np.testing.assert_allclose(got[name], ref, rtol=OTA_RTOL,
                                   atol=OTA_RTOL * np.abs(ref).max())
    assert list(bits) == [32] * 3 and list(ratios) == [1.0] * 3


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------

def _run_world(w):
    ds = make_mnist_like(num_samples=w["samples"], seed=0)
    cell = channel.CellConfig(num_devices=w["m"])
    shards = dirichlet_partition(ds.y_train, w["m"], seed=0)
    return ds, cell, shards


@pytest.mark.parametrize("key", list(RUNS))
def test_legacy_run_matches_reference(reference, key):
    _, out = reference
    want = {name[len(key) + 1:]: v for name, v in out.items()
            if name.startswith(key + "/")}
    w = _world_of(key)
    ds, cell, shards = _run_world(w)
    bundle = channel.ChannelBundle(
        want["distances"], want["gains"], want["dl_gains"])
    got = fl.run_federated_learning(
        ds, shards, cell, FLConfig(**_cfg_args(key)), channels=bundle,
        init_params=tree(want, "init/"), device="cpu",
    )
    assert_equal_runs(got, want, w["t"],
                      rate_ulp=RATE_ULP if key == "tdma" else 0)
    if key == "round-robin-tail":
        assert got.logs[-1].devices == () and got.logs[-1].bits.size == 0


def _port_run(w, **kw):
    ds, cell, shards = _run_world(w)
    cfg = FLConfig(**{**dict(num_devices=w["m"], group_size=w["k"],
                             num_rounds=w["t"], scheduler="lazy-gwmin",
                             power_mode="max", seed=0), **kw})
    return fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")


def _assert_engines_equal(a, b):
    """tests/test_fl_engine.py:_assert_equal_runs between two port runs."""
    assert [l.devices for l in a.logs] == [l.devices for l in b.logs]
    for la, lb in zip(a.logs, b.logs):
        np.testing.assert_array_equal(la.bits, lb.bits)
        np.testing.assert_array_equal(la.rates, lb.rates)
        np.testing.assert_array_equal(la.compression_ratios,
                                      lb.compression_ratios)
    np.testing.assert_array_equal(a.times(), b.times())
    np.testing.assert_allclose(a.accuracies(), b.accuracies(), atol=0.02)
    assert_param_drift(flat(a.final_params, ""), flat(b.final_params, ""))


@pytest.mark.parametrize("compression", ["adaptive", "none"])
@pytest.mark.parametrize("uplink", ["noma", "tdma"])
def test_legacy_driver_matches_batched_engine(uplink, compression):
    """The reference's engine-equality grid over its precomputed policy."""
    runs = [_port_run(WORLD, uplink=uplink, compression=compression,
                      fl_engine=engine) for engine in ("legacy", "batched")]
    _assert_engines_equal(*runs)


@pytest.mark.parametrize("uplink", ["noma", "tdma"])
def test_legacy_driver_matches_batched_engine_on_empty_tails(uplink):
    runs = [_port_run(TAIL, uplink=uplink, scheduler="round-robin",
                      fl_engine=engine) for engine in ("legacy", "batched")]
    assert runs[0].logs[-1].devices == () and runs[0].logs[-1].bits.size == 0
    _assert_engines_equal(*runs)


def test_legacy_full_evaluation_equals_the_engines():
    """The legacy loop's full-test-set accuracy is the batched engine's
    ``evaluate`` at eval_sample = 1.0, to the bit."""
    ds, _, shards = _run_world(TAIL)
    cfg = FLConfig(num_devices=4, group_size=2, num_rounds=3,
                   fl_engine="batched")
    engine = fl_engine.BatchedRoundEngine(ds, shards, cfg, PAYLOAD,
                                          device="cpu")
    params = _params(_numpy_params(4), "p/")
    acc = fl_engine._eval_full(
        params, torch.from_numpy(ds.x_test), torch.from_numpy(ds.y_test),
        model=LenetFLModel())
    assert float(acc) == engine.evaluate(params, 0) == engine.evaluate(params, 2)


def test_legacy_eval_every_keeps_the_last_accuracy_and_the_final_round():
    every = _port_run(WORLD, fl_engine="legacy", num_rounds=4)
    ds, cell, shards = _run_world(WORLD)
    cfg = FLConfig(num_devices=WORLD["m"], group_size=WORLD["k"],
                   num_rounds=4, power_mode="max", fl_engine="legacy")
    sparse = fl.run_federated_learning(ds, shards, cell, cfg, eval_every=2,
                                       device="cpu")
    a, b = every.accuracies(), sparse.accuracies()
    # rounds 0 and 2 evaluated, 1 and 3 carry the last value, except the
    # final round, which is always evaluated
    assert b[0] == a[0] and b[1] == a[0] and b[2] == a[2] and b[3] == a[3]


def test_quickstart_torch_runs_the_default_engine_on_the_cpu(capsys):
    """examples/quickstart_torch.py with ``--device cpu``: FLConfig's
    defaults (the legacy engine), six rounds, accuracy improves."""
    import os
    import runpy

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "quickstart_torch.py")
    runpy.run_path(path, run_name="quickstart_torch")["main"](
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 5:" in out and "engine legacy" in out
