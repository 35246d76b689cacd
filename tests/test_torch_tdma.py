"""The port's TDMA uplink (the paper's Fig. 5 baseline) against the JAX
package's.

The reference computes the TDMA rates with jnp outside any jit and without
x64, so in float32, and its float32 ``log`` (``log2(x)`` lowers to ``log(x)
* 1.44269502f``) is not correctly rounded.  The port takes the log in
float64 and rounds it to float32, so its rates are within RATE_ULP ulp of
the reference's, not bit-equal (ROADMAP.md queue 3).  The budgets, bit
widths and compression ratios follow from the rates: bits are held exactly
(a rate one ulp off moving a width across a floor would be a fault), ratios
within the same ulp bound as the rates.

Whole runs go through the shimmed subprocess of test_torch_harness, both
power modes in one call, under tests/test_fl_engine.py:_assert_equal_runs
otherwise: schedules, bits and times exact; accuracy within 0.02;
parameter drift mean < 1e-6, max < 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from test_torch_harness import (  # noqa: E402,F401
    _ulps, assert_equal_runs, one_torch_thread, run_reference, tree,
)

from repro.core import noma as ref_noma  # noqa: E402
from repro.core import quantization as ref_qlib  # noqa: E402

from repro_torch.config import FLConfig  # noqa: E402
from repro_torch.core import channel, fl, noma  # noqa: E402
from repro_torch.core import quantization as qlib  # noqa: E402
from repro_torch.data import dirichlet_partition, make_mnist_like  # noqa: E402
from repro_torch.models import lenet  # noqa: E402

RATE_ULP = 2
PAYLOAD = lenet.NUM_PARAMS * 32


@pytest.mark.parametrize("powers", ["pmax", "uniform"])
def test_tdma_rates_within_two_ulp_of_reference(powers):
    """The paper cell's channels (M=300, T=35): rates within 2 ulp, and
    the adaptive bit widths of the resulting budgets equal."""
    cell = channel.CellConfig()
    gains = channel.sample_channels(0, cell, 35).gains
    rng = np.random.default_rng(1)
    if powers == "pmax":
        p = np.full(gains.shape, cell.max_power_w)
    else:
        p = rng.uniform(0.0, cell.max_power_w, gains.shape)
    got = noma.tdma_rates(p, gains, cell.noise_power_w)
    want = np.asarray(ref_noma.tdma_rates(
        jnp.asarray(p), jnp.asarray(gains), cell.noise_power_w))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == gains.shape
    assert _ulps(got, want).max() <= RATE_ULP
    scale = cell.bandwidth_hz * cell.slot_seconds
    got_bits = qlib.adaptive_bits(PAYLOAD, torch.from_numpy(
        (got * scale).astype(np.float64)))
    want_bits = ref_qlib.adaptive_bits(PAYLOAD, jnp.asarray(want * scale))
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))


def test_tdma_round_physics():
    """One sub-slot per scheduled device; an empty round costs the
    downlink only; float32 rates and budgets."""
    cell = channel.CellConfig(num_devices=4)
    gains = np.full((2, 4), 1e-6)
    powers = np.full(2, cell.max_power_w)
    rates, budgets, t = fl._round_physics(
        (0, 3), powers, None, 1, gains, cell, "tdma", 0.5)
    assert rates.dtype == budgets.dtype == np.float32
    np.testing.assert_array_equal(
        budgets, rates * cell.bandwidth_hz * cell.slot_seconds)
    assert t == 2 * cell.slot_seconds + 0.5
    rates, budgets, t = fl._round_physics(
        (), np.zeros(0), None, 0, gains, cell, "tdma", 0.5)
    assert rates.shape == budgets.shape == (0,) and t == 0.5


WORLD = dict(m=12, samples=800, k=3, t=3)
POWER_MODES = ("mapel", "max")


def _cfg_args(power_mode):
    return dict(
        num_devices=WORLD["m"], group_size=WORLD["k"],
        num_rounds=WORLD["t"], scheduler="lazy-gwmin", fl_engine="batched",
        use_pallas=True, uplink="tdma", compression="adaptive",
        power_mode=power_mode, seed=0,
    )


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("tdma"), "fl_runs", {"runs": [
        dict(key=mode, num_devices=WORLD["m"], num_samples=WORLD["samples"],
             cfg=_cfg_args(mode)) for mode in POWER_MODES
    ]})


@pytest.mark.parametrize("power_mode", POWER_MODES)
def test_tdma_run_matches_reference(reference_runs, power_mode):
    want = {name[len(power_mode) + 1:]: v
            for name, v in reference_runs.items()
            if name.startswith(power_mode + "/")}
    ds = make_mnist_like(num_samples=WORLD["samples"], seed=0)
    cell = channel.CellConfig(num_devices=WORLD["m"])
    shards = dirichlet_partition(ds.y_train, WORLD["m"], seed=0)
    bundle = channel.ChannelBundle(
        want["distances"], want["gains"], want["dl_gains"])
    got = fl.run_federated_learning(
        ds, shards, cell, FLConfig(**_cfg_args(power_mode)), channels=bundle,
        init_params=tree(want, "init/"), device="cpu",
    )
    assert_equal_runs(got, want, WORLD["t"], rate_ulp=RATE_ULP)
