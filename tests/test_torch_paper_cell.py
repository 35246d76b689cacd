"""The paper's own experiment cell (M=300, K=3, T=35, 12,000 samples, seed
0, no ``--fast``) through the port's example twin, against the record the
reference's ``examples/fl_noma_mnist.py`` wrote:
tests/torch_reference/paper_cell.json, its command in the file
(``_torch_reference_worker.py --write-paper-cell-reference``).

The record holds four runs (``PAPER_CELL_RUNS``): NOMA with MAPEL, lazy
GWMIN and adaptive DoReFa through kernel #1 (``--pallas-agg``), Fig. 5's
TDMA baseline, OTA with receiver noise 1e-9 through the keyed #2, and the
legacy round body.  Contract (tests/test_fl_engine.py:_assert_equal_runs
without the drift, which at this cell is F1's business, ROADMAP.md queue
3): devices, bits, rates, compression ratios and simulated times equal to
the record, of the record's types, TDMA's rates and ratios within 2
float32 ulps (XLA's float32 log, queue 3); accuracy within 0.02 in every
round.  The port's CPU runs the NOMA and OTA argv here (~5 s each alone);
chip_smoke.py's ``[paper-cell]`` runs all four on the card.  A run from
another seed is rejected: its schedule is not the record's.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_harness import (  # noqa: E402,F401
    ACC_ATOL, TESTS_DIR, _ulps, load_example, one_torch_thread,
)
from _torch_reference_worker import PAPER_CELL_RUNS  # noqa: E402

RECORD = os.path.join(TESTS_DIR, "torch_reference", "paper_cell.json")
TDMA_RATE_ULP = 2


@pytest.fixture(scope="module")
def record():
    with open(RECORD, encoding="utf-8") as fh:
        return json.load(fh)


def _run_twin(argv):
    twin = load_example("fl_noma_mnist_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        return twin.main(list(argv) + ["--device", "cpu"])


def assert_matches_record(res, run):
    """One run's logs against its record (the module's contract)."""
    rounds = run["rounds"]
    assert len(res.logs) == len(rounds)
    ulp = TDMA_RATE_ULP if run["cfg"]["uplink"] == "tdma" else 0
    for log, want in zip(res.logs, rounds):
        t = log.round
        assert list(log.devices) == want["devices"], f"round {t} devices"
        assert log.bits.tolist() == want["bits"], f"round {t} bits"
        for field, key in (("rates", "rates"),
                           ("compression_ratios", "ratios")):
            got = np.asarray(getattr(log, field))
            assert str(got.dtype) == run["dtypes"][key], (t, field)
            if ulp:
                assert _ulps(got, want[key]).max(initial=0) <= ulp, (t, field)
            else:
                np.testing.assert_array_equal(
                    got.astype(np.float64), want[key], err_msg=f"{t} {field}")
        assert str(log.bits.dtype) == run["dtypes"]["bits"]
        assert log.wall_time_s == want["time"], f"round {t} time"
    np.testing.assert_allclose(res.accuracies(),
                               [w["acc"] for w in rounds], atol=ACC_ATOL)


def test_the_record_holds_the_paper_cell(record):
    """Four runs of the reference example at M=300, K=3, T=35, 12,000
    samples, seed 0, each with its argv and the config its ``main`` built
    from it; every round schedules 3 devices, times grow and the final
    accuracy is the paper's regime."""
    assert "--write-paper-cell-reference" in record["_command"]
    runs = record["runs"]
    assert {k: v["argv"] for k, v in runs.items()} == PAPER_CELL_RUNS
    for name, run in runs.items():
        cfg = run["cfg"]
        assert (cfg["num_devices"], cfg["group_size"], cfg["num_rounds"],
                cfg["seed"], run["samples"]) == (300, 3, 35, 0, 12_000)
        assert cfg["fl_engine"] == ("legacy" if name == "legacy"
                                    else "batched")
        assert cfg["use_pallas"] == ("--pallas-agg" in run["argv"])
        assert cfg["uplink"] == {"tdma": "tdma", "ota": "ota"}.get(
            name, "noma")
        assert cfg["ota_noise"] == (1e-9 if name == "ota" else 0.0)
        rounds = run["rounds"]
        assert len(rounds) == 35
        assert all(len(r["devices"]) == len(r["bits"]) == 3 for r in rounds)
        times = [r["time"] for r in rounds]
        assert all(b > a for a, b in zip(times, times[1:]))
        assert 0.9 < rounds[-1]["acc"] <= 1.0
        assert run["stdout"][0].startswith("M=300 K=3 T=35 ")


@pytest.mark.parametrize("name", ["noma", "ota"])
def test_the_ports_cpu_run_matches_the_record(record, name):
    run = record["runs"][name]
    assert_matches_record(_run_twin(run["argv"]), run)


def test_another_seeds_run_is_rejected(record):
    """``--seed 1`` draws other channels: its schedule is not the
    record's, and the check says so at the first round."""
    run = record["runs"]["noma"]
    res = _run_twin(run["argv"] + ["--seed", "1"])
    with pytest.raises(AssertionError, match="round 0 devices"):
        assert_matches_record(res, run)
