"""The JAX package's records of the trainer runs that chip_smoke.py holds
the card to.

``tests/torch_reference/train_<name>.json`` records the reference's
``launch.train.main`` for each full-width ``[train:<name>]`` run (the
worker's ``--write-train-reference tests/torch_reference --arch NAME``):
each step's loss, the run that threw away one step's update beside it,
and both runs' final parameters at 512 sampled elements a leaf.  Here,
with nothing trained and nothing allocated:

- each record is whole: written by the stated command, its argv the
  worker's and a valid argv of the port's trainer, its depth cut the
  worker's and chip_smoke.py's;
- its losses are finite and fall, and the dropped run equals the sound
  run up to the dropped step and differs from it after;
- its sampled leaves are the port's leaves at that depth, every index
  inside its leaf;
- chip_smoke.py's limit for the run is one that the record's own dropped
  run leaves.
"""
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_harness import REPO, TESTS_DIR  # noqa: E402

sys.path.insert(0, REPO)

import _torch_reference_worker as worker  # noqa: E402
import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils.tree import tree_flatten_with_paths  # noqa: E402

NAMES = list(worker.TRAIN_ARCH_RECORDS)
SAMPLES = 512


def _record(name):
    path = os.path.join(TESTS_DIR, "torch_reference", f"train_{name}.json")
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _abstract_leaves(argv, num_layers):
    """{path: element count} of the port's parameters for ``argv`` at
    ``num_layers`` layers (None: the config's own), from the schema
    alone."""
    import dataclasses

    args = train.parser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return {path: int(np.prod(leaf.shape)) for path, leaf in
            tree_flatten_with_paths(build_model(cfg).abstract())}


def test_every_record_is_one_of_the_runs():
    """The per-run train files are exactly the worker's runs and
    chip_smoke.py's, in the same order and at the same depths."""
    files = sorted(f[len("train_"):-len(".json")] for f in os.listdir(
        os.path.join(TESTS_DIR, "torch_reference"))
        if f.startswith("train_") and f.endswith(".json")
        and not f.startswith("train_losses"))
    assert files == sorted(NAMES)
    assert [(name, layers) for name, (_, layers)
            in worker.TRAIN_ARCH_RECORDS.items()] \
        == list(chip_smoke.TRAIN_ARCH_RUNS)


@pytest.mark.parametrize("name", NAMES)
def test_record_is_the_workers_run(name):
    """Written by the stated command, under 500 kB; argv and depth the
    worker's; argv parses with the port's trainer: seed 0, 4-bit uplink
    (error feedback in the -ef run only), published widths."""
    path = os.path.join(TESTS_DIR, "torch_reference", f"train_{name}.json")
    assert os.path.getsize(path) < 500_000
    record = _record(name)
    argv, layers = worker.TRAIN_ARCH_RECORDS[name]
    assert record["_command"] == (
        "PYTHONPATH=src JAX_PLATFORMS=cpu python "
        "tests/_torch_reference_worker.py --write-train-reference "
        f"tests/torch_reference --arch {name}")
    assert record["name"] == name and record["argv"] == argv
    assert record["num_layers"] == layers
    assert record["dropped_step"] == worker.TRAIN_DROPPED_STEP
    args = train.parser().parse_args(record["argv"])
    assert not args.smoke and args.seed == 0 and args.fl_bits == 4
    assert args.ef == name.endswith("-ef") and not args.no_fl
    assert layers is None or layers < get_config(args.arch).num_layers


@pytest.mark.parametrize("name", NAMES)
def test_record_losses_fall_and_the_dropped_run_parts_at_its_step(name):
    record = _record(name)
    args = train.parser().parse_args(record["argv"])
    losses = np.asarray(record["losses"])
    wrong = np.asarray(record["dropped_losses"])
    drop = record["dropped_step"]
    assert losses.shape == wrong.shape == (args.steps,)
    assert np.all(np.isfinite(losses)) and np.all(np.isfinite(wrong))
    assert losses[-1] < losses[0]
    np.testing.assert_array_equal(wrong[:drop], losses[:drop])
    assert np.all(wrong[drop:] != losses[drop:])


@pytest.mark.parametrize("name", NAMES)
def test_record_samples_are_the_ports_leaves(name):
    """The sampled leaves are the port's at the record's depth (paths and
    sizes from the schema); each leaf's indices are the worker's draw
    for a leaf of the port's size (every index of a leaf of at most 512
    elements, else 512 drawn without repeats by ``default_rng(0)``), which
    no leaf of another size gives; both runs' values finite, and the
    dropped run's differ somewhere."""
    record = _record(name)
    sizes = _abstract_leaves(record["argv"], record["num_layers"])
    final = record["final"]
    assert final.keys() == sizes.keys()
    moved = 0
    for path, rec in final.items():
        idx = np.asarray(rec["index"])
        n = sizes[path]
        want = (np.arange(n) if n <= SAMPLES else np.sort(
            np.random.default_rng(0).choice(n, SAMPLES, replace=False)))
        np.testing.assert_array_equal(idx, want, err_msg=path)
        values = np.asarray(rec["values"])
        dropped = np.asarray(rec["dropped"])
        assert values.shape == dropped.shape == idx.shape
        assert np.all(np.isfinite(values)) and np.all(np.isfinite(dropped))
        moved += int(np.any(values != dropped))
    assert moved > 0


@pytest.mark.parametrize("name", NAMES + ["mamba2-130m",
                                          "mixtral-8x22b-smoke"])
def test_card_limits_are_left_by_the_records_dropped_run(name):
    """chip_smoke.py holds the run by a loss limit, and by a drift limit
    where it has one; the record's own dropped run leaves the drift limit
    and the loss limit (but in TRAIN_LOSS_BLIND's runs, which a drift
    limit holds)."""
    record = chip_smoke.train_record(name)
    assert name in chip_smoke.TRAIN_LOSS_LIMITS
    if name in chip_smoke.TRAIN_DRIFT_LIMITS:
        final = record["final"]
        wrong = chip_smoke._sampled_drift(
            {p: r["dropped"] for p, r in final.items()}, final)
        assert wrong > chip_smoke.TRAIN_DRIFT_LIMITS[name]
    else:
        assert name not in chip_smoke.TRAIN_LOSS_BLIND
    if name not in chip_smoke.TRAIN_LOSS_BLIND:
        wrong = max(abs(a - b) / abs(b) for a, b in zip(
            record["dropped_losses"], record["losses"]))
        assert wrong > chip_smoke.TRAIN_LOSS_LIMITS[name]


@pytest.mark.parametrize("name", ["mamba2-130m", "mixtral-8x22b-smoke"])
def test_earlier_runs_read_their_shared_record(name):
    """Mamba2-130M and the SMOKE Mixtral keep their runs in
    train_losses.json, read whole depth with its dropped step."""
    record = chip_smoke.train_record(name)
    with open(os.path.join(TESTS_DIR, "torch_reference", "train_losses.json"),
              encoding="utf-8") as fh:
        shared = json.load(fh)
    assert record["num_layers"] is None
    assert record["dropped_step"] == shared["dropped_step"]
    assert record["losses"] == shared["runs"][name]["losses"]
    assert record["argv"] == shared["runs"][name]["argv"]
