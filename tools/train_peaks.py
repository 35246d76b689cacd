"""Trainer runs on the card, for this tree's trainer or another's, each
through ``chip_smoke.py``'s ``run_train_phase``.

    python3 tools/train_peaks.py [--root DIR] [--wrong KIND] NAME ...

Each NAME is a trainer run with a record (``chip_smoke.train_record``):
its argv and depth cut are the record's.  Per run, ``run_train_phase``'s
line (seconds per step over the run and over steps 2 on, each step timed
with the card synchronised on both sides; the peak of ``torch.cuda.
max_memory_allocated``, reset before the run; #5's and Threefry's
launches), then each step's loss gap to the record, relative, and, where
the record samples the final parameters, the worst leaf's mean drift over
the samples beside the record's dropped run's, and each leaf's.  A run
that runs out of device memory is reported and the next one starts.

``--root DIR`` imports ``repro_torch`` from ``DIR/src`` (a ``git archive``
of another commit), so two trainers are compared on one card: run the
script once per tree, in turns (parent, change, change, parent), in one
call.  ``--wrong KIND`` runs each NAME under ``chip_smoke.moe_wrong_run``
(``aux``: the load-balance loss's gradient cut; ``capacity``: each
expert's buffer one slot short).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+")
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--wrong", choices=("aux", "capacity"))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    # the package is bound before chip_smoke puts this tree's src first
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch  # noqa: F401

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.utils.tree import tree_flatten_with_paths

    resolve_device("cuda")
    cs.CARD = cs._smi_line()
    print(f"trainer of {root} on {cs.CARD}", flush=True)
    for name in args.names:
        want, seen = cs.train_record(name), {}
        label = name + (f":{args.wrong}" if args.wrong else "")
        wrong = (cs.moe_wrong_run(args.wrong) if args.wrong
                 else contextlib.nullcontext())
        torch.cuda.empty_cache()
        try:
            with cs.train_depth(want["num_layers"]), wrong:
                losses = cs.run_train_phase(label, want["argv"], seen)
        except cs.SmokeFailure as err:
            print(err, flush=True)
            continue
        gaps = cs._loss_gaps(losses, want)
        line = (f"[{label}] loss gap to the record {max(gaps):.3g} at "
                f"worst, by step {[float(f'{x:.2g}') for x in gaps]}")
        if "final" in want:
            params = dict(tree_flatten_with_paths(seen.pop("params")))
            card = {path: params[path].reshape(-1)[torch.tensor(
                rec["index"], device=params[path].device)].double().cpu()
                for path, rec in want["final"].items()}
            dropped = {path: rec["dropped"]
                       for path, rec in want["final"].items()}
            drift = {path: cs._sampled_drift({path: card[path]},
                                             {path: want["final"][path]})
                     for path in card}
            by_leaf = {k: float(f"{v:.3g}") for k, v in drift.items()}
            line += (f"; final drift {max(drift.values()):.3g} (the record's "
                     f"dropped run: "
                     f"{cs._sampled_drift(dropped, want['final']):.3g}), by "
                     f"leaf {by_leaf}")
        del seen
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
