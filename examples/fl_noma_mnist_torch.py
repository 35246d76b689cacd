"""Paper §IV experiment driver on the PyTorch port: M=300 devices, K=3 per
round, T=35 rounds, LeNet-300-100, non-iid data, the Fig. 5 / Fig. 6
settings.  The twin of examples/fl_noma_mnist.py: the same flags, defaults
and printed lines, plus ``--device``.

    PYTHONPATH=src python examples/fl_noma_mnist_torch.py [--fast] \
        [--scheduler NAME] [--power mapel|max|ota-align] \
        [--uplink noma|tdma|ota] [--ota-noise STD] [--ota-threshold FRAC] \
        [--engine batched|legacy] [--pallas-agg] \
        [--horizon per-round|scan] [--seeds N] [--seed S] \
        [--model NAME] [--topk FRAC] [--sanitize-nans] [--device cuda|cpu]

It runs on the CUDA card unless given ``--device cpu``; seed s draws the
data, the channels and the initial weights the reference draws from seed
s.  ``--scheduler`` takes any policy of ``repro_torch.core.scheduling``;
``--uplink ota`` forces ``compression="none"`` and ``topk=1.0`` (the
analog sum decodes no per-device payload) and, as an online scheduler
under ``--horizon scan`` does, defaults ``--power`` to ``max``;
``--pallas-agg`` aggregates through the hand-written kernels (#1, or the
keyed #2 under OTA); ``--seeds N`` sweeps seeds S..S+N-1 through
``fl.run_horizon_vmapped`` and implies ``--horizon scan``; ``--model``
takes ``lenet`` or a token payload (``tiny-transformer``, an arch id,
``<id>:smoke``), trained on the synthetic next-token corpus;
``--sanitize-nans`` runs under ``repro_torch.utils.sanitizers.nan_guard``:
the first op or kernel that makes a NaN raises ``FloatingPointError``.
--fast runs M=60, T=10.

``main(argv)`` returns what it ran: the ``FLResult``, or the list of them
under ``--seeds``.
"""
import argparse
import contextlib

import numpy as np

from repro_torch.config import FLConfig
from repro_torch.core import channel, fl, ota, scheduling
from repro_torch.data import dirichlet_partition, make_mnist_like
from repro_torch.data.tokens import make_token_dataset
from repro_torch.models.fl_models import get_fl_model
from repro_torch.utils.sanitizers import nan_guard


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--scheduler", default="lazy-gwmin",
                    choices=scheduling.available_policies())
    ap.add_argument("--power", default=None,
                    help="power mode (default mapel; ota uplink defaults "
                         "to max, as does an online scheduler under "
                         "--horizon scan)")
    ap.add_argument("--uplink", default="noma", choices=ota.UPLINK_MODES)
    ap.add_argument("--ota-noise", type=float, default=0.0,
                    help="OTA receiver noise std (uplink=ota; 0 = exact "
                         "weighted aggregate)")
    ap.add_argument("--ota-threshold", type=float, default=0.0,
                    help="truncated channel inversion: devices below this "
                         "fraction of the round's best gain sit out")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--engine", default="batched",
                    choices=["legacy", "batched"])
    ap.add_argument("--pallas-agg", action="store_true",
                    help="aggregate through the hand-written CUDA kernels")
    ap.add_argument("--horizon", default="per-round",
                    choices=["per-round", "scan"],
                    help="scan: the whole horizon from device tensors "
                         "(precomputed schedules and online policies)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="sweep N seeds in one stacked horizon "
                         "(implies --horizon scan)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="lenet",
                    help="FL payload (FLConfig.model): lenet, "
                         "tiny-transformer, tiny-transformer-1m, or an "
                         "arch id ('<id>' / '<id>:smoke')")
    ap.add_argument("--topk", type=float, default=1.0,
                    help="top-k sparsification cap before DoReFa "
                         "(fraction of coordinates kept; 1.0 = dense; "
                         "batched engine / scan horizon only)")
    ap.add_argument("--sanitize-nans", action="store_true",
                    help="run under nan_guard: a NaN anywhere in the FL "
                         "math raises FloatingPointError at the source; "
                         "slow, debug only")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.seeds is not None:
        args.horizon = "scan"
    if args.power is None:
        online_scan = (args.horizon == "scan"
                       and scheduling.policy_is_online(args.scheduler))
        args.power = ("max" if args.uplink == "ota" or online_scan
                      else "mapel")

    m = 60 if args.fast else 300              # paper: M = 300
    t = args.rounds or (10 if args.fast else 35)  # paper: T = 35

    model = get_fl_model(args.model)
    if model.kind == "tokens":
        # the synthetic next-token corpus, Dirichlet-partitioned by the
        # rows' pseudo-class as the image path is by label
        ds = make_token_dataset(
            vocab_size=model.cfg.vocab_size,
            num_samples=4000 if args.fast else 12_000,
            seq_len=16, seed=args.seed)
        part_labels = ds.class_train
    else:
        ds = make_mnist_like(num_samples=4000 if args.fast else 12_000,
                             seed=args.seed)
        part_labels = ds.y_train
    cell = channel.CellConfig(num_devices=m)   # paper §IV cell parameters
    shards = dirichlet_partition(part_labels, m, seed=args.seed)
    # the analog sum never decodes per-device payloads: DoReFa and top-k
    # cannot apply under OTA
    compression = "none" if args.uplink == "ota" else "adaptive"
    topk = 1.0 if args.uplink == "ota" else args.topk
    cfg = FLConfig(num_devices=m, group_size=3, num_rounds=t,
                   learning_rate=0.01, batch_size=10,   # Table I
                   scheduler=args.scheduler, power_mode=args.power,
                   compression=compression, fl_engine=args.engine,
                   use_pallas=args.pallas_agg, horizon=args.horizon,
                   model=args.model, topk=topk, uplink=args.uplink,
                   ota_noise=args.ota_noise, ota_threshold=args.ota_threshold,
                   seed=args.seed)

    online = scheduling.get_policy(args.scheduler).online
    print(f"M={m} K=3 T={t} scheduler={args.scheduler} power={args.power} "
          f"uplink={args.uplink} engine={args.engine} "
          f"horizon={args.horizon} model={args.model} "
          f"{'topk=' + format(args.topk, '.2f') + ' ' if args.topk < 1 else ''}"
          f"mode={'online (live)' if online else 'precomputed'}")

    guard = nan_guard() if args.sanitize_nans else contextlib.nullcontext()
    with guard:
        if args.seeds is not None:
            sweep = fl.run_horizon_vmapped(
                ds, shards, cell, cfg,
                seeds=range(args.seed, args.seed + args.seeds),
                uplink=args.uplink, device=args.device)
            finals = np.array([r.accuracies()[-1] for r in sweep])
            for i, r in enumerate(sweep):
                print(f"seed {args.seed + i}: final acc "
                      f"{r.accuracies()[-1]:.3f} "
                      f"sim time {r.times()[-1]:6.1f}s")
            print(f"\n{args.seeds} seeds: final acc {finals.mean():.3f} "
                  f"+/- {finals.std():.3f}")
            return sweep

        res = fl.run_federated_learning(
            ds, shards, cell, cfg, uplink=args.uplink, device=args.device,
            progress=lambda log: print(
                f"round {log.round:3d} acc={log.test_accuracy:.3f} "
                f"bits={log.bits.tolist()} t={log.wall_time_s:6.1f}s"))
    accs = res.accuracies()
    print(f"\nfinal acc {accs[-1]:.3f}; mean-last-5 "
          f"{np.mean(accs[-5:]):.3f}; total sim time {res.times()[-1]:.1f}s")
    return res


if __name__ == "__main__":
    main()
