"""The LLM trainer with the paper's FL compression in the loop: the port of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 50 --fl-bits 8 [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  Each step: a synthetic
token batch -> forward / backward -> DoReFa-quantized gradients with the
bits of the NOMA rate model (one simulated round per step, the K = 3 best
channels standing in for the clients) -> AdamW.  The families the
reference's registry runs but for encdec and vlm (ROADMAP.md item 8d).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import channel as chan
from repro_torch.core import noma
from repro_torch.core import prng
from repro_torch.core import quantization as qlib
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.utils.tree import tree_count

K_CLIENTS = 3


def fl_bits_schedule(key, payload_bits: float, n_rounds: int,
                     cell: chan.CellConfig) -> np.ndarray:
    """Per-round uplink bit widths from the NOMA rate model, the
    reference's: positions drawn under ``key``, fading under ``fold_in(key,
    1)``; each round schedules the K = 3 best gains at full power and takes
    the *minimum* scheduled budget (synchronous aggregation waits for the
    slowest client), in float32."""
    dist = chan.sample_positions(key, cell)
    gains = chan.sample_round_channels(prng.fold_in(key, 1), dist, cell,
                                       n_rounds)
    bits = []
    for t in range(n_rounds):
        top = torch.sort(torch.from_numpy(gains[t])).values[-K_CLIENTS:]
        powers = torch.full((K_CLIENTS,), cell.max_power_w,
                            dtype=torch.float32)
        budget = noma.bit_budget(powers, top, cell.noise_power_w,
                                 cell.bandwidth_hz, cell.slot_seconds)
        b = qlib.adaptive_bits(payload_bits, torch.min(budget))
        bits.append(int(b))
    return np.array(bits)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fl-bits", type=int, default=None,
                    help="fixed uplink bits; default: adaptive from NOMA model")
    ap.add_argument("--no-fl", action="store_true", help="disable compression")
    ap.add_argument("--ef", action="store_true",
                    help="error-feedback quantization (beyond-paper; residual "
                         "compensation, fixed --fl-bits required)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, help="checkpoint path (saved at end)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="also checkpoint every N steps")
    ap.add_argument("--resume", default=None, help="checkpoint path to resume")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    key = prng.prng_key(args.seed)
    params = model.init(key, device=device)
    start_step = 0
    n_params = tree_count(params)
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M family={cfg.family}")

    opt = adamw(linear_warmup_cosine(args.lr, 10, args.steps))
    if args.ef:
        from repro_torch.core.compression import error_feedback_optimizer

        assert args.fl_bits is not None, "--ef needs a fixed --fl-bits"
        opt = error_feedback_optimizer(opt, args.fl_bits)
    opt_state = opt.init(params)

    if args.resume:
        from repro_torch.checkpoint import load_checkpoint

        ckpt = load_checkpoint(args.resume, device=device)
        assert ckpt["arch"] == cfg.name, (ckpt["arch"], cfg.name)
        params, opt_state = ckpt["params"], ckpt["opt_state"]
        start_step = int(ckpt["step"])
        print(f"resumed from {args.resume} at step {start_step}")

    if args.no_fl:
        bits_per_round = np.full(args.steps, 32)
    elif args.fl_bits is not None:
        bits_per_round = np.full(args.steps, args.fl_bits)
    else:
        cell = chan.CellConfig()
        bits_per_round = fl_bits_schedule(
            prng.fold_in(key, 99), n_params * 32, args.steps, cell
        )
        print("adaptive fl bits:", bits_per_round[:10], "...")

    step_cache = {}

    def get_step(bits):
        # with --ef the quantization lives inside the optimizer wrapper
        eff = None if (args.ef or bits >= 32) else int(bits)
        if bits not in step_cache:
            step_cache[bits] = steps_lib.make_train_step(model, opt,
                                                         fl_bits=eff)
        return step_cache[bits]

    def save(path, step):
        from repro_torch.checkpoint import save_checkpoint

        save_checkpoint(path, {"arch": cfg.name, "step": step,
                               "params": params, "opt_state": opt_state})
        print(f"checkpoint -> {path} (step {step})")

    data = synthetic_token_batches(cfg.vocab_size, args.batch, args.seq,
                                   seed=args.seed)
    # keep the data stream aligned with the step counter on resume
    for _ in range(start_step):
        next(data)
    losses = []
    t0 = time.time()
    for i in range(start_step, args.steps):
        tokens, labels = next(data)
        batch = {"tokens": torch.from_numpy(tokens).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        params, opt_state, loss = get_step(int(bits_per_round[i]))(
            params, opt_state, batch)
        losses.append(float(loss))
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} bits {bits_per_round[i]}")
        if args.save_every and (i + 1) % args.save_every == 0 and args.save:
            save(args.save, i + 1)

    dt = time.time() - t0
    if losses:
        print(f"done: {args.steps} steps in {dt:.1f}s; "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if losses and losses[-1] >= losses[0]:
        print("WARNING: loss did not improve (expected for very low fl-bits "
              "or very short runs)")
    if args.save:
        save(args.save, args.steps)
    return losses


if __name__ == "__main__":
    main()
