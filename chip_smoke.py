"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(on PATH, under CUDA_HOME or /usr/local/cuda) and PyTorch built for CUDA.
It imports the port (``src/repro_torch``) and nothing of JAX or of the JAX
package, and exits non-zero on the first failure.  Phases:

  1. a CUDA card is present (else exit 2, printing no result);
  2. every kernel of the main path builds from the checkout's sources
     (``nvcc`` into ``build/``);
  3. each kernel is held against its plain PyTorch version on the card over
     a sweep of shapes and code types (rtol 1e-5, atol 1e-6, the
     tolerance of tests/test_kernels.py);
  4. each kernel is timed at the main path's shapes beside its plain
     version, one PyTorch library call computing the same function, and
     the least time the card could take (its bound);
  5. the main path — ``repro_torch.core.fl.run_federated_learning`` at
     paper width (M=300 devices, K=3, LeNet-300-100 on 12,000 samples,
     MAPEL, lazy GWMIN, adaptive DoReFa, batched engine with the kernel) —
     runs on the card; launch counts show it went through the kernels;
  6. the same run at M=30 on the CPU and on the card agree (schedules, bits,
     rates, ratios and times exactly; accuracy within 0.02; parameter drift
     within the bounds of tests/test_fl_engine.py:_assert_equal_runs).

The last lines are the card's name and power limit as nvidia-smi reports
them, one JSON object with every kernel's numbers, and the one-line result
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
LENET_LEAVES = (235_200, 300, 30_000, 100, 1_000, 10)
SWEEP_K = (1, 3, 8)
SWEEP_N = (1, 10, 300, 30_000, 235_200, 2_200_000)
RTOL, ATOL = 1e-5, 1e-6
ACC_ATOL, PARAM_MEAN_ATOL, PARAM_MAX_ATOL = 0.02, 1e-6, 2e-2


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# kernels: build, compare, time
# --------------------------------------------------------------------------

def kernels_of_main_path():
    """Every kernel the main path runs, with its wrapper and metadata."""
    from repro_torch.kernels import aggregate

    return [dict(
        name="weighted_aggregate",
        route="cuda",
        source="src/repro_torch/kernels/csrc/aggregate.cu",
        replaces="src/repro/kernels/aggregate.py:74",
        wrapper=aggregate.weighted_aggregate,
        module=aggregate,
    )]


def build_kernels(kernels):
    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    for kern in kernels:
        path = cuda_build.build(kern["module"].KERNEL)
        log(f"[build] {kern['name']}: {os.path.relpath(path, REPO)}")
    for kern in kernels:
        kern["module"]._library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")


def _aggregate_case(k, n, dtype, gen):
    """Inputs shaped like the main path's: DoReFa codes in [-a_k, a_k]
    (int32 at 4 bits, or float32-held at per-client widths up to 32),
    max-abs scales and FedAvg weights that sum to one."""
    dev = torch.device("cuda")
    if dtype == torch.int32:
        bits = torch.full((k,), 4)
    else:
        bits = torch.randint(1, 33, (k,), generator=gen)
    levels = torch.pow(torch.full((k,), 2.0), bits.float()) - 1.0
    x = torch.clamp(torch.randn(k, n, generator=gen) / 3.0, -1.0, 1.0)
    codes = torch.round(levels[:, None] * x).to(dtype)
    scales = torch.rand(k, generator=gen) * 1.5 + 0.5
    w = torch.rand(k, generator=gen)
    w = w / w.sum() if k else w
    return codes.to(dev), scales.to(dev), w.to(dev), levels.to(dev)


def compare_aggregate(mod):
    """Kernel vs plain version on the card over the sweep; returns the
    largest absolute difference."""
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    cases = [(k, n) for k in SWEEP_K for n in SWEEP_N] + [(0, 300), (3, 0)]
    for dtype in (torch.float32, torch.int32):
        for k, n in cases:
            codes, scales, w, levels = _aggregate_case(k, n, dtype, gen)
            if dtype == torch.int32:
                got = mod.weighted_aggregate(codes, scales, w, 4)
            else:
                got = mod.weighted_aggregate(codes, scales, w, levels=levels)
            want = (
                mod.weighted_aggregate_plain(
                    codes, mod.coefficients(scales, w, levels)
                ) if k and n else torch.zeros(n, device="cuda")
            )
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.device.type == "cuda",
                  f"aggregate shape {tuple(got.shape)} at K={k} n={n}")
            err = (got - want).abs()
            tol = ATOL + RTOL * want.abs()
            check(bool(torch.all(err <= tol)),
                  f"aggregate disagrees at K={k} n={n} {dtype}: "
                  f"max err {err.max().item() if n else 0.0}")
            if n:
                worst = max(worst, err.max().item())
    log(f"[compare] weighted_aggregate: {2 * len(cases)} cases ok, "
        f"max abs err {worst!r}")
    return worst


def _time_ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_aggregate(mod, k=3):
    """Per-round times at the main path's shapes: the six LeNet leaves at
    K=3, float32-held codes.  Kernel, plain version and ``torch.einsum``
    (the yardstick library call) on the same inputs, interleaved
    plain/kernel/kernel/plain.  Each time is the mean of back-to-back
    calls, host launch cost included, with the inputs warm in L2 as the
    main path leaves them; returns summed per-round milliseconds."""
    gen = torch.Generator().manual_seed(1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for n in LENET_LEAVES:
        codes, scales, w, levels = _aggregate_case(k, n, torch.float32, gen)
        coeff = mod.coefficients(scales, w, levels)
        counted = mod.weighted_aggregate.launches
        plain = _time_ms(lambda: mod.weighted_aggregate_plain(codes, coeff))
        kern = _time_ms(lambda: mod._launch(codes, coeff))
        kern = 0.5 * (kern + _time_ms(lambda: mod._launch(codes, coeff)))
        plain = 0.5 * (plain + _time_ms(
            lambda: mod.weighted_aggregate_plain(codes, coeff)))
        lib = _time_ms(lambda: torch.einsum("k,kn->n", coeff, codes))
        mod.weighted_aggregate.launches = counted   # timing launches don't count
        nbytes = (k + 1) * n * 4 + k * 4            # codes + coeff in, out
        flops = 2 * k * n
        bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
        log(f"[time] weighted_aggregate K={k} n={n}: kernel {kern * 1e3:.3f} us"
            f"  plain {plain * 1e3:.3f} us  einsum {lib * 1e3:.3f} us"
            f"  bound {bound * 1e3:.4f} us")
        tot["ms"] += kern
        tot["plain_ms"] += plain
        tot["library_ms"] += lib
        tot["bound_ms"] += bound
    return tot


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def _world(m, samples):
    from repro_torch.core import channel
    from repro_torch.data import dirichlet_partition, make_mnist_like

    ds = make_mnist_like(num_samples=samples, seed=0)
    cell = channel.CellConfig(num_devices=m)
    shards = dirichlet_partition(ds.y_train, m, seed=0)
    return ds, cell, shards


def _config(m, t):
    from repro_torch.config import FLConfig

    return FLConfig(
        num_devices=m, group_size=3, num_rounds=t, scheduler="lazy-gwmin",
        power_mode="mapel", compression="adaptive", fl_engine="batched",
        use_pallas=True, seed=0,
    )


def run_main_path(kernels, m=300, t=5, samples=12_000):
    """Paper-width run on the card; returns (result, launches per kernel)."""
    from repro_torch.core import channel, fl

    ds, cell, shards = _world(m, samples)
    cfg = _config(m, t)
    t0 = time.perf_counter()
    bundle = channel.sample_channels(cfg.seed, cell, cfg.num_rounds)
    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    schedule = fl.make_schedule(bundle.gains, sizes / sizes.sum(), cell, cfg)
    t_sched = time.perf_counter() - t0
    log(f"[main] M={m} K={cfg.group_size} T={t} samples={samples}: host "
        f"schedule (lazy-gwmin + MAPEL) {t_sched:.3f} s")

    stamps = []    # host clock at the start, then after each round

    def progress(lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"[main] round {lg.round}: devices {list(lg.devices)} bits "
            f"{lg.bits.tolist()} acc {lg.test_accuracy:.4f} sim_time "
            f"{lg.wall_time_s:.4f} s host {stamps[-1] - stamps[-2]:.4f} s")

    for kern in kernels:
        kern["wrapper"].launches = 0
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    t1 = stamps[0]
    res = fl.run_federated_learning(
        ds, shards, cell, cfg, channels=bundle, schedule=schedule,
        progress=progress, device="cuda",
    )
    torch.cuda.synchronize()
    total = time.perf_counter() - t1
    launches = {k["name"]: k["wrapper"].launches for k in kernels}
    log(f"[main] run {total:.3f} s after the schedule; launches {launches}")

    nonempty = sum(1 for lg in res.logs if lg.devices)
    acc = res.accuracies()
    check(launches["weighted_aggregate"] == 6 * nonempty,
          f"weighted_aggregate launched {launches['weighted_aggregate']} "
          f"times, expected 6 x {nonempty} non-empty rounds")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(bool(np.all(np.isfinite(acc))), f"non-finite accuracy {acc}")
    check(acc[-1] > acc[0], f"accuracy did not improve: {acc.tolist()}")
    for layer in res.final_params.values():
        for leaf in layer.values():
            check(leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all()),
                  "final parameters not finite on the card")
    return res, launches


def compare_cpu_and_card(kernels, m=30, t=5, samples=12_000):
    """The M=30 run on the CPU (plain versions) and on the card (kernels)."""
    from repro_torch.core import fl

    ds, cell, shards = _world(m, samples)
    cfg = _config(m, t)
    cpu = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    for kern in kernels:
        kern["wrapper"].launches = 0
    gpu = fl.run_federated_learning(ds, shards, cell, cfg, device="cuda")
    launches = {k["name"]: k["wrapper"].launches for k in kernels}
    check([lg.devices for lg in cpu.logs] == [lg.devices for lg in gpu.logs],
          "schedules differ between CPU and card")
    for a, b in zip(cpu.logs, gpu.logs):
        for field in ("bits", "rates", "compression_ratios"):
            check(np.array_equal(getattr(a, field), getattr(b, field)),
                  f"round {a.round} {field} differ between CPU and card")
    check(np.array_equal(cpu.times(), gpu.times()), "times differ")
    acc_gap = float(np.max(np.abs(cpu.accuracies() - gpu.accuracies())))
    check(acc_gap <= ACC_ATOL, f"accuracy gap {acc_gap}")
    worst_mean = worst_max = 0.0
    for name, layer in cpu.final_params.items():
        for leaf, v in layer.items():
            d = (v.double() - gpu.final_params[name][leaf].cpu().double()).abs()
            worst_mean = max(worst_mean, d.mean().item())
            worst_max = max(worst_max, d.max().item())
    check(worst_mean < PARAM_MEAN_ATOL and worst_max < PARAM_MAX_ATOL,
          f"param drift mean {worst_mean} max {worst_max}")
    log(f"[parity] M={m} CPU vs card: schedules/bits/rates/ratios/times "
        f"equal, acc gap {acc_gap!r}, param drift mean {worst_mean!r} max "
        f"{worst_max!r}, card launches {launches}")


# --------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.device import resolve_device

    resolve_device("cuda")           # pins float32 matmuls to full precision
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} card {kind}")

    kernels = kernels_of_main_path()
    build_kernels(kernels)
    errs = {"weighted_aggregate": compare_aggregate(kernels[0]["module"])}
    times = {"weighted_aggregate": time_aggregate(kernels[0]["module"])}
    _, launches = run_main_path(kernels)
    compare_cpu_and_card(kernels)

    rows = []
    for kern in kernels:
        name = kern["name"]
        t = times[name]
        rows.append(dict(
            name=name, route=kern["route"], source=kern["source"],
            replaces=kern["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by="bytes",
            library_ms=t["library_ms"],
        ))
        check(all(math.isfinite(t[x]) for x in t), f"{name} timing not finite")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
