"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(on PATH, under CUDA_HOME or /usr/local/cuda) and PyTorch built for CUDA.
It imports the port (``src/repro_torch``) and nothing of JAX or of the JAX
package, and exits non-zero on the first failure.  Phases:

  1. a CUDA card is present (else exit 2, printing no result);
  2. every kernel of the main path builds from the checkout's sources
     (one ``nvcc`` per source, all started together, into ``build/``);
  3. each kernel is held against its plain PyTorch version on the card over
     a sweep of shapes and types: the aggregation kernel within rtol 1e-5,
     atol 1e-6 (tests/test_kernels.py) one matrix per launch, and bit for
     bit in grouped launches (LeNet's six leaves with empty matrices, views
     off the 16-byte boundary, more matrices than one launch's table), the
     SIC scorer within relative 2e-5 (tests/test_rates.py), K = 9 refused;
  4. each kernel is timed at the main path's shapes beside its plain
     version, one PyTorch library call computing the same function where
     there is one, and the least time the card could take (its bound):
     host-inclusive time per call, and device time from CUDA events over
     launches queued behind a sleep kernel;
  5. the lazy GWMIN scheduler at the paper widths of BENCH_scheduling.json
     (M=300/T=35 and M=1000/T=50, K=3, pool 64): the numpy backend on the
     host and the device backends ``jax`` (scorer ``xla`` and ``pallas``)
     and ``jax-stepwise`` on the card give identical schedules, the fused
     loop runs under ``torch.cuda.set_sync_debug_mode("error")``, and the
     SIC kernel launches once per greedy step; torch.profiler splits
     each device backend's time into device-busy and idle; at the FL main
     path's shape the fused loop is also issued whole behind a sleep kernel
     (no step waits for the card); an instance of equal gains shows the
     first-maximum tie-break on the card;
  6. the main path — ``repro_torch.core.fl.run_federated_learning`` at
     paper width (M=300 devices, K=3, LeNet-300-100 on 12,000 samples,
     MAPEL, lazy GWMIN, adaptive DoReFa, batched engine with the kernel) —
     runs on the card three times (one grouped aggregation launch per
     round for all six LeNet leaves): with the host schedule, with
     ``scheduler_backend="jax"``, and with a schedule planned on the card by
     ``get_policy("lazy-gwmin")`` with the SIC kernel as scorer; launch
     counts show each went through its kernels;
  7. the same run at M=30 with ``scheduler_backend="jax"`` on the CPU and on
     the card agree (schedules, bits, rates, ratios and times exactly;
     accuracy within 0.02; parameter drift within the bounds of
     tests/test_fl_engine.py:_assert_equal_runs);
  8. the over-the-air uplink: the OTA kernel's two entries against their
     plain versions over a sweep, in both row layouts (contiguous rows,
     read one element per thread when N % 4 != 0; rows spaced for 16-byte
     loads, as the path lays them out): the strip entry (the noise read
     from a strip, as the Pallas kernel takes it) and the keyed entry (the
     path's: the noise formed from the round key in registers, also held
     to the strip kernel fed ``scale * prng.normal(key)``), and the keyed
     entry on one OTA round's own inputs (bit for bit); their timing (the
     keyed kernel beside the three launches it replaces, the strip kernel
     beside ``addmv``, both bounds, the keyed kernel's registers and
     occupancy), the receiver-noise stream (its bits on the card equal the
     CPU's; the Threefry kernel's normal draw of a round's size, one
     launch, equal to its plain version ``prng.draw_plain`` to the bit and
     timed beside it), the paper-width run with ``uplink="ota"``
     (ota-align powers, noise 1e-9: one keyed OTA launch per non-empty
     round and no noise draw) and with ``uplink="tdma"``
     (one aggregation launch per round), and the
     M=30 OTA run on the CPU and on the card held to the same contract as 7;
  9. the packed DoReFa codec: the three quantizer kernels against their
     plain versions on the card and on the CPU (codes equal, outputs
     bit-equal) over the shapes of tests/test_kernels.py and LeNet's leaves,
     float32 and bfloat16, bits 1-32, and the 16-byte kernels on views at
     every element offset off a 16-byte boundary (``[dorefa-kernel]``);
     each timed at LeNet's ``fc1/w`` leaf and at
     benchmarks/kernel_bench.py's 2^20 (``[time]``, with the kernel/library
     ratio of each and their registers, shared and local bytes and
     occupancy); ``encode_tree`` ->
     ``decode_tree`` and
     ``ops.quantize_dequantize`` over the M=300 host run's LeNet update
     (final minus initial parameters) at bits 1, 4, 8, 16 and the run's own
     adaptive widths, equal to the CPU's plain path to the bit
     (``[codec]``); the paper-width run with ``topk=0.1`` (one aggregation
     launch per round on the concatenated (3, 266,610) codes stacked over
     the b = 32 passthrough rows, the kernel
     held to its plain version on that round's own inputs) and with
     ``client_bank="bucketed"`` (bit-equal to the host run); and the M=30
     ``topk=0.1`` run on the CPU and on the card held to the contract of 7;
 10. the flash-decode kernel: against its plain version on the card
     (``[flash-kernel]``), within tests/test_kernels.py's float32 contract
     (atol and rtol 1e-5) and in bfloat16 within one rounding of the
     output (atol 1e-6, rtol 2^-7; zeros at valid_len = 0) at the
     test shapes and at decode_32k (B=128, S=32,768) with Qwen2-0.5B's
     Hkv=2, G=7, D=64, float32 and bfloat16, valid_len 0, 1, 300, S-1, S;
     timed at decode_32k (``[time] flash_decode``: device and
     host-inclusive time, plain version, ``scaled_dot_product_attention``
     with ``enable_gqa=True`` as the library yardstick (the faster of the
     call with a boolean mask and the call without one),
     and the bound: the bytes of k and v below valid_len; the
     kernel/sdpa ratio of the run, the kernel's registers, shared and
     local bytes and occupancy); and its path,
     ``kernels.ops.flash_decode(use_pallas=True)`` at decode_32k
     (``[main:flash]``: one launch per call, held to the oracle);
 11. the legacy round body, the reference's default engine and its oracle:
     ``FLConfig``'s defaults (legacy, ``use_pallas=False``, numpy lazy
     GWMIN, MAPEL, adaptive DoReFa, NOMA) at the main path's width
     (``[main:legacy]``: no kernel launch but LeNet's three initial draws,
     the per-round host time printed, logs equal to ``[main:host]``'s with
     accuracy within 0.02 and the parameter drift against it printed); the
     legacy round under OTA (ota-align, noise 1e-9, ``use_pallas=True``:
     ``[main:legacy-ota]``, one keyed OTA launch per non-empty round, logs
     equal to ``[main:ota]``'s); the batched engine with the random
     schedule (``[main:random]``); and the M=30 default run on the CPU and
     on the card held to the contract of 7 (``[cpu-vs-card:legacy]``);
 12. the seeded draws (``[draws]``): the reference's positions and gains of
     the paper cell (M=300, T=35) and LeNet's initial weights, drawn on the
     card through the Threefry kernel, equal the CPU's to the bit, and so
     do 2^20 of the kernel's uniforms, normals and truncated normals
     against its plain version on the card and the CPU.  Every main-path
     run draws LeNet's initial weights with the kernel (three launches);
     the OTA run draws no noise strip;
 13. the scanned horizon (``horizon="scan"``: the plan uploaded once, every
     round from device tensors, one download): the host and OTA runs of 6
     and 8 scanned (``[main:scan]``, ``[main:scan-ota]``), equal to them
     to the bit, with 5 launches of kernel #1 or of the keyed OTA kernel
     (one per round) and the horizon's device part run under
     ``torch.cuda.set_sync_debug_mode("error")``; a seed sweep of seeds
     0-3 in one stacked horizon beside the four single scans
     (``[sweep:seeds]``: logs equal, final parameters bit-equal, inside the
     drift contract or in F1's shape, and the line says which; kernel #1
     twice a round for the 24 (seed, leaf) sums); a cell sweep of 2 cells x
     2 seeds with ``cell_shards=2``, clamped to the card count
     (``[sweep:cells]``: each instance equal to its single scan to the
     bit); and the M=30 scan on the CPU and on the card held to the
     contract of 7 (``[cpu-vs-card:scan]``);
 14. the online policies, which select each round from the FL state of
     the rounds before: update-aware with MAPEL per round
     (``[main:online]``: each round's norms fed to the policy and host
     time printed; kernel #1 once per non-empty round), age-fair with max
     power (``[main:online-age]``), update-aware with max power scanned
     (``[main:online-scan]``: selection, powers, rates and budgets on the
     card inside the horizon, under the sync check, its logs equal to the
     same configuration per round (``[main:online-max]``) and its
     parameters within the drift contract), matching-pursuit over OTA
     (ota-align, noise 1e-9) per round and scanned (``[main:online-mp]``,
     ``[main:online-mp-scan]``: one keyed OTA launch per round, the one
     equal to the other), ``FLConfig(scheduler="update-aware")`` on the
     legacy engine (``[main:online-legacy]``: no kernel but Threefry's
     3), the online seed sweep over seeds 0-3 (``[sweep:online-seeds]``:
     every row's logs equal to its single online scan's) and the M=30
     update-aware run on the CPU and on the card
     (``[cpu-vs-card:online]``: the contract of 7, or F1's shape where
     the drift leaves it);
 15. the token payloads, the dense transformer as the FL payload: kernel
     #1 on the 14 Qwen2-0.5B leaves (494,147,456 int32 codes a client,
     K=3) in one grouped launch and the keyed OTA kernel on its embedding
     leaf (K=3 x 136,249,344), each bit-equal to its plain version and
     timed (``[token-kernel]``); Qwen2-0.5B at full width through
     ``run_federated_learning`` on the card, M=30, K=3, T=3, 600 rows of
     16 tokens (``[main:tokens]``: NOMA, MAPEL, adaptive DoReFa, one #1
     launch per non-empty round; ``[main:tokens-ota]``: ota-align, noise
     1e-9, one keyed #2 launch per non-empty round; the initial draw's
     time, each round's host time and the peak device memory printed);
     ``tiny-transformer-1m`` with ``topk=0.01`` scanned against per round,
     bit for bit, the horizon under the sync check
     (``[main:tokens-scan]``); the SMOKE Qwen2 at M=12 on the CPU and on
     the card (``[cpu-vs-card:tokens]``: logs exact, the drift inside the
     contract or in F3's shape); and the card's full-width initial weights
     and one batch's loss against tests/torch_reference/qwen2_0_5b.json,
     written by the JAX package (``[ref:qwen2-0.5b]``);
 16. the moe, ssm and hybrid families: Mamba2-130M at full width as the FL
     payload on the card, M=30, K=3, T=3, 600 rows of 16 tokens
     (``[main:tokens-ssm]``: NOMA, MAPEL, adaptive DoReFa, one #1 launch
     per non-empty round, one round more traced by torch.profiler:
     ``[trace:tokens-ssm]``; ``[main:tokens-ssm-ota]``: one keyed #2
     launch per non-empty round; the Threefry kernel once per drawn
     leaf); the
     SMOKE Mamba2 and Zamba2 at M=12 on the CPU and on the card, and the
     SMOKE Mixtral payload raising the reference's ValueError
     (``[cpu-vs-card:families]``); the card's full-width Mamba2 weights
     and one batch's loss against tests/torch_reference/mamba2_130m.json
     (``[ref:mamba2-130m]``); ``launch.serve`` at the published widths
     on Mamba2-130M, Zamba2-7B cut to 6 layers and Mixtral-8x22B cut to 2
     (``[serve:*]``: initial weights held to the reference's recorded
     elements, tokens to the plain per-token forward); ``launch.train`` at
     full width on Qwen2-0.5B (also with error feedback) and Mamba2-130M
     (each step's loss held to the reference's record), a save / resume
     round trip, and the SMOKE Mixtral (``[train:*]``).

The last lines are the card's name and power limit as nvidia-smi reports
them, one JSON object with every kernel's numbers, and the one-line result
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
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
SIC_RTOL = 2e-5
SIC_SWEEP_K = (1, 2, 3, 8)
# 10,120 = T*C(24, 3), one step of the FL main path's pallas-scored greedy
# (M=300, T=5); 1,458,240 and 2,083,200 = one step at M=300/T=35 and
# M=1000/T=50 with pool 64
SIC_SWEEP_V = (0, 1, 255, 256, 257, 10_120, 1_458_240, 2_083_200)
NOISE, PMAX = 1.6e-14, 0.01     # benchmarks/scheduling_bench.py's instance
SCHED_CASES = ((300, 35, 3, 64), (1000, 50, 3, 64))   # M, T, K, pool
SLEEP_CYCLES = 200_000_000      # ~0.1 s of queued work ahead of a timing
OTA_SWEEP_K = (0, 1, 3, 8)
OTA_SWEEP_N = (0, 1, 257, 1000, 32_771, 266_610, 2_200_000)
LENET_PARAMS = sum(LENET_LEAVES)    # 266,610
OTA_NOISE = 1e-9                # benchmarks/ota_bench.py's NOISE_STD
ACC_ATOL, PARAM_MEAN_ATOL, PARAM_MAX_ATOL = 0.02, 1e-6, 2e-2
# tests/test_torch_fl.py's bound between float order and a DoReFa code flip
# (F1, ROADMAP.md queue 3): until a code flips, two float orders differ by
# far less per element, and one code step is far more
F1_FLOAT_ORDER = 1e-6
DOREFA_SHAPES = ((17,), (128,), (4096,), (32768,), (100_001,), (3, 77, 11)) \
    + tuple((n,) for n in LENET_LEAVES)
DOREFA_BITS = (1, 2, 4, 8, 16, 24, 31, 32)
DOREFA_TIME_N = (235_200, 1 << 20)   # LeNet fc1/w; kernel_bench.py's N
DOREFA_ODD_SCALES = (1.0, float("nan"), float("inf"), 0.0, -1.0)
CODEC_BITS = (1, 4, 8, 16)
TOPK = 0.1
SWEEP_SEEDS = (0, 1, 2, 3)      # [sweep:seeds]; [sweep:cells] runs 0-3 too
# tests/test_kernels.py's flash-decode shapes (B, Hkv, G, D, S), then
# decode_32k (src/repro/config.py) at Qwen2-0.5B's head layout
# (src/repro/configs/qwen2_0_5b.py: 14 query heads, 2 kv heads, D=64)
FLASH_SHAPES = ((1, 1, 1, 128, 256), (2, 2, 3, 128, 512), (1, 4, 2, 64, 1024),
                (3, 1, 8, 128, 256))
DECODE_32K = (128, 2, 7, 64, 32_768)
# (atol, rtol) of the flash-decode kernel against its plain version and the
# oracle: float32 at tests/test_kernels.py's 1e-5; in bfloat16 all three
# read the same inputs and compute in float32, so they differ by at most
# one bfloat16 rounding of the output (2^-7 relative), far inside that
# contract's 5e-2, which a kernel returning zeros would pass
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
PEAK_FLOPS = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: 989e12}
# operations per normal of the Threefry kernel, counted from its source:
# the hash 118 integer operations, the uniform 6, erf_inv about 66 (a
# fused multiply-add counted as two)
THREEFRY_OPS = 190
THREEFRY_HASH_OPS = 118
INT32_OPS_PER_SM_CLOCK = 64     # Hopper: half the float32 lanes
LENET_WEIGHT_LEAVES = 3     # truncated-normal draws of LeNet's init


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
    from repro_torch.kernels import (
        aggregate, dorefa, flash_decode, ota_aggregate, sic_rates, threefry,
    )

    return [dict(
        name="weighted_aggregate",
        route="cuda",
        source="src/repro_torch/kernels/csrc/aggregate.cu",
        replaces="src/repro/kernels/aggregate.py:74",
        wrapper=aggregate.weighted_aggregate,
        module=aggregate,
    ), dict(
        name="sic_weighted_rates",
        route="cuda",
        source="src/repro_torch/kernels/csrc/sic_rates.cu",
        replaces="src/repro/kernels/sic_rates.py:56",
        wrapper=sic_rates.sic_weighted_rates,
        module=sic_rates,
    ), dict(
        name="ota_aggregate",
        route="cuda",
        source="src/repro_torch/kernels/csrc/ota_aggregate.cu",
        replaces="src/repro/kernels/aggregate.py:170",
        wrapper=ota_aggregate.ota_aggregate,
        module=ota_aggregate,
    )] + [dict(
        name=name,
        route="cuda",
        source="src/repro_torch/kernels/csrc/dorefa.cu",
        replaces=f"src/repro/kernels/dorefa.py:{line}",
        wrapper=getattr(dorefa, name),
        module=dorefa,
    ) for name, line in (("quantize_codes", 43), ("dequantize_codes", 71),
                         ("quantize_dequantize", 101))] + [dict(
        name="flash_decode",
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:67",
        wrapper=flash_decode.flash_decode,
        module=flash_decode,
    ), dict(
        # not a Pallas kernel: the reference draws its fading and initial
        # weights with jax.random under XLA; on the main path it draws
        # LeNet's initial weights (the OTA round's noise is formed inside
        # the keyed OTA kernel from the same header, csrc/threefry.cuh)
        name="threefry_draw",
        route="cuda",
        source="src/repro_torch/kernels/csrc/threefry.cu",
        replaces="src/repro/models/params.py:63",
        wrapper=threefry.threefry_draw,
        module=threefry,
    )]


def build_kernels(kernels):
    """One nvcc per source, all started together."""
    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    modules = list({kern["module"].KERNEL: kern["module"]
                    for kern in kernels}.values())
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        paths = list(pool.map(
            lambda mod: cuda_build.build(mod.KERNEL), modules))
    for mod, path in zip(modules, paths):
        names = [k["name"] for k in kernels if k["module"] is mod]
        log(f"[build] {', '.join(names)}: {os.path.relpath(path, REPO)}")
        mod._library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")


def reset_launches(kernels):
    for kern in kernels:
        kern["wrapper"].launches = 0


def read_launches(kernels):
    return {k["name"]: k["wrapper"].launches for k in kernels}


def _aggregate_case(k, n, dtype, gen, int_bits=4):
    """Inputs shaped like the main path's: DoReFa codes in [-a_k, a_k]
    (int32 at ``int_bits``, or float32-held at per-client widths up to 32),
    max-abs scales and FedAvg weights that sum to one."""
    dev = torch.device("cuda")
    if dtype == torch.int32:
        bits = torch.full((k,), int_bits)
    else:
        bits = torch.randint(1, 33, (k,), generator=gen)
    levels = torch.pow(torch.full((k,), 2.0), bits.float()) - 1.0
    x = torch.clamp(torch.randn(k, n, generator=gen) / 3.0, -1.0, 1.0)
    exact_levels = torch.pow(2.0, bits.double()) - 1.0   # 2^31 - 1 exact
    codes = torch.round(exact_levels[:, None] * x.double()).to(dtype)
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
    # int32 codes at 4 bits, and at 31 bits, where codes above 2^24 are
    # rounded to float32 before the multiply-add
    kinds = ((torch.float32, None), (torch.int32, 4), (torch.int32, 31))
    for dtype, int_bits in kinds:
        for k, n in cases:
            codes, scales, w, levels = _aggregate_case(k, n, dtype, gen,
                                                       int_bits)
            if dtype == torch.int32:
                got = mod.weighted_aggregate(codes, scales, w, int_bits)
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
                  f"aggregate disagrees at K={k} n={n} {dtype} "
                  f"int bits {int_bits}: "
                  f"max err {err.max().item() if n else 0.0}")
            if n:
                worst = max(worst, err.max().item())
    log(f"[compare] weighted_aggregate: {len(kinds) * len(cases)} cases "
        f"(float32-held codes; int32 at 4 and 31 bits) ok, "
        f"max abs err {worst!r}")
    return max(worst, compare_aggregate_group(mod))


def compare_aggregate_group(mod):
    """The grouped kernel against the plain version, matrix by matrix, bit
    for bit: LeNet's six leaves with an empty matrix of each kind among
    them, in one launch, at K = 1, 3 and 8, float32-held and int32 codes,
    each matrix a view 0 or 1 elements off its buffer's 16-byte boundary
    (the vector and the scalar paths); and 2.5 tables of matrices of every
    size mod 4 in three launches.  Returns the largest absolute
    difference."""
    gen = torch.Generator().manual_seed(2)
    worst, n_cases = 0.0, 0
    kinds = ((torch.float32, None), (torch.int32, 4), (torch.int32, 31))
    tables = 2 * mod.MAX_SEGMENTS + mod.MAX_SEGMENTS // 2
    layouts = [(k, list(LENET_LEAVES), off) for k in SWEEP_K
               for off in (0, 1)] + [(3, [5 + 3 * i for i in range(tables)], 0)]
    for dtype, int_bits in kinds:
        for k, sizes, off in layouts:
            codes, coeffs = [], []
            for n in sizes:
                c, scales, w, levels = _aggregate_case(k, n + off, dtype, gen,
                                                       int_bits)
                codes.append(c.reshape(-1)[off:off + k * n].reshape(k, n))
                coeffs.append(mod.coefficients(scales, w, levels))
            if len(sizes) == len(LENET_LEAVES):
                codes[2:2] = [codes[0][:, :0], codes[0][:0]]
                coeffs[2:2] = [coeffs[0], coeffs[0][:0]]
            before = mod.weighted_aggregate.launches
            got = mod.weighted_aggregate_group(codes, coeffs)
            torch.cuda.synchronize()
            want_launches = -(-len(sizes) // mod.MAX_SEGMENTS)
            check(mod.weighted_aggregate.launches - before == want_launches,
                  f"grouped aggregate launched "
                  f"{mod.weighted_aggregate.launches - before} times for "
                  f"{len(sizes)} matrices, expected {want_launches}")
            mod.weighted_aggregate.launches = before   # checks don't count
            for out, c, cf in zip(got, codes, coeffs):
                want = (mod.weighted_aggregate_plain(c, cf) if c.numel() else
                        torch.zeros(c.shape[1:], device="cuda"))
                try:
                    worst = max(worst, _bits_equal(out, want))
                except SmokeFailure as exc:
                    raise SmokeFailure(
                        f"grouped aggregate at K={k} n={c.shape[1:]} {dtype} "
                        f"offset {off}: {exc}")
            n_cases += 1
    log(f"[compare] weighted_aggregate_group: {n_cases} grouped calls (LeNet's "
        f"six leaves with two empty matrices at K {SWEEP_K}, views 0 and 1 "
        f"elements off 16 bytes; {tables} matrices in "
        f"{-(-tables // mod.MAX_SEGMENTS)} launches) bit-equal to the plain "
        f"version, max abs err {worst!r}")
    return worst


def _time_ms(fn, iters=200, warmup=20):
    """Mean ms per call of back-to-back calls, CUDA events around the loop:
    host launch cost included when the card outruns the host."""
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


def _device_ms(fn, iters=20):
    """Device ms per call: the calls are queued behind a sleep kernel, so
    the card runs them back to back and the CUDA events between them see
    device time only.  If the sleep ended before the host had queued every
    call (the start event already passed), the host's gaps would count:
    retry with fewer calls."""
    fn()
    while True:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        backlogged = not start.query()
        torch.cuda.synchronize()
        if backlogged:
            return start.elapsed_time(stop) / iters
        check(iters > 1, "could not queue one call behind the sleep kernel")
        iters //= 2


def _busy_ms(fn, iters=2):
    """Device-busy ms and kernel launches per call, from torch.profiler:
    for calls of more launches than the card queues behind a sleep kernel
    (about a thousand: the host then blocks until the sleep ends, so
    :func:`_device_ms` cannot hide the host's launch time)."""
    fn()
    launches, busy, _ = _profile_schedule(
        lambda: [fn() for _ in range(iters)])
    return busy / iters, launches / iters


def _attributes_text(attrs):
    """A kernel's build and launch attributes (cuda_build.ATTRIBUTES) as
    read from the card, with its occupancy in resident warps per SM."""
    warps = attrs["threads"] // 32 * attrs["ctas_per_sm"]
    return (f"{attrs['registers']} registers/thread, shared "
            f"{attrs['static_smem']} B static + {attrs['dynamic_smem']} B "
            f"dynamic, local (spill) {attrs['local_bytes']} B/thread, "
            f"{attrs['threads']} threads x {attrs['ctas_per_sm']} CTAs/SM "
            f"(occupancy {warps}/64 warps)")


def time_aggregate(mod, k=3):
    """Per-round times at the main path's shapes: the six LeNet leaves at
    K=3, float32-held codes, reduced by one grouped launch (the kernel's
    time per round), beside the same kernel launched once per leaf (the
    launches the round made before the grouped kernel), the plain version
    over the six leaves and six ``torch.einsum`` calls (the yardstick
    library call), on the same inputs, warm in L2 as the main path leaves
    them.  ``host_*``: the mean of back-to-back calls with CUDA events
    around the loop, interleaved plain/kernel/kernel/plain, host launch
    cost included; ``ms`` / ``plain_ms`` / ``library_ms``: device time
    (:func:`_device_ms`).  The bound counts each leaf's codes and
    coefficients read once and its output written once.  Returns
    per-round milliseconds."""
    gen = torch.Generator().manual_seed(1)
    codes, coeffs = [], []
    for n in LENET_LEAVES:
        c, scales, w, levels = _aggregate_case(k, n, torch.float32, gen)
        codes.append(c)
        coeffs.append(mod.coefficients(scales, w, levels))
    counted = mod.weighted_aggregate.launches

    def kern_fn():
        return mod._launch_group(codes, coeffs)

    def per_leaf_fn():
        return [mod._launch(c, cf) for c, cf in zip(codes, coeffs)]

    def plain_fn():
        return [mod.weighted_aggregate_plain(c, cf)
                for c, cf in zip(codes, coeffs)]

    def lib_fn():
        return [torch.einsum("k,kn->n", cf, c) for c, cf in zip(codes, coeffs)]

    for got, want in zip(kern_fn(), plain_fn()):
        _bits_equal(got, want)
    plain = _time_ms(plain_fn, iters=50, warmup=5)
    kern = _time_ms(kern_fn)
    per_leaf = _time_ms(per_leaf_fn)
    kern = 0.5 * (kern + _time_ms(kern_fn))
    per_leaf = 0.5 * (per_leaf + _time_ms(per_leaf_fn))
    plain = 0.5 * (plain + _time_ms(plain_fn, iters=50, warmup=5))
    lib = _time_ms(lib_fn)
    dev = {name: _device_ms(fn, iters=iters) for name, fn, iters in
           (("plain", plain_fn, 20), ("kernel", kern_fn, 200),
            ("per_leaf", per_leaf_fn, 200), ("lib", lib_fn, 200),
            ("kernel2", kern_fn, 200))}
    mod.weighted_aggregate.launches = counted   # timing launches don't count
    nbytes = sum((k + 1) * n * 4 + k * 4 for n in LENET_LEAVES)
    flops = sum(2 * k * n for n in LENET_LEAVES)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    ms = 0.5 * (dev["kernel"] + dev["kernel2"])
    log(f"[time] weighted_aggregate K={k} LeNet's six leaves ({LENET_PARAMS} "
        f"elements) per round: device kernel (one grouped launch) "
        f"{ms * 1e3:.3f} us ({dev['kernel'] * 1e3:.3f} / "
        f"{dev['kernel2'] * 1e3:.3f}), one launch per leaf "
        f"{dev['per_leaf'] * 1e3:.3f} us, plain {dev['plain'] * 1e3:.3f} us, "
        f"six einsum {dev['lib'] * 1e3:.3f} us; host-inclusive kernel "
        f"{kern * 1e3:.3f} us, one launch per leaf {per_leaf * 1e3:.3f} us, "
        f"plain {plain * 1e3:.3f} us, six einsum {lib * 1e3:.3f} us; bound "
        f"{bound * 1e3:.4f} us ({bound_by}); "
        f"{ms / bound:.2f}x the bound; kernel/einsum {ms / dev['lib']:.3f}")
    log(f"[time] weighted_aggregate grouped kernel: "
        f"{_attributes_text(mod.attributes(torch.float32))}")
    return dict(ms=ms, plain_ms=dev["plain"], library_ms=dev["lib"],
                bound_ms=bound, host_ms=kern, plain_host_ms=plain,
                bound_by=bound_by)


# --------------------------------------------------------------------------
# the SIC scorer kernel
# --------------------------------------------------------------------------

def _sic_case(v, k, dtype, seed, tie=False, full_power=False):
    """Inputs shaped like the greedy's: gains at the paper cell's scale,
    powers up to pmax, Dirichlet weights (tests/test_rates.py); ``tie``
    gives columns 0 and 1 equal receive power; ``full_power`` sets every
    power to pmax, as the greedy's scorer does."""
    rng = np.random.default_rng(seed)
    g = np.abs(rng.normal(1e-6, 5e-7, (v, k))) + 1e-8
    p = rng.uniform(0.0, PMAX, (v, k))
    if full_power:
        p = np.full((v, k), PMAX)
    w = rng.dirichlet(np.ones(k), size=v) if v else np.zeros((0, k))
    if tie and k > 1:
        g[:, 1] = g[:, 0]
        p[:, 1] = p[:, 0]
    return tuple(torch.as_tensor(a).to(device="cuda", dtype=dtype)
                 for a in (p, g, w))


def _sic_errors(got, want, what):
    """Fails unless ``got`` is within relative SIC_RTOL of ``want``
    elementwise; returns the largest absolute and relative errors."""
    err = (got - want).abs()
    rel = (err / want.abs()).max().item()
    check(bool(torch.all(err <= SIC_RTOL * want.abs())),
          f"SIC kernel disagrees at {what}: max rel err {rel!r}")
    return err.max().item(), rel


def compare_sic(mod):
    """Kernel vs plain version on the card over the sweep; returns the
    largest absolute difference."""
    worst_abs = worst_rel = 0.0
    cases = [(v, k, tie) for k in SIC_SWEEP_K for v in SIC_SWEEP_V
             for tie in (False, True)]
    n_cases = 0
    for dtype in (torch.float32, torch.float64):
        for v, k, tie in cases:
            if tie and (k == 1 or v != 257):
                continue
            p, g, w = _sic_case(v, k, dtype, seed=v * 10 + k)
            before = mod.sic_weighted_rates.launches
            got = mod.sic_weighted_rates(p, g, w, NOISE)
            want = mod.sic_weighted_rates_plain(p, g, w, NOISE)
            torch.cuda.synchronize()
            n_cases += 1
            check(mod.sic_weighted_rates.launches == before + (v > 0),
                  f"SIC launches at V={v} K={k}")
            check(got.shape == (v,) and got.dtype == torch.float32
                  and got.device.type == "cuda",
                  f"SIC shape {tuple(got.shape)} {got.dtype} at V={v} K={k}")
            if not v:
                continue
            err_abs, rel = _sic_errors(
                got, want, f"V={v} K={k} {dtype} tie={tie}")
            worst_abs = max(worst_abs, err_abs)
            worst_rel = max(worst_rel, rel)
    p, g, w = _sic_case(4, 9, torch.float64, seed=9)
    try:
        mod.sic_weighted_rates(p, g, w, NOISE)
    except ValueError as exc:
        check("K <= 8" in str(exc), f"K=9 raised {exc}")
    else:
        raise SmokeFailure("K=9 did not raise")
    log(f"[compare] sic_weighted_rates: {n_cases} cases ok, max abs err "
        f"{worst_abs!r}, max rel err {worst_rel!r} (limit {SIC_RTOL}); "
        f"K=9 refused")
    return worst_abs


def time_sic(mod, vertices, k=3, label=""):
    """One greedy step's scoring at ``vertices`` (T x C(pool, K)) float64
    groups: kernel and plain version, host-inclusive (as in
    :func:`time_aggregate`, interleaved plain/kernel/kernel/plain) and
    device time.  The inputs are the greedy's (every power pmax), and the
    kernel is held to its plain version on them first.  No single PyTorch
    call computes this function (library: none)."""
    p, g, w = _sic_case(vertices, k, torch.float64, seed=3, full_power=True)
    counted = mod.sic_weighted_rates.launches
    err_abs, rel = _sic_errors(
        mod.sic_weighted_rates(p, g, w, NOISE),
        mod.sic_weighted_rates_plain(p, g, w, NOISE),
        f"{label}V={vertices} K={k} float64 full power")

    def kern_fn():
        return mod.sic_weighted_rates(p, g, w, NOISE)

    def plain_fn():
        return mod.sic_weighted_rates_plain(p, g, w, NOISE)

    plain_wall = _time_ms(plain_fn, iters=50, warmup=5)
    kern_wall = _time_ms(kern_fn, iters=50, warmup=5)
    kern_wall = 0.5 * (kern_wall + _time_ms(kern_fn, iters=50, warmup=5))
    plain_wall = 0.5 * (plain_wall + _time_ms(plain_fn, iters=50, warmup=5))
    kern_dev = _device_ms(kern_fn)
    plain_dev = _device_ms(plain_fn)
    mod.sic_weighted_rates.launches = counted   # timing launches don't count
    nbytes = vertices * (3 * k * 8 + 4)          # p, g, w in; f32 out
    # per group: 2K products, K(K-1) compares (and their adds), K times
    # an add, a divide, a log2, a product and an add
    ops = vertices * (2 * k + 2 * k * (k - 1) + 5 * k)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    log(f"[time] sic_weighted_rates {label}V={vertices} K={k} f64 (max abs "
        f"err {err_abs!r}, max rel err {rel!r} vs plain): kernel "
        f"device {kern_dev * 1e3:.2f} us host-inclusive {kern_wall * 1e3:.2f}"
        f" us; plain device {plain_dev * 1e3:.2f} us host-inclusive "
        f"{plain_wall * 1e3:.2f} us; bound {bound * 1e3:.2f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}); "
        f"{kern_dev / bound:.2f}x the bound")
    return dict(ms=kern_dev, plain_ms=plain_dev, library_ms=None,
                bound_ms=bound, host_ms=kern_wall, plain_host_ms=plain_wall,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# the OTA kernel and the receiver-noise stream
# --------------------------------------------------------------------------

def _spaced(mod, x):
    """``x`` copied into the OTA path's row layout (:func:`row_buffer`:
    rows on 16-byte boundaries), in which the kernel takes its 16-byte
    loads."""
    out = mod.row_buffer(x.shape[0], x.shape[1], device=x.device)
    out.copy_(x)
    return out


def _ota_case(mod, k, n, gen, spaced=False):
    """Raw update rows (contiguous, or ``spaced`` as the path lays them
    out), masked FedAvg coefficients (row 1 masked out when K > 1, as a
    sub-threshold participant is) and scaled noise."""
    dev = torch.device("cuda")
    x = torch.randn(k, n, generator=gen) * 0.01
    coeff = torch.rand(k, generator=gen)
    if k > 1:
        coeff[1] = 0.0
    coeff = coeff / coeff.sum() if k else coeff
    noise = torch.randn(n, generator=gen) * 3e-3
    x = x.to(dev)
    return (_spaced(mod, x) if spaced else x), coeff.to(dev), noise.to(dev)


def _ota_errors(mod, x, coeff, noise, what):
    """Kernel (through the wrapper) vs plain version on the card; fails
    unless they agree to the bit; returns the max abs difference."""
    k, n = x.shape
    before = mod.ota_aggregate.launches
    got = mod.ota_aggregate(x, coeff, noise)
    want = mod.ota_aggregate_plain(x, coeff, noise)
    torch.cuda.synchronize()
    check(mod.ota_aggregate.launches == before + (k > 0 and n > 0),
          f"OTA launches at {what}")
    check(got.shape == want.shape == (n,) and got.device.type == "cuda",
          f"OTA shape {tuple(got.shape)} at {what}")
    err = (got - want).abs().max().item() if n else 0.0
    check(err == 0.0, f"OTA kernel disagrees at {what}: max abs err {err!r}")
    return err


def _ota_keyed_errors(mod, x, coeff, key, scale, what):
    """The keyed kernel (through the wrapper: noise formed from ``key`` in
    registers) vs its plain version on the card and vs the strip kernel fed
    ``scale * prng.normal(key, n)``; fails unless all three agree to the
    bit; returns the max abs difference."""
    from repro_torch.core import prng

    k, n = x.shape
    before = mod.ota_aggregate.launches
    got = mod.ota_aggregate_keyed(x, coeff, key, scale)
    torch.cuda.synchronize()
    check(mod.ota_aggregate.launches == before + (n > 0),
          f"keyed OTA launches at {what}")
    check(got.shape == (n,) and got.device.type == "cuda",
          f"keyed OTA shape {tuple(got.shape)} at {what}")
    strip = mod.ota_aggregate(x, coeff, scale * prng.normal(key, n,
                                                            device="cuda"))
    try:
        return max(_bits_equal(got, mod.ota_aggregate_keyed_plain(
            x, coeff, key, scale)), _bits_equal(got, strip))
    except SmokeFailure as exc:
        raise SmokeFailure(f"keyed OTA kernel at {what}: {exc}")


def compare_ota(mod):
    """Kernel vs plain version on the card over the sweep, the strip entry
    and the keyed one (the latter also against the strip kernel fed the
    drawn noise, at a scale and at scale 0); returns the largest absolute
    difference."""
    from repro_torch.core import ota

    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    n_keyed = 0
    for spaced in (False, True):
        for k in OTA_SWEEP_K:
            for n in OTA_SWEEP_N:
                what = f"K={k} n={n} {'spaced' if spaced else 'contiguous'}"
                x, coeff, noise = _ota_case(mod, k, n, gen, spaced)
                worst = max(worst, _ota_errors(mod, x, coeff, noise, what))
                key = ota.horizon_keys(n, k + 1)[k]
                for scale in (3e-3, 0.0):
                    s = torch.tensor(scale, dtype=torch.float32, device="cuda")
                    worst = max(worst, _ota_keyed_errors(
                        mod, x, coeff, key, s, f"{what} scale {scale}"))
                    n_keyed += 1
    log(f"[ota-kernel] {2 * len(OTA_SWEEP_K) * len(OTA_SWEEP_N)} strip cases "
        f"and {n_keyed} keyed cases (K in {OTA_SWEEP_K}, n in {OTA_SWEEP_N}, "
        f"contiguous and spaced rows, a masked row; keyed at scale 3e-3 and "
        f"0, also against the strip kernel fed scale * normal(key)) ok, max "
        f"abs err {worst!r}")
    return worst


def _vector_rows(x):
    """Whether the kernel takes its 16-byte loads on ``x``: rows a
    multiple of 4 elements apart, on 16-byte boundaries."""
    return x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0


def _max_sm_clock_hz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def time_ota(mod, k=3, n=LENET_PARAMS):
    """One OTA round's reduction at the path's shape (K=3 clients, the
    whole LeNet payload, in the path's spaced row layout), warm in L2 as
    the path leaves it.  The keyed kernel (the path's: noise formed from
    the round key in registers) beside what it replaces, the three-launch
    sequence of the strip path (the Threefry draw, ``scale * z``, the
    strip kernel), beside its plain version and its bound in both forms
    (bytes; operations by THREEFRY_OPS, and the hash's integer operations
    alone at Hopper's INT32 rate); the strip kernel beside ``torch.addmv``
    on the same strip (the strip kernel's library yardstick, never on the
    path) and in contiguous rows (one element per thread, since n % 4 == 2
    at LeNet's P).  Device time behind a sleep kernel and host-inclusive
    time (interleaved plain/kernel/kernel/plain), as :func:`time_aggregate`
    measures.  Returns the keyed kernel's timing dict."""
    from repro_torch.core import ota, prng
    from repro_torch.kernels import threefry

    x, coeff, noise = _ota_case(mod, k, n, torch.Generator().manual_seed(3),
                                spaced=True)
    check(_vector_rows(x), "the spaced rows do not take the 16-byte loads")
    dense = x.contiguous()
    key = ota.horizon_keys(0, 4)[3]
    scale = torch.tensor(3e-3, dtype=torch.float32, device="cuda")
    counted = mod.ota_aggregate.launches
    drawn = threefry.threefry_draw.launches
    _ota_errors(mod, x, coeff, noise, f"timed K={k} n={n}")
    _ota_keyed_errors(mod, x, coeff, key, scale, f"timed K={k} n={n}")

    def keyed_fn():
        return mod._launch_keyed(x, coeff, key, scale)

    def keyed_plain_fn():
        return mod.ota_aggregate_keyed_plain(x, coeff, key, scale)

    def sequence_fn():
        return mod._launch(x, coeff, scale * prng.normal(key, n,
                                                         device="cuda"))

    def strip_fn():
        return mod._launch(x, coeff, noise)

    def dense_fn():
        return mod._launch(dense, coeff, noise)

    def strip_plain_fn():
        return mod.ota_aggregate_plain(x, coeff, noise)

    def lib_fn():
        return torch.addmv(noise, x.t(), coeff)

    lib_err = (lib_fn() - strip_fn()).abs().max().item()
    check(torch.equal(keyed_fn(), sequence_fn()),
          "the keyed kernel and the three-launch sequence differ")
    host = {}
    for name, fn in (("plain", keyed_plain_fn), ("keyed", keyed_fn),
                     ("keyed", keyed_fn), ("plain", keyed_plain_fn),
                     ("sequence", sequence_fn), ("strip", strip_fn),
                     ("lib", lib_fn)):
        host[name] = host.get(name, []) + [_time_ms(fn)]
    host = {name: sum(v) / len(v) for name, v in host.items()}
    dev = {name: _device_ms(fn, iters=50) for name, fn in
           (("plain", keyed_plain_fn), ("keyed", keyed_fn),
            ("sequence", sequence_fn), ("strip", strip_fn), ("lib", lib_fn),
            ("dense", dense_fn), ("strip_plain", strip_plain_fn),
            ("keyed2", keyed_fn), ("sequence2", sequence_fn))}
    check(torch.equal(dense_fn(), strip_fn()),
          "the two row layouts give different sums")
    mod.ota_aggregate.launches = counted    # timing launches don't count
    threefry.threefry_draw.launches = drawn
    attrs = mod.keyed_attributes()
    # keyed: updates + coeff + scale in, out; the hash and erf_inv per element
    k_bytes = (k + 1) * n * 4 + k * 4 + 4
    k_ops = (THREEFRY_OPS + 2 * k) * n
    kb, ko = k_bytes / PEAK_BYTES_PER_S * 1e3, k_ops / PEAK_F32_FLOPS * 1e3
    bound = max(kb, ko)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    int_rate = sms * INT32_OPS_PER_SM_CLOCK * clock     # per second
    t_int = THREEFRY_HASH_OPS * n / int_rate * 1e3
    # strip: updates + noise + coeff in, out
    s_bytes = (k + 2) * n * 4 + k * 4
    s_bound = max(s_bytes / PEAK_BYTES_PER_S, 2 * k * n / PEAK_F32_FLOPS) * 1e3
    log(f"[time] ota_aggregate K={k} n={n} keyed (the path's kernel): device "
        f"{dev['keyed'] * 1e3:.3f} us (again {dev['keyed2'] * 1e3:.3f}); the "
        f"three-launch sequence it replaces (Threefry draw, scale * z, strip "
        f"kernel) {dev['sequence'] * 1e3:.3f} us (again "
        f"{dev['sequence2'] * 1e3:.3f}); plain {dev['plain'] * 1e3:.3f} us; "
        f"host-inclusive keyed {host['keyed'] * 1e3:.3f} us  sequence "
        f"{host['sequence'] * 1e3:.3f} us  plain {host['plain'] * 1e3:.3f} us")
    log(f"[time] ota_aggregate keyed bound: bytes {k_bytes} B -> "
        f"{kb * 1e3:.4f} us; operations ({THREEFRY_OPS} + 2K) x n = {k_ops} "
        f"at the float32 peak -> {ko * 1e3:.4f} us; bound {bound * 1e3:.4f} "
        f"us ({'bytes' if kb >= ko else 'operations'}), "
        f"{dev['keyed'] / bound:.2f}x; the hash alone, {THREEFRY_HASH_OPS} "
        f"integer operations per element at {INT32_OPS_PER_SM_CLOCK} per SM "
        f"per clock x {sms} SMs x {clock / 1e9:.3f} GHz -> {t_int * 1e3:.4f} "
        f"us ({dev['keyed'] / t_int:.2f}x); kernel {_attributes_text(attrs)}")
    log(f"[time] ota_aggregate K={k} n={n} strip entry: device 16-byte loads "
        f"(spaced rows) {dev['strip'] * 1e3:.3f} us; one element per thread "
        f"(contiguous rows) {dev['dense'] * 1e3:.3f} us; plain "
        f"{dev['strip_plain'] * 1e3:.3f} us; addmv on the strip "
        f"{dev['lib'] * 1e3:.3f} us (kernel/addmv "
        f"{dev['strip'] / dev['lib']:.3f}); host-inclusive strip "
        f"{host['strip'] * 1e3:.3f} us  addmv {host['lib'] * 1e3:.3f} us; "
        f"bound {s_bound * 1e3:.4f} us (bytes), "
        f"{dev['strip'] / s_bound:.2f}x; addmv max abs diff {lib_err!r}")
    return dict(ms=dev["keyed"], plain_ms=dev["plain"], library_ms=None,
                bound_ms=bound, host_ms=host["keyed"],
                plain_host_ms=host["plain"],
                bound_by="bytes" if kb >= ko else "operations")


def check_noise(mod, n=LENET_PARAMS):
    """The receiver-noise stream of one round key: its bits on the card
    equal the CPU's; the Threefry kernel's normal draw (one launch) equals
    its plain version (``prng.draw_plain``) on the card and on the CPU to
    the bit, and is timed beside it.  Returns (timings, max abs error)."""
    from repro_torch.core import ota, prng

    key = ota.horizon_keys(0, 4)[3]
    card = prng.random_bits(key, n, device="cuda").cpu()
    check(torch.equal(card, prng.random_bits(key, n, device="cpu")),
          "noise bits differ between the card and the CPU")
    counted = mod.threefry_draw.launches

    def kern_fn():
        return prng.normal(key, n, device="cuda")

    def plain_fn():
        return prng.draw_plain(key, n, prng.NORMAL_LO, 1.0, normal=True,
                               device="cuda")

    z = kern_fn()
    check(mod.threefry_draw.launches == counted + 1,
          "the normal draw did not launch the Threefry kernel once")
    err = _bits_equal(z, plain_fn())
    _bits_equal(z, prng.normal(key, n, device="cpu"))
    host = _time_ms(kern_fn, iters=200, warmup=20)
    plain_host = _time_ms(plain_fn, iters=5, warmup=1)
    dev = {"kernel": _device_ms(kern_fn), "kernel2": _device_ms(kern_fn)}
    # the plain version's ~1,300 launches per call exceed the queue
    dev["plain"], plain_launches = _busy_ms(plain_fn)
    mod.threefry_draw.launches = counted    # timing launches don't count
    t_bytes = 4 * n / PEAK_BYTES_PER_S * 1e3
    t_ops = THREEFRY_OPS * n / PEAK_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    log(f"[noise] round key {key.tolist()}: {n} bits equal on the card and "
        f"the CPU; normals of the Threefry kernel bit-equal to its plain "
        f"version on the card and the CPU (max abs err {err!r}); draw of "
        f"{n} normals per round: device kernel {dev['kernel'] * 1e3:.3f} us "
        f"(again {dev['kernel2'] * 1e3:.3f})  plain {dev['plain'] * 1e3:.1f} "
        f"us busy in {plain_launches:.0f} launches (torch.profiler); "
        f"host-inclusive kernel {host * 1e3:.3f} us  plain "
        f"{plain_host * 1e3:.1f} us; bound {bound * 1e3:.4f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {4 * n} B, "
        f"{THREEFRY_OPS * n} op); {dev['kernel'] / bound:.2f}x the bound")
    return dict(ms=dev["kernel"], plain_ms=dev["plain"], library_ms=None,
                bound_ms=bound, host_ms=host, plain_host_ms=plain_host,
                bound_by="bytes" if t_bytes >= t_ops else "operations"), err


# --------------------------------------------------------------------------
# the DoReFa quantizer kernels and the packed codec
# --------------------------------------------------------------------------

def _bits_equal(got, want):
    """Same shape and type and equal bits (the card's tensor against a
    plain version's on the card or the CPU); returns the max abs error."""
    got = got.cpu()
    want = want.cpu()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    if got.dtype.is_floating_point:
        # NaN at the same places (a NaN's payload may differ), the rest
        # bit for bit
        nan = torch.isnan(got)
        check(torch.equal(nan, torch.isnan(want)), "NaN at other places")
        got, want = got[~nan], want[~nan]
        view = torch.int16 if got.element_size() == 2 else torch.int32
        same = torch.equal(got.view(view), want.view(view))
    else:
        same = torch.equal(got, want)
    diff = (got.double() - want.double()).abs().masked_fill(got == want, 0)
    err = diff.max().item() if got.numel() else 0.0     # equal Infs give 0
    check(same, f"bits differ (max abs err {err!r})")
    return err


def _dorefa_case(shape, dtype, seed):
    """Normals x0.3 (tests/test_kernels.py's data) and their max-abs
    scale, on the card."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 0.3).to(dtype)
    scale = torch.amax(torch.abs(x.to(torch.float32))).clamp_min(1e-12)
    return x.to("cuda"), scale.to("cuda")


def _dorefa_one(mod, x, s, bits, n_out, what):
    """The three kernels once on (x, s) against their plain versions on the
    card and on the CPU; returns the largest absolute difference."""
    xc, sc = x.cpu(), s.cpu()
    n = x.numel()
    wrappers = (mod.quantize_codes, mod.dequantize_codes,
                mod.quantize_dequantize)
    before = [fn.launches for fn in wrappers]
    codes = mod.quantize_codes(x, s, bits, n_out)
    deq = mod.dequantize_codes(codes[:n], s, bits)
    qdq = mod.quantize_dequantize(x, s, bits)
    torch.cuda.synchronize()
    check([fn.launches for fn in wrappers] == [b + 1 for b in before],
          f"DoReFa launches at {what}")
    worst = 0.0
    try:
        for got, card, cpu in (
            (codes, mod.quantize_codes_plain(x, s, bits, n_out),
             mod.quantize_codes_plain(xc, sc, bits, n_out)),
            (deq, mod.dequantize_codes_plain(codes[:n], s, bits),
             mod.dequantize_codes_plain(codes[:n].cpu(), sc, bits)),
            (qdq, mod.quantize_dequantize_plain(x, s, bits),
             mod.quantize_dequantize_plain(xc, sc, bits)),
        ):
            worst = max(worst, _bits_equal(got, card), _bits_equal(got, cpu))
    except SmokeFailure as exc:
        raise SmokeFailure(f"DoReFa kernel at {what}: {exc}")
    check(bool(torch.all(codes[n:] == 0)), f"nonzero pad codes at {what}")
    return worst


def compare_dorefa(mod):
    """The three kernels against their plain versions, on the card and on
    the CPU, over shapes x types x bits; the quantize kernel also with the
    reference's tile padding (zero codes past n).  Then NaN and Inf
    elements under a finite, NaN, Inf, zero or negative scale: NaN must
    stay NaN (code 0), as in the reference.  Returns the largest absolute
    difference of any kind (it must be 0)."""
    n_cases = 0
    worst = 0.0
    for si, shape in enumerate(DOREFA_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, s = _dorefa_case(shape, dtype, seed=si)
            n_out = -(-x.numel() // (256 * 128)) * (256 * 128)
            for bits in DOREFA_BITS:
                worst = max(worst, _dorefa_one(
                    mod, x, s, bits, n_out, f"{shape} {dtype} b={bits}"))
                n_cases += 1
    n_views = 0
    for dtype in (torch.float32, torch.bfloat16):
        buf, s = _dorefa_case((LENET_LEAVES[0] + 64,), dtype, seed=77)
        for off in range(1, 16 // buf.element_size()):
            for n in (LENET_LEAVES[0] + off, 4096 + off):
                for bits in (1, 8, 32):
                    worst = max(worst, _dorefa_one(
                        mod, buf[off:off + n], s, bits, n + 3,
                        f"view at offset {off} n={n} {dtype} b={bits}"))
                    n_views += 1
    gen = torch.Generator().manual_seed(78)
    cbuf = torch.randint(-(2 ** 31), 2 ** 31, (LENET_LEAVES[0] + 64,),
                         generator=gen, dtype=torch.int64).to(torch.int32)
    cbuf[[1, 2, 5]] = torch.tensor([-(2 ** 31), 2 ** 31 - 1, 0],
                                   dtype=torch.int32)
    cbuf = cbuf.to("cuda")
    for off in range(1, 4):
        for n in (LENET_LEAVES[0] + off, 4096 + off, 5 + off):
            c = cbuf[off:off + n]
            for scale in (0.37, 0.0, float("nan")):
                s = torch.tensor(scale, dtype=torch.float32, device="cuda")
                for bits in (1, 8, 32):
                    got = mod.dequantize_codes(c, s, bits)
                    try:
                        worst = max(worst, _bits_equal(
                            got, mod.dequantize_codes_plain(c, s, bits)),
                            _bits_equal(got, mod.dequantize_codes_plain(
                                c.cpu(), s.cpu(), bits)))
                    except SmokeFailure as exc:
                        raise SmokeFailure(
                            f"dequantize_codes on a view at offset {off} "
                            f"n={n} scale {scale} b={bits}: {exc}")
                    n_views += 1
    n_odd = 0
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.5,
                            -0.5, 0.0, -0.0, 1e30, -float("nan")])
    for dtype in (torch.float32, torch.bfloat16):
        x, _ = _dorefa_case((4099,), dtype, seed=99)
        x[:special.numel()] = special.to(dtype)
        for scale in DOREFA_ODD_SCALES:
            s = torch.tensor(scale, dtype=torch.float32, device="cuda")
            for bits in (3, 31, 32):
                what = f"non-finite {dtype} scale={scale} b={bits}"
                worst = max(worst, _dorefa_one(mod, x, s, bits, 32_768, what))
                check(mod.quantize_codes(x, s, bits)[0].item() == 0
                      and bool(torch.isnan(
                          mod.quantize_dequantize(x, s, bits)[0])),
                      f"a NaN element lost its NaN at {what}")
                n_odd += 1
    log(f"[dorefa-kernel] {n_cases} cases x 3 kernels (shapes "
        f"{[s[0] if len(s) == 1 else s for s in DOREFA_SHAPES]}, float32 and "
        f"bfloat16, bits {DOREFA_BITS}), {n_views} on views at every element "
        f"offset off 16 bytes (dequantize_codes also on int32 views with "
        f"INT_MIN / INT_MAX codes and a zero and NaN scale), and {n_odd} "
        f"with NaN / Inf elements "
        f"(scales {DOREFA_ODD_SCALES}, bits 3, 31, 32): codes equal, outputs "
        f"bit-equal to the plain versions on the card and on the CPU (NaN at "
        f"the same places), pad codes 0; max abs err {worst!r}")
    return worst


def time_dorefa(mod, n, bits=8):
    """Each quantizer kernel at n float32 elements: device time (behind
    the sleep kernel) and host-inclusive time (interleaved
    plain/kernel/kernel/plain) beside its plain version, one PyTorch call
    computing the same function (for quantize_codes and quantize_dequantize
    one that rounds x * (a / s) instead, timed only), and the bound: each
    input read once, each output written once, at 3.35 TB/s.  Returns
    {kernel name: timing dict}."""
    x, s = _dorefa_case((n,), torch.float32, seed=n)
    n_out = -(-n // (256 * 128)) * (256 * 128)
    codes = mod.quantize_codes(x, s, bits, n_out)
    step = s * mod.inv_levels(bits)
    a = mod.levels(bits)
    fq_scale = s.item() / a     # read once: a sync inside a call would spoil
                                # the timing behind the sleep kernel
    counted = {name: getattr(mod, name).launches for name in
               ("quantize_codes", "dequantize_codes", "quantize_dequantize")}
    cases = {
        # name: (kernel, plain, library or None, bytes, operations)
        "quantize_codes": (
            lambda: mod._quantize_codes_launch(x, s, bits, n_out),
            lambda: mod.quantize_codes_plain(x, s, bits, n_out),
            lambda: torch.quantize_per_tensor(x, fq_scale, 0, torch.qint32),
            4 * n + 4 * n_out + 4, 5 * n),
        "dequantize_codes": (
            lambda: mod._dequantize_codes_launch(codes[:n], s, bits),
            lambda: mod.dequantize_codes_plain(codes[:n], s, bits),
            lambda: torch.mul(codes[:n], step), 8 * n + 4, 2 * n),
        "quantize_dequantize": (
            lambda: mod._quantize_dequantize_launch(x, s, bits),
            lambda: mod.quantize_dequantize_plain(x, s, bits),
            lambda: torch.fake_quantize_per_tensor_affine(
                x, fq_scale, 0, -int(a), int(a)),
            8 * n + 4, 6 * n),
    }
    lib_err = _bits_equal(cases["dequantize_codes"][2](),
                          cases["dequantize_codes"][0]())
    q_lib = cases["quantize_codes"][2]().int_repr()
    q_off = (q_lib - cases["quantize_codes"][0]()[:n]).abs()
    q_diff, q_worst = int(torch.count_nonzero(q_off)), int(q_off.max())
    out = {}
    for name, (kern_fn, plain_fn, lib_fn, nbytes, ops) in cases.items():
        plain = _time_ms(plain_fn, iters=50, warmup=5)
        kern = _time_ms(kern_fn)
        kern = 0.5 * (kern + _time_ms(kern_fn))
        plain = 0.5 * (plain + _time_ms(plain_fn, iters=50, warmup=5))
        dev_k = _device_ms(kern_fn, iters=50)
        dev_p = _device_ms(plain_fn, iters=20)
        dev_l = _device_ms(lib_fn, iters=50) if lib_fn else None
        lib_host = _time_ms(lib_fn) if lib_fn else None
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        lib_txt = ("none" if lib_fn is None else
                   f"device {dev_l * 1e3:.3f} us host-inclusive "
                   f"{lib_host * 1e3:.3f} us")
        log(f"[time] {name} n={n} b={bits}: kernel device "
            f"{dev_k * 1e3:.3f} us host-inclusive {kern * 1e3:.3f} us; plain "
            f"device {dev_p * 1e3:.3f} us host-inclusive {plain * 1e3:.3f} "
            f"us; library {lib_txt}; bound {bound * 1e3:.3f} us "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}); "
            f"{dev_k / bound:.2f}x the bound")
        out[name] = dict(ms=dev_k, plain_ms=dev_p, library_ms=dev_l,
                         bound_ms=bound, host_ms=kern, plain_host_ms=plain,
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    for name, lib_name, attributes in (
            ("quantize_codes", "quantize_per_tensor",
             lambda: mod.quantize_codes_attributes(torch.float32)),
            ("dequantize_codes", "torch.mul",
             mod.dequantize_codes_attributes),
            ("quantize_dequantize", "fake_quantize_per_tensor_affine",
             lambda: mod.quantize_dequantize_attributes(torch.float32))):
        ratio = out[name]["ms"] / out[name]["library_ms"]
        log(f"[time] {name} n={n}: kernel/library ({lib_name}) device-time "
            f"ratio {ratio:.3f} in this run; kernel "
            f"{_attributes_text(attributes())}")
    for name, value in counted.items():
        getattr(mod, name).launches = value   # timing launches don't count
    log(f"[time] dequantize_codes n={n}: torch.mul(codes, s * fl(1/a)) "
        f"equals the kernel to the bit (max abs err {lib_err!r}); "
        f"quantize_per_tensor (qint32, scale s/a) and "
        f"fake_quantize_per_tensor_affine are timed only (another rounding: "
        f"{q_diff} of {n} codes differ from the kernel's, by at most "
        f"{q_worst})")
    return out


def run_codec(kernels, host_run):
    """The packed codec on the card over the M=300 host run's LeNet update
    (final minus initial parameters): encode_tree -> decode_tree and
    ops.quantize_dequantize with the kernels (use_pallas=True) at each
    width, each result equal to the CPU's plain path to the bit.  Launch
    counts are zeroed just before and read just after; returns (launches
    per kernel, max abs err)."""
    from repro_torch.core import compression
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels import ops
    from repro_torch.models.fl_models import get_fl_model

    init = get_fl_model("lenet").init(0, device="cuda")
    update = tree_lib.tree_map(lambda a, b: a - b, host_run.final_params, init)
    update_cpu = tree_lib.tree_map(lambda v: v.cpu(), update)
    leaves = tree_lib.tree_flatten(update)[0]
    run_bits = sorted({int(b) for lg in host_run.logs for b in lg.bits})
    widths = sorted(set(CODEC_BITS) | {b for b in run_bits if b < 32})
    worst = 0.0
    reset_launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bits in widths:
        enc = compression.encode_tree(update, bits, use_pallas=True)
        dec = compression.decode_tree(enc, use_pallas=True)
        qdq = [ops.quantize_dequantize(v, bits, use_pallas=True)
               for v in leaves]
        want_enc = compression.encode_tree(update_cpu, bits, use_pallas=True)
        want_dec = compression.decode_tree(want_enc, use_pallas=True)
        n = sum(v.numel() for v in leaves)
        check(enc.total_bits == n * (bits + 1) + 32 * len(leaves)
              == want_enc.total_bits, f"total_bits at b={bits}")
        check(enc.shapes == want_enc.shapes, f"shapes at b={bits}")
        try:
            for c, wc in zip(enc.codes, want_enc.codes):
                worst = max(worst, _bits_equal(c, wc))
            for sc, ws in zip(enc.scales, want_enc.scales):
                worst = max(worst, _bits_equal(sc, ws))
            for d, wd, q, v in zip(tree_lib.tree_flatten(dec)[0],
                                   tree_lib.tree_flatten(want_dec)[0], qdq,
                                   tree_lib.tree_flatten(update_cpu)[0]):
                worst = max(worst, _bits_equal(d, wd), _bits_equal(
                    q, ops.quantize_dequantize(v, bits, use_pallas=True)))
                check(bool(torch.isfinite(d).all()), f"decode at b={bits}")
        except SmokeFailure as exc:
            raise SmokeFailure(f"[codec] at b={bits}: {exc}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(kernels)
    per = len(widths) * len(leaves)
    for name in ("quantize_codes", "dequantize_codes", "quantize_dequantize"):
        check(launches[name] == per,
              f"{name} launched {launches[name]} times, expected {per}")
    check(launches["weighted_aggregate"] == 0, "[codec] launched aggregation")
    log(f"[codec] LeNet update of the M=300 host run at bits {widths} (the "
        f"run's own adaptive widths {run_bits}): codes, scales, decoded and "
        f"fused outputs equal the CPU plain path to the bit (max abs err "
        f"{worst!r}); total_bits = sum n(b+1) + 32 per leaf; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({len(leaves)} "
        f"quantize + {len(leaves)} dequantize per round trip and "
        f"{len(leaves)} fused per width); {secs:.3f} s with the CPU side")
    return launches, worst


# --------------------------------------------------------------------------
# the scheduler at paper width
# --------------------------------------------------------------------------

def _sched_instance(m, t, seed=0):
    """benchmarks/scheduling_bench.py:_instance, the BENCH_scheduling.json
    instances."""
    rng = np.random.default_rng(seed)
    gains = np.abs(rng.normal(1e-6, 5e-7, (t, m))) + 1e-8
    w = rng.dirichlet(np.ones(m))
    return gains, w


def _same_schedule(a, b):
    return a.rounds == b.rounds and a.weighted_sum_rate == b.weighted_sum_rate


def _fused_on_card(gains, w, k, pool, scorer, behind_sleep=False):
    """The fused loop alone with every host sync an error; returns the
    rounds it selected (read back after the mode is lifted).

    PyTorch calls its sync-debug mode a prototype that may miss a sync, so
    with ``behind_sleep`` the loop is also queued behind a sleep kernel: if
    the host issues every step while the card still sleeps, no step waited
    for the card.  That proof holds only while the loop's launches fit the
    card's launch queue (past it the host blocks until the card drains the
    queue, as the paper-width loops, of thousands of launches, do), so it
    is made at the FL main path's shape, hundreds of launches."""
    from repro_torch.core import rates_device, scheduling

    pool, kk, (g, wt, solo, subs) = scheduling._device_greedy_inputs(
        gains, w, pool, k, PMAX, NOISE, torch.device("cuda"))
    torch.cuda.synchronize()
    if behind_sleep:
        torch.cuda._sleep(10 * SLEEP_CYCLES)
        asleep = torch.cuda.Event()
        asleep.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assign, done, _ = rates_device.greedy_rounds_fused(
            g, wt, solo, subs, pool=pool, pmax=PMAX, noise_power=NOISE,
            scorer=scorer)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if behind_sleep:
        check(not asleep.query(), "the card finished its sleep before the "
              "host had issued the fused loop: a step waited for the card")
    assign, done = assign.cpu().numpy(), done.cpu().numpy()
    return [tuple(int(d) for d in assign[t]) if done[t] else ()
            for t in range(len(done))]


def _profile_schedule(fn):
    """Kernels launched and device-busy ms of one call (torch.profiler),
    beside its host wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return len(kernels), busy, wall


def run_scheduler(sic):
    """The four backends at the BENCH_scheduling.json widths, the no-sync
    checks of the fused loop, and the equal-gains tie-break."""
    from repro_torch.core import scheduling

    backends = (("numpy", "xla"), ("jax", "xla"), ("jax", "pallas"),
                ("jax-stepwise", "xla"))

    def schedule(gains, w, k, pool, backend, scorer):
        return scheduling.lazy_greedy_schedule(
            gains, w, k, noise_power=NOISE, pmax=PMAX, candidate_pool=pool,
            backend=backend, scorer=scorer, device="cuda")

    # warm-up on a small instance: the device backends' first calls
    g_eq, w_eq = _sched_instance(48, 6, seed=1)
    for backend, scorer in backends[1:]:
        schedule(g_eq, w_eq, 3, 16, backend, scorer)
    # equal gains and weights: every subset ties, the first maximum wins
    g_tie = np.full((4, 12), 1e-6)
    w_tie = np.full(12, 1.0 / 12)
    ties = [schedule(g_tie, w_tie, 3, 8, b, sc) for b, sc in backends]
    check(all(_same_schedule(ties[0], x) for x in ties[1:]),
          f"equal-gains schedules differ: {[x.rounds for x in ties]}")
    log(f"[sched] equal gains M=12 T=4: all backends pick {ties[0].rounds}")

    for m, t, k, pool in SCHED_CASES:
        gains, w = _sched_instance(m, t)
        out = {}
        for backend, scorer in backends:
            before = sic.sic_weighted_rates.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[(backend, scorer)] = schedule(gains, w, k, pool, backend, scorer)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = sic.sic_weighted_rates.launches - before
            log(f"[sched] M={m} T={t} K={k} pool={pool} {backend}/{scorer}: "
                f"{secs:.3f} s wsum {out[(backend, scorer)].weighted_sum_rate!r}"
                f" SIC launches {launches}")
            if scorer == "pallas":
                check(launches == min(t, m // k),
                      f"SIC launches {launches}, expected {min(t, m // k)} "
                      f"greedy steps")
        ref = out[("numpy", "xla")]
        for key, sched in out.items():
            check(_same_schedule(ref, sched),
                  f"M={m}: {key} schedule differs from the numpy backend")
        for scorer in ("xla", "pallas"):
            rounds = _fused_on_card(gains, w, k, pool, scorer)
            check(rounds == ref.rounds,
                  f"M={m}: fused loop ({scorer}) under sync-debug differs")
        log(f"[sched] M={m}: numpy, jax/xla, jax/pallas, jax-stepwise "
            f"identical; fused loop (xla, pallas) ran under sync-debug "
            f"'error'")
        for backend, scorer in backends[1:]:
            n_kern, busy, wall = _profile_schedule(
                lambda: schedule(gains, w, k, pool, backend, scorer))
            log(f"[sched] M={m} {backend}/{scorer} profiled: {n_kern} "
                f"kernels, device busy {busy:.3f} ms of {wall:.3f} ms wall "
                f"(idle share {1 - busy / wall:.3f})")
    # the FL main path's greedy shape: the whole loop fits the launch queue
    gains, w = _sched_instance(300, 5)
    ref = schedule(gains, w, 3, 24, "numpy", "xla")
    for scorer in ("xla", "pallas"):
        rounds = _fused_on_card(gains, w, 3, 24, scorer, behind_sleep=True)
        check(rounds == ref.rounds, f"M=300 T=5: fused loop ({scorer}) differs")
    log("[sched] M=300 T=5 pool=24: fused loop (xla, pallas) issued whole "
        "while the card slept: no step waited for the card")


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


def _config(m, t, backend="numpy", uplink="noma", **overrides):
    """The main path's settings; ``uplink="ota"`` takes the reference's OTA
    configuration (raw updates, ota-align powers, receiver noise 1e-9);
    ``overrides`` replace any field."""
    from repro_torch.config import FLConfig

    extra = {}
    if uplink == "ota":
        extra = dict(compression="none", power_mode="ota-align",
                     ota_noise=OTA_NOISE, ota_threshold=0.0)
    extra.update(overrides)
    return FLConfig(**{**dict(
        num_devices=m, group_size=3, num_rounds=t, scheduler="lazy-gwmin",
        scheduler_backend=backend, power_mode="mapel",
        compression="adaptive", fl_engine="batched", use_pallas=True,
        uplink=uplink, seed=0,
    ), **extra})


def _legacy_config(m, t, uplink="noma", **overrides):
    """``FLConfig``'s defaults (the legacy engine, ``use_pallas=False``,
    numpy lazy GWMIN, MAPEL, adaptive DoReFa, NOMA) at M devices and T
    rounds; ``uplink="ota"`` the reference's OTA settings with the keyed
    OTA kernel (``use_pallas=True``); ``overrides`` replace any field."""
    from repro_torch.config import FLConfig

    extra = {}
    if uplink == "ota":
        extra = dict(uplink="ota", compression="none",
                     power_mode="ota-align", ota_noise=OTA_NOISE,
                     use_pallas=True)
    extra.update(overrides)
    return FLConfig(num_devices=m, num_rounds=t, **extra)


# the online policies' main-path modes -> their FLConfig overrides;
# "online-mp*" run under OTA, "online-legacy" on the legacy engine
ONLINE_MODES = {
    "online": dict(scheduler="update-aware"),
    "online-age": dict(scheduler="age-fair", power_mode="max"),
    "online-max": dict(scheduler="update-aware", power_mode="max"),
    "online-scan": dict(scheduler="update-aware", power_mode="max",
                        horizon="scan"),
    "online-mp": dict(scheduler="matching-pursuit"),
    "online-mp-scan": dict(scheduler="matching-pursuit", horizon="scan"),
    "online-legacy": dict(scheduler="update-aware"),
}


RUN_SECONDS = {}    # main-path mode -> seconds of its run after the schedule


def run_main_path(kernels, mode, m=300, t=5, samples=12_000):
    """Paper-width run on the card; returns (result, launches per kernel).

    ``mode`` picks where the schedule is planned: ``"host"`` (numpy
    backend, before the run), ``"jax"`` (``scheduler_backend="jax"``,
    inside the run, on the card) or ``"pallas"`` (``get_policy
    ("lazy-gwmin")`` on the card with the SIC kernel as scorer, handed to
    the run as ``schedule=``); ``"ota"`` and ``"tdma"`` take that uplink
    with the host schedule, ``"topk"`` the top-k stage (``topk=0.1``) and
    ``"bucketed"`` the bucketed client bank, ``"random"`` the random
    schedule; ``"legacy"`` runs ``FLConfig``'s defaults (the legacy round
    body, no kernel but the initial draws) and ``"legacy-ota"`` the legacy
    round under OTA with the keyed OTA kernel, both with the host schedule;
    ``"scan"`` and ``"scan-ota"`` run the host and OTA modes with
    ``horizon="scan"``, the horizon's device part under
    ``set_sync_debug_mode("error")``; the ``ONLINE_MODES`` run an online
    policy, which selects inside the run (per round each round's norms fed
    to the policy are printed; a scanned horizon selects on the card).
    The launch counts are zeroed just before and read just after the
    schedule and the run; the run's seconds go to ``RUN_SECONDS``."""
    from repro_torch.core import channel, fl, scheduling

    ds, cell, shards = _world(m, samples)
    uplink = "ota" if mode in ("ota", "legacy-ota", "scan-ota", "online-mp",
                               "online-mp-scan") else (
        "tdma" if mode == "tdma" else "noma")
    legacy = mode in ("legacy", "legacy-ota", "online-legacy")
    scan = mode in ("scan", "scan-ota", "online-scan", "online-mp-scan")
    overrides = {"topk": dict(topk=TOPK),
                 "bucketed": dict(client_bank="bucketed"),
                 "random": dict(scheduler="random"),
                 "scan": dict(horizon="scan"),
                 "scan-ota": dict(horizon="scan"),
                 **ONLINE_MODES}.get(mode, {})
    if legacy:
        cfg = _legacy_config(m, t, uplink, **overrides)
    else:
        cfg = _config(m, t, "jax" if mode in ("jax", "pallas") else "numpy",
                      uplink, **overrides)
    bundle = channel.sample_channels(cfg.seed, cell, cfg.num_rounds)
    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    reset_launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    schedule = None
    if mode in ("host", "ota", "tdma", "topk", "bucketed", "random",
                "legacy", "legacy-ota", "scan", "scan-ota"):
        schedule = fl.make_schedule(bundle.gains, sizes / sizes.sum(), cell,
                                    cfg)
    elif mode == "pallas":
        pcfg = dataclasses.replace(
            fl.policy_config(cell, cfg, "cuda"), scorer="pallas")
        schedule = scheduling.build_schedule(
            scheduling.get_policy("lazy-gwmin"), bundle.gains,
            sizes / sizes.sum(), pcfg)
    t_sched = time.perf_counter() - t0
    if schedule is not None:
        log(f"[main:{mode}] M={m} K={cfg.group_size} T={t} samples={samples}"
            f" engine={cfg.fl_engine} use_pallas={cfg.use_pallas}: schedule "
            f"({cfg.scheduler} + {cfg.power_mode}) {t_sched:.3f} s")

    stamps = []    # host clock at the start, then after each round
    fed = []       # the norms an online policy was fed, round by round
    record = scheduling.Observation.record_round

    def keep_norms(self, t, group, rates_k, update_norms_k=None):
        fed.append([] if update_norms_k is None else list(update_norms_k))
        return record(self, t, group, rates_k, update_norms_k)

    def progress(lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        # a scanned horizon logs its rounds after its one download
        host = ("" if scan else
                f" host {stamps[-1] - stamps[-2]:.4f} s")
        norms = (f" norms {[float(f'{v:.6g}') for v in fed[-1]]}"
                 if fed and fed[-1] else "")
        log(f"[main:{mode}] round {lg.round}: devices {list(lg.devices)} bits "
            f"{lg.bits.tolist()} acc {lg.test_accuracy:.4f} sim_time "
            f"{lg.wall_time_s:.4f} s{host}{norms}")

    def run():
        return fl.run_federated_learning(
            ds, shards, cell, cfg, channels=bundle, schedule=schedule,
            progress=progress, device="cuda",
        )

    horizon_s = []
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    t1 = stamps[0]
    scheduling.Observation.record_round = keep_norms
    try:
        res = _with_checked_horizon(run, horizon_s) if scan else run()
    finally:
        scheduling.Observation.record_round = record
    torch.cuda.synchronize()
    total = time.perf_counter() - t1
    RUN_SECONDS[mode] = total
    launches = read_launches(kernels)
    log(f"[main:{mode}] run {total:.3f} s after the schedule"
        f"{' (schedule inside the run)' if schedule is None else ''}; "
        f"launches {launches}")
    if scan:
        check(len(horizon_s) == 1, f"[main:{mode}] ran {len(horizon_s)} "
              f"horizons")
        log(f"[main:{mode}] the horizon's device part (after its one upload, "
            f"before its one download) ran under torch.cuda."
            f"set_sync_debug_mode('error'): no host sync; {horizon_s[0]:.4f} "
            f"s for {t} rounds, {horizon_s[0] / t:.4f} s per round")

    nonempty = sum(1 for lg in res.logs if lg.devices)
    acc = res.accuracies()
    want = {name: 0 for name in launches}   # the codec and flash decode
    # one grouped launch for the six leaves, or one on the concatenated
    # payload under top-k, per non-empty round of the batched engine and
    # per round of a scanned horizon (which sums all-padding rounds too);
    # the legacy round sums on the host
    rounds = t if scan else nonempty
    want["weighted_aggregate"] = (
        0 if uplink == "ota" or legacy else rounds)
    want["ota_aggregate"] = (
        rounds if uplink == "ota" and cfg.use_pallas else 0)
    want["sic_weighted_rates"] = (
        min(t, m // cfg.group_size) if mode == "pallas" else 0)
    # LeNet's initial weights; the OTA round forms its noise inside the
    # keyed OTA kernel, so it draws none
    want["threefry_draw"] = LENET_WEIGHT_LEAVES
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times on [main:{mode}], "
              f"expected {n} ({nonempty} non-empty rounds)")
    check(bool(np.all(np.isfinite(acc))), f"non-finite accuracy {acc}")
    check(acc[-1] > acc[0], f"accuracy did not improve: {acc.tolist()}")
    if mode in ONLINE_MODES and not scan:
        check(len(fed) == t, f"[main:{mode}] fed its policy {len(fed)} times")
        if cfg.scheduler != "age-fair":
            check(all(len(f) == len(lg.devices) and np.all(np.isfinite(f))
                      and min(f, default=1.0) > 0.0
                      for f, lg in zip(fed, res.logs)),
                  f"[main:{mode}] norms fed to the policy: {fed}")
    for layer in res.final_params.values():
        for leaf in layer.values():
            check(leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all()),
                  "final parameters not finite on the card")
    return res, launches


def _paired_leaves(got, want, label):
    """(path, got's leaf, want's leaf) for every leaf of two parameter
    trees, matched by path; the two must hold the same paths."""
    from repro_torch.utils.tree import tree_flatten_with_paths

    a = dict(tree_flatten_with_paths(got))
    b = dict(tree_flatten_with_paths(want))
    check(a.keys() == b.keys(),
          f"{label} leaves differ: {sorted(a.keys() ^ b.keys())}")
    return [(path, a[path], b[path]) for path in a]


def _check_equal_logs(got, want, label):
    """One engine's run against another's on the same draws: schedules,
    bits, rates, ratios and times exact, accuracy within ACC_ATOL; returns
    the worst mean and max parameter drift over the leaves, which it
    prints."""
    check([lg.devices for lg in got.logs] == [lg.devices for lg in want.logs],
          f"{label} schedules differ")
    for a, b in zip(got.logs, want.logs):
        for field in ("bits", "rates", "compression_ratios"):
            check(np.array_equal(getattr(a, field), getattr(b, field)),
                  f"{label} round {a.round} {field} differ")
    check(np.array_equal(got.times(), want.times()), f"{label} times differ")
    acc_gap = float(np.max(np.abs(got.accuracies() - want.accuracies())))
    check(acc_gap <= ACC_ATOL, f"{label} accuracy gap {acc_gap}")
    worst_mean = worst_max = 0.0
    for _, a, v in _paired_leaves(got.final_params, want.final_params,
                                  label):
        d = (a.double().cpu() - v.double().cpu()).abs()
        worst_mean = max(worst_mean, d.mean().item())
        worst_max = max(worst_max, d.max().item())
    log(f"{label} schedules/bits/rates/ratios/times equal, acc gap "
        f"{acc_gap!r}, param drift mean {worst_mean!r} max {worst_max!r}")
    return worst_mean, worst_max


def _check_code_flips(cpu_rounds, card_rounds, k, label):
    """F1's shape (ROADMAP.md queue 3, tests/test_torch_fl.py): round by
    round the card's weights stay within float order of the CPU's until a
    round in which a few elements jump, DoReFa codes flipped on a rounding
    boundary, at most one per scheduled client.  A wrong bit width, scale
    or schedule would move whole leaves in the first round it touched."""
    check(len(cpu_rounds) == len(card_rounds) > 0, f"{label} round count")
    for t, (a, b) in enumerate(zip(cpu_rounds, card_rounds)):
        jumped = {name: int(((a[name] - b[name]).abs() > F1_FLOAT_ORDER)
                            .sum()) for name in a}
        if sum(jumped.values()):
            break
    else:
        return
    check(t > 0, f"{label}: round 0 already leaves float order {jumped}")
    check(sum(jumped.values()) <= k,
          f"{label}: round {t}: {sum(jumped.values())} elements beyond float "
          f"order {jumped}")
    log(f"{label}: the final weights leave the drift contract as in F1 "
        f"(float order amplified by quantization, ROADMAP.md queue 3): float "
        f"order until round {t}, where {sum(jumped.values())} element(s) "
        f"jump (at most K={k} code flips) {jumped}")


def _check_identical_runs(got, want, label):
    """Logs and final parameters equal to the bit."""
    for a, b in zip(got.logs, want.logs):
        check(a.devices == b.devices and a.test_accuracy == b.test_accuracy
              and a.wall_time_s == b.wall_time_s,
              f"{label} round {a.round} differs")
        for field in ("bits", "rates", "compression_ratios"):
            check(np.array_equal(getattr(a, field), getattr(b, field)),
                  f"{label} round {a.round} {field} differ")
    check(len(got.logs) == len(want.logs), f"{label} round count")
    for path, a, v in _paired_leaves(got.final_params, want.final_params,
                                     label):
        check(torch.equal(a, v), f"{label} final {path} differs")
    log(f"{label} logs and final parameters equal the host run's to the bit")


def run_ota_main_path(kernels):
    """``run_main_path(kernels, "ota")``, keeping a copy of the first OTA
    round's keyed-kernel inputs (updates, coefficients, round key, noise
    scale), on which the keyed kernel is then held to its plain version and
    to the strip kernel fed ``scale * prng.normal(key, P)``, in the same
    row layout.  The copy is taken around the wrapper, which still launches
    and counts; every round's payload must reach the kernel in rows it
    reads with 16-byte loads.  Returns (result, launches per kernel, the
    kernel's max abs error on the path's round)."""
    from repro_torch.core import ota
    from repro_torch.kernels import ota_aggregate

    seen, layouts = [], []
    launch = ota.ota_aggregate_keyed

    def keep_first(flat, coeff, key, scale):
        layouts.append(_vector_rows(flat))
        if not seen:
            seen.append((flat.clone(), coeff.clone(), np.array(key),
                         scale.clone()))
        return launch(flat, coeff, key, scale)

    ota.ota_aggregate_keyed = keep_first
    try:
        res, launches = run_main_path(kernels, "ota")
    finally:
        ota.ota_aggregate_keyed = launch
    check(bool(seen), "the OTA main path never reached the OTA kernel")
    check(all(layouts), f"OTA payload rows not spaced for 16-byte loads: "
          f"{layouts}")
    x, coeff, key, scale = seen[0]
    x = _spaced(ota_aggregate, x)
    counted = ota_aggregate.ota_aggregate.launches
    err = _ota_keyed_errors(
        ota_aggregate, x, coeff, key, scale,
        f"the main path's round (K={x.shape[0]}, P={x.shape[1]})")
    ota_aggregate.ota_aggregate.launches = counted   # the check doesn't count
    log(f"[ota-kernel] main path's own round K={x.shape[0]} P={x.shape[1]} "
        f"(key {key.tolist()}, scale {scale.item()!r}): keyed kernel "
        f"bit-equal to its plain version and to the strip kernel fed the "
        f"drawn noise, max abs err {err!r}; {len(layouts)} rounds, every "
        f"payload in 16-byte-load rows, no noise strip drawn")
    return res, launches, err


def run_topk_main_path(kernels):
    """``run_main_path(kernels, "topk")``, recording each round's kept
    counts and a copy of the first round's aggregation-kernel inputs (the
    concatenated (3, 266,610) codes stacked over the (3, 266,610) masked
    values that b = 32 clients pass through, with their scales, weights and
    levels: a (6, 266,610) matrix), on which
    the kernel is then held to its plain version bit for bit.  The copy is
    taken around the wrapper, which still launches and counts.  Returns
    (result, launches per kernel, the kernel's max abs error on the
    round)."""
    from repro_torch.core import fl_engine
    from repro_torch.kernels import aggregate

    kept_seen, inputs = [], []
    sparse, launch = fl_engine._sparse_quantize_aggregate, \
        fl_engine.weighted_aggregate

    def keep_kept(*args, **kwargs):
        out = sparse(*args, **kwargs)
        kept_seen.append(out[1].cpu().tolist())
        return out

    def keep_first(codes, scales, w, levels):
        if not inputs:
            inputs.append((codes.clone(), scales.clone(), w.clone(),
                           levels.clone()))
        return launch(codes, scales, w, levels=levels)

    fl_engine._sparse_quantize_aggregate = keep_kept
    fl_engine.weighted_aggregate = keep_first
    try:
        res, launches = run_main_path(kernels, "topk")
    finally:
        fl_engine._sparse_quantize_aggregate = sparse
        fl_engine.weighted_aggregate = launch
    cap = math.ceil(TOPK * LENET_PARAMS)
    check(len(kept_seen) == sum(1 for lg in res.logs if lg.devices),
          f"the top-k stage ran {len(kept_seen)} times")
    check(all(1 <= k <= cap for row in kept_seen for k in row),
          f"kept outside [1, {cap}]: {kept_seen}")
    codes, scales, w, levels = inputs[0]
    check(tuple(codes.shape) == (2 * 3, LENET_PARAMS),
          f"top-k payload {tuple(codes.shape)}")
    counted = aggregate.weighted_aggregate.launches
    got = aggregate.weighted_aggregate(codes, scales, w, levels=levels)
    want = aggregate.weighted_aggregate_plain(
        codes, aggregate.coefficients(scales, w, levels))
    err = _bits_equal(got, want)
    aggregate.weighted_aggregate.launches = counted  # the check doesn't count
    log(f"[main:topk] kept per round {kept_seen} (cap {cap}); aggregation "
        f"kernel on round 0's (2 x 3, {LENET_PARAMS}) payload (codes over "
        f"passthrough rows) bit-equal to its "
        f"plain version (max abs err {err!r})")
    return res, launches, err


def _timed(fn):
    """(fn(), seconds), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _with_checked_horizon(fn, seen):
    """fn() with every scanned horizon's device part (``fl_engine.
    _horizon_core`` or, for an online policy, ``_online_horizon_core``:
    after the horizon's one upload, before its one download) run under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host sync inside
    raises; each horizon's seconds go to ``seen``."""
    from repro_torch.core import fl_engine

    cores = {name: getattr(fl_engine, name)
             for name in ("_horizon_core", "_online_horizon_core")}

    def checked(core):
        def run(*args, **kwargs):
            torch.cuda.synchronize()            # the upload, queued before
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = core(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            seen.append(time.perf_counter() - t0)
            return out
        return run

    for name, core in cores.items():
        setattr(fl_engine, name, checked(core))
    try:
        return fn()
    finally:
        for name, core in cores.items():
            setattr(fl_engine, name, core)


def _scan_rounds(fn, run):
    """fn() with the scanned round body wrapped to keep run ``run``'s
    parameters after every round on the host: a read of the card every
    round, so never under the sync check.  Returns (fn(), rounds)."""
    from repro_torch.core import fl_engine

    body = fl_engine._train_quantize_aggregate
    rounds = []

    def keep(*args, **kwargs):
        out = body(*args, **kwargs)
        rounds.append({f"{a}/{c}": v[run].double().cpu()
                       for a, d in out[0].items() for c, v in d.items()})
        return out

    fl_engine._train_quantize_aggregate = keep
    try:
        return fn(), rounds
    finally:
        fl_engine._train_quantize_aggregate = body


def _params_equal(got, want, label):
    return all(torch.equal(a, v) for _, a, v in _paired_leaves(
        got.final_params, want.final_params, label))


def run_seed_sweep(kernels, scan_run, m=300, t=5, samples=12_000):
    """``[sweep:seeds]``: ``run_horizon_vmapped`` over SWEEP_SEEDS at the
    ``[main:scan]`` width, beside one ``run_horizon_scanned`` per seed.
    Row 0's logs are held against ``[main:scan]``, every row's against its
    single scan; the final parameters are bit-equal, or within the drift
    contract, or leave it in F1's shape (float order until a round of at
    most K code flips), and the line says which.  Kernel #1 launches
    ceil(6 S / 16) times a round.  Returns the single scans and their
    device parts' seconds."""
    from repro_torch.core import fl

    ds, cell, shards = _world(m, samples)
    cfg = _config(m, t, horizon="scan")
    num = len(SWEEP_SEEDS)
    single_dev, sweep_dev = [], []
    singles, single_s = [], 0.0
    for seed in SWEEP_SEEDS:
        res, sec = _timed(lambda seed=seed: _with_checked_horizon(
            lambda: fl.run_federated_learning(
                ds, shards, cell, dataclasses.replace(cfg, seed=seed),
                device="cuda"), single_dev))
        singles.append(res)
        single_s += sec
    reset_launches(kernels)
    sweep, sweep_s = _timed(lambda: _with_checked_horizon(
        lambda: fl.run_horizon_vmapped(ds, shards, cell, cfg,
                                       seeds=SWEEP_SEEDS, device="cuda"),
        sweep_dev))
    launches = read_launches(kernels)
    per_round = -(-6 * num // 16)
    want = {name: 0 for name in launches}
    want["weighted_aggregate"] = t * per_round
    want["threefry_draw"] = LENET_WEIGHT_LEAVES * num
    check(launches == want, f"[sweep:seeds] launches {launches}, expected "
          f"{want}")
    _check_equal_logs(sweep[0], scan_run,
                      "[sweep:seeds] row 0 against [main:scan]:")
    check(any([lg.devices for lg in res.logs]
              != [lg.devices for lg in sweep[0].logs] for res in sweep[1:]),
          "[sweep:seeds] every seed scheduled as seed 0")
    held = []
    for s, (res, single) in enumerate(zip(sweep, singles)):
        label = f"[sweep:seeds] row {s} (seed {SWEEP_SEEDS[s]}) against its " \
                f"single scan:"
        worst_mean, worst_max = _check_equal_logs(res, single, label)
        if _params_equal(res, single, label):
            held.append("bit-equal")
        elif worst_mean < PARAM_MEAN_ATOL and worst_max < PARAM_MAX_ATOL:
            held.append("drift contract")
        else:
            seed_cfg = dataclasses.replace(cfg, seed=SWEEP_SEEDS[s])
            _, alone = _scan_rounds(lambda: fl.run_federated_learning(
                ds, shards, cell, seed_cfg, device="cuda"), 0)
            _, stacked = _scan_rounds(lambda: fl.run_horizon_vmapped(
                ds, shards, cell, cfg, seeds=SWEEP_SEEDS, device="cuda"), s)
            _check_code_flips(alone, stacked, cfg.group_size, label)
            held.append("F1 shape")
    log(f"[sweep:seeds] S={num} seeds {list(SWEEP_SEEDS)} at M={m} K=3 T={t}:"
        f" final parameters against the single scans: {held}; the device "
        f"part under set_sync_debug_mode('error'): no host sync")
    log(f"[sweep:seeds] kernel #1 {launches['weighted_aggregate'] / t:g} "
        f"launches per round ({6 * num} (seed, leaf) matrices, 16 a launch);"
        f" the sweep {sweep_s / num:.4f} s per seed (device part "
        f"{sweep_dev[0] / num:.4f}) against {num} single scans "
        f"{single_s / num:.4f} s per seed (device part "
        f"{sum(single_dev) / num:.4f}), schedules included")
    return singles, single_dev


def run_cell_sweep(kernels, singles, single_dev, m=300, t=5,
                   samples=12_000):
    """``[sweep:cells]``: ``run_cell_sweep`` with 2 cells of 2 seeds and
    ``cell_shards=2``, which clamps to the card count; every instance's
    logs and final parameters equal its own single scan's to the bit (the
    same ``run_horizon`` program at the same batch count).  Each of the
    four horizons' device part runs under the sync check, and its seconds
    print beside the single scans'."""
    from repro_torch.core import fl
    from repro_torch.sharding import cells

    ds, cell, shards = _world(m, samples)
    cfg = _config(m, t, horizon="scan")
    shards_n = cells.cell_shards(2, "cuda")
    check(shards_n == min(2, torch.cuda.device_count()),
          f"cell_shards=2 ran as {shards_n} shards")
    reset_launches(kernels)
    cells_dev = []
    grid, sec = _timed(lambda: _with_checked_horizon(
        lambda: fl.run_cell_sweep(
            ds, shards, cell, cfg, num_cells=2, seeds_per_cell=2,
            cell_shards=2, device="cuda"), cells_dev))
    launches = read_launches(kernels)
    check(len(cells_dev) == 4,
          f"[sweep:cells] {len(cells_dev)} checked horizons, expected 4")
    check(launches["weighted_aggregate"] == 4 * t
          and launches["threefry_draw"] == 4 * LENET_WEIGHT_LEAVES,
          f"[sweep:cells] launches {launches}")
    for c in range(2):
        for s in range(2):
            seed = c * 2 + s
            _check_identical_runs(
                grid[c][s], singles[SWEEP_SEEDS.index(seed)],
                f"[sweep:cells] cell {c} seed {s} (seed {seed}) against its "
                f"single scan:")
    log(f"[sweep:cells] C=2 x S=2 at M={m} K=3 T={t}, cell_shards=2 clamped "
        f"to {shards_n} on {torch.cuda.device_count()} card(s): one "
        f"run_horizon per instance; {sec:.3f} s ({sec / 4:.4f} s per "
        f"instance, schedules included); launches {launches}")
    singles_dev = [single_dev[SWEEP_SEEDS.index(seed)] for seed in range(4)]
    log(f"[sweep:cells] the device part under set_sync_debug_mode('error'):"
        f" no host sync; per instance {[round(x, 4) for x in cells_dev]} s "
        f"(mean {sum(cells_dev) / 4:.4f}) against the single scans' "
        f"{[round(x, 4) for x in singles_dev]} s (mean "
        f"{sum(singles_dev) / 4:.4f})")


def run_online_phases(kernels):
    """The online policies at the main path's width: ``[main:online]``
    (update-aware, MAPEL, per round), ``[main:online-age]`` (age-fair,
    max power), ``[main:online-scan]`` (update-aware, max power, the
    scanned horizon) against the same configuration per round
    (``[main:online-max]``), ``[main:online-mp]`` and
    ``[main:online-mp-scan]`` (matching-pursuit over OTA, per round and
    scanned, the one against the other), and ``[main:online-legacy]``
    (``FLConfig(scheduler="update-aware")``: the legacy engine, as Fig. 6
    runs it).  Each run checks its own launch counts (run_main_path); a
    scan must give the per-round run's logs exactly and its parameters
    within the drift contract.  Returns the scanned update-aware run."""
    per_round = {}
    for mode in ("online", "online-age", "online-max", "online-mp"):
        per_round[mode], _ = run_main_path(kernels, mode)
    scans = {}
    for mode, twin in (("online-scan", "online-max"),
                       ("online-mp-scan", "online-mp")):
        scans[mode], _ = run_main_path(kernels, mode)
        label = f"[main:{mode}] against [main:{twin}] (per round):"
        worst_mean, worst_max = _check_equal_logs(scans[mode],
                                                  per_round[twin], label)
        check(worst_mean < PARAM_MEAN_ATOL and worst_max < PARAM_MAX_ATOL,
              f"{label} param drift mean {worst_mean} max {worst_max}")
        held = ("bit-equal" if _params_equal(scans[mode], per_round[twin],
                                             label)
                else "inside the drift contract")
        log(f"{label} final parameters {held}; {RUN_SECONDS[mode]:.4f} s "
            f"after the set-up against {RUN_SECONDS[twin]:.4f} s per round")
    legacy, _ = run_main_path(kernels, "online-legacy")
    same = ([lg.devices for lg in legacy.logs]
            == [lg.devices for lg in per_round["online"].logs])
    log(f"[main:online-legacy] schedules "
        f"{'equal' if same else 'differ from'} [main:online]'s; "
        f"{RUN_SECONDS['online-legacy']:.4f} s against "
        f"{RUN_SECONDS['online']:.4f} s")
    return scans["online-scan"]


def run_online_seed_sweep(kernels, scan_run, m=300, t=5, samples=12_000):
    """``[sweep:online-seeds]``: ``run_horizon_vmapped`` of the
    ``[main:online-scan]`` configuration over SWEEP_SEEDS beside one
    single online scan per seed, every horizon under the sync check: each
    row's logs equal its single scan's (the rows select on the card from
    their own norms), its parameters within the drift contract or in F1's
    shape, and the line says which.  Kernel #1 launches ceil(6 S / 16)
    times a round."""
    from repro_torch.core import fl

    ds, cell, shards = _world(m, samples)
    cfg = _config(m, t, **ONLINE_MODES["online-scan"])
    num = len(SWEEP_SEEDS)
    single_dev, sweep_dev, singles, single_s = [], [], [], 0.0
    for seed in SWEEP_SEEDS:
        res, sec = _timed(lambda seed=seed: _with_checked_horizon(
            lambda: fl.run_federated_learning(
                ds, shards, cell, dataclasses.replace(cfg, seed=seed),
                device="cuda"), single_dev))
        singles.append(res)
        single_s += sec
    reset_launches(kernels)
    sweep, sweep_s = _timed(lambda: _with_checked_horizon(
        lambda: fl.run_horizon_vmapped(ds, shards, cell, cfg,
                                       seeds=SWEEP_SEEDS, device="cuda"),
        sweep_dev))
    launches = read_launches(kernels)
    want = {name: 0 for name in launches}
    want["weighted_aggregate"] = t * -(-6 * num // 16)
    want["threefry_draw"] = LENET_WEIGHT_LEAVES * num
    check(launches == want, f"[sweep:online-seeds] launches {launches}, "
          f"expected {want}")
    check(len(sweep_dev) == 1 and len(single_dev) == num,
          f"[sweep:online-seeds] {len(sweep_dev)} + {len(single_dev)} "
          f"checked horizons")
    _check_equal_logs(sweep[0], scan_run,
                      "[sweep:online-seeds] row 0 against [main:online-scan]:")
    held = []
    for s, (res, single) in enumerate(zip(sweep, singles)):
        label = (f"[sweep:online-seeds] row {s} (seed {SWEEP_SEEDS[s]}) "
                 f"against its single scan:")
        worst_mean, worst_max = _check_equal_logs(res, single, label)
        if _params_equal(res, single, label):
            held.append("bit-equal")
        elif worst_mean < PARAM_MEAN_ATOL and worst_max < PARAM_MAX_ATOL:
            held.append("drift contract")
        else:
            seed_cfg = dataclasses.replace(cfg, seed=SWEEP_SEEDS[s])
            _, alone = _scan_rounds(lambda: fl.run_federated_learning(
                ds, shards, cell, seed_cfg, device="cuda"), 0)
            _, stacked = _scan_rounds(lambda: fl.run_horizon_vmapped(
                ds, shards, cell, cfg, seeds=SWEEP_SEEDS, device="cuda"), s)
            _check_code_flips(alone, stacked, cfg.group_size, label)
            held.append("F1 shape")
    check(any([lg.devices for lg in res.logs]
              != [lg.devices for lg in sweep[0].logs] for res in sweep[1:]),
          "[sweep:online-seeds] every seed scheduled as seed 0")
    log(f"[sweep:online-seeds] S={num} seeds {list(SWEEP_SEEDS)} at M={m} "
        f"K=3 T={t}: final parameters against the single scans: {held}; "
        f"every horizon's device part under set_sync_debug_mode('error'): "
        f"no host sync; launches {launches}")
    log(f"[sweep:online-seeds] the sweep {sweep_s / num:.4f} s per seed "
        f"(device part {sweep_dev[0] / num:.4f}) against {num} single scans "
        f"{single_s / num:.4f} s per seed (device part "
        f"{sum(single_dev) / num:.4f}), set-up included")


def compare_cpu_and_card(kernels, m=30, t=5, samples=12_000, uplink="noma",
                         topk=1.0, legacy=False, scan=False, online=False):
    """The M=30 run on the CPU (plain versions) and on the card (kernels):
    with ``scheduler_backend="jax"`` (greedy on the CPU and on the card)
    under NOMA, under OTA with ota-align powers, receiver noise 1e-9
    and truncation threshold 0.1, with the top-k stage (``topk`` < 1,
    host schedule), ``legacy``: ``FLConfig``'s defaults, the legacy
    round body, ``scan``: the scanned horizon with the host schedule, and
    ``online``: update-aware on the batched engine, each round selected
    from the norms of the rounds before on its own device.
    Held to the full contract, parameter drift included (the legacy and
    online runs: or F1's shape where the drift leaves it)."""
    from repro_torch.core import fl, fl_engine

    ds, cell, shards = _world(m, samples)
    rounds = {"cpu": [], "cuda": []}
    if legacy:
        cfg = _legacy_config(m, t)
    elif online:
        cfg = _config(m, t, **ONLINE_MODES["online"])
    elif scan:
        cfg = _config(m, t, horizon="scan")
    elif uplink == "ota":
        cfg = _config(m, t, "numpy", "ota", ota_threshold=0.1)
    elif topk < 1.0:
        cfg = _config(m, t, "numpy", topk=topk)
    else:
        cfg = _config(m, t, "jax")
    legacy_round = fl._legacy_round

    def keep(*args, **kwargs):      # each round's weights, on the host
        out = legacy_round(*args, **kwargs)
        dev = "cpu" if args[0]["fc1"]["w"].device.type == "cpu" else "cuda"
        rounds[dev].append({f"{a}/{c}": v.double().cpu()
                            for a, d in out[0].items() for c, v in d.items()})
        return out

    run_round = fl_engine.BatchedRoundEngine.run_round

    def keep_batched(self, params, *args, **kwargs):
        out = run_round(self, params, *args, **kwargs)
        rounds[self.device.type].append({
            f"{a}/{c}": v.double().cpu()
            for a, d in out[0].items() for c, v in d.items()})
        return out

    if legacy:
        fl._legacy_round = keep
    if online:
        fl_engine.BatchedRoundEngine.run_round = keep_batched
    try:
        cpu = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
        reset_launches(kernels)
        gpu = fl.run_federated_learning(ds, shards, cell, cfg, device="cuda")
        launches = read_launches(kernels)
    finally:
        fl._legacy_round = legacy_round
        fl_engine.BatchedRoundEngine.run_round = run_round
    if legacy:
        label = f"[cpu-vs-card:legacy] M={m} FLConfig defaults (legacy)"
    elif online:
        label = f"[cpu-vs-card:online] M={m} update-aware (batched)"
    elif scan:
        label = f"[cpu-vs-card:scan] M={m} horizon='scan'"
    elif uplink == "ota":
        label = f"[cpu-vs-card:ota] M={m} ota-align noise 1e-9 threshold 0.1"
    elif topk < 1.0:
        label = f"[cpu-vs-card:topk] M={m} topk={topk}"
    else:
        label = f"[parity] M={m} scheduler_backend='jax'"
    worst_mean, worst_max = _check_equal_logs(gpu, cpu, label + " CPU vs card:")
    within = worst_mean < PARAM_MEAN_ATOL and worst_max < PARAM_MAX_ATOL
    if (legacy or online) and not within:
        _check_code_flips(rounds["cpu"], rounds["cuda"], cfg.group_size,
                          label)
    else:
        check(within, f"{label} param drift mean {worst_mean} max {worst_max}")
    # a scanned horizon aggregates every round, all-padding ones too
    nonempty = t if scan else sum(1 for lg in gpu.logs if lg.devices)
    check(launches["ota_aggregate"] == (nonempty if uplink == "ota" else 0),
          f"card run launched ota_aggregate {launches['ota_aggregate']} times")
    want_agg = 0 if uplink == "ota" or legacy else nonempty
    check(launches["weighted_aggregate"] == want_agg,
          f"card run launched weighted_aggregate "
          f"{launches['weighted_aggregate']} times, expected {want_agg}")
    log(f"{label}: card launches {launches}")


# --------------------------------------------------------------------------
# the flash-decode kernel and its path
# --------------------------------------------------------------------------

def _flash_case(shape, dtype, seed):
    """Normal q, k, v of ``shape`` = (B, Hkv, G, D, S) in ``dtype``, made
    on the card from a seed."""
    b, h, g, d, s = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, g, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    return q, k, v


def _flash_err(got, want, dtype, what):
    """Max abs error of the kernel against a reference version, within
    (atol, rtol) = FLASH_TOL[dtype]."""
    got, want = got.float(), want.float()
    atol, rtol = FLASH_TOL[dtype]
    check(bool(torch.isfinite(got).all()), f"non-finite output at {what}")
    bad = (got - want).abs() > atol + rtol * want.abs()
    err = (got - want).abs().max().item()
    check(not bool(bad.any()), f"flash_decode at {what}: max abs err {err!r} "
          f"beyond atol {atol}, rtol {rtol}")
    return err


def compare_flash(mod):
    """The kernel against its plain version on the card: the test shapes
    and decode_32k, float32 and bfloat16, valid_len 0, 1, 300, S-1, S (a
    card-resident int32, as the path hands it over); zeros at 0.  Returns
    the largest absolute error per type."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for si, shape in enumerate(FLASH_SHAPES + (DECODE_32K,)):
        s_len = shape[4]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_case(shape, dtype, seed=si)
            for vl in sorted({0, 1, 300, s_len - 1, s_len}):
                what = f"{shape} {dtype} valid_len={vl}"
                vt = torch.tensor(vl, dtype=torch.int32, device="cuda")
                before = mod.flash_decode.launches
                got = mod.flash_decode(q, k, v, vt)
                torch.cuda.synchronize()
                check(mod.flash_decode.launches == before + 1,
                      f"flash_decode did not launch at {what}")
                if vl == 0:
                    check(bool((got == 0).all()), f"nonzero output at {what}")
                    continue
                want = mod.flash_decode_plain(q, k, v, vl)
                worst[dtype] = max(worst[dtype],
                                   _flash_err(got, want, dtype, what))
                n_cases += 1
            del q, k, v
    torch.cuda.empty_cache()
    log(f"[flash-kernel] {n_cases} cases (shapes {FLASH_SHAPES} and "
        f"decode_32k {DECODE_32K} as (B, Hkv, G, D, S), float32 and "
        f"bfloat16, valid_len 0, 1, 300, S-1, S): within (atol, rtol) "
        f"{FLASH_TOL[torch.float32]} / {FLASH_TOL[torch.bfloat16]} of the "
        f"plain version, zeros at valid_len 0; max abs err float32 "
        f"{worst[torch.float32]!r}, bfloat16 {worst[torch.bfloat16]!r}")
    return worst


def time_flash(mod, dtype, shape=DECODE_32K):
    """The kernel at decode_32k with the whole cache valid: device time
    (behind the sleep kernel) and host-inclusive time beside its plain
    version, ``scaled_dot_product_attention`` (``enable_gqa=True``: the
    library yardstick, never on the path; the faster of the call with a
    boolean mask of the valid positions and, since the whole cache is
    valid, the call without one, which leaves SDPA's flash and cuDNN
    backends open) and the bound: the bytes of k and v below valid_len (plus q
    and the output) at 3.35 TB/s, against 4 * B * Hkv * G * n * D
    operations at the type's peak."""
    import torch.nn.functional as F

    b, h, g, d, s_len = shape
    q, k, v = _flash_case(shape, dtype, seed=7)
    vl = s_len
    vt = torch.tensor(vl, dtype=torch.int32, device="cuda")
    qh = q.reshape(b, h * g, 1, d)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(s_len, device="cuda") < vt).reshape(1, 1, 1, s_len)
    counted = mod.flash_decode.launches

    def kern_fn():
        return mod._launch(q, k, v, vt, mod.BLOCK_S)

    def plain_fn():
        return mod.flash_decode_plain(q, k, v, vl)

    def lib_fn():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    def lib_full_fn():      # no mask: valid_len = S leaves every backend open
        return F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)

    err = _flash_err(kern_fn(), plain_fn(), dtype, f"timed {shape} {dtype}")
    lib_err = max((fn().reshape(b, h, g, d).float()
                   - plain_fn().float()).abs().max().item()
                  for fn in (lib_fn, lib_full_fn))
    plain = _time_ms(plain_fn, iters=5, warmup=1)
    kern = _time_ms(kern_fn, iters=20, warmup=3)
    kern = 0.5 * (kern + _time_ms(kern_fn, iters=20, warmup=1))
    plain = 0.5 * (plain + _time_ms(plain_fn, iters=5, warmup=1))
    lib_masked = _time_ms(lib_fn, iters=5, warmup=1)
    lib_full = _time_ms(lib_full_fn, iters=5, warmup=1)
    dev = {name: _device_ms(fn, iters=n) for name, fn, n in
           (("kernel", kern_fn, 20), ("lib_masked", lib_fn, 4),
            ("lib_full", lib_full_fn, 4), ("kernel2", kern_fn, 20))}
    # the library's time is the faster of the two calls
    dev["lib"] = min(dev["lib_masked"], dev["lib_full"])
    lib = min(lib_masked, lib_full)
    # the plain version's ~1,300 launches per call exceed the queue
    dev["plain"], plain_launches = _busy_ms(plain_fn)
    mod.flash_decode.launches = counted    # timing launches don't count
    size = k.element_size()
    nbytes = 2 * b * vl * h * d * size + 2 * q.numel() * size
    flops = 4 * b * h * g * vl * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bound = max(t_bytes, t_ops)
    name = str(dtype).replace("torch.", "")
    log(f"[time] flash_decode {name} B={b} Hkv={h} G={g} D={d} S={s_len} "
        f"valid_len={vl}: device kernel {dev['kernel'] * 1e3:.1f} us (again "
        f"{dev['kernel2'] * 1e3:.1f})  plain {dev['plain'] * 1e3:.1f} us  "
        f"sdpa {dev['lib'] * 1e3:.1f} us (masked "
        f"{dev['lib_masked'] * 1e3:.1f}, no mask "
        f"{dev['lib_full'] * 1e3:.1f}); host-inclusive kernel "
        f"{kern * 1e3:.1f} us  plain {plain * 1e3:.1f} us  sdpa "
        f"{lib * 1e3:.1f} us (masked {lib_masked * 1e3:.1f}, no mask "
        f"{lib_full * 1e3:.1f}); bound {bound * 1e3:.1f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, "
        f"{flops} op); plain device time is its busy time over "
        f"{plain_launches:.0f} launches (torch.profiler); "
        f"{dev['kernel'] / bound:.2f}x the bound, "
        f"{dev['lib'] / dev['kernel']:.2f}x faster than sdpa; max abs err "
        f"kernel vs plain {err!r}, sdpa vs plain {lib_err!r}")
    log(f"[time] flash_decode {name}: kernel/sdpa device-time ratio "
        f"{dev['kernel'] / dev['lib']:.3f} (again "
        f"{dev['kernel2'] / dev['lib']:.3f}) in this run; kernel "
        f"{_attributes_text(mod.kernel_attributes(dtype, d, g))}")
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return dict(ms=dev["kernel"], plain_ms=dev["plain"], library_ms=dev["lib"],
                bound_ms=bound, host_ms=kern, plain_host_ms=plain,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def run_flash_main_path(kernels, shape=DECODE_32K):
    """The kernel's path, ``kernels.ops.flash_decode(use_pallas=True)``,
    at decode_32k in bfloat16 and float32 with valid_len S - 1 on the
    card: the launch counts are zeroed just before and read just after;
    each output is then held to the oracle (``use_pallas=False``).
    Returns (launches per kernel, max abs error against the oracle)."""
    from repro_torch.kernels import ops

    b, h, g, d, s_len = shape
    vt = torch.tensor(s_len - 1, dtype=torch.int32, device="cuda")
    cases = [(dtype, *_flash_case(shape, dtype, seed=11))
             for dtype in (torch.bfloat16, torch.float32)]
    reset_launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ops.flash_decode(q, k, v, vt, use_pallas=True)
            for _, q, k, v in cases]
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = read_launches(kernels)
    check(launches["flash_decode"] == len(cases),
          f"flash_decode launched {launches['flash_decode']} times on its "
          f"path, expected {len(cases)}")
    check(sum(launches.values()) == len(cases), f"other launches {launches}")
    worst = 0.0
    for out, (dtype, q, k, v) in zip(outs, cases):
        check(out.shape == q.shape and out.dtype == dtype, "output shape")
        oracle = ops.flash_decode(q, k, v, vt, use_pallas=False)
        worst = max(worst, _flash_err(out, oracle, dtype,
                                      f"the path {shape} {dtype}"))
    del cases, outs
    torch.cuda.empty_cache()
    log(f"[main:flash] ops.flash_decode(use_pallas=True) at decode_32k "
        f"{shape} valid_len {s_len - 1}, bfloat16 and float32: {took:.4f} s "
        f"host for both calls; launches {launches}; within (atol, rtol) "
        f"{FLASH_TOL[torch.float32]} / {FLASH_TOL[torch.bfloat16]} of the "
        f"oracle (max abs err {worst!r})")
    return launches, worst


# --------------------------------------------------------------------------
# the seeded draws
# --------------------------------------------------------------------------

def check_draws(seed=0, m=300, t=35):
    """The reference's draws from ``seed`` on the card equal the CPU's to
    the bit: the paper cell's positions and gains, LeNet's initial weights,
    and long uniform, normal and truncated-normal streams of the Threefry
    kernel against its plain version on the card and the CPU."""
    from repro_torch.core import channel, prng
    from repro_torch.models.params import init_lenet

    cell = channel.CellConfig(num_devices=m)
    t0 = time.perf_counter()
    card = channel.sample_channels(seed, cell, t, device="cuda")
    t_card = time.perf_counter() - t0
    host = channel.sample_channels(seed, cell, t)
    for field in ("distances", "gains", "dl_gains"):
        _bits_equal(torch.from_numpy(getattr(card, field)),
                    torch.from_numpy(getattr(host, field)))
    w_card = init_lenet(seed, device="cuda")
    w_host = init_lenet(seed, device="cpu")
    for layer, leaves in w_host.items():
        for leaf, v in leaves.items():
            check(w_card[layer][leaf].device.type == "cuda", "weights device")
            _bits_equal(w_card[layer][leaf], v)
    key = prng.fold_in(prng.prng_key(seed), 2)
    n = 1 << 20
    a, b = prng.ERF_BOUNDS[(-3.0, 3.0)]
    clip = (float(np.nextafter(np.float32(-3), 0)),
            float(np.nextafter(np.float32(3), 0)))
    for lo, hi, normal, cut in ((-2.5, 7.0, False, None),
                                (prng.NORMAL_LO, 1.0, True, None),
                                (a, b, True, clip)):
        got = prng.draw(key, n, lo, hi, normal=normal, clip=cut,
                        device="cuda")
        _bits_equal(got, prng.draw_plain(key, n, lo, hi, normal=normal,
                                         clip=cut, device="cuda"))
        _bits_equal(got, prng.draw_plain(key, n, lo, hi, normal=normal,
                                         clip=cut, device="cpu"))
    log(f"[draws] seed {seed}: positions and gains of M={m} T={t} (drawn on "
        f"the card in {t_card:.3f} s), LeNet's initial weights, 2^20 "
        f"uniforms, normals and truncated normals: the card's (the Threefry "
        f"kernel) equal the plain version's on the card and the CPU to the "
        f"bit")


# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the token payloads: the dense transformer on the FL path
# --------------------------------------------------------------------------

QWEN2 = "qwen2_0_5b"
QWEN2_PARAMS = 494_147_456
QWEN2_LEAVES = 14
QWEN2_WEIGHT_DRAWS = 8      # embed + wq, wk, wv, wo + wi_gate, wi_up, wo;
                            # the zero biases and unit norm scales draw none
QWEN2_REF = os.path.join(REPO, "tests", "torch_reference", "qwen2_0_5b.json")
TOKEN_DATA = dict(vocab_size=151_936, num_samples=600, seq_len=16, seed=0)
TOKEN_M, TOKEN_T = 30, 3
ONE_M_DATA = dict(vocab_size=16_384, num_samples=600, seq_len=16, seed=0)
SMOKE_DATA = dict(vocab_size=512, num_samples=400, seq_len=8, seed=0)
TOKEN_LOSS_RTOL = 5e-4      # tests/test_torch_models.py's loss bound (F3)
# F3's limits for the SMOKE Qwen2 (tests/test_torch_tokens.py:F3_LIMITS)
F3_MEAN_ATOL, F3_MAX_ATOL = 1.6e-4, 5e-2


def _token_world(m, data):
    from repro_torch.core import channel
    from repro_torch.data import dirichlet_partition, make_token_dataset

    ds = make_token_dataset(**data)
    return (ds, channel.CellConfig(num_devices=m),
            dirichlet_partition(ds.class_train, m, seed=0))


def _fl_sizes(name):
    """(path, elements) of an FL model's full-width leaves, from the schema
    (no allocation)."""
    from repro_torch.models.fl_models import get_fl_model
    from repro_torch.models.params import abstract_params
    from repro_torch.utils.tree import tree_flatten_with_paths

    return [(path, leaf.size) for path, leaf in tree_flatten_with_paths(
        abstract_params(get_fl_model(name).schema()))]


def compare_token_kernels(name=QWEN2, label="Qwen2-0.5B",
                          phase="token-kernel", n_leaves=QWEN2_LEAVES,
                          n_params=QWEN2_PARAMS):
    """Kernels #1 and #2 at a token payload's full-width shapes (by
    default the 14 Qwen2-0.5B leaves, 494,147,456 elements, the embedding
    136,249,344).  #1: every leaf as int32 codes at K=3, reduced in one
    grouped launch, bit-equal to the plain version leaf by leaf, and timed
    (device and host-inclusive) beside the plain version and one
    ``torch.einsum`` a leaf on the same codes as float32.  #2: the keyed
    entry on the embedding leaf (K=3, the path's 16-byte row layout),
    bit-equal to its plain version and to the strip kernel fed the drawn
    noise, timed beside its plain version.  The launch counters are
    restored afterwards.  Returns the two kernels' max abs errors."""
    from repro_torch.core import ota
    from repro_torch.kernels import aggregate, ota_aggregate, threefry

    sizes = _fl_sizes(name)
    check(len(sizes) == n_leaves and sum(n for _, n in sizes) == n_params,
          f"{label} leaves {sizes}")
    k = 3
    gen = torch.Generator(device="cuda").manual_seed(7)
    codes, coeffs = [], []
    for _, n in sizes:
        codes.append(torch.randint(-15, 16, (k, n), dtype=torch.int32,
                                   device="cuda", generator=gen))
        scales = torch.rand(k, device="cuda", generator=gen) + 0.5
        w = torch.rand(k, device="cuda", generator=gen)
        coeffs.append(aggregate.coefficients(
            scales, w / w.sum(), torch.full((k,), 15.0, device="cuda")))
    counted = aggregate.weighted_aggregate.launches
    got = aggregate.weighted_aggregate_group(codes, coeffs)
    torch.cuda.synchronize()
    check(aggregate.weighted_aggregate.launches == counted + 1,
          f"the {n_leaves} {label} leaves took more than one grouped launch")
    agg_err = 0.0
    for (path, _), out, c, cf in zip(sizes, got, codes, coeffs):
        try:
            agg_err = max(agg_err, _bits_equal(
                out, aggregate.weighted_aggregate_plain(c, cf)))
        except SmokeFailure as exc:
            raise SmokeFailure(f"grouped aggregate at {label} {path}: {exc}")
    del got
    floats = [c.to(torch.float32) for c in codes]

    def kern_fn():
        return aggregate._launch_group(codes, coeffs)

    def plain_fn():
        return [aggregate.weighted_aggregate_plain(c, cf)
                for c, cf in zip(codes, coeffs)]

    def lib_fn():
        return [torch.einsum("k,kn->n", cf, c) for c, cf in zip(floats, coeffs)]

    host = {"kernel": _time_ms(kern_fn, iters=10, warmup=2),
            "lib": _time_ms(lib_fn, iters=10, warmup=2)}
    dev = {"kernel": _device_ms(kern_fn, iters=10),
           "plain": _busy_ms(plain_fn, iters=1)[0],
           "lib": _device_ms(lib_fn, iters=10),
           "kernel2": _device_ms(kern_fn, iters=10)}
    aggregate.weighted_aggregate.launches = counted   # checks don't count
    nbytes = sum(k * n * 4 + n * 4 + k * 4 for _, n in sizes)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * k * n_params / PEAK_F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    ms = 0.5 * (dev["kernel"] + dev["kernel2"])
    log(f"[{phase}] weighted_aggregate K={k}, the {n_leaves} {label} leaves "
        f"({n_params} int32 codes a client) in one grouped launch: "
        f"bit-equal to the plain version, max abs err {agg_err!r}; device "
        f"{ms:.4f} ms ({dev['kernel']:.4f} / {dev['kernel2']:.4f}), plain "
        f"(device-busy) {dev['plain']:.4f} ms, {n_leaves} einsum on float32 "
        f"codes {dev['lib']:.4f} ms; host-inclusive kernel {host['kernel']:.4f} ms,"
        f" einsum {host['lib']:.4f} ms; bound {bound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B), "
        f"{ms / bound:.2f}x; kernel/einsum {ms / dev['lib']:.3f}")
    del codes, floats, coeffs

    n = dict(sizes)["embed/tokens"]
    x = ota_aggregate.row_buffer(k, n, device="cuda")
    x.copy_(torch.randn(k, n, device="cuda", generator=gen) * 0.01)
    coeff = torch.tensor([0.5, 0.0, 0.5], device="cuda")
    key = ota.horizon_keys(0, 2)[1]
    scale = torch.tensor(3e-3, dtype=torch.float32, device="cuda")
    counted = ota_aggregate.ota_aggregate.launches
    drawn = threefry.threefry_draw.launches
    ota_err = _ota_keyed_errors(ota_aggregate, x, coeff, key, scale,
                                f"the {label} embedding leaf (K={k}, n={n})")

    def keyed_fn():
        return ota_aggregate._launch_keyed(x, coeff, key, scale)

    def keyed_plain_fn():
        return ota_aggregate.ota_aggregate_keyed_plain(x, coeff, key, scale)

    host_keyed = _time_ms(keyed_fn, iters=10, warmup=2)
    d_keyed = _device_ms(keyed_fn, iters=10)
    d_plain = _busy_ms(keyed_plain_fn, iters=1)[0]
    ota_aggregate.ota_aggregate.launches = counted
    threefry.threefry_draw.launches = drawn
    k_bytes = (k + 1) * n * 4 + k * 4 + 4
    kb = k_bytes / PEAK_BYTES_PER_S * 1e3
    ko = (THREEFRY_OPS + 2 * k) * n / PEAK_F32_FLOPS * 1e3
    log(f"[{phase}] ota_aggregate keyed on the {label} embedding leaf "
        f"K={k} n={n}: bit-equal to its plain version and to the strip "
        f"kernel fed the drawn noise, max abs err {ota_err!r}; device "
        f"{d_keyed:.4f} ms, plain (device-busy) {d_plain:.4f} ms, "
        f"host-inclusive {host_keyed:.4f} ms; bound {max(kb, ko):.4f} ms "
        f"({'bytes' if kb >= ko else 'operations'}), "
        f"{d_keyed / max(kb, ko):.2f}x")
    del x
    torch.cuda.empty_cache()
    return agg_err, ota_err


def _profile_round(fn):
    """fn() under torch.profiler, with ``fl_engine.sgd_epoch`` timed on the
    host clock (the card synchronised around it).  Returns (fn(), kernels
    launched, device-busy ms, wall ms, local-SGD wall ms, the six aten ops
    whose kernels took the most device time as (name, ms, calls))."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fl_engine

    epoch = fl_engine.sgd_epoch
    sgd_ms = []

    def timed_epoch(*args, **kwargs):
        out, sec = _timed(lambda: epoch(*args, **kwargs))
        sgd_ms.append(sec * 1e3)
        return out

    fl_engine.sgd_epoch = timed_epoch
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out, wall = _timed(fn)
    finally:
        fl_engine.sgd_epoch = epoch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    # device time by the aten op that launched it
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.key.startswith("aten::") and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda op: -op[1])[:6]
    return out, len(kernels), busy, wall * 1e3, sum(sgd_ms), top


def run_token_main_path(kernels, mode, m=TOKEN_M, t=TOKEN_T):
    """``[main:tokens]`` / ``[main:tokens-ota]``: Qwen2-0.5B at full width
    (494,147,456 parameters, random weights from seed 0) as the FL payload
    through ``run_federated_learning`` on the card, the batched engine with
    the kernels, M=30 devices, K=3, T=3 (``[main:tokens]`` one round more,
    traced by torch.profiler: ``[trace:tokens]``), on ``make_token_dataset(
    vocab_size=151936, num_samples=600, seq_len=16)``; NOMA + MAPEL +
    adaptive DoReFa (one grouped #1 launch per non-empty round for the 14
    leaves) or OTA with ota-align powers and noise 1e-9 (one keyed #2
    launch per non-empty round).  The initial draw (8 Threefry launches)
    is timed alone first; the per-round host time and the peak device
    memory of the run are printed.  Returns the result."""
    from repro_torch.core import channel, fl, fl_engine
    from repro_torch.models.fl_models import get_fl_model
    from repro_torch.utils.tree import tree_count, tree_flatten_with_paths

    ds, cell, shards = _token_world(m, TOKEN_DATA)
    uplink = "ota" if mode == "tokens-ota" else "noma"
    cfg = _config(m, t + (mode == "tokens"), "numpy", uplink, model=QWEN2)
    model = get_fl_model(QWEN2)
    params, t_init = _timed(lambda: model.init(cfg.seed, device="cuda"))
    check(tree_count(params) == QWEN2_PARAMS
          and len(tree_flatten_with_paths(params)) == QWEN2_LEAVES,
          f"Qwen2-0.5B has {tree_count(params)} parameters")
    del params
    torch.cuda.empty_cache()
    bundle = channel.sample_channels(cfg.seed, cell, cfg.num_rounds)
    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    schedule, t_sched = _timed(lambda: fl.make_schedule(
        bundle.gains, sizes / sizes.sum(), cell, cfg))
    log(f"[main:{mode}] {QWEN2} at full width ({QWEN2_PARAMS} parameters, "
        f"{QWEN2_LEAVES} leaves) M={m} K={cfg.group_size} "
        f"T={cfg.num_rounds}, "
        f"{TOKEN_DATA['num_samples']} rows of {TOKEN_DATA['seq_len']} tokens"
        f" (vocab {TOKEN_DATA['vocab_size']}), uplink {uplink}, "
        f"{cfg.power_mode}, {cfg.compression}: initial draw on the card "
        f"{t_init:.3f} s, schedule {t_sched:.3f} s")
    stamps = []

    def progress(lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"[main:{mode}] round {lg.round}: devices {list(lg.devices)} "
            f"bits {lg.bits.tolist()} acc {lg.test_accuracy:.4f} host "
            f"{stamps[-1] - stamps[-2]:.3f} s")

    # [main:tokens] runs one round more and traces it: the rounds before
    # are timed untraced
    body = fl_engine._train_quantize_aggregate
    trace_last, traced = _tracing_last_round(t)

    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    if mode == "tokens":
        fl_engine._train_quantize_aggregate = trace_last
    try:
        res = fl.run_federated_learning(
            ds, shards, cell, cfg, channels=bundle, schedule=schedule,
            progress=progress, device="cuda")
    finally:
        fl_engine._train_quantize_aggregate = body
    torch.cuda.synchronize()
    total = time.perf_counter() - stamps[0]
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    nonempty = sum(1 for lg in res.logs if lg.devices)
    want = {name: 0 for name in launches}
    want["weighted_aggregate"] = nonempty if uplink == "noma" else 0
    want["ota_aggregate"] = nonempty if uplink == "ota" else 0
    want["threefry_draw"] = QWEN2_WEIGHT_DRAWS
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times on [main:{mode}], "
              f"expected {n} ({nonempty} non-empty rounds)")
    acc = res.accuracies()
    check(bool(np.all(np.isfinite(acc))) and bool(np.all((acc >= 0)
                                                          & (acc <= 1))),
          f"[main:{mode}] accuracy {acc}")
    check(tree_count(res.final_params) == QWEN2_PARAMS,
          "final parameters lost leaves")
    for path, leaf in tree_flatten_with_paths(res.final_params):
        check(leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all()),
              f"[main:{mode}] final {path} not finite on the card")
    steps = np.diff(stamps)
    log(f"[main:{mode}] run {total:.3f} s after the schedule, rounds "
        f"{[float(f'{s:.3f}') for s in steps]} s; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"launches {launches}")
    if mode == "tokens":
        _log_traced_round("tokens", t, traced)
    return res


def _tracing_last_round(t):
    """(a stand-in for ``fl_engine._train_quantize_aggregate`` that runs
    rounds 0..t-1 as they are and round t under torch.profiler, the list
    its traces land in)."""
    from repro_torch.core import fl_engine

    body = fl_engine._train_quantize_aggregate
    traced = []

    def trace_last(*args, **kwargs):
        if len(traced) < t:
            traced.append(None)
            return body(*args, **kwargs)
        out, *trace = _profile_round(lambda: body(*args, **kwargs))
        traced.append(trace)
        return out

    return trace_last, traced


def _log_traced_round(label, t, traced):
    check(len(traced) == t + 1 and traced[-1] is not None,
          f"[trace:{label}] traced {len(traced)} rounds")
    n_launch, busy, wall, sgd, top = traced[-1]
    log(f"[trace:{label}] round {t} (traced by torch.profiler, which slows "
        f"the host): {n_launch} kernels, device busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall (idle share {1 - busy / wall:.3f}); local SGD "
        f"{sgd:.1f} ms of it; the aten ops with the most device time: "
        + "; ".join(f"{name} {ms:.2f} ms ({n} calls)"
                    for name, ms, n in top) + f" ({CARD})")


def run_token_scan(kernels, m=TOKEN_M, t=5):
    """``[main:tokens-scan]``: ``tiny-transformer-1m`` (>= 10^6 parameters)
    with ``topk=0.01`` per round and with ``horizon="scan"`` (its device
    part under the sync check), M=30, K=3, T=5: logs and final parameters
    equal to the bit, one #1 launch per round each."""
    from repro_torch.core import fl

    ds, cell, shards = _token_world(m, ONE_M_DATA)
    cfg = _config(m, t, "numpy", model="tiny-transformer-1m", topk=0.01,
                  power_mode="max")
    reset_launches(kernels)
    per_round, t_round = _timed(lambda: fl.run_federated_learning(
        ds, shards, cell, cfg, device="cuda"))
    round_launches = read_launches(kernels)
    seen = []
    reset_launches(kernels)
    scanned, t_scan = _timed(lambda: _with_checked_horizon(
        lambda: fl.run_federated_learning(
            ds, shards, cell, dataclasses.replace(cfg, horizon="scan"),
            device="cuda"), seen))
    scan_launches = read_launches(kernels)
    check(len(seen) == 1, f"[main:tokens-scan] ran {len(seen)} horizons")
    nonempty = sum(1 for lg in per_round.logs if lg.devices)
    check(round_launches["weighted_aggregate"] == nonempty
          and scan_launches["weighted_aggregate"] == t,
          f"[main:tokens-scan] aggregation launches {round_launches} / "
          f"{scan_launches}")
    _check_identical_runs(scanned, per_round,
                          "[main:tokens-scan] scan against per round:")
    log(f"[main:tokens-scan] tiny-transformer-1m topk=0.01 M={m} T={t}: per "
        f"round {t_round:.3f} s, scanned {t_scan:.3f} s (device part "
        f"{seen[0]:.3f} s under set_sync_debug_mode('error')); ratios "
        f"{[lg.compression_ratios.round(1).tolist() for lg in scanned.logs]}")


def compare_tokens_cpu_and_card(kernels, m=12, t=3):
    """``[cpu-vs-card:tokens]``: the SMOKE Qwen2 (QKV bias, GQA, tied
    embeddings) on the batched engine with the kernels, M=12, T=3, on the
    CPU and on the card: logs exact, accuracy within 0.02, and the drift
    inside the contract or in F3's shape (ROADMAP.md queue 3: bf16 rounding
    in other places; every leaf's mean drift below 1.6e-4, max below
    5e-2)."""
    from repro_torch.core import fl

    ds, cell, shards = _token_world(m, SMOKE_DATA)
    cfg = _config(m, t, "numpy", model=f"{QWEN2}:smoke")
    cpu = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
    reset_launches(kernels)
    card = fl.run_federated_learning(ds, shards, cell, cfg, device="cuda")
    launches = read_launches(kernels)
    label = f"[cpu-vs-card:tokens] M={m} {QWEN2}:smoke"
    worst_mean, worst_max = _check_equal_logs(card, cpu, label + " CPU vs card:")
    if worst_mean < PARAM_MEAN_ATOL and worst_max < PARAM_MAX_ATOL:
        log(f"{label}: inside the drift contract")
    else:
        check(worst_mean < F3_MEAN_ATOL and worst_max < F3_MAX_ATOL,
              f"{label} drift mean {worst_mean} max {worst_max} beyond F3's "
              f"shape")
        log(f"{label}: the drift leaves the contract in F3's shape (bf16 "
            f"rounding in other places; ROADMAP.md queue 3)")
    nonempty = sum(1 for lg in card.logs if lg.devices)
    check(launches["weighted_aggregate"] == nonempty,
          f"{label}: aggregation launches {launches}")


def check_qwen2_reference():
    """``[ref:qwen2-0.5b]``: the card's full-width initial parameters and
    one fixed batch's loss against tests/torch_reference/qwen2_0_5b.json
    (written by the JAX package; its command is in the file): every leaf's
    recorded elements exactly, its float64 sum and sum of squares within
    float64 summation error (n * 2^-53 * sum |x|), and the loss within
    TOKEN_LOSS_RTOL."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models.fl_models import get_fl_model
    from repro_torch.utils.tree import tree_flatten_with_paths

    with open(QWEN2_REF, encoding="utf-8") as fh:
        record = json.load(fh)
    model = get_fl_model(record["model"])
    params = model.init(record["seed"], device="cuda")
    worst = 0.0
    for path, leaf in tree_flatten_with_paths(params):
        want = record["leaves"][path]
        check(list(leaf.shape) == want["shape"], f"[ref] {path} shape")
        flat = leaf.reshape(-1)
        idx = torch.tensor(want["index"], dtype=torch.int64).to("cuda")
        got = flat[idx].cpu().numpy()
        check(np.array_equal(got, np.asarray(want["values"], np.float32)),
              f"[ref] {path} elements {got} != {want['values']}")
        x = flat.double()
        bound = x.numel() * 2.0 ** -53
        for name, val, mag in (("sum", x.sum(), x.abs().sum()),
                               ("sumsq", (x * x).sum(), (x * x).sum())):
            err = abs(val.item() - want[name])
            check(err <= bound * mag.item(),
                  f"[ref] {path} {name} {val.item()!r} != {want[name]!r}")
            worst = max(worst, err / max(mag.item(), 1e-300))
    tokens = torch.tensor(record["tokens"], dtype=torch.int32).to("cuda")
    labels = torch.tensor(record["labels"], dtype=torch.int32).to("cuda")
    with torch.no_grad():
        stacked = tree_lib.tree_map(lambda w: w.unsqueeze(0), params)
        loss = float(model.batch_loss(stacked, tokens[None], labels[None],
                                      None)[0])
    rel = abs(loss - record["loss"]) / abs(record["loss"])
    check(rel <= TOKEN_LOSS_RTOL,
          f"[ref] loss {loss!r} against {record['loss']!r} (rel {rel})")
    log(f"[ref:qwen2-0.5b] {len(record['leaves'])} leaves "
        f"({record['param_count']} parameters) drawn on the card: the "
        f"recorded elements equal the reference's, sums within float64 "
        f"summation error (worst {worst:.3g} of sum |x|); the loss of the "
        f"fixed 2 x 16 batch {loss!r} against the reference's "
        f"{record['loss']!r}: relative {rel:.3g} (bound {TOKEN_LOSS_RTOL})")
    del params, stacked
    torch.cuda.empty_cache()


def run_token_phases(kernels):
    """The token slice's phases, in order; returns #1's and #2's max abs
    errors at the Qwen2 shapes."""
    errs = compare_token_kernels()
    run_token_main_path(kernels, "tokens")
    torch.cuda.empty_cache()
    run_token_main_path(kernels, "tokens-ota")
    torch.cuda.empty_cache()
    run_token_scan(kernels)
    compare_tokens_cpu_and_card(kernels)
    check_qwen2_reference()
    return errs


# --------------------------------------------------------------------------
# the moe, ssm and hybrid families: FL payload, server and trainer
# --------------------------------------------------------------------------

MAMBA2 = "mamba2_130m"
MAMBA2_PARAMS = 129_100_224     # the FL schema's leaves (padded vocab)
MAMBA2_LEAVES = 15
MAMBA2_DATA = dict(vocab_size=50_280, num_samples=600, seq_len=16, seed=0)
FAMILY_SMOKE_DATA = dict(vocab_size=512, num_samples=400, seq_len=8, seed=0)
# tests/test_torch_families_fl.py's worlds (data, FLConfig fields: one
# local batch a client; the SMOKE Zamba2 with no codes, F4 in ROADMAP.md
# queue 3) and FAMILY_LIMITS
FAMILY_WORLDS = {
    "mamba2_130m": (FAMILY_SMOKE_DATA, dict(batch_size=80)),
    "zamba2_7b": (dict(FAMILY_SMOKE_DATA, num_samples=200),
                  dict(compression="none", batch_size=24)),
}
FAMILY_LIMITS = {"mamba2_130m": (5e-5, 1.5e-2), "zamba2_7b": (1.5e-4, 4e-3)}
FAMILY_LOSS_RTOL = 5e-4     # tests/test_torch_families.py's loss bound
# [train:*] against the reference's record (tests/torch_reference/
# train_losses.json): each step's loss, relative; Mamba2's final
# parameters' worst leaf mean drift over the sampled elements.  Each limit
# lies between the card's sound run and the record's dropped-step run
# (Mixtral's losses 1.1e-4 / 7.9e-4; Mamba2's drift 2.2e-5 / 3.7e-5), but
# Mamba2's losses, whose wrong run's 1.3e-4 is inside the card's 2.2e-4
TRAIN_LOSS_LIMITS = {"mamba2-130m": FAMILY_LOSS_RTOL,
                     "mixtral-8x22b-smoke": 4e-4}
TRAIN_DRIFT_LIMITS = {"mamba2-130m": 3e-5}
SERVE_RUNS = (("mamba2-130m", None), ("zamba2-7b", 6), ("mixtral-8x22b", 2))
SERVE_TIE_ULPS = 4          # tests/test_torch_launch.py's near-tie bound
CARD = ""                   # the card's name and power limit (nvidia-smi)


def _record(arch):
    with open(os.path.join(REPO, "tests", "torch_reference", f"{arch}.json"),
              encoding="utf-8") as fh:
        return json.load(fh)


def _weight_draws(schema):
    """The leaves of a schema that draw from the Threefry kernel (all but
    the zero and one initializers)."""
    from repro_torch.utils.tree import tree_flatten_with_paths

    return sum(1 for _, spec in tree_flatten_with_paths(schema)
               if spec.init not in ("zeros", "ones"))


def _check_record_elements(params, record, label):
    """The card's initial weights at the record's flat indices equal the
    reference's elements exactly; where the record has sums, each leaf's
    float64 sum and sum of squares within float64 summation error.
    Returns the worst relative sum error (0 for a sampled record)."""
    from repro_torch.utils.tree import tree_flatten_with_paths

    worst = 0.0
    leaves = dict(tree_flatten_with_paths(params))
    check(leaves.keys() == record["leaves"].keys(),
          f"{label} leaves {sorted(leaves.keys() ^ record['leaves'].keys())}")
    for path, want in record["leaves"].items():
        leaf = leaves[path]
        check(list(leaf.shape) == want["shape"], f"{label} {path} shape")
        flat = leaf.reshape(-1)
        idx = torch.tensor(want["index"], dtype=torch.int64).to(leaf.device)
        got = flat[idx].cpu().numpy()
        check(np.array_equal(got, np.asarray(want["values"], np.float32)),
              f"{label} {path} elements {got} != {want['values']}")
        if "sum" not in want:
            continue
        x = flat.double()
        bound = x.numel() * 2.0 ** -53
        for name, val, mag in (("sum", x.sum(), x.abs().sum()),
                               ("sumsq", (x * x).sum(), (x * x).sum())):
            err = abs(val.item() - want[name])
            check(err <= bound * mag.item(),
                  f"{label} {path} {name} {val.item()!r} != {want[name]!r}")
            worst = max(worst, err / max(mag.item(), 1e-300))
    return worst


def check_mamba2_reference():
    """``[ref:mamba2-130m]``: the card's full-width initial parameters and
    one fixed batch's loss against tests/torch_reference/mamba2_130m.json
    (written by the JAX package; its command is in the file)."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models.fl_models import get_fl_model

    record = _record(MAMBA2)
    model = get_fl_model(record["model"])
    params = model.init(record["seed"], device="cuda")
    worst = _check_record_elements(params, record, "[ref:mamba2-130m]")
    tokens = torch.tensor(record["tokens"], dtype=torch.int32).to("cuda")
    labels = torch.tensor(record["labels"], dtype=torch.int32).to("cuda")
    with torch.no_grad():
        stacked = tree_lib.tree_map(lambda w: w.unsqueeze(0), params)
        loss = float(model.batch_loss(stacked, tokens[None], labels[None],
                                      None)[0])
    rel = abs(loss - record["loss"]) / abs(record["loss"])
    check(rel <= FAMILY_LOSS_RTOL,
          f"[ref:mamba2-130m] loss {loss!r} against {record['loss']!r}")
    log(f"[ref:mamba2-130m] {len(record['leaves'])} leaves "
        f"({record['param_count']} parameters) drawn on the card: the "
        f"recorded elements equal the reference's, sums within float64 "
        f"summation error (worst {worst:.3g} of sum |x|); the loss of the "
        f"fixed 2 x 16 batch {loss!r} against the reference's "
        f"{record['loss']!r}: relative {rel:.3g} (bound {FAMILY_LOSS_RTOL})")
    del params, stacked
    torch.cuda.empty_cache()


def run_family_main_path(kernels, mode, m=TOKEN_M, t=TOKEN_T):
    """``[main:tokens-ssm]`` / ``[main:tokens-ssm-ota]``: Mamba2-130M at
    full width (129,100,224 parameters in the FL schema, random weights
    from seed 0) as the FL payload through ``run_federated_learning`` on
    the card, the batched engine with the kernels, M=30 devices, K=3, T=3,
    on ``make_token_dataset(vocab_size=50280, num_samples=600,
    seq_len=16)``; NOMA + MAPEL + adaptive DoReFa (one grouped #1 launch
    per non-empty round) or OTA with ota-align powers and noise 1e-9 (one
    keyed #2 launch per non-empty round).  The initial draw is timed alone
    first; the per-round host time and the peak device memory are
    printed; ``[main:tokens-ssm]`` runs one round more, traced by
    torch.profiler (``[trace:tokens-ssm]``)."""
    from repro_torch.core import channel, fl, fl_engine
    from repro_torch.models.fl_models import get_fl_model
    from repro_torch.utils.tree import tree_count, tree_flatten_with_paths

    ds, cell, shards = _token_world(m, MAMBA2_DATA)
    uplink = "ota" if mode.endswith("-ota") else "noma"
    traced_mode = mode == "tokens-ssm"
    cfg = _config(m, t + traced_mode, "numpy", uplink, model=MAMBA2)
    model = get_fl_model(MAMBA2)
    draws = _weight_draws(model.schema())
    params, t_init = _timed(lambda: model.init(cfg.seed, device="cuda"))
    check(tree_count(params) == MAMBA2_PARAMS,
          f"Mamba2-130M has {tree_count(params)} parameters")
    n_leaves = len(tree_flatten_with_paths(params))
    check(n_leaves == MAMBA2_LEAVES, f"Mamba2-130M has {n_leaves} leaves")
    del params
    torch.cuda.empty_cache()
    bundle = channel.sample_channels(cfg.seed, cell, cfg.num_rounds)
    sizes = np.array([len(s) for s in shards], dtype=np.float64)
    schedule, t_sched = _timed(lambda: fl.make_schedule(
        bundle.gains, sizes / sizes.sum(), cell, cfg))
    log(f"[main:{mode}] {MAMBA2} at full width ({MAMBA2_PARAMS} parameters, "
        f"{n_leaves} leaves, {draws} drawn) M={m} K={cfg.group_size} "
        f"T={cfg.num_rounds}, {MAMBA2_DATA['num_samples']} rows of "
        f"{MAMBA2_DATA['seq_len']} tokens (vocab {MAMBA2_DATA['vocab_size']})"
        f", uplink {uplink}, {cfg.power_mode}, {cfg.compression}: initial "
        f"draw on the card {t_init:.3f} s, schedule {t_sched:.3f} s ({CARD})")
    stamps = []

    def progress(lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"[main:{mode}] round {lg.round}: devices {list(lg.devices)} "
            f"bits {lg.bits.tolist()} acc {lg.test_accuracy:.4f} host "
            f"{stamps[-1] - stamps[-2]:.3f} s")

    # [main:tokens-ssm] runs one round more and traces it
    body = fl_engine._train_quantize_aggregate
    trace_last, traced = _tracing_last_round(t)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    if traced_mode:
        fl_engine._train_quantize_aggregate = trace_last
    try:
        res = fl.run_federated_learning(
            ds, shards, cell, cfg, channels=bundle, schedule=schedule,
            progress=progress, device="cuda")
    finally:
        fl_engine._train_quantize_aggregate = body
    torch.cuda.synchronize()
    total = time.perf_counter() - stamps[0]
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    nonempty = sum(1 for lg in res.logs if lg.devices)
    want = {name: 0 for name in launches}
    want["weighted_aggregate"] = nonempty if uplink == "noma" else 0
    want["ota_aggregate"] = nonempty if uplink == "ota" else 0
    want["threefry_draw"] = draws
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times on [main:{mode}], "
              f"expected {n} ({nonempty} non-empty rounds)")
    acc = res.accuracies()
    check(bool(np.all(np.isfinite(acc))) and bool(np.all((acc >= 0)
                                                          & (acc <= 1))),
          f"[main:{mode}] accuracy {acc}")
    check(tree_count(res.final_params) == MAMBA2_PARAMS,
          "final parameters lost leaves")
    for path, leaf in tree_flatten_with_paths(res.final_params):
        check(leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all()),
              f"[main:{mode}] final {path} not finite on the card")
    log(f"[main:{mode}] run {total:.3f} s after the schedule, rounds "
        f"{[float(f'{s:.3f}') for s in np.diff(stamps)]} s; peak device "
        f"memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"launches {launches} ({CARD})")
    if traced_mode:
        _log_traced_round("tokens-ssm", t, traced)
    return launches


def compare_families_cpu_and_card(kernels, m=12, t=3):
    """``[cpu-vs-card:families]``: the SMOKE Mamba2 and Zamba2 on the
    batched engine with the kernels, M=12, T=3, lr 0.05, max power, in
    tests/test_torch_families_fl.py's worlds (Mamba2: 400 rows, batch 80,
    adaptive DoReFa; Zamba2: 200 rows, no codes, batch 24), on the CPU and
    on the card: logs exact, accuracy within 0.02, the drift inside the
    model's limits; #1
    in ceil(leaves / 16) grouped launches a non-empty round (Zamba2's 40
    leaves take 3); and the SMOKE Mixtral run raising the reference's
    ValueError at its first loss on the card."""
    from repro_torch.core import fl
    from repro_torch.kernels import aggregate

    for arch, (mean_atol, max_atol) in FAMILY_LIMITS.items():
        data, fields = FAMILY_WORLDS[arch]
        ds, cell, shards = _token_world(m, data)
        cfg = _config(m, t, "numpy", model=f"{arch}:smoke",
                      learning_rate=0.05, power_mode="max", **fields)
        cpu = fl.run_federated_learning(ds, shards, cell, cfg, device="cpu")
        reset_launches(kernels)
        card = fl.run_federated_learning(ds, shards, cell, cfg,
                                         device="cuda")
        launches = read_launches(kernels)
        label = (f"[cpu-vs-card:families] M={m} {arch}:smoke "
                 f"{data['num_samples']} rows, {cfg.compression}, batch "
                 f"{cfg.batch_size}")
        worst_mean, worst_max = _check_equal_logs(card, cpu,
                                                  label + " CPU vs card:")
        nonempty = sum(1 for lg in card.logs if lg.devices)
        # one grouped launch reduces up to MAX_SEGMENTS leaves
        per_round = -(-len(_leaves(card.final_params))
                      // aggregate.MAX_SEGMENTS)
        check(launches["weighted_aggregate"] == nonempty * per_round,
              f"{label}: aggregation launches {launches}, expected "
              f"{per_round} a non-empty round")
        check(worst_mean < mean_atol and worst_max < max_atol,
              f"{label} drift mean {worst_mean} max {worst_max} beyond "
              f"its limits")
        log(f"{label}: the drift inside its limits ({mean_atol}, "
            f"{max_atol})")
    ds, cell, shards = _token_world(m, FAMILY_SMOKE_DATA)
    cfg = _config(m, 2, "numpy", model="mixtral_8x22b:smoke")
    try:
        fl.run_federated_learning(ds, shards, cell, cfg, device="cuda")
    except ValueError as exc:
        check("too many values to unpack" in str(exc),
              f"[cpu-vs-card:families] mixtral raised {exc}")
        log(f"[cpu-vs-card:families] mixtral_8x22b:smoke on the card raises "
            f"the reference's ValueError at its first loss: {exc}")
    else:
        raise SmokeFailure("[cpu-vs-card:families] the moe payload trained")


def _bf16_ulp(x):
    x = max(float(abs(x)), float(np.finfo(np.float32).tiny))
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def run_serve_phase(arch, num_layers, gen=16):
    """``[serve:<arch>]``: ``launch.serve`` at the published widths (depth
    cut to ``num_layers`` where given), batch 4, prompt 32, 16 tokens, on
    the card.  The initial weights at the record's indices equal the
    reference's; the greedy tokens are held against the plain per-token
    forward on the card (each step's full forward over the sequence so
    far, no cache): every token is that forward's best logit within 4
    bf16 ulps (a near-tie may flip a choice, as in the CPU tests).  Prints
    the prefill seconds and the decode tokens per second."""
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32", "--gen",
            str(gen), "--device", "cuda"]
    if num_layers:
        argv += ["--num-layers", str(num_layers)]
    label = f"[serve:{arch}]"
    torch.cuda.reset_peak_memory_stats()
    out, wall = _timed(lambda: serve.run(argv))
    peak = torch.cuda.max_memory_allocated()
    model, params, tokens = out["model"], out["params"], out["tokens"]
    cfg = model.cfg
    record = _record(arch.replace("-", "_").replace(".", "_"))
    check(record["num_layers"] == cfg.num_layers,
          f"{label} record has {record['num_layers']} layers")
    _check_record_elements(params, record, label)
    seq = torch.cat([out["prompts"], tokens[:, :-1]], dim=1)
    flips, worst = 0, 0.0
    with torch.no_grad():
        for i in range(gen):
            logits = model.forward(params, {"tokens": seq[:, :32 + i]})[0]
            last = logits[:, -1, : cfg.vocab_size]
            best = last.max(-1).values
            chosen = torch.gather(last, -1, tokens[:, i:i + 1].long())[:, 0]
            gap = float((best - chosen).max())
            tol = SERVE_TIE_ULPS * _bf16_ulp(float(last.abs().max()))
            check(gap <= tol, f"{label} token {i}: {gap} below the best "
                              f"logit (tolerance {tol})")
            flips += int((last.argmax(-1).to(torch.int32)
                          != tokens[:, i]).sum())
            worst = max(worst, gap)
    n_params = sum(leaf.numel() for leaf in _leaves(params))
    log(f"{label} {cfg.name} at full width, {cfg.num_layers} layers "
        f"({n_params} parameters), batch 4, prompt 32, {gen} tokens: prefill "
        f"{out['prefill_s']:.3f} s, decode {out['decode_s']:.3f} s "
        f"({gen * 4 / out['decode_s']:.1f} tok/s), whole run {wall:.1f} s "
        f"(the initial draw included), peak {peak / 2**30:.2f} GiB; the "
        f"record's initial elements equal the reference's; tokens against "
        f"the plain per-token forward: {flips} near-tie flips, worst gap "
        f"{worst:.3g} ({CARD})")
    del out, model, params, tokens, seq
    torch.cuda.empty_cache()


def _leaves(tree):
    from repro_torch.core import tree as tree_lib

    return tree_lib.tree_flatten(tree)[0]


def run_train_phase(label, argv, final=None):
    """``[train:<label>]``: ``launch.train.main(argv)`` on the card: its
    losses finite, seconds per step and the peak device memory printed.
    Returns the losses; with a dict ``final``, the last step's parameters
    land in ``final["params"]``."""
    import contextlib
    import io

    from repro_torch.launch import steps, train

    make = steps.make_train_step

    def keeping(model, opt, **kwargs):
        step = make(model, opt, **kwargs)

        def kept(params, state, batch):
            out = step(params, state, batch)
            final["params"] = out[0]
            return out

        return kept

    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    if final is not None:
        steps.make_train_step = keeping
    try:
        with contextlib.redirect_stdout(buf):
            losses, wall = _timed(
                lambda: train.main(argv + ["--device", "cuda"]))
    finally:
        steps.make_train_step = make
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) > 0 and all(math.isfinite(x) for x in losses),
          f"[train:{label}] losses {losses}")
    bits = [line for line in buf.getvalue().splitlines()
            if line.startswith("adaptive fl bits")]
    log(f"[train:{label}] {' '.join(argv)}: {len(losses)} steps, "
        f"{wall / len(losses):.3f} s / step (the first step and the initial "
        f"draw included), loss {losses[0]:.4f} -> {losses[-1]:.4f}, peak "
        f"{peak / 2**30:.2f} GiB; {bits[0] if bits else 'fixed bits'} "
        f"({CARD})")
    torch.cuda.empty_cache()
    return losses


def _sampled_drift(values, record):
    """The worst leaf's mean |values[path] - the reference's| over the
    record's sampled elements (``record``: path -> index, values)."""
    return max(float(np.abs(np.asarray(values[path], np.float64)
                            - np.asarray(rec["values"], np.float64)).mean())
               for path, rec in record.items())


def check_train_record(name):
    """``[train:<name>]``: the record's run (tests/torch_reference/
    train_losses.json, written by the JAX package) on the card, held to
    the reference's run by a limit that the record's wrong run (one step's
    update thrown away) leaves: each step's loss within
    ``TRAIN_LOSS_LIMITS[name]`` relative; where the record has the final
    parameters (Mamba2-130M, whose wrong run moves no loss beyond the
    sound run's bf16 spread), their worst leaf's mean drift over the
    sampled elements within ``TRAIN_DRIFT_LIMITS[name]``; the loss
    falling, as the reference's does."""
    with open(os.path.join(REPO, "tests", "torch_reference",
                           "train_losses.json"), encoding="utf-8") as fh:
        record = json.load(fh)
    want = record["runs"][name]

    def worst(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       want["losses"]))

    final = {}
    losses = run_train_phase(name, want["argv"], final)
    rel, limit = worst(losses), TRAIN_LOSS_LIMITS[name]
    check(len(losses) == len(want["losses"]) and rel <= limit,
          f"[train:{name}] losses {losses} against the reference's "
          f"{want['losses']} (limit {limit})")
    check(losses[-1] < losses[0],
          f"[train:{name}] the loss did not fall: {losses}")
    wrong = worst(want["dropped_losses"])
    line = (f"[train:{name}] each step's loss within {rel:.3g} relative of "
            f"the reference's (limit {limit}; the run that threw away step "
            f"{record['dropped_step']}'s update: {wrong:.3g})")
    if "final" in want:
        from repro_torch.utils.tree import tree_flatten_with_paths

        params = dict(tree_flatten_with_paths(final["params"]))
        check(params.keys() == want["final"].keys(),
              f"[train:{name}] final leaves")
        card = {path: params[path].reshape(-1)[torch.tensor(
            rec["index"], device=params[path].device)].double().cpu()
            for path, rec in want["final"].items()}
        drift = _sampled_drift(card, want["final"])
        wrong = _sampled_drift({path: rec["dropped"] for path, rec
                                in want["final"].items()}, want["final"])
        limit = TRAIN_DRIFT_LIMITS[name]
        check(drift < limit,
              f"[train:{name}] final drift {drift} beyond {limit}")
        line += (f"; final parameters' worst leaf mean drift {drift:.3g} "
                 f"over the sampled elements (limit {limit}; the wrong "
                 f"run: {wrong:.3g})")
    check(wrong > limit, f"[train:{name}] the wrong run's {wrong} does not "
                         f"leave the limit {limit}")
    log(f"{line}; the reference's {want['losses'][0]:.4f} -> "
        f"{want['losses'][-1]:.4f}")


def run_train_phases(tmpdir):
    """The trainer at full width, batch 8, seq 128, adaptive NOMA bits:
    Qwen2-0.5B (the reference's default arch) 10 steps and with ``--ef
    --fl-bits 4``, the loss falling; Mamba2-130M 20 steps (the reference's
    default count: at 1-bit codes its loss does not fall within 10, the
    reference's neither) held to the reference's record
    (:func:`check_train_record`); a ``--save`` / ``--resume`` round trip
    on Mamba2-130M (10 steps, a checkpoint at 5, the other 5 resumed: the
    same losses as the uninterrupted run, to the bit); the SMOKE Mixtral
    (the moe family) 12 steps, held to its record likewise."""
    import repro_torch.checkpoint as ck

    base = ["--batch", "8", "--seq", "128"]
    for label, argv in (
            ("qwen2-0.5b", ["--arch", "qwen2-0.5b", "--steps", "10"] + base),
            ("qwen2-0.5b-ef", ["--arch", "qwen2-0.5b", "--steps", "10",
                               "--ef", "--fl-bits", "4"] + base)):
        losses = run_train_phase(label, argv)
        check(losses[-1] < losses[0],
              f"[train:{label}] the loss did not fall: {losses}")
    check_train_record("mamba2-130m")
    # the step-5 checkpoint is the one the resume reads; the run's other
    # saves (1.5 GB each through zlib on a host without zstandard, ~40 s)
    # are skipped
    five = os.path.join(tmpdir, "five.ckpt")
    save = ck.save_checkpoint
    ck.save_checkpoint = lambda path, tree: (
        save(five, tree) if tree["step"] == 5 else None)
    argv = ["--arch", "mamba2-130m", "--steps", "10"] + base
    try:
        losses = run_train_phase(
            "mamba2-130m-save",
            argv + ["--save", os.path.join(tmpdir, "whole.ckpt"),
                    "--save-every", "5"])
    finally:
        ck.save_checkpoint = save
    rest = run_train_phase("mamba2-130m-resume", argv + ["--resume", five])
    check(rest == losses[5:], f"[train:mamba2-130m-resume] {rest} != "
                              f"{losses[5:]}")
    log("[train:mamba2-130m-resume] resumed at step 5 from the checkpoint: "
        "the same losses as the uninterrupted run, to the bit")
    check_train_record("mixtral-8x22b-smoke")


def run_family_phases(kernels):
    """The moe, ssm and hybrid slice's phases, in order; returns #1's and
    #2's max abs errors at the Mamba2-130M shapes (``[family-kernel]``)."""
    import tempfile

    errs = compare_token_kernels(MAMBA2, "Mamba2-130M", "family-kernel",
                                 MAMBA2_LEAVES, MAMBA2_PARAMS)
    torch.cuda.empty_cache()
    run_family_main_path(kernels, "tokens-ssm")
    torch.cuda.empty_cache()
    run_family_main_path(kernels, "tokens-ssm-ota")
    torch.cuda.empty_cache()
    compare_families_cpu_and_card(kernels)
    check_mamba2_reference()
    for arch, num_layers in SERVE_RUNS:
        run_serve_phase(arch, num_layers)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        run_train_phases(tmp)
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    global CARD
    CARD = smi

    kernels = kernels_of_main_path()
    build_kernels(kernels)
    agg, sic = kernels[0]["module"], kernels[1]["module"]
    errs = {"weighted_aggregate": compare_aggregate(agg),
            "sic_weighted_rates": compare_sic(sic)}
    m, t, k, pool = SCHED_CASES[0]
    times = {"weighted_aggregate": time_aggregate(agg),
             "sic_weighted_rates": time_sic(
                 sic, t * math.comb(pool, k), k, label="M=300 T=35 pool=64 ")}
    time_sic(sic, 5 * math.comb(24, k), k, label="FL main path T=5 pool=24 ")
    m2, t2, k2, pool2 = SCHED_CASES[1]
    time_sic(sic, t2 * math.comb(pool2, k2), k2, label="M=1000 T=50 pool=64 ")
    run_scheduler(sic)
    host, _ = run_main_path(kernels, "host")
    on_card, _ = run_main_path(kernels, "jax")
    planned, launches = run_main_path(kernels, "pallas")
    check([lg.devices for lg in host.logs] == [lg.devices for lg in on_card.logs]
          == [lg.devices for lg in planned.logs],
          "the three main-path runs scheduled differently")
    compare_cpu_and_card(kernels)

    ota_mod = kernels[2]["module"]
    errs["ota_aggregate"] = compare_ota(ota_mod)
    times["ota_aggregate"] = time_ota(ota_mod)
    threefry_mod = kernels[7]["module"]
    times["threefry_draw"], errs["threefry_draw"] = check_noise(threefry_mod)
    ota_run, ota_launches, path_err = run_ota_main_path(kernels)
    launches["threefry_draw"] = ota_launches["threefry_draw"]
    errs["ota_aggregate"] = max(errs["ota_aggregate"], path_err)
    tdma_run, _ = run_main_path(kernels, "tdma")
    check([lg.devices for lg in ota_run.logs]
          == [lg.devices for lg in tdma_run.logs]
          == [lg.devices for lg in host.logs],
          "the OTA, TDMA and NOMA runs scheduled differently")
    compare_cpu_and_card(kernels, uplink="ota")
    launches["ota_aggregate"] = ota_launches["ota_aggregate"]

    dorefa_mod = kernels[3]["module"]
    worst = compare_dorefa(dorefa_mod)
    for n in DOREFA_TIME_N:
        dorefa_times = time_dorefa(dorefa_mod, n)
        if n == LENET_LEAVES[0]:            # the codec path's largest leaf
            times.update(dorefa_times)
    codec_launches, codec_err = run_codec(kernels, host)
    for name in ("quantize_codes", "dequantize_codes", "quantize_dequantize"):
        errs[name] = max(worst, codec_err)
        launches[name] = codec_launches[name]
    topk_run, _, topk_err = run_topk_main_path(kernels)
    errs["weighted_aggregate"] = max(errs["weighted_aggregate"], topk_err)
    bucketed_run, _ = run_main_path(kernels, "bucketed")
    check([lg.devices for lg in topk_run.logs]
          == [lg.devices for lg in host.logs],
          "the top-k and host runs scheduled differently")
    _check_identical_runs(bucketed_run, host, "[main:bucketed]")
    compare_cpu_and_card(kernels, topk=TOPK)

    legacy_run, _ = run_main_path(kernels, "legacy")
    _check_equal_logs(legacy_run, host, "[main:legacy] against [main:host]:")
    legacy_ota_run, _ = run_main_path(kernels, "legacy-ota")
    _check_equal_logs(legacy_ota_run, ota_run,
                      "[main:legacy-ota] against [main:ota]:")
    random_run, _ = run_main_path(kernels, "random")
    check([lg.devices for lg in random_run.logs]
          != [lg.devices for lg in host.logs],
          "the random schedule equals the lazy-gwmin one")
    compare_cpu_and_card(kernels, legacy=True)

    scan_run, _ = run_main_path(kernels, "scan")
    _check_identical_runs(scan_run, host, "[main:scan] against [main:host]:")
    log(f"[main:scan] {RUN_SECONDS['scan']:.4f} s after the schedule, "
        f"{RUN_SECONDS['scan'] / 5:.4f} s per round; [main:host] "
        f"{RUN_SECONDS['host']:.4f} s, {RUN_SECONDS['host'] / 5:.4f} s per "
        f"round")
    scan_ota_run, _ = run_main_path(kernels, "scan-ota")
    _check_identical_runs(scan_ota_run, ota_run,
                          "[main:scan-ota] against [main:ota]:")
    log(f"[main:scan-ota] {RUN_SECONDS['scan-ota']:.4f} s after the "
        f"schedule; [main:ota] {RUN_SECONDS['ota']:.4f} s")
    singles, single_dev = run_seed_sweep(kernels, scan_run)
    run_cell_sweep(kernels, singles, single_dev)
    compare_cpu_and_card(kernels, scan=True)

    online_scan = run_online_phases(kernels)
    run_online_seed_sweep(kernels, online_scan)
    compare_cpu_and_card(kernels, online=True)

    flash_mod = kernels[6]["module"]
    flash_err = compare_flash(flash_mod)
    flash_times = {dtype: time_flash(flash_mod, dtype)
                   for dtype in (torch.bfloat16, torch.float32)}
    times["flash_decode"] = flash_times[torch.bfloat16]
    flash_launches, path_err = run_flash_main_path(kernels)
    errs["flash_decode"] = max(max(flash_err.values()), path_err)
    launches["flash_decode"] = flash_launches["flash_decode"]
    check_draws()

    agg_err, ota_err = run_token_phases(kernels)
    errs["weighted_aggregate"] = max(errs["weighted_aggregate"], agg_err)
    errs["ota_aggregate"] = max(errs["ota_aggregate"], ota_err)
    agg_err, ota_err = run_family_phases(kernels)
    errs["weighted_aggregate"] = max(errs["weighted_aggregate"], agg_err)
    errs["ota_aggregate"] = max(errs["ota_aggregate"], ota_err)

    rows = []
    for kern in kernels:
        name = kern["name"]
        t = times[name]
        rows.append(dict(
            name=name, route=kern["route"], source=kern["source"],
            replaces=kern["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t.get("bound_by", "bytes"),
            library_ms=t["library_ms"], host_ms=t["host_ms"],
            plain_host_ms=t["plain_host_ms"],
        ))
        check(all(math.isfinite(v) for v in t.values()
                  if isinstance(v, float)), f"{name} timing not finite")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"(build included)")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
