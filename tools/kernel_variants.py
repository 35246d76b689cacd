"""Time source variants of the port's CUDA kernels in turns, on the card.

Each variant is ``csrc/<kernel>.cu`` with a few constants replaced; it is
built with the port's own nvcc flags into ``build/variants/``, checked
against the plain version, and timed behind a sleep kernel (device time,
as ``chip_smoke.py`` times kernels) in rounds that visit every variant in
turn, so the card's drift falls on all of them alike.  The library call
the kernel is held against is timed in the same rounds.

    python3 tools/kernel_variants.py [--rounds 3]

Variants: the bf16 flash-decode kernel at decode_32k (B=128, S=32,768,
Hkv=2, G=7, D=64) with other ring depths and warps per CTA, against
``scaled_dot_product_attention``; ``quantize_codes``,
``dequantize_codes`` and ``quantize_dequantize`` at 2^20 float32 elements
with one, two and four 16-byte vectors per thread, against
``quantize_per_tensor``, ``torch.mul`` and
``fake_quantize_per_tensor_affine``; the grouped aggregation kernel over
one FL round's six LeNet leaves at K=3 with 128, 256 and 512 threads per
CTA, against six ``einsum`` calls; the keyed OTA kernel over one OTA
round (K=3, LeNet's 266,610 parameters in the path's spaced rows) with one
and two quads per thread at 128 and 256 threads per CTA, against the
three launches it replaces (the Threefry draw, ``scale * z`` and the
strip kernel); the Threefry draw at the main path's shapes (the bf16
normal at 52,428,800, the float32 normal at 266,610 and 136,249,344, the
truncated normal at 235,200, the uniform at 2^20) with 1, 2 or 4 float32
(1, 4 or 8 bf16) values per thread (4 and 8 also below the card's
resident threads, where the committed kernel draws 1), 128 threads per
CTA, the bf16 table as bf16 bits, the hash's adds where ptxas puts
them (or only the rounds' on IMAD), erf_inv's w >= 5 side as selects and
the ragged last group after the loop, each with its host-inclusive time,
its
bound (chip_smoke.py:threefry_bound_ms) and its SASS per value, against
``torch.randn`` / ``torch.rand`` (Philox, another generator: a yardstick
only).  The first variant of each is the kernel as committed.

    python3 tools/kernel_variants.py --only threefry --only ota_aggregate \
        --baseline DIR

``--only`` runs the named sections (flash_decode, dorefa, aggregate,
ota_aggregate, threefry); ``--baseline DIR`` adds the Threefry draw and the
keyed OTA kernel built from another tree's ``csrc`` (``DIR`` holding its
``threefry.cu``, ``threefry.cuh`` and ``ota_aggregate.cu``, e.g. a
``git archive`` of the parent commit), timed in the same turns.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

from repro_torch.core import ota, prng  # noqa: E402
from repro_torch.kernels import aggregate, cuda_build, dorefa  # noqa: E402
from repro_torch.kernels import ota_aggregate  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import threefry  # noqa: E402

import chip_smoke  # noqa: E402

FLASH_VARIANTS = {
    "4 stages x 2 warps": [],
    "3 stages x 2 warps": [("kBf16Stages = 4;", "kBf16Stages = 3;")],
    "6 stages x 2 warps": [("kBf16Stages = 4;", "kBf16Stages = 6;")],
    "3 stages x 4 warps": [("kBf16Stages = 4;", "kBf16Stages = 3;"),
                           ("kWarps = 2;", "kWarps = 4;")],
    "6 stages x 4 warps": [("kBf16Stages = 4;", "kBf16Stages = 6;"),
                           ("kWarps = 2;", "kWarps = 4;")],
    "3 stages x 8 warps": [("kBf16Stages = 4;", "kBf16Stages = 3;"),
                           ("kWarps = 2;", "kWarps = 8;")],
}
VECTORS = "kVectorsPerThread = 2;"
DOREFA_VARIANTS = {
    "2 vectors/thread": [],
    "1 vector/thread": [(VECTORS, "kVectorsPerThread = 1;")],
    "4 vectors/thread": [(VECTORS, "kVectorsPerThread = 4;")],
}
THREADS = "kThreads = 256;"
AGGREGATE_VARIANTS = {
    "256 threads/CTA": [],
    "128 threads/CTA": [(THREADS, "kThreads = 128;")],
    "512 threads/CTA": [(THREADS, "kThreads = 512;")],
}
QUADS = "kQuadsPerThread = 1;"
OTA_VARIANTS = {
    "1 quad x 256 threads": [],
    "2 quads x 256 threads": [(QUADS, "kQuadsPerThread = 2;")],
    "1 quad x 128 threads": [(THREADS, "kThreads = 128;")],
    "2 quads x 128 threads": [(QUADS, "kQuadsPerThread = 2;"),
                              (THREADS, "kThreads = 128;")],
}
IMAD_ADD = """  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(blockDim.z),
      "r"(y));
  return d;"""
# the key injections as written, where ptxas chooses the pipe
KEY_ADDS = [("""  x0 = imad_add(x0, ks[0]);
  x1 = imad_add(x1, ks[1]);""", """  x0 += ks[0];
  x1 += ks[1];"""), ("""    x0 = imad_add(x0, ks[(i + 1) % 3]);
    x1 = imad_add(x1, ks[(i + 2) % 3] + (uint32_t)(i + 1));""",
                     """    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);""")]
# the bf16 table as bf16 bits, two to a 32-bit bank word: a lookup at the
# byte offset bits & 0xFE, no shift
BF16_TABLE = [
    ("__shared__ float table[128];", "__shared__ unsigned short table[128];"),
    ("""    table[threadIdx.x] = __bfloat162float(
        __float2bfloat16_rn(bf16_normal_of_k(threadIdx.x)));""",
     """    table[threadIdx.x] = __bfloat16_as_ushort(
        __float2bfloat16_rn(bf16_normal_of_k(threadIdx.x)));"""),
    ("vals.v[j] = __float_as_uint(table[(bits & 0xFFu) >> 1]) >> 16;",
     "vals.v[j] = table[(bits & 0xFFu) >> 1];")]
ERF_BRANCH = """  float p;
  if (__builtin_expect(lp > -5.0f, 1)) {
    p = erf_inv_poly(__fsub_rn(-2.5f, lp), lt5_c);
  } else {   // w >= 5, or a NaN
    p = erf_inv_poly(__fadd_rn(__fsqrt_rn(-lp), -3.0f), ge5_c);
  }"""
# the w >= 5 side as the selects of the earlier design: both sides' w, one
# polynomial whose every coefficient is a select
ERF_SELECTS = """  const bool lt5 = lp > -5.0f;
  const float w = lt5 ? __fsub_rn(-2.5f, lp)
                      : __fadd_rn(__fsqrt_rn(-lp), -3.0f);
  float p = __fmaf_rn(w, lt5 ? lt5_c[0] : ge5_c[0], lt5 ? lt5_c[1] : ge5_c[1]);
#pragma unroll
  for (int i = 2; i < 9; ++i) p = __fmaf_rn(w, p, lt5 ? lt5_c[i] : ge5_c[i]);"""
RAGGED_IN = """  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i0 = g * G;
    const Group<T, G> vals = draw(i0);
    if (i0 + G <= n) {
      reinterpret_cast<V*>(out + i0)[0] = vals.chunk;
      continue;
    }"""
# the ragged group after the loop, drawn by the thread whose turn it is:
# the loop holds no test of it (and measured slower)
RAGGED_AFTER = """  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t g = first; g < n / G; g += stride) {
    reinterpret_cast<V*>(out + g * G)[0] = draw(g * G).chunk;
  }
  const int64_t i0 = n / G * G;
  if (i0 < n && first == n / G % stride) {
    const Group<T, G> vals = draw(i0);"""
F32_PER = "kF32PerThread = 4;"
BF16_PER = "kBf16PerThread = 8;"
THREEFRY_VARIANTS = {
    "4 f32 / 8 bf16 x 256": [],
    "2 f32 / 4 bf16 x 256": [(F32_PER, "kF32PerThread = 2;"),
                             (BF16_PER, "kBf16PerThread = 4;")],
    "1 f32 / 1 bf16 x 256": [(F32_PER, "kF32PerThread = 1;"),
                             (BF16_PER, "kBf16PerThread = 1;")],
    "4 f32 / 8 bf16 x 128": [(THREADS, "kThreads = 128;")],
    "4 f32 / 8 bf16 at every size": [("  if (n <= resident) return 1;\n",
                                      "")],
    "bf16-bits table": BF16_TABLE,
    "adds as written": [(IMAD_ADD, "  return x + y;")],
    "only round adds as IMAD": KEY_ADDS,
    "erf_inv selects": [(ERF_BRANCH, ERF_SELECTS)],
    "ragged group after the loop": [(RAGGED_IN, RAGGED_AFTER)],
}
# the header's alternatives, as the keyed OTA kernel takes them
OTA_VARIANTS.update({tag: THREEFRY_VARIANTS[tag]
                     for tag in ("adds as written", "erf_inv selects")})
# the main path's draws: (mode, n)
THREEFRY_SHAPES = (
    ("bf16", 52_428_800), ("normal", 136_249_344), ("normal", 266_610),
    ("truncated", 235_200), ("uniform", 1 << 20))
LENET_LEAVES = (235_200, 300, 30_000, 100, 1_000, 10)
LENET_PARAMS = sum(LENET_LEAVES)    # 266,610
QWEN2_EMBED = 136_249_344
BASELINE = "baseline"        # the tag of a --baseline build
DECODE_32K = (128, 2, 7, 64, 32_768)


def build(kernel, tag, subs, csrc=cuda_build.CSRC):
    """Compile ``<csrc>/<kernel>.cu`` with ``subs`` applied to it or to the
    ``*.cuh`` header that holds each, in a directory of its own (which its
    ``#include "..."`` reads first); the library."""
    name = f"{kernel}_" + "".join(c if c.isalnum() else "_" for c in tag)
    out = cuda_build.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text()
             for p in [Path(csrc) / f"{kernel}.cu", *Path(csrc).glob("*.cuh")]}
    for old, new in subs:
        holders = [f for f, text in files.items() if old in text]
        if len(holders) != 1:
            raise SystemExit(f"{kernel}: {old!r} in {holders or 'no file'}")
        files[holders[0]] = files[holders[0]].replace(old, new)
    for fname, text in files.items():
        (out / fname).write_text(text)
    proc = subprocess.run(
        cuda_build.nvcc_command(cuda_build.find_nvcc(), out / f"{kernel}.cu",
                                out / f"{name}.so"),
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{kernel} {tag}: {proc.stderr[-2000:]}")
    return str(out / f"{name}.so")


@contextlib.contextmanager
def loaded(mod, path):
    """``mod``'s wrappers launch the kernel of the library at ``path``."""
    load = cuda_build.load
    cuda_build.load = lambda name: ctypes.CDLL(path)
    mod._lib = None
    try:
        mod._library()
        yield
    finally:
        cuda_build.load = load
        mod._lib = None


def device_ms(fn, iters):
    """Device ms per call of ``iters`` calls queued behind a sleep."""
    fn()
    while True:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        backlogged = not start.query()
        torch.cuda.synchronize()
        if backlogged:
            return start.elapsed_time(stop) / iters
        if iters == 1:
            raise SystemExit("could not queue one call behind the sleep")
        iters //= 2


def host_ms(fn, iters):
    """Mean ms per call of back-to-back calls, CUDA events around the
    loop: the host's launch cost included where the card outruns it."""
    for _ in range(3):
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


def time_in_turns(cases, library, rounds, host=None):
    """{name: [ms per round]} over ``cases`` {name: (mod, path, fn,
    iters)} and the library call (fn, iters), visited in turn; with a
    dict ``host``, each one's host-inclusive ms per round there too."""
    times = {name: [] for name in [*cases, "library"]}
    for name in times if host is not None else ():
        host[name] = []
    for _ in range(rounds):
        for name, (mod, path, fn, iters) in cases.items():
            with loaded(mod, path):
                times[name].append(device_ms(fn, iters))
                if host is not None:
                    host[name].append(host_ms(fn, iters))
        times["library"].append(device_ms(*library))
        if host is not None:
            host["library"].append(host_ms(*library))
    return times


def flash_cases(libs):
    b, h, g, d, s = DECODE_32K
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(*shape, device="cuda", generator=gen).bfloat16()
               for shape in ((b, h, g, d), (b, s, h, d), (b, s, h, d)))
    vt = torch.tensor(s, dtype=torch.int32, device="cuda")
    want = fd.flash_decode_plain(q, k, v, s).float()
    for tag, path in libs.items():
        with loaded(fd, path):
            got = fd._launch(q, k, v, vt, fd.BLOCK_S).float()
            if bool(((got - want).abs()
                     > 1e-6 + 2.0 ** -7 * want.abs()).any()):
                raise SystemExit(f"flash_decode {tag}: beyond one rounding")
    qh = q.reshape(b, h * g, 1, d)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    cases = {tag: (fd, path, lambda: fd._launch(q, k, v, vt, fd.BLOCK_S), 20)
             for tag, path in libs.items()}
    library = (lambda: F.scaled_dot_product_attention(
        qh, kh, vh, enable_gqa=True), 4)
    return cases, library


def dorefa_cases(name, libs, n=1 << 20, bits=8):
    """``quantize_codes``, ``dequantize_codes`` or ``quantize_dequantize``
    at n float32 elements, each variant checked bit for bit against the
    plain version."""
    gen = torch.Generator().manual_seed(n)
    x = (torch.randn(n, generator=gen) * 0.3).cuda()
    s = x.abs().max()
    n_out = -(-n // 32_768) * 32_768
    scale = s.item() / dorefa.levels(bits)
    if name == "quantize_codes":
        def kern():
            return dorefa._quantize_codes_launch(x, s, bits, n_out)
        want = dorefa.quantize_codes_plain(x, s, bits, n_out)
        library = (lambda: torch.quantize_per_tensor(x, scale, 0,
                                                     torch.qint32), 50)
    elif name == "dequantize_codes":
        codes = dorefa.quantize_codes_plain(x, s, bits)
        step = s * dorefa.inv_levels(bits)

        def kern():
            return dorefa._dequantize_codes_launch(codes, s, bits)
        want = dorefa.dequantize_codes_plain(codes, s, bits)
        library = (lambda: torch.mul(codes, step), 50)
    else:
        def kern():
            return dorefa._quantize_dequantize_launch(x, s, bits)
        want = dorefa.quantize_dequantize_plain(x, s, bits)
        a = int(dorefa.levels(bits))
        library = (lambda: torch.fake_quantize_per_tensor_affine(
            x, scale, 0, -a, a), 50)
    for tag, path in libs.items():
        with loaded(dorefa, path):
            if not torch.equal(kern().view(torch.int32),
                               want.view(torch.int32)):
                raise SystemExit(f"{name} {tag}: outputs differ")
    cases = {tag: (dorefa, path, kern, 50) for tag, path in libs.items()}
    return cases, library


def aggregate_cases(libs, k=3):
    """One round's grouped aggregation over LeNet's six leaves, each
    variant checked bit for bit against the plain version."""
    gen = torch.Generator().manual_seed(k)
    codes = [torch.round(torch.randn(k, n, generator=gen) * 40).cuda()
             for n in LENET_LEAVES]
    coeffs = [torch.rand(k, generator=gen).cuda() for _ in LENET_LEAVES]
    want = [aggregate.weighted_aggregate_plain(c, cf)
            for c, cf in zip(codes, coeffs)]

    def kern():
        return aggregate._launch_group(codes, coeffs)

    for tag, path in libs.items():
        with loaded(aggregate, path):
            if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(kern(), want)):
                raise SystemExit(f"aggregate {tag}: outputs differ")
    cases = {tag: (aggregate, path, kern, 200) for tag, path in libs.items()}
    library = (lambda: [torch.einsum("k,kn->n", cf, c)
                        for c, cf in zip(codes, coeffs)], 200)
    return cases, library


def ota_cases(libs, k=3, n=LENET_PARAMS):
    """One OTA round's keyed reduction (the path's kernel), each variant
    checked bit for bit against the plain version; the yardstick is the
    strip path's three launches on the same inputs."""
    gen = torch.Generator().manual_seed(k)
    x = ota_aggregate.row_buffer(k, n, device="cuda")
    x.copy_(torch.randn(k, n, generator=gen) * 0.01)
    coeff = torch.rand(k, generator=gen).cuda()
    key = ota.horizon_keys(0, 4)[3]
    scale = torch.tensor(3e-3, device="cuda")
    want = ota_aggregate.ota_aggregate_keyed_plain(x, coeff, key, scale)

    def kern():
        return ota_aggregate._launch_keyed(x, coeff, key, scale)

    def sequence():
        return ota_aggregate._launch(
            x, coeff, scale * prng.normal(key, n, device="cuda"))

    for tag, path in libs.items():
        with loaded(ota_aggregate, path):
            if not torch.equal(kern().view(torch.int32),
                               want.view(torch.int32)):
                raise SystemExit(f"ota_aggregate {tag}: outputs differ")
    cases = {tag: (ota_aggregate, path, kern, 50)
             for tag, path in libs.items()}
    return cases, (sequence, 50)


def ota_embedding_cases(libs):
    """The keyed reduction on the Qwen2-0.5B embedding leaf (K=3 x
    136,249,344), the committed kernel and the baseline only."""
    first = next(iter(libs))
    return ota_cases({tag: path for tag, path in libs.items()
                      if tag in (first, BASELINE)}, n=QWEN2_EMBED)


def _draw_args(mode):
    """(minval, maxval, keyword arguments) of the wrapper's draw."""
    if mode == "uniform":
        return 0.0, 1.0, {}
    if mode == "truncated":
        a, b = prng.ERF_BOUNDS[(-3.0, 3.0)]
        clip = (float(np.nextafter(np.float32(-3), 0)),
                float(np.nextafter(np.float32(3), 0)))
        return a, b, {"normal": True, "clip": clip}
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    return prng.NORMAL_LO, 1.0, {"normal": True, "dtype": dtype}


def threefry_cases(libs, mode, n, key):
    """The draw of ``mode`` at n through the wrapper: the committed kernel
    checked bit for bit against the plain version on the card, every other
    variant against the committed kernel."""
    lo, hi, kw = _draw_args(mode)

    def kern():
        return threefry.threefry_draw(key, n, lo, hi, device="cuda", **kw)

    if mode == "bf16":
        want = prng.normal_bf16_plain(key, n, device="cuda")
        library = (lambda: torch.randn(n, device="cuda",
                                       dtype=torch.bfloat16), 20)
    else:
        want = prng.draw_plain(key, n, lo, hi, normal=kw.get("normal", False),
                               clip=kw.get("clip"), device="cuda")
        library = ((lambda: torch.rand(n, device="cuda")) if mode == "uniform"
                   else (lambda: torch.randn(n, device="cuda")), 20)
    view = torch.int16 if mode == "bf16" else torch.int32
    for tag, path in libs.items():
        with loaded(threefry, path):
            if not torch.equal(kern().view(view), want.view(view)):
                raise SystemExit(f"threefry {mode} {n} {tag}: outputs differ")
    del want
    iters = 20 if n > 10_000_000 else 100
    cases = {tag: (threefry, path, kern, iters) for tag, path in libs.items()}
    return cases, library


def _report(label, times, host, bound, sass):
    """One line a variant: device and host-inclusive ms per round, the
    mean over the bound and the SASS per value."""
    for name, dev in times.items():
        mean = sum(dev) / len(dev)
        line = (f"[variants] {label} {name}: device " + " ".join(
            f"{t:.5f}" for t in dev) + " ms; host-inclusive " + " ".join(
            f"{t:.5f}" for t in host[name]) + " ms")
        if name != "library":
            line += (f"; {mean / bound['ms']:.3f}x the bound; "
                     + sass.get(name, ""))
        print(line, flush=True)


def run_threefry(libs, rounds):
    """Every draw of THREEFRY_SHAPES in turns over the Threefry builds, and
    the keyed OTA kernel at LeNet and at the Qwen2 embedding over the
    committed and baseline builds, each against its bound."""
    key = ota.horizon_keys(0, 4)[3]
    for mode, n in THREEFRY_SHAPES:
        rational, rare = (chip_smoke.draw_shares(key, n, *_draw_args(mode)[:2])
                          if mode in ("normal", "truncated") else (0.0, 0.0))
        work = chip_smoke.threefry_work(
            "normal" if mode == "truncated" else mode, rational, rare,
            clamp=mode == "truncated")
        bound = chip_smoke.threefry_bound_ms(
            work, n, n * (2 if mode == "bf16" else 4))
        print(f"[variants] threefry {mode} n={n}: bound {bound['ms']:.5f} ms "
              f"({bound['by']}; bytes {bound['bytes']:.5f}, ALU pipe "
              f"{bound['ALU pipe']:.5f}, issue {bound['issue']:.5f}); "
              f"shares rational {rational:.5f}, w >= 5 {rare:.6f}",
              flush=True)
        kind = "normal" if mode == "truncated" else mode
        sass = {}
        for tag, path in libs.items():
            if tag == BASELINE:     # one kernel for every float32 mode
                fn = ("threefry_normal_bf16_kernel" if mode == "bf16"
                      else "threefry_drawEjj")
                per = 1
            else:
                with loaded(threefry, path):
                    per = threefry.attributes(kind, n)["values_per_thread"]
                fn = chip_smoke.threefry_function(kind, per)
            sass[tag] = f"{per} a thread; " + chip_smoke._sass_text(
                chip_smoke.sass_counts(path, fn, per), work)
        cases, library = threefry_cases(libs, mode, n, key)
        host = {}
        times = time_in_turns(cases, library, rounds, host)
        _report(f"threefry {mode} n={n}", times, host, bound, sass)
        del cases, library
        torch.cuda.empty_cache()


def run_keyed(libs, rounds, k=3):
    """The keyed OTA kernel at LeNet (its variants) and at the Qwen2-0.5B
    embedding (committed and baseline), against its bound."""
    key = ota.horizon_keys(0, 4)[3]
    for n, make in ((LENET_PARAMS, ota_cases),
                    (QWEN2_EMBED, ota_embedding_cases)):
        work = chip_smoke.threefry_work("normal",
                                        *chip_smoke.draw_shares(key, n))
        work["fma"] += 1 + k
        work["mem"] += k / 4
        bound = chip_smoke.threefry_bound_ms(work, n,
                                             (k + 1) * n * 4 + k * 4 + 4)
        cases, library = make(libs)
        sass = {tag: chip_smoke._sass_text(chip_smoke.sass_counts(
            path, "ota_vec4ILb1E", 4), work) for tag, (_, path, _, _)
            in cases.items()}
        host = {}
        times = time_in_turns(cases, library, rounds, host)
        print(f"[variants] ota_aggregate keyed K={k} n={n}: bound "
              f"{bound['ms']:.5f} ms ({bound['by']}); the library line is "
              f"the three launches it replaces", flush=True)
        _report(f"ota_aggregate keyed n={n}", times, host, bound, sass)
        del cases, library
        torch.cuda.empty_cache()


SECTIONS = ("flash_decode", "dorefa", "aggregate", "ota_aggregate",
            "threefry")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--only", action="append", choices=SECTIONS)
    parser.add_argument("--baseline", type=Path, default=None)
    args = parser.parse_args()
    only = set(args.only or SECTIONS)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    variants = {"flash_decode": FLASH_VARIANTS, "dorefa": DOREFA_VARIANTS,
                "aggregate": AGGREGATE_VARIANTS, "ota_aggregate": OTA_VARIANTS,
                "threefry": THREEFRY_VARIANTS}
    jobs = [(kernel, tag, subs, cuda_build.CSRC) for kernel in SECTIONS
            if kernel in only for tag, subs in variants[kernel].items()]
    if args.baseline is not None:
        jobs += [(kernel, BASELINE, [], args.baseline.resolve())
                 for kernel in ("ota_aggregate", "threefry") if kernel in only]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda job: build(*job), jobs))
    libs = {(kernel, tag): path
            for (kernel, tag, _, _), path in zip(jobs, paths)}

    def of(kernel):
        return {tag: path for (k, tag), path in libs.items() if k == kernel}

    if "threefry" in only:
        run_threefry(of("threefry"), args.rounds)
    if "ota_aggregate" in only:
        run_keyed(of("ota_aggregate"), args.rounds)
    for kernel, label, unit, scale, make in (
            ("flash_decode", "flash_decode", "ms", 1.0, flash_cases),
            ("dorefa", "quantize_codes", "us", 1e3,
             lambda libs: dorefa_cases("quantize_codes", libs)),
            ("dorefa", "dequantize_codes", "us", 1e3,
             lambda libs: dorefa_cases("dequantize_codes", libs)),
            ("dorefa", "quantize_dequantize", "us", 1e3,
             lambda libs: dorefa_cases("quantize_dequantize", libs)),
            ("aggregate", "weighted_aggregate round", "us", 1e3,
             aggregate_cases)):
        if kernel not in only:
            continue
        cases, library = make(of(kernel))
        for name, times in time_in_turns(cases, library, args.rounds).items():
            print(f"[variants] {label} {name}: " + " ".join(
                f"{t * scale:.4f}" for t in times) + f" {unit} device")
        del cases, library
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
