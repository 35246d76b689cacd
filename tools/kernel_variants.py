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
strip kernel).  The first variant of each is the kernel as committed.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.core import ota, prng  # noqa: E402
from repro_torch.kernels import aggregate, cuda_build, dorefa  # noqa: E402
from repro_torch.kernels import ota_aggregate  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

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
LENET_LEAVES = (235_200, 300, 30_000, 100, 1_000, 10)
LENET_PARAMS = sum(LENET_LEAVES)    # 266,610
DECODE_32K = (128, 2, 7, 64, 32_768)


def build(kernel, tag, subs):
    """Compile ``csrc/<kernel>.cu`` with ``subs`` applied; the library."""
    src = (cuda_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{kernel}: {old!r} not in the source")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    name = f"{kernel}_" + "".join(c if c.isalnum() else "_" for c in tag)
    (out / f"{name}.cu").write_text(src)
    proc = subprocess.run(
        cuda_build.nvcc_command(cuda_build.find_nvcc(), out / f"{name}.cu",
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


def time_in_turns(cases, library, rounds):
    """{name: [ms per round]} over ``cases`` {name: (mod, path, fn,
    iters)} and the library call (fn, iters), visited in turn."""
    times = {name: [] for name in [*cases, "library"]}
    for _ in range(rounds):
        for name, (mod, path, fn, iters) in cases.items():
            with loaded(mod, path):
                times[name].append(device_ms(fn, iters))
        times["library"].append(device_ms(*library))
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    jobs = [("flash_decode", tag, subs) for tag, subs in FLASH_VARIANTS.items()]
    jobs += [("dorefa", tag, subs) for tag, subs in DOREFA_VARIANTS.items()]
    jobs += [("aggregate", tag, subs)
             for tag, subs in AGGREGATE_VARIANTS.items()]
    jobs += [("ota_aggregate", tag, subs)
             for tag, subs in OTA_VARIANTS.items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda job: build(*job), jobs))
    libs = {(kernel, tag): path for (kernel, tag, _), path in zip(jobs, paths)}
    for kernel, label, unit, scale, make in (
            ("flash_decode", "flash_decode", "ms", 1.0, flash_cases),
            ("dorefa", "quantize_codes", "us", 1e3,
             lambda libs: dorefa_cases("quantize_codes", libs)),
            ("dorefa", "dequantize_codes", "us", 1e3,
             lambda libs: dorefa_cases("dequantize_codes", libs)),
            ("dorefa", "quantize_dequantize", "us", 1e3,
             lambda libs: dorefa_cases("quantize_dequantize", libs)),
            ("aggregate", "weighted_aggregate round", "us", 1e3,
             aggregate_cases),
            ("ota_aggregate", "ota_aggregate keyed round", "us", 1e3,
             ota_cases)):
        cases, library = make({tag: path for (k, tag), path in libs.items()
                               if k == kernel})
        for name, times in time_in_turns(cases, library, args.rounds).items():
            print(f"[variants] {label} {name}: " + " ".join(
                f"{t * scale:.4f}" for t in times) + f" {unit} device")
        del cases, library
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
