"""Multi-card dry-run: count every (arch x shape x mesh) step and emit its
memory and roofline analysis; the port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]

It computes nothing and needs no card, as the reference's dry-run needs no
TPU: the step runs once under ``FakeTensorMode``, on fake CPU tensors that
carry shapes and dtypes and allocate nothing, at the published widths and
full depth.  (Each kernel wrapper therefore takes its plain version's
branch, whose operations are what get counted; nothing is launched.)  The
mesh is a torch ``DeviceMesh`` of 256 or 512 cards over torch's fake
process group (``launch/mesh.py``), from which the rules
(``sharding/rules.py``) read the placements.

What is counted, per card:
  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step, the
    backward pass included for train, divided evenly over the mesh;
  * HBM bytes: every aten op's input and output bytes (views move none),
    divided likewise: the eager counterpart of XLA's "bytes accessed", the
    bytes the port really moves, with no fusion;
  * collective bytes: from the placements, as output-shape bytes: the
    data-axis all-gather of each FSDP-sharded parameter, for train the
    gradients' reduce-scatters (all-reduces for leaves not sharded over
    "data", and over "pod" on two pods), and the tensor-parallel
    all-reduces at the activation-sharding sites whose input is a partial
    sum over the model axis (attention and MLP outputs, the embedding;
    twice for train, the backward pass mirroring each);
  * bytes per device: the sharded parameters, optimizer state, batch and
    caches, plus the peak of live bytes the step allocates over the mesh.

A decode step's host read of the cache length (``int(cache["len"])`` in
``models/layers.py``, one per attention layer) is answered with
``seq_len - 1``, so the step reads the whole cache, as the reference's
count does (a prefill's with 0, its fresh cache's); the number of such
reads is reported.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import INPUT_SHAPES, ShapeConfig
from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.core import tree as tree_lib
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models.registry import build_model
from repro_torch.models import layers as mlayers
from repro_torch.optim import adamw
from repro_torch.sharding import rules as sh

# Principled skips: long_500k needs sub-quadratic attention.
SKIPS = {
    ("qwen3_8b", "long_500k"): "pure full attention",
    ("granite_34b", "long_500k"): "pure full attention",
    ("qwen2_0_5b", "long_500k"): "pure full attention",
    ("mistral_large_123b", "long_500k"): "pure full attention",
    ("llama_3_2_vision_90b", "long_500k"): "pure full-attention backbone",
    ("seamless_m4t_medium", "long_500k"): "enc-dec; 500k decode not meaningful",
}

@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    status: str
    compile_s: float = 0.0
    bytes_per_device: int = 0
    roofline: dict = None
    error: str = ""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Bytes in and out of every aten op, the peak of live storage bytes
    (an op's result that lies in one of its inputs' storages, as an
    in-place op's does, allocates nothing), and the host reads
    (``_local_scalar_dense``), answered with ``host_value``."""

    # allocations that write nothing (views are skipped by ``is_view``)
    _NO_DATA = ("aten::empty", "aten::empty_strided", "aten::empty_like")

    def __init__(self, host_value: Optional[int] = None):
        super().__init__()
        self.host_value = host_value
        self.host_reads = 0
        self.bytes = 0
        self.bytes_by_op = collections.Counter()
        self.live = {}
        self.live_bytes = 0
        self.peak = 0
        self._since_sweep = 0

    def _sweep(self):
        for key in [k for k, (ref, _) in self.live.items() if ref.expired()]:
            self.live_bytes -= self.live.pop(key)[1]
        self._since_sweep = 0

    def _track(self, out):
        storage = out.untyped_storage()
        ref = StorageWeakRef(storage)
        if ref.cdata in self.live:
            return
        self.live[ref.cdata] = (ref, storage.nbytes())
        self.live_bytes += storage.nbytes()
        self._since_sweep += 1
        # dead storages leave the sum at a sweep; one runs (every 32
        # allocations at most) when the sum passes the peak
        if self.live_bytes > self.peak and self._since_sweep >= 32:
            self._sweep()
            self.peak = max(self.peak, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            if self.host_value is None:
                raise RuntimeError("a host read on a counted path")
            self.host_reads += 1
            return self.host_value
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        # an op with no tensor result (``prim::device``, sizes) moves no
        # data, nor does a view
        if outs and not func.is_view \
                and func._schema.name not in self._NO_DATA:
            moved = sum(_nbytes(t) for t in outs)
            for t in ins:
                moved += min(_nbytes(t), t.untyped_storage().nbytes())
            self.bytes += moved
            self.bytes_by_op[func._schema.name] += moved
        if not func.is_view:
            # an in-place op's result is its input's storage: nothing new
            # (the step's parameters and moments are counted as resident)
            written = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata not in written:
                    self._track(t)
        return out

    def finish(self) -> int:
        self._sweep()
        self.peak = max(self.peak, self.live_bytes)
        return self.peak


class CollectiveCounter:
    """The activation-sharding hook of a counted step: the identity, which
    records the tensor-parallel all-reduce each partial-sum site (the
    row-parallel attention and MLP outputs, the vocab-sharded embedding
    gather) implies: the per-card output shape, the batch dim split over
    the batch axes where it divides."""

    def __init__(self, mesh):
        sizes = sh.axis_sizes(mesh)
        self.model = sizes.get("model", 1)
        self.nb = sh.batch_shard(mesh)
        self.bytes = 0
        self.count = 0

    def __call__(self, x, kind, partial_sum):
        if partial_sum and self.model > 1:
            split = self.nb if x.shape[0] % self.nb == 0 else 1
            self.bytes += _nbytes(x) // split
            self.count += 1
        return x


def _leaves(tree):
    return tree_lib.tree_flatten(tree)[0]


def _param_collectives(ab_params, pspecs, mesh,
                       train: bool) -> rl.CollectiveStats:
    """The collectives the parameters' placements imply, per card: the
    FSDP all-gathers, and for train the gradients' reductions, as float32
    output shapes."""
    sizes = sh.axis_sizes(mesh)
    stats = rl.empty_collectives()

    def add(kind, nbytes):
        stats.bytes_by_kind[kind] += int(nbytes)
        stats.count_by_kind[kind] += 1

    for ab, spec in zip(_leaves(ab_params), _leaves(pspecs)):
        full = int(np.prod(ab.shape, dtype=np.int64)) * 4
        local = full // spec.shard_factor(mesh)
        fsdp = sizes["data"] > 1 and any(
            "data" in spec.axes_of(d) for d in range(len(spec)))
        if fsdp:
            add("all-gather", local * sizes["data"])
        if not train:
            continue
        if fsdp:
            add("reduce-scatter", local)
            if sizes.get("pod", 1) > 1:
                add("all-reduce", local)
        elif sh.batch_shard(mesh) > 1:
            add("all-reduce", local)
    return stats


def _cache_pspecs(caches, mesh):
    def spec(x):
        if x.ndim >= 4:
            # (stack..., B, S, H, D) KV caches
            return sh.cache_pspec(mesh, x.shape, stacked_dims=x.ndim - 4)
        if x.ndim == 0:
            return sh.ShardSpec()
        # SSM/conv states: (stack..., B, ...) — shard batch when divisible
        ba = sh.batch_axes(mesh)
        nb = sh.batch_shard(mesh)
        for i, d in enumerate(x.shape):
            if d % nb == 0 and d >= nb:
                return sh.ShardSpec(*([None] * i), ba,
                                    *([None] * (x.ndim - i - 1)))
        return sh.ShardSpec(*([None] * x.ndim))

    return tree_lib.tree_map(spec, caches)


def _sharded_bytes(tree, specs, mesh) -> int:
    return sum(_nbytes(x) // s.shard_factor(mesh)
               for x, s in zip(_leaves(tree), _leaves(specs)))


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape))


def run_one(arch: str, shape_name, *, multi_pod: bool = False,
            smoke_mesh: bool = False, fl_bits: Optional[int] = 8,
            kv_chunk_train: int = 1024, kv_chunk_decode: int = 4096,
            cfg_override: Optional[dict] = None, grad_accum: int = 1,
            verbose: bool = True) -> DryrunResult:
    """Count one step of ``arch`` at ``shape_name`` (a key of
    ``INPUT_SHAPES``, or a :class:`ShapeConfig`) on the production mesh
    (or the 1-card mesh with ``smoke_mesh``)."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else INPUT_SHAPES[shape_name])
    mesh = make_smoke_mesh() if smoke_mesh \
        else make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    mesh_name = _mesh_name(mesh)

    t0 = time.time()
    try:
        model = build_model(cfg, shards=sh.axis_sizes(mesh)["model"])
        ab_params = model.abstract()
        pspecs = sh.param_pspecs(model.param_logical_specs(), ab_params, mesh)
        train = shape.kind == "train"
        coll = _param_collectives(ab_params, pspecs, mesh, train)
        hook = CollectiveCounter(mesh)
        fake = FakeTensorMode()
        with fake:
            params = tree_lib.tree_map(
                lambda a: torch.empty(a.shape, dtype=torch.float32),
                ab_params)
        batch = steps.input_specs(cfg, shape, fake_mode=fake)
        resident = _sharded_bytes(params, pspecs, mesh)
        resident += sum(
            _nbytes(v) // sh.activation_specs(
                mesh, v.shape[0], extra_dims=v.ndim - 1).shard_factor(mesh)
            for v in batch.values())
        # a prefill's cache starts empty; a decode step's is full
        counter = StepCounter(host_value={
            "train": None, "prefill": 0}.get(shape.kind, shape.seq_len - 1))
        flops = FlopCounterMode(display=False)
        mlayers.set_activation_sharding(hook)
        with fake:
            if train:
                opt = adamw(3e-4)
                opt_state = opt.init(params)
                resident += sum(
                    _sharded_bytes(v, pspecs, mesh) if k != "step"
                    else _nbytes(v) for k, v in opt_state.items())
                step = steps.make_train_step(
                    model, opt, fl_bits=fl_bits, kv_chunk=kv_chunk_train,
                    grad_accum=grad_accum)
                with flops, counter:
                    step(params, opt_state, batch)
            elif shape.kind == "prefill":
                step = steps.make_prefill_step(
                    model, shape, kv_chunk=kv_chunk_train, device="cpu")
                with flops, counter:
                    step(params, batch)
            else:  # decode
                caches = steps.abstract_cache(model, shape, fake_mode=fake)
                resident += _sharded_bytes(
                    caches, _cache_pspecs(caches, mesh), mesh)
                step = steps.make_serve_step(model, kv_chunk=kv_chunk_decode)
                with flops, counter:
                    step(params, caches, batch)
        peak = counter.finish()
    except Exception as e:  # noqa: BLE001 — dry-run failures are findings
        return DryrunResult(arch, getattr(shape, "name", str(shape_name)),
                            mesh_name, "FAIL", time.time() - t0,
                            error=f"{type(e).__name__}: {e}")
    finally:
        mlayers.set_activation_sharding(None)

    dt = time.time() - t0
    tp = hook.bytes * (2 if train else 1)
    coll.bytes_by_kind["all-reduce"] += tp
    coll.count_by_kind["all-reduce"] += hook.count * (2 if train else 1)
    roof = rl.Roofline(
        flops=flops.get_total_flops() / n_chips,
        hbm_bytes=counter.bytes / n_chips,
        collective_bytes=float(coll.total_bytes),
        collectives=coll,
        model_flops=rl.model_flops(cfg, shape, n_chips=n_chips),
    )
    bytes_per_device = int(resident + peak // n_chips)
    summary = roof.summary()
    summary["host_reads"] = counter.host_reads
    # the aten ops that move the most bytes, per card
    summary["hbm_bytes_by_op"] = {
        op: b / n_chips for op, b in counter.bytes_by_op.most_common(6)}
    if verbose:
        print(f"[{arch} x {shape.name} x {mesh_name}] count {dt:.1f}s  "
              f"mem/dev {bytes_per_device/2**30:.2f} GiB  "
              f"bottleneck {roof.bottleneck}  "
              f"t=(c {roof.t_compute*1e3:.2f} | m {roof.t_memory*1e3:.2f} | "
              f"x {roof.t_collective*1e3:.2f}) ms  "
              f"useful {roof.useful_flops_ratio:.2f}")
        sys.stdout.flush()
    return DryrunResult(arch, shape.name, mesh_name, "OK", dt,
                        bytes_per_device, summary)


def probe_plan(cfg):
    """Reduced-config probes for component-wise extrapolation.

    Returns (probes, target): each probe is (cfg-overrides, counts) where
    counts are the multiplicities of each homogeneous component
    (intercept, unit1[, unit2]) in that probe; ``target`` is the full
    config's multiplicities."""
    if cfg.family == "hybrid":
        # components: intercept, mamba layer, shared-attn site
        probes = [
            ({"num_layers": 3, "hybrid_attn_every": 2}, (1, 3, 1)),
            ({"num_layers": 2, "hybrid_attn_every": 2}, (1, 2, 1)),
            ({"num_layers": 4, "hybrid_attn_every": 2}, (1, 4, 2)),
        ]
        target = (1, cfg.num_layers, cfg.num_layers // cfg.hybrid_attn_every)
    elif cfg.family == "vlm":
        # components: intercept, self layer, cross layer
        probes = [
            ({"num_layers": 2, "cross_attn_every": 2}, (1, 1, 1)),
            ({"num_layers": 4, "cross_attn_every": 2}, (1, 2, 2)),
            ({"num_layers": 4, "cross_attn_every": 4}, (1, 3, 1)),
        ]
        e = cfg.cross_attn_every
        target = (1, cfg.num_layers - cfg.num_layers // e, cfg.num_layers // e)
    elif cfg.family == "encdec":
        probes = [
            ({"num_layers": 2, "encoder_layers": 2}, (1, 2)),
            ({"num_layers": 4, "encoder_layers": 4}, (1, 4)),
        ]
        target = (1, cfg.num_layers)
    else:
        probes = [({"num_layers": 2}, (1, 2)), ({"num_layers": 4}, (1, 4))]
        target = (1, cfg.num_layers)
    return probes, target


def roofline_extrapolated(arch: str, shape_name, *,
                          fl_bits: Optional[int] = 8, grad_accum: int = 1,
                          cfg_override: Optional[dict] = None,
                          verbose: bool = True, **run_kw) -> DryrunResult:
    """Component-extrapolated roofline, the reference's API: each pair is
    counted at 2-3 reduced configs (:func:`probe_plan`) and the per-card
    FLOPs / bytes / collective bytes are solved component-wise (least
    squares) and evaluated at the full config.  The port can count the
    full depth directly (:func:`run_one`), which holds this against it."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    probes, target = probe_plan(cfg)
    results = []
    for overrides, counts in probes:
        r = run_one(arch, shape_name,
                    cfg_override={**(cfg_override or {}), **overrides},
                    fl_bits=fl_bits, grad_accum=grad_accum, verbose=False,
                    **run_kw)
        if r.status != "OK":
            return dataclasses.replace(r, mesh=r.mesh + "(extrap)")
        results.append((r, counts))

    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else INPUT_SHAPES[shape_name])
    n_chips = 512 if run_kw.get("multi_pod") else 256
    a_mat = np.array([c for _, c in results], dtype=np.float64)
    tvec = np.array(target, dtype=np.float64)

    def extrap(y):
        coef, *_ = np.linalg.lstsq(a_mat, np.asarray(y, np.float64),
                                   rcond=None)
        return float(tvec @ coef)

    def extrap_key(key):
        y = [r.roofline[key] for r, _ in results]
        return max(extrap(y), float(max(y)))

    flops = extrap_key("hlo_flops_per_chip")
    hbm = extrap_key("hbm_bytes_per_chip")
    coll = extrap_key("collective_bytes_per_chip")
    mf = rl.model_flops(cfg, shape, n_chips=n_chips)
    terms = {
        "t_compute_s": flops / rl.PEAK_FLOPS,
        "t_memory_s": hbm / rl.HBM_BW,
        "t_collective_s": coll / rl.LINK_BW,
    }
    bottleneck = max(terms, key=terms.get).replace("t_", "").replace("_s", "")
    summary = {
        **terms,
        "bottleneck": bottleneck,
        "hlo_flops_per_chip": flops,
        "hbm_bytes_per_chip": hbm,
        "collective_bytes_per_chip": coll,
        "collective_breakdown": {
            k: max(extrap([r.roofline["collective_breakdown"][k]
                           for r, _ in results]), 0.0)
            for k in results[0][0].roofline["collective_breakdown"]
        },
        "collective_counts": results[-1][0].roofline["collective_counts"],
        "model_flops_per_chip": mf,
        "useful_flops_ratio": mf / max(flops, 1.0),
        "probe_configs": [o for o, _ in probes],
        "target_counts": list(target),
    }
    res = DryrunResult(arch, shape.name, results[0][0].mesh + "(extrap)",
                       "OK", sum(r.compile_s for r, _ in results),
                       results[-1][0].bytes_per_device, summary)
    if verbose:
        print(f"[{arch} x {shape.name} x roofline-extrap] "
              f"bottleneck {bottleneck}  "
              f"t=(c {terms['t_compute_s']*1e3:.2f} | "
              f"m {terms['t_memory_s']*1e3:.2f} | "
              f"x {terms['t_collective_s']*1e3:.2f}) ms  "
              f"useful {summary['useful_flops_ratio']:.2f}")
        sys.stdout.flush()
    return res


def extrapolation_gap(extrapolated: DryrunResult,
                      direct: DryrunResult) -> dict:
    """|extrapolated - direct| / direct of the three per-card counts."""
    if direct.status != "OK":
        return {"direct": direct.error}
    return {k: abs(extrapolated.roofline[k] - direct.roofline[k])
            / max(direct.roofline[k], 1.0)
            for k in ("hlo_flops_per_chip", "hbm_bytes_per_chip",
                      "collective_bytes_per_chip")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="depth-extrapolated roofline pass (reduced-depth "
                         "probes), beside the full-depth count")
    ap.add_argument("--fl-bits", type=int, default=8,
                    help="paper's uplink quantization bit-width in "
                         "train_step (32=off)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatch count for train shapes (memory lever)")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    pairs = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                pairs.append((a, s))
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        pairs.append((args.arch, args.shape))

    results = []
    for arch, shape in pairs:
        key = (canonical(arch), shape)
        if key in SKIPS:
            print(f"[{arch} x {shape}] SKIP: {SKIPS[key]}")
            res = DryrunResult(arch, shape, "-", "SKIP", error=SKIPS[key])
        elif args.roofline:
            res = roofline_extrapolated(arch, shape, fl_bits=args.fl_bits,
                                        grad_accum=args.grad_accum,
                                        multi_pod=args.multi_pod)
            if res.status == "OK":
                direct = run_one(arch, shape, multi_pod=args.multi_pod,
                                 fl_bits=args.fl_bits,
                                 grad_accum=args.grad_accum, verbose=False)
                res.roofline["direct_rel_gap"] = extrapolation_gap(
                    res, direct)
                print(f"[{arch} x {shape}] extrapolated against the "
                      f"full-depth count, relative: "
                      f"{res.roofline['direct_rel_gap']}")
        else:
            res = run_one(arch, shape, multi_pod=args.multi_pod,
                          fl_bits=args.fl_bits, grad_accum=args.grad_accum)
        if res.status == "FAIL":
            print(f"[{arch} x {shape}] FAIL: {res.error}")
        results.append(res)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(dataclasses.asdict(res)) + "\n")

    n_ok = sum(r.status == "OK" for r in results)
    n_fail = sum(r.status == "FAIL" for r in results)
    n_skip = sum(r.status == "SKIP" for r in results)
    print(f"\n== dry-run: {n_ok} OK, {n_fail} FAIL, {n_skip} SKIP ==")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
