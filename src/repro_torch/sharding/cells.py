"""The cell axis of a sweep across cards.

The port of the reference's cell split (``repro.launch.mesh.cell_mesh``
and ``shard_map`` over it, ``repro/core/fl.py``'s padding): a (C, S) grid
of independent simulations is cut along its cell axis into one contiguous
block per card, each block runs on its card, and the blocks' results are
joined in cell order.  The cells never communicate, so there is no
collective; each block runs in a worker process of its own
(:func:`run_blocks`, a ``torch.multiprocessing`` spawn context: CUDA
cannot be forked, and a simulation's round is host dispatch, so only
separate processes let several cards' rounds be issued at once).

  * :func:`cell_shards` clamps a requested shard count to the card count
    (1 on the CPU), the bound :func:`repro_torch.launch.mesh.cell_mesh`
    checks; :func:`shard_devices` places the shards, and takes a sequence
    of devices as given (how the CPU tests and a one-card host reach the
    split: ``["cpu", "cpu"]``, ``["cuda:0", "cuda:0"]``).
  * :func:`pad_cells` repeats the leading cells until C is a multiple of
    the shard count, as the reference pads; the results of the repeated
    cells are dropped on return.
  * :class:`Workers` starts one spawned process a shard ahead of its
    block (the caller builds the plans meanwhile); :func:`run_blocks`
    starts, runs and stops them in one call.
  * :func:`cut_blocks` and :func:`join_blocks` read the placements of
    :mod:`repro_torch.sharding.rules` (``cell_sweep_*_specs``): an
    argument placed ``Shard(0)`` is cut into blocks of cells, one placed
    ``Replicate()`` goes whole to every block.

A worker receives its block as host numpy arrays through a pipe (no
shared memory; one sending thread a worker) and returns host arrays and
its process's kernel launch counts, which :data:`last_launches` keeps per
worker (:data:`last_seconds` its wall times).  A worker that
raises makes the caller raise with its traceback; one that dies, or that
has not answered within :data:`WORKER_TIMEOUT` seconds, makes the caller
raise too.  Nothing falls back to the unsplit path.
"""
from __future__ import annotations

import io
import multiprocessing.connection
import pickle
import struct
import threading
import time
import traceback

import numpy as np
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.sharding import vertex as vertex_lib

WORKER_TIMEOUT = 3600.0     # seconds a split waits for its workers' results
WORKER_KERNELS = ("aggregate", "ota_aggregate", "dorefa", "threefry")
# the kernel libraries a worker's horizons may load: built in the parent
# before the workers start, so that no two processes compile one kernel

last_launches: list = []
# each worker's kernel launch counts ({wrapper name: launches}) from the
# latest Workers.run: the counters are per process
last_seconds: list = []
# each worker's wall seconds in the latest Workers.run: "start" (from
# the spawn to the worker's first statement: the interpreter, torch and
# the target's module imported), "setup" (the device's context),
# "receive" (waiting for its block, which the caller may still be
# building, and reading it from the pipe), "run" (the target, the card
# synchronised) and "exit" (from its result to its process's end, as the
# caller waited for it)


def cell_shards(requested, device) -> int:
    """The shard count a cell sweep splits into: ``requested`` (``None``
    means 1) clamped to [1, the card count on ``device``]; a sequence of
    devices is one shard per entry."""
    return len(shard_devices(requested, device))


def shard_devices(requested, device) -> list:
    """The devices of a sweep's shards: ``None`` is the run's device, an
    int is clamped to the card count and placed on the first cards
    (:func:`repro_torch.sharding.vertex.shard_devices`), a sequence of
    devices is taken as given, and started :class:`Workers` are on
    theirs."""
    if requested is None:
        return [torch.device(device)]
    if isinstance(requested, Workers):
        return list(requested.devices)
    return vertex_lib.shard_devices(requested, device)


def pad_cells(x, num_cells: int, pad: int):
    """``x`` (a tree of arrays or tensors with a leading cell axis of
    ``num_cells``, or ``None``) with its leading cells repeated ``pad``
    times more, cyclically, as the reference pads C to the mesh."""
    if x is None or pad == 0:
        return x
    idx = np.arange(num_cells + pad) % num_cells
    return tree_lib.tree_map(
        lambda a: a[torch.from_numpy(idx).to(a.device)]
        if isinstance(a, torch.Tensor) else a[idx], x)


def _is_sharded(placement) -> bool:
    from torch.distributed.tensor import Shard

    return isinstance(placement, Shard)


def cut_blocks(args, specs, n: int) -> list:
    """The positional ``args`` of a split call cut into ``n`` blocks by
    their placements ``specs``: a ``Shard(0)`` argument (a tree, or
    ``None``) into ``n`` contiguous blocks of its leading cell axis, which
    must divide evenly; a ``Replicate()`` one whole into every block."""
    if len(args) != len(specs):
        raise ValueError(f"{len(args)} arguments for {len(specs)} placements")
    blocks = [[] for _ in range(n)]
    for arg, spec in zip(args, specs):
        if not _is_sharded(spec) or arg is None:
            for b in blocks:
                b.append(arg)
            continue
        cells = tree_lib.tree_flatten(arg)[0][0].shape[0]
        if cells % n:
            raise ValueError(f"{cells} cells do not split into {n} blocks; "
                             f"pad them first (pad_cells)")
        size = cells // n
        for j, b in enumerate(blocks):
            b.append(tree_lib.tree_map(
                lambda a, j=j: a[j * size:(j + 1) * size], arg))
    return [tuple(b) for b in blocks]


def join_blocks(outs, specs) -> tuple:
    """The blocks' results joined by their placements: ``Shard(0)``
    results concatenated along the cell axis in block order (``None``
    stays ``None``), ``Replicate()`` ones taken from the first block."""
    joined = []
    for i, spec in enumerate(specs):
        parts = [out[i] for out in outs]
        if not _is_sharded(spec) or parts[0] is None:
            joined.append(parts[0])
            continue
        joined.append(tree_lib.tree_map(
            lambda *a: np.concatenate(a), *parts))
    return tuple(joined)


def to_host(tree):
    """Every tensor leaf of ``tree`` (nested dicts, tuples and lists) as a
    host numpy array; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def launch_counts() -> dict:
    """This process's kernel launch counts, by wrapper name."""
    from repro_torch.kernels import (
        aggregate, dorefa, flash_decode, ota_aggregate, sic_rates, threefry,
    )

    wrappers = (aggregate.weighted_aggregate, ota_aggregate.ota_aggregate,
                dorefa.quantize_codes, dorefa.dequantize_codes,
                dorefa.quantize_dequantize, sic_rates.sic_weighted_rates,
                flash_decode.flash_decode, threefry.threefry_draw)
    return {w.__name__: w.launches for w in wrappers}


def _build_worker_kernels() -> None:
    """Compile the libraries the workers may load, once, in this process."""
    from repro_torch.kernels import cuda_build

    for name in WORKER_KERNELS:
        cuda_build.build(name)


def _send_payload(conn, payload: bytes) -> None:
    """Write a pickled block to a worker's pipe: its 8-byte length, then
    the bytes, from a view (the pipe's own ``send`` is read back by
    ``os.read`` calls that each allocate the whole remaining length, which
    costs seconds for a client bank on a sandboxed host).  A worker that
    is gone breaks the pipe; :meth:`Workers.run` reports it."""
    out = io.FileIO(conn.fileno(), "wb", closefd=False)
    try:
        for part in (struct.pack("!Q", len(payload)), payload):
            view, pos = memoryview(part), 0
            while pos < len(view):
                pos += out.write(view[pos:])
    except OSError:
        pass


def _recv_block(conn):
    """Read what :func:`_send_payload` wrote, into one preallocated
    buffer, and unpickle it."""
    src = io.FileIO(conn.fileno(), "rb", closefd=False)

    def read_into(buf):
        view, pos = memoryview(buf), 0
        while pos < len(buf):
            got = src.readinto(view[pos:])
            if not got:
                raise EOFError("the block's pipe closed early")
            pos += got
        return buf

    (size,) = struct.unpack("!Q", read_into(bytearray(8)))
    return pickle.loads(read_into(bytearray(size)))


def _worker_main(conn, device: str, threads: int, spawned: float) -> None:
    """A worker process: set up ``device``, receive ``(target, block)``,
    run ``target(block, device)`` and send back ``("ok", result, launch
    counts, seconds)``, or ``("error", traceback, None, None)`` if
    anything raised."""
    marks = [spawned, time.time()]
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            from repro_torch.device import resolve_device

            resolve_device(dev)
            torch.cuda.set_device(dev)
            torch.cuda.synchronize(dev)
        marks.append(time.time())
        target, block = _recv_block(conn)
        marks.append(time.time())
        out = target(block, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(time.time())
        seconds = dict(zip(("start", "setup", "receive", "run"),
                           np.diff(marks).tolist()))
        conn.send(("ok", out, launch_counts(), seconds))
    except Exception:   # noqa: BLE001 - the parent re-raises it
        conn.send(("error", traceback.format_exc(), None, None))
    finally:
        conn.close()


class Workers:
    """One spawned worker process on each of ``devices``, started ahead of
    its work, so that the caller can build the blocks while the workers
    import and set up their devices; :meth:`run` gives each its block
    once; leaving a ``with`` block (or :meth:`close`) stops any still
    running.  The workers run with this process's torch thread count."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices for the workers")
        if any(d.type == "cuda" for d in self.devices):
            _build_worker_kernels()
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs, self.conns, self._used = [], [], False
        try:
            for dev in self.devices:
                parent_end, child_end = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main, daemon=True,
                    args=(child_end, str(dev), torch.get_num_threads(),
                          time.time()))
                proc.start()
                child_end.close()
                self.procs.append(proc)
                self.conns.append(parent_end)
        except BaseException:
            self.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(self, target, blocks, *, timeout=None) -> list:
        """``target(block, device)`` for each block on its worker, all at
        once; returns the results in block order.

        ``target`` is a module-level function of the package (a spawned
        worker imports it by name), ``blocks`` hold host arrays.  Each
        worker's kernel launch counts go to :data:`last_launches`, its
        seconds to :data:`last_seconds`.  Raises ``RuntimeError`` if a
        worker raises (with its traceback) or dies, ``TimeoutError`` if
        the results are not all in within ``timeout`` seconds
        (:data:`WORKER_TIMEOUT`).
        """
        global last_launches, last_seconds
        if self._used:
            raise RuntimeError("these workers have run their blocks")
        self._used = True
        n = len(self.devices)
        if len(blocks) != n:
            raise ValueError(f"{len(blocks)} blocks for {n} workers")
        timeout = WORKER_TIMEOUT if timeout is None else float(timeout)
        # pickled here, so that a block that cannot be pickled raises here;
        # then one writing thread a worker, so that no worker waits for
        # another's block
        payloads = [pickle.dumps((target, block),
                                 protocol=pickle.HIGHEST_PROTOCOL)
                    for block in blocks]
        for conn, payload in zip(self.conns, payloads):
            threading.Thread(target=_send_payload, args=(conn, payload),
                             daemon=True).start()
        results, launches, seconds = [None] * n, [None] * n, [None] * n
        pending = set(range(n))
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"cell-sweep workers {sorted(pending)} gave no result "
                    f"within {timeout:g} s")
            ready = multiprocessing.connection.wait(
                [self.conns[j] for j in pending]
                + [self.procs[j].sentinel for j in pending], timeout=left)
            for j in sorted(pending):
                conn, proc = self.conns[j], self.procs[j]
                if conn not in ready and proc.sentinel not in ready:
                    continue
                if not conn.poll():
                    raise RuntimeError(self._died(j))
                try:
                    status, out, counts, seconds[j] = conn.recv()
                except EOFError:
                    raise RuntimeError(self._died(j)) from None
                if status != "ok":
                    raise RuntimeError(f"cell-sweep worker {j} on "
                                       f"{self.devices[j]} raised:\n{out}")
                results[j], launches[j] = out, counts
                seconds[j]["answered"] = time.monotonic()
                pending.discard(j)
        for j, proc in enumerate(self.procs):
            proc.join(10)
            seconds[j]["exit"] = time.monotonic() - seconds[j].pop("answered")
        last_launches, last_seconds = launches, seconds
        return results

    def _died(self, j) -> str:
        self.procs[j].join(5)
        return (f"cell-sweep worker {j} on {self.devices[j]} died without a "
                f"result (exit code {self.procs[j].exitcode})")

    def close(self) -> None:
        """Stop every worker still running (one that answered has exited,
        or exits on its own)."""
        for conn in self.conns:
            conn.close()
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
            proc.join(5)


def run_blocks(target, blocks, devices, *, timeout=None) -> list:
    """:meth:`Workers.run` on workers started for it and stopped after."""
    with Workers(devices) as workers:
        return workers.run(target, blocks, timeout=timeout)
