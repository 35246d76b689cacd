"""Runtime sanitizers of the port: the counterpart of the reference's
``tools/flcheck/sanitizers.py`` (the port imports nothing of ``tools/``).

* :func:`nan_guard` — the opt-in NaN sanitizer of the FL drivers
  (``--sanitize-nans`` in ``examples/fl_noma_mnist_torch.py``), the
  counterpart of ``jax_debug_nans``: inside the block, an ATen op whose
  floating-point output holds a NaN raises ``FloatingPointError`` naming
  the op, at the source instead of in the accuracy curve.  A
  ``TorchDispatchMode`` sees every op below autograd and ``vmap``: the
  forward's, the backward's and the unwrapped tensors of a ``vmap``.
  The hand-written kernels launch through ``ctypes``, out of the
  dispatcher's sight, so each kernel wrapper checks its outputs after the
  launch while :data:`NAN_CHECK` is set (:func:`check_kernel_outputs`),
  naming the wrapper.
* :func:`build_count` — the counterpart of ``compile_count``.  In eager
  PyTorch the work that runs once per process, and must not repeat per
  round or per seed, is the kernel build: the block's count is the
  ``nvcc`` runs of :func:`repro_torch.kernels.cuda_build.build` plus the
  libraries :func:`~repro_torch.kernels.cuda_build.load` loaded.  It is
  constant as rounds and seeds scale, and 0 on a rerun.

Two kinds of op are not checked, because neither computes a value: a view
(its output aliases an input, whose NaN was checked where it was made) and
an allocation that leaves its memory uninitialized (``empty``, whose
garbage bits may read as NaN).  Nothing on the main path calls either
guard unless asked.  The guard syncs the host at every op: it is a
debugging mode, never a default, and does not run under
``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)

from repro_torch.kernels import cuda_build

# True inside nan_guard(): the kernel wrappers read it after each launch
NAN_CHECK = False

_aten = torch.ops.aten
# allocations whose memory is left uninitialized: no value to check
_UNINITIALIZED = frozenset((_aten.empty, _aten.empty_like,
                            _aten.empty_strided))


def _holds_nan(value) -> bool:
    """A floating or complex strided tensor with data that holds a NaN."""
    return (isinstance(value, torch.Tensor)
            and (value.is_floating_point() or value.is_complex())
            and value.layout == torch.strided and value.device.type != "meta"
            and value.numel() > 0 and bool(torch.isnan(value).any()))


class _NanCheck(TorchDispatchMode):
    """Run each op, then raise if a floating-point output holds a NaN.  The
    mode is off inside its own handler, so its ``isnan`` checks are not
    themselves dispatched to it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _UNINITIALIZED:
            return out
        for value in pytree.tree_leaves(out):
            if _holds_nan(value):
                raise FloatingPointError(
                    f"nan_guard: the output of {func} holds a NaN "
                    f"({tuple(value.shape)} {value.dtype} on "
                    f"{value.device})")
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Opt-in NaN sanitizer for the dynamic extent of the block.

    With ``enable`` an ATen op or a kernel wrapper whose floating-point
    output holds a NaN raises ``FloatingPointError`` naming it; with
    ``enable=False`` NaNs pass through.  The dispatch mode stack and
    :data:`NAN_CHECK` are as they were after the block, even when it
    raises.
    """
    global NAN_CHECK
    before = NAN_CHECK
    NAN_CHECK = bool(enable)
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        NAN_CHECK = before


def check_kernel_outputs(name: str, *outputs) -> None:
    """Raise ``FloatingPointError`` naming the kernel wrapper ``name`` if a
    floating-point output of its launch holds a NaN.  The wrappers call it
    only while :data:`NAN_CHECK` is set; the check runs with the dispatch
    modes off."""
    with _disable_current_modes():
        for value in outputs:
            if _holds_nan(value):
                raise FloatingPointError(
                    f"nan_guard: the output of kernel wrapper {name} holds "
                    f"a NaN ({tuple(value.shape)} {value.dtype} on "
                    f"{value.device})")


@dataclasses.dataclass
class BuildTally:
    """Yielded by :func:`build_count`: ``count`` (``nvcc`` runs plus
    library loads), ``builds`` and ``loads`` are None inside the block and
    the block's numbers after it."""
    count: "int | None" = None
    builds: "int | None" = None
    loads: "int | None" = None


def _build_totals():
    return cuda_build.build.nvcc_runs, cuda_build.load.calls


@contextlib.contextmanager
def build_count():
    """Count the kernel builds (``nvcc`` runs) and library loads inside
    the block.

    >>> with build_count() as tally:
    ...     run_federated_learning(...)
    >>> assert tally.count == 0      # every kernel was built before

    The counts are process-wide: a build in another thread during the
    block is counted too.
    """
    tally = BuildTally()
    builds, loads = _build_totals()
    try:
        yield tally
    finally:
        now_builds, now_loads = _build_totals()
        tally.builds = now_builds - builds
        tally.loads = now_loads - loads
        tally.count = tally.builds + tally.loads
