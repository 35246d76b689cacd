"""Gradient-tree codec on the DoReFa quantizer (paper Algorithm 1 uplink).

The port of ``repro.core.compression``.  It measures the
payload, derives the adaptive bit width from a device's bit budget, packs
a tree into integer codes for honest byte accounting (:func:`encode_tree`
/ :func:`decode_tree`, through the DoReFa kernels of
:mod:`repro_torch.kernels.ops` under ``use_pallas``), and prices the top-k
sparse stage that may run before DoReFa (:func:`topk_plan`,
:func:`topk_mask`, :func:`sparse_payload_bits`).  The trainer's uplink
(``launch/steps.py``) quantizes its gradient tree in place with
:func:`quantize_dequantize_tree_`, optionally under
:func:`error_feedback_optimizer`.

Trees are nested dicts of tensors, flattened in JAX's sorted-key order
(:mod:`repro_torch.core.tree`), so an :class:`EncodedTree` lines up with
the reference's code for code.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import quantization as q
from repro_torch.core import tree as tree_lib
from repro_torch.kernels import dorefa
from repro_torch.kernels import ops as kops


def payload_bits(tree, *, full_bits: int = 32) -> int:
    """Uncompressed payload size I in bits (32 bits per parameter), a
    Python int: a 10^8-parameter tree at 32 bits exceeds int32."""
    return sum(int(leaf.numel()) * full_bits
               for leaf in tree_lib.tree_flatten(tree)[0])


# ---------------------------------------------------------------------------
# Top-k sparsification before DoReFa.  Per kept coordinate the on-air code
# is a sign-magnitude DoReFa code (b + 1 bits) and a coordinate index
# (ceil(log2 P) bits), plus one fp32 scale per client:
#
#     S_k = k_k * (b_k + 1 + idx_bits) + 32
#
# k_k is the largest count affordable at the 1-bit floor, capped by the
# FLConfig.topk fraction; the leftover per-coordinate budget becomes b_k.
# ---------------------------------------------------------------------------


def topk_index_bits(num_params: int) -> int:
    """Bits to address one coordinate of a P-param payload: ceil(log2 P)."""
    if num_params < 1:
        raise ValueError(f"num_params must be >= 1, got {num_params}")
    return max(1, int(np.ceil(np.log2(num_params))))


def topk_plan(num_params: int, budget_bits, *, topk: float = 1.0):
    """Per-client (kept, bits) int32 (K,) tensors from the (K,) budgets:
    kept in [1, ceil(topk * P)], bits in [1, 32].

    Computed in float32 as the reference's jitted round computes it: there
    ``spend / float(2 + idx)`` divides by a constant, which XLA turns into
    a product with the float32 reciprocal, written so here on every
    device; ``spend / kept`` stays a true division."""
    idx = topk_index_bits(num_params)
    k_cap = max(1, int(np.ceil(topk * num_params)))
    c = torch.as_tensor(budget_bits).to(torch.float32)
    spend = torch.clamp_min(c - 32.0, 0.0)      # the fp32 scale off the top
    per_coord = float(np.float32(1.0) / np.float32(2 + idx))
    kept = torch.clamp(
        torch.floor(spend * per_coord), 1.0, float(k_cap)
    ).to(torch.int32)
    bits = torch.clamp(
        torch.floor(spend / kept.to(torch.float32)) - float(1 + idx),
        1.0, 32.0,
    ).to(torch.int32)
    return kept, bits


def topk_mask(flat: torch.Tensor, kept) -> torch.Tensor:
    """(K, N) magnitude top-k mask with a per-row count (exact): row i keeps
    the ``kept[i]`` largest |x|, ties broken by position (a stable sort),
    in flat's dtype.  kept = 0 gives an all-zero row, kept = N all ones."""
    order = torch.argsort(-torch.abs(flat), dim=1, stable=True)
    pos = torch.arange(flat.shape[1], device=flat.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(1, order, pos)
    kept_col = torch.as_tensor(kept).to(device=flat.device,
                                        dtype=torch.int64).reshape(-1, 1)
    return (ranks < kept_col).to(flat.dtype)


def sparse_payload_bits(kept, bits, num_params: int):
    """Honest on-air size S_k of a top-k + DoReFa payload (float64)."""
    idx = topk_index_bits(num_params)
    kept = np.asarray(kept, np.float64)
    bits = np.asarray(bits, np.float64)
    return kept * (bits + 1.0 + idx) + 32.0


def sparse_compression_ratio(payload_bits_, kept, bits, num_params: int):
    """r = max(I / S_k, 1) for the sparse payload (float64, host-side)."""
    on_air = sparse_payload_bits(kept, bits, num_params)
    return np.maximum(float(payload_bits_) / np.maximum(on_air, 1e-9), 1.0)


# ---------------------------------------------------------------------------
# The packed codec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncodedTree:
    """Packed quantized gradient tree (what crosses the uplink)."""

    codes: list             # int32 (R, 128) tensors, one per leaf
    scales: list            # float32 0-dim tensors, one per leaf
    bits: int
    treedef: Any            # tree_lib tree definition
    shapes: list            # leaf shapes (tuples)
    total_bits: int         # honest on-air size, incl. per-tensor scales


def encode_tree(tree, bits: int, *, use_pallas: bool = False) -> EncodedTree:
    """Quantize and pack every leaf at a static ``bits``."""
    leaves, treedef = tree_lib.tree_flatten(tree)
    codes, scales, shapes = [], [], []
    total = 0
    for leaf in leaves:
        c, s = kops.quantize_pack(leaf.reshape(-1), bits,
                                  use_pallas=use_pallas)
        codes.append(c)
        scales.append(s)
        shapes.append(tuple(leaf.shape))
        # b+1 bits per element (sign-magnitude code) + one fp32 scale
        total += int(leaf.numel()) * (int(bits) + 1) + 32
    return EncodedTree(codes, scales, int(bits), treedef, shapes, total)


def decode_tree(enc: EncodedTree, *, use_pallas: bool = False):
    """The float32 tree an :class:`EncodedTree` carries."""
    leaves = []
    for c, s, shape in zip(enc.codes, enc.scales, enc.shapes):
        size = int(np.prod(shape)) if shape else 1
        x = kops.unpack_dequantize(c, s, enc.bits, size,
                                   use_pallas=use_pallas)
        leaves.append(x.reshape(shape))
    return tree_lib.tree_unflatten(enc.treedef, leaves)


def encode_decode_tree(tree, bits, *, paper_exact: bool = False):
    """Fused quantize->dequantize of a tree: ``bits`` a Python int, a 0-dim
    tensor, or a (K,) tensor when every leaf carries a leading client axis
    (:func:`repro_torch.core.quantization.quantize_tree`)."""
    return q.quantize_tree(tree, bits, paper_exact=paper_exact)


def quantize_dequantize_leaf(g, bits: int, *, paper_exact: bool = False):
    """Fused quantize->dequantize of one leaf at a static ``bits``, in the
    jitted form: ``c * (s * fl(1/a))`` with ``s`` the leaf's max-abs scale
    (``1.0`` under ``paper_exact``), as XLA compiles the reference's
    :func:`encode_decode_tree` inside a jitted step with a Python-int width.
    Through :func:`repro_torch.kernels.dorefa.quantize_dequantize`: kernel
    #5 on a CUDA tensor (one launch), its plain version on a CPU one."""
    return dorefa.quantize_dequantize(g, _tree_scale(g, paper_exact),
                                      bits).reshape(g.shape)


def quantize_dequantize_tree_(tree, bits: int, *, paper_exact: bool = False):
    """:func:`quantize_dequantize_leaf` of every leaf, in place: each leaf
    of ``tree`` is replaced in its dict by its quantized value as soon as
    that exists, so one leaf's gradients at most are held twice.  Returns
    ``tree``."""
    return tree_lib.tree_map_(lambda g: quantize_dequantize_leaf(
        g, bits, paper_exact=paper_exact), tree)


def _tree_scale(g, paper_exact: bool) -> torch.Tensor:
    if paper_exact:
        return torch.ones((), dtype=torch.float32, device=g.device)
    return kops.max_abs_scale(g)


def quantize_dequantize_residual_leaf(g, bits: int, *,
                                      paper_exact: bool = False):
    """(:func:`quantize_dequantize_leaf`, the error-feedback residual ``adj
    - q`` as XLA's CPU compiles it after the quantizer: one fused
    multiply-add, ``fma(c, -(s * fl(1/a)), adj)``, ``c`` the rounded
    levels) of one float32 leaf, through
    :func:`repro_torch.kernels.dorefa.quantize_dequantize_residual`: kernel
    #5's residual mode on a CUDA tensor (one launch writes both), its plain
    version on a CPU one."""
    q, r = dorefa.quantize_dequantize_residual(
        g, _tree_scale(g, paper_exact), bits)
    return q.reshape(g.shape), r.reshape(g.shape)


def quantize_dequantize_residual_tree_(tree, residual, bits: int, *,
                                       paper_exact: bool = False):
    """:func:`quantize_dequantize_residual_leaf` of every leaf, in place:
    leaf by leaf, ``tree``'s leaf is replaced by its quantized value and
    ``residual``'s (a tree of the same structure) by the residual.
    Returns ``tree``."""
    for (box, key), (rbox, rkey) in zip(tree_lib.tree_slots(tree),
                                        tree_lib.tree_slots(residual)):
        box[key], rbox[rkey] = quantize_dequantize_residual_leaf(
            box[key], bits, paper_exact=paper_exact)
    return tree


def adaptive_bits_for_budget(tree, budget_bits) -> torch.Tensor:
    """Paper §II-B: b = floor(32 / r), r = max(I / c, 1)."""
    return q.adaptive_bits(payload_bits(tree), budget_bits)


def error_feedback_optimizer(optimizer, bits: int, *,
                             paper_exact: bool = False):
    """Error-feedback (EF) wrapper around any optimizer (beyond the paper):
    the previous round's rounding residual is added back before
    quantizing, ``adj_t = g_t + r_{t-1}; q_t = Q_b(adj_t); r_t = adj_t -
    q_t``, with the residual kept in float32 (the reference's
    ``compression.error_feedback_optimizer``).  The reference runs it
    inside its jitted train step, so ``Q_b`` is
    :func:`quantize_dequantize_leaf`, the jitted form, and ``adj - q`` is
    the fused multiply-add XLA contracts it to, both from one pass
    (:func:`quantize_dequantize_residual_tree_`).  Its ``update_`` replaces
    the gradients' and the residual's leaves one at a time and the inner
    optimizer updates in place."""
    from repro_torch.optim.optimizers import Optimizer

    def init(params):
        return {
            "inner": optimizer.init(params),
            "residual": tree_lib.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params),
        }

    def update_(grads, state, params):
        # grads' leaves become adj, then q, the residual's its new value,
        # each as soon as it exists
        tree_lib.tree_map_(lambda g, r: g.to(torch.float32) + r, grads,
                           state["residual"])
        quantize_dequantize_residual_tree_(grads, state["residual"], bits,
                                           paper_exact=paper_exact)
        params, state["inner"] = optimizer.update_(grads, state["inner"],
                                                   params)
        return params, state

    return Optimizer(init, update_)
