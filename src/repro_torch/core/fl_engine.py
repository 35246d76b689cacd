"""Batched FL round engine on the device (Algorithm 1, steps 3-5).

The port of ``repro.core.fl_engine``'s per-round batched engine
(``FLConfig.fl_engine = "batched"``).  All M shards live on the device in a
:class:`repro_torch.data.ClientBank`, and one round is:

  1. **gather** — the round's K shards are a K-row gather of the bank.
  2. **local SGD** — :func:`sgd_epoch` trains all K clients at once: every
     parameter carries a leading client axis (written out where the
     reference uses ``vmap``), and one backward pass over the sum of the K
     per-client losses gives each client its own gradient.
  3. **adaptive quantization** — per-client bit-widths from the (K,) budget
     vector in float32 (``quantization.adaptive_bits``) and per-client
     DoReFa codes (``quantization.quantize_codes_batched``).
  4. **aggregation** — with ``use_pallas`` (the reference's name for the
     fused kernel path) every parameter leaf goes through the hand-written
     aggregation kernel, all leaves of the round in one grouped launch
     (:func:`repro_torch.kernels.aggregate.weighted_aggregate_group`);
     otherwise through the einsum the reference computes in XLA.  Under
     the over-the-air uplink, steps 3-4 are replaced by the analog
     superposition (:func:`repro_torch.core.ota.superpose_tree`): the
     noisy channel sum of the raw deltas is the aggregate.  With
     ``topk < 1`` steps 3-4 run once over the concatenated (K, P) update
     (:func:`_sparse_quantize_aggregate`): top-k sparsification, then
     DoReFa, then one aggregation.

With ``client_bank="bucketed"`` the bank is a
:class:`repro_torch.data.BucketedClientBank` and step 1 gathers across its
buckets outside the round body; the gathered rows equal the padded bank's,
so the round is bit-identical.

Scheduling, power allocation, budgets, timing and logging stay in the
:mod:`repro_torch.core.fl` runtime on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import ota as ota_lib
from repro_torch.core import quantization as qlib
from repro_torch.core import tree as tree_lib
from repro_torch.data.client_bank import (
    BucketedClientBank, ClientBank, EvalBank, eval_sample_plan,
)
from repro_torch.kernels.aggregate import (
    coefficients, weighted_aggregate, weighted_aggregate_group,
)
from repro_torch.kernels.fma import fma_dot
from repro_torch.models.fl_models import get_fl_model

ENGINES = ("legacy", "batched")
# the reference's round-body engines, both ported: "legacy" is the
# per-device round body in repro_torch.core.fl, "batched" this module

HORIZON_MODES = ("per-round", "scan")
# the reference's horizon modes; this slice ports "per-round"


# --------------------------------------------------------------------------
# Local SGD over the client axis
# --------------------------------------------------------------------------

def sgd_epoch(params, x, y, lr, *, model):
    """One pass of minibatch SGD for K clients at once.

    params: leaves with a leading client axis (K, ...); x: (K, nb, bs, D);
    y: (K, nb, bs) with -1 marking padding.  ``valid = (y >= 0)`` as
    float32 is the loss mask, so an all-padding batch contributes an
    exactly-zero gradient and leaves that client's parameters untouched.
    Each step is ``w - lr * grad``, the reference's update.
    """
    valid = (y >= 0).to(torch.float32)
    p = params
    for b in range(x.shape[1]):
        leaves, treedef = tree_lib.tree_flatten(p)
        leaves = [w.detach().requires_grad_(True) for w in leaves]
        req = tree_lib.tree_unflatten(treedef, leaves)
        with torch.enable_grad():
            loss = model.batch_loss(req, x[:, b], y[:, b], valid[:, b]).sum()
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            p = tree_lib.tree_unflatten(
                treedef, [w - lr * gw for w, gw in zip(leaves, grads)]
            )
    return p


# --------------------------------------------------------------------------
# Aggregation
# --------------------------------------------------------------------------

def _pallas_aggregate_leaves(leaves, bits_k, agg_w, *, compress,
                             paper_exact):
    """Fused dequant + weighted sum of client-stacked leaves (kernel path),
    in two passes: every leaf is quantized, then one grouped kernel call
    reduces them all.

    Quantizes the raw deltas to per-client float32-held codes and lets the
    aggregation kernel apply scale_k * w_k / a_k during the reduction.  A
    client with b >= 32 passes through at full precision: its kernel weight
    is zeroed and its raw delta joins through a separate weighted sum.
    With ``compress=False`` the identity codes (scale = a = 1) reduce to the
    plain weighted sum.  Returns one aggregate per leaf, shaped like
    ``leaf[0]``.
    """
    k = leaves[0].shape[0]
    flats = [leaf.reshape(k, -1).to(torch.float32) for leaf in leaves]
    ones = torch.ones(k, dtype=torch.float32, device=leaves[0].device)
    if compress:
        full = (bits_k >= 32).to(torch.float32)
        w_q, w_full = agg_w * (1.0 - full), agg_w * full
        codes, coeffs = [], []
        for flat in flats:
            c, scales, a = qlib.quantize_codes_batched(
                flat, bits_k, scales=ones if paper_exact else None,
            )
            codes.append(c)
            coeffs.append(coefficients(scales, w_q, a))
        outs = [
            out + torch.einsum("k,kn->n", w_full, flat)
            for out, flat in zip(weighted_aggregate_group(codes, coeffs),
                                 flats)
        ]
    else:
        coeff = coefficients(ones, agg_w, ones)
        outs = weighted_aggregate_group(flats, [coeff] * len(flats))
    return [out.reshape(leaf.shape[1:]) for out, leaf in zip(outs, leaves)]


def _pallas_aggregate_leaf(leaf, bits_k, agg_w, *, compress, paper_exact):
    """:func:`_pallas_aggregate_leaves` of one leaf."""
    return _pallas_aggregate_leaves(
        [leaf], bits_k, agg_w, compress=compress, paper_exact=paper_exact)[0]


def _einsum_aggregate_leaf(leaf, bits_k, agg_w, *, compress, paper_exact):
    """The same aggregate through einsums (``use_pallas=False``): the
    dequant scale s_k / a_k folds into the reduction coefficients, and
    b >= 32 clients join through a second einsum over the raw deltas."""
    k = leaf.shape[0]
    flat = leaf.reshape(k, -1).to(torch.float32)
    if not compress:
        return torch.einsum("k,kn->n", agg_w, flat).reshape(leaf.shape[1:])
    a = qlib.dorefa_levels(bits_k)
    full = (bits_k >= 32).to(torch.float32)
    w_full = agg_w * full
    w_q = agg_w * (1.0 - full) / a
    codes, scales, _ = qlib.quantize_codes_batched(
        flat, bits_k,
        scales=(
            torch.ones(k, dtype=torch.float32, device=leaf.device)
            if paper_exact else None
        ),
    )
    out = torch.einsum("k,kn->n", w_full, flat) + torch.einsum(
        "k,kn->n", w_q * scales, codes
    )
    return out.reshape(leaf.shape[1:])


def _sparse_quantize_aggregate(
    deltas, budgets, agg_w, *, payload, topk, paper_exact, use_pallas,
):
    """Top-k sparsification then DoReFa over the concatenated update.

    Flattens the delta tree (sorted leaf order) to one (K, P) matrix —
    sparsification picks coordinates of the whole payload, not per leaf —
    derives per-client (kept, bits) from the budgets
    (:func:`repro_torch.core.compression.topk_plan`), masks all but each
    row's ``kept`` largest magnitudes, quantizes the survivors, and reduces
    through the aggregation kernel (``use_pallas``, one launch over the
    codes rows and the b >= 32 rows' full-precision values) or two einsums.
    Masking keeps each row's largest magnitude, so the max-abs scale is
    unchanged.  The einsums are :func:`repro_torch.kernels.fma.fma_dot`,
    the fused multiply-adds XLA compiles them to, so the update equals the
    reference's to the bit.  Returns ``(update_tree, kept, bits)``.
    """
    leaves, treedef = tree_lib.tree_flatten(deltas)
    k = leaves[0].shape[0]
    flat = torch.cat(
        [leaf.reshape(k, -1).to(torch.float32) for leaf in leaves], dim=1
    )                                            # (K, P)
    kept, bits = comp.topk_plan(payload // 32, budgets, topk=topk)
    masked = flat * comp.topk_mask(flat, kept)

    ones = torch.ones(k, dtype=torch.float32, device=flat.device)
    codes, scales, a = qlib.quantize_codes_batched(
        masked, bits, scales=ones if paper_exact else None
    )
    full = (bits >= 32).to(torch.float32)
    # XLA folds each ``y + einsum(...)`` into the einsum's fused
    # multiply-add chain as its starting value: the kernel's chain over the
    # codes rows continues over the passthrough rows, so both go through
    # one launch on the stacked (2K, P) matrix (their coefficients
    # 1 * (w * full) / 1 are exactly w * full)
    if use_pallas:
        out = weighted_aggregate(
            torch.cat([codes, masked]), torch.cat([scales, ones]),
            torch.cat([agg_w * (1.0 - full), agg_w * full]),
            levels=torch.cat([a, ones]),
        )
    else:
        out = fma_dot(agg_w * (1.0 - full) / a * scales, codes,
                      acc=fma_dot(agg_w * full, masked))
    parts = torch.split(out, [leaf[0].numel() for leaf in leaves])
    update = tree_lib.tree_unflatten(
        treedef, [p.reshape(leaf.shape[1:]) for p, leaf in zip(parts, leaves)]
    )
    return update, kept, bits


def _train_quantize_aggregate(
    params, x, y, budgets, agg_w,
    *, lr, epochs, payload, compress, paper_exact, use_pallas, model,
    topk, ota=None,
):
    """The round body on gathered client rows: batched local SGD ->
    per-client quantization -> weighted aggregation.

    x: (K, nb, BS, ...); y: (K, nb, BS); budgets: (K,) float32 bit budgets;
    agg_w: (K,) float32 FedAvg weights.  Returns ``(new_params, bits,
    kept)``: bits (K,) int32, kept (K,) int32 coordinates per client under
    ``topk < 1`` (with ``compress``), else ``None``.  ``ota`` (dict or
    None) swaps quantization and aggregation for the over-the-air
    superposition: ``gains`` (K,) float32 channel amplitudes on the device,
    ``key`` (2,) uint32 noise key, ``pmax``, ``noise_std`` and
    ``threshold``; bits are then logged as 32 (nothing is quantized on
    air).
    """
    k = x.shape[0]
    start = tree_lib.tree_map(
        lambda w: w.unsqueeze(0).expand(k, *w.shape), params
    )
    new = start
    for _ in range(epochs):
        new = sgd_epoch(new, x, y, lr, model=model)
    deltas = tree_lib.tree_map(lambda a, b: a - b, new, start)

    if ota is not None:
        with torch.no_grad():
            update = ota_lib.superpose_tree(
                deltas, ota["gains"], agg_w, ota["key"], pmax=ota["pmax"],
                noise_std=ota["noise_std"], threshold=ota["threshold"],
                use_pallas=use_pallas,
            )
            new_params = tree_lib.tree_map(lambda p, u: p + u, params, update)
        return new_params, torch.full((k,), 32, dtype=torch.int32,
                                      device=x.device), None

    if compress and topk < 1.0:
        with torch.no_grad():
            update, kept, bits = _sparse_quantize_aggregate(
                deltas, budgets, agg_w, payload=payload, topk=topk,
                paper_exact=paper_exact, use_pallas=use_pallas,
            )
            new_params = tree_lib.tree_map(lambda p, u: p + u, params, update)
        return new_params, bits, kept

    if compress:
        bits = qlib.adaptive_bits(payload, budgets)
    else:
        bits = torch.full((k,), 32, dtype=torch.int32, device=x.device)
    with torch.no_grad():
        if use_pallas:
            leaves, treedef = tree_lib.tree_flatten(deltas)
            update = tree_lib.tree_unflatten(treedef, _pallas_aggregate_leaves(
                leaves, bits, agg_w, compress=compress, paper_exact=paper_exact,
            ))
        else:
            update = tree_lib.tree_map(
                lambda leaf: _einsum_aggregate_leaf(
                    leaf, bits, agg_w, compress=compress,
                    paper_exact=paper_exact,
                ),
                deltas,
            )
        new_params = tree_lib.tree_map(lambda p, u: p + u, params, update)
    return new_params, bits, None


# --------------------------------------------------------------------------
# Engine front-end (what the fl runtime calls)
# --------------------------------------------------------------------------

def _eval_full(params, xe, ye, *, model):
    with torch.no_grad():
        return model.accuracy(params, xe, ye)


def _eval_sampled(params, xe, ye, idx, *, model):
    """Client-sampled test accuracy: gather the round's eval rows, forward
    once."""
    with torch.no_grad():
        return model.accuracy(params, xe[idx], ye[idx])


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor on ``device``; a CUDA copy goes through pinned
    memory and is queued on the stream, so the host does not wait."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class BatchedRoundEngine:
    """Round-body engine: builds the banks once, then one round at a time."""

    def __init__(self, dataset, shards, cfg, payload_bits: int, *, device,
                 model=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.payload = int(payload_bits)
        self.model = model if model is not None else get_fl_model(cfg.model)
        bank_cls = (
            BucketedClientBank if cfg.client_bank == "bucketed" else ClientBank
        )
        self.bank = bank_cls.build(
            dataset.x_train, dataset.y_train, shards, cfg.batch_size,
            device=self.device,
        )
        self.eval_bank = EvalBank.build(
            dataset.x_test, dataset.y_test, device=self.device
        )
        self._eval_idx = eval_sample_plan(
            self.eval_bank.num_samples, cfg.eval_sample, cfg.num_rounds,
            cfg.seed,
        )

    def evaluate(self, params, t: int) -> float:
        """Test accuracy after round t (sampled per ``FLConfig.eval_sample``)."""
        if self._eval_idx is None:
            acc = _eval_full(
                params, self.eval_bank.xe, self.eval_bank.ye, model=self.model
            )
        else:
            idx = torch.from_numpy(self._eval_idx[t]).to(
                self.device, torch.int64
            )
            acc = _eval_sampled(
                params, self.eval_bank.xe, self.eval_bank.ye, idx,
                model=self.model,
            )
        return float(acc)

    def run_round(self, params, devs, budgets, agg_w, ota=None):
        """Run one round's local training + upload + aggregation.

        devs: scheduled device ids; budgets: per-device uplink bit budgets
        (float64, host); agg_w: FedAvg weights |D_k| / sum |D_k| (float64,
        host).  ``ota`` (dict or None) switches the upload to the
        over-the-air superposition: ``gains`` (K,) channel amplitudes
        (float64, host), ``key`` (2,) uint32 receiver-noise key and
        ``pmax`` for the round; noise std and truncation threshold come
        from the config.  Returns ``(params, bits, ratios)`` with bits (K,)
        int32 and ratios (K,) float64 numpy arrays for the round log.  With
        the top-k stage on, bits are the widths of the kept coordinates and
        ratios the honest sparse on-air ratios I / S_k
        (``compression.sparse_compression_ratio``).
        """
        k = len(devs)
        if k == 0:    # empty T*K > M tail round: nothing to train or send
            return params, np.zeros(0, np.int32), np.zeros(0)
        cfg = self.cfg
        compress = cfg.compression == "adaptive"
        nb = self.bank.n_batches_for(devs)
        # budgets and weights enter the round in float32, as the
        # reference's jitted round step receives them
        budgets32 = torch.as_tensor(np.asarray(budgets, np.float64)).to(
            torch.float32
        )
        agg32 = torch.as_tensor(np.asarray(agg_w, np.float64)).to(
            torch.float32
        )
        ota_dev = None
        if ota is not None:
            gains32 = torch.as_tensor(np.asarray(ota["gains"], np.float64)).to(
                torch.float32
            )
            ota_dev = dict(
                gains=_to_device(gains32, self.device), key=ota["key"],
                pmax=float(ota["pmax"]), noise_std=float(cfg.ota_noise),
                threshold=float(cfg.ota_threshold),
            )
        # the round's K shards, cut to the group's own max batch count:
        # batches past a client's own count are all padding and contribute
        # exactly-zero gradients
        x, y = self.bank.gather(devs, nb)
        params, bits, kept = _train_quantize_aggregate(
            params, x, y, budgets32.to(self.device), agg32.to(self.device),
            lr=float(cfg.learning_rate), epochs=int(cfg.local_epochs),
            payload=self.payload, compress=compress,
            paper_exact=bool(cfg.paper_exact_range),
            use_pallas=bool(cfg.use_pallas), model=self.model,
            topk=float(cfg.topk), ota=ota_dev,
        )
        if kept is not None:
            # honest sparse accounting: on-air size from the realized
            # (kept, bits) pair, not the dense 32-bit payload
            ratios = comp.sparse_compression_ratio(
                self.payload, kept.cpu().numpy(), bits.cpu().numpy(),
                self.payload // 32,
            )
        elif compress:
            # the reference's host call computes in float32 too
            ratios = qlib.compression_ratio(self.payload, budgets32)
            ratios = ratios.numpy().astype(np.float64)
        else:
            ratios = np.ones(k)
        return params, bits.cpu().numpy(), ratios
