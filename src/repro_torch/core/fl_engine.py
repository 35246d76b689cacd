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
:mod:`repro_torch.core.fl` runtime on the host, except in the scanned
horizons: :func:`_horizon_core` runs a host-planned schedule from device
tensors, and :func:`_online_horizon_core` runs an online policy's
selection, its closed-form powers, the rates and the bit budgets on the
device, round by round, reading nothing back.  Their entries are the
reference's: :func:`run_horizon` and :func:`run_horizon_online` for one
horizon, :func:`run_horizon_vmapped` and :func:`run_horizon_online_vmapped`
for a seed sweep (S horizons folded into the client rows of one program),
:func:`run_horizon_sharded` and :func:`run_horizon_online_sharded` for a
cell sweep split across devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import noma
from repro_torch.core import ota as ota_lib
from repro_torch.core import power as power_lib
from repro_torch.core import quantization as qlib
from repro_torch.core import rates_device
from repro_torch.core import scheduling as sched_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.prng import sqrt_f32
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
# the reference's horizon modes, both ported: "per-round" is the host round
# loop of repro_torch.core.fl, "scan" the whole horizon of _horizon_core

UNSET = -1.0
# a horizon log's entries before a round writes them (no count, accuracy or
# bit width is negative); not NaN, which nan_guard would flag


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

def _pallas_aggregate_seeds(leaves, bits_k, agg_w, *, seeds, compress,
                            paper_exact):
    """Fused dequant + weighted sum of client-stacked leaves (kernel path)
    for ``seeds`` runs stacked on the client axis, in two passes: every
    leaf is quantized, then one grouped kernel call reduces every (seed,
    leaf) matrix.

    Leaves are (S*K, ...), seed s owning rows s*K to (s+1)*K - 1.  Quantizes
    the raw deltas to per-client float32-held codes and lets the
    aggregation kernel apply scale_k * w_k / a_k during the reduction.  A
    client with b >= 32 passes through at full precision: its kernel weight
    is zeroed and its raw delta joins through a separate weighted sum of
    its seed's rows.  With ``compress=False`` the identity codes (scale = a
    = 1) reduce to the plain weighted sum.  Returns one (S, ...) aggregate
    per leaf; quantization is per row, so seed s's aggregate is the one its
    K rows give alone.
    """
    rows = leaves[0].shape[0]
    k = rows // seeds
    parts = [slice(i * k, (i + 1) * k) for i in range(seeds)]
    flats = [leaf.reshape(rows, -1).to(torch.float32) for leaf in leaves]
    ones = torch.ones(rows, dtype=torch.float32, device=leaves[0].device)
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
    else:
        codes = flats
        coeffs = [coefficients(ones, agg_w, ones)] * len(flats)
    sums = iter(weighted_aggregate_group(
        [c[r] for c in codes for r in parts],
        [c[r] for c in coeffs for r in parts],
    ))
    outs = []
    for flat, leaf in zip(flats, leaves):
        per_seed = [next(sums) for _ in parts]
        if compress:
            per_seed = [out + torch.einsum("k,kn->n", w_full[r], flat[r])
                        for out, r in zip(per_seed, parts)]
        out = per_seed[0].unsqueeze(0) if seeds == 1 else torch.stack(per_seed)
        outs.append(out.reshape(seeds, *leaf.shape[1:]))
    return outs


def _pallas_aggregate_leaves(leaves, bits_k, agg_w, *, compress,
                             paper_exact):
    """:func:`_pallas_aggregate_seeds` of one run: (K, ...) leaves, one
    aggregate per leaf shaped like ``leaf[0]``."""
    return [out[0] for out in _pallas_aggregate_seeds(
        leaves, bits_k, agg_w, seeds=1, compress=compress,
        paper_exact=paper_exact)]


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


def _stack_runs(trees):
    """Parameter trees of S runs -> one tree of (S, ...) leaves (views of
    the one tree's leaves when S = 1)."""
    if len(trees) == 1:
        return tree_lib.tree_map(lambda w: w.unsqueeze(0), trees[0])
    return tree_lib.tree_map(lambda *ws: torch.stack(ws), *trees)


def _round_ratios(payload, compress, kept, bits, budgets32):
    """A round log's per-client compression ratios, for both drivers.

    With the top-k stage on (``kept`` not ``None``) the honest sparse
    on-air ratios I / S_k from the realized (kept, bits) pair
    (``compression.sparse_compression_ratio``); with adaptive DoReFa
    ``compression_ratio`` on the float32 budgets, as the reference's host
    call computes it; else ones.  ``kept`` and ``bits`` are (K,) host
    arrays, ``budgets32`` a (K,) host float32 tensor; returns (K,) float64.
    """
    if kept is not None:
        return comp.sparse_compression_ratio(payload, kept, bits,
                                             payload // 32)
    if compress:
        return qlib.compression_ratio(payload, budgets32).numpy().astype(
            np.float64)
    return np.ones(len(bits))


def _run_of(params_s, i):
    """Run i's parameters out of a tree of (S, ...) leaves (views)."""
    return tree_lib.tree_map(lambda w: w[i], params_s)


def _rows(tree, part):
    """The client rows ``part`` (a slice) of every leaf of a tree."""
    return tree_lib.tree_map(lambda leaf: leaf[part], tree)


def _train_quantize_aggregate(
    params_s, x, y, budgets, agg_w,
    *, lr, epochs, payload, compress, paper_exact, use_pallas, model,
    topk, ota=None, need_norms=False,
):
    """The round body on gathered client rows of S runs at once: batched
    local SGD -> per-client quantization -> weighted aggregation per run.

    params_s: leaves (S, ...), run s's parameters; x: (S*K, nb, BS, ...)
    and y: (S*K, nb, BS), run s owning rows s*K to (s+1)*K - 1; budgets:
    (S*K,) float32 bit budgets; agg_w: (S*K,) float32 FedAvg weights (zero
    on padding rows, which train and then drop out of the sum exactly).
    The per-round engine runs it with S = 1 and the scanned horizon with a
    seed or cell axis: every step is per row or per run, so run s's round
    is the one it would run alone.  Returns ``(new_params_s, bits, kept,
    norms)``: bits (S*K,) int32, kept (S*K,) int32 coordinates per client
    under ``topk < 1`` (with ``compress``), else ``None``, and with
    ``need_norms`` the (S*K,) float32 norms of the raw (pre-quantization)
    deltas, the online policies' signal, else ``None``: each row's squares
    summed per leaf over the sorted leaves in float32, then the square
    root, as the reference's batched reduction takes them.  ``ota`` (dict
    or None) swaps quantization and aggregation for the over-the-air
    superposition: ``gains`` (S*K,) float32 channel amplitudes on the
    device, ``keys`` one (2,) uint32 host noise key per run, ``pmax``,
    ``noise_std`` and ``threshold``; bits are then logged as 32 (nothing
    is quantized on air).
    """
    seeds = tree_lib.tree_flatten(params_s)[0][0].shape[0]
    rows = x.shape[0]
    k = rows // seeds
    parts = [slice(i * k, (i + 1) * k) for i in range(seeds)]
    # each run's parameters repeated over its K client rows (a view when
    # S = 1, as the per-round engine has always trained them)
    start = tree_lib.tree_map(
        lambda w: w.unsqueeze(1).expand(seeds, k, *w.shape[1:])
        .reshape(rows, *w.shape[1:]),
        params_s,
    )
    new = start
    for _ in range(epochs):
        new = sgd_epoch(new, x, y, lr, model=model)
    deltas = tree_lib.tree_map(lambda a, b: a - b, new, start)

    kept = norms = None
    with torch.no_grad():
        if need_norms:
            norms = sqrt_f32(sum(
                torch.sum(torch.square(leaf.reshape(rows, -1).to(
                    torch.float32)), dim=1)
                for leaf in tree_lib.tree_flatten(deltas)[0]
            ))
        if ota is not None:
            updates = [ota_lib.superpose_tree(
                _rows(deltas, r), ota["gains"][r], agg_w[r], key,
                pmax=ota["pmax"], noise_std=ota["noise_std"],
                threshold=ota["threshold"], use_pallas=use_pallas,
            ) for r, key in zip(parts, ota["keys"])]
            bits = torch.full((rows,), 32, dtype=torch.int32, device=x.device)
        elif compress and topk < 1.0:
            outs = [_sparse_quantize_aggregate(
                _rows(deltas, r), budgets[r], agg_w[r], payload=payload,
                topk=topk, paper_exact=paper_exact, use_pallas=use_pallas,
            ) for r in parts]
            updates = [update for update, _, _ in outs]
            kept = torch.cat([kept_r for _, kept_r, _ in outs])
            bits = torch.cat([bits_r for _, _, bits_r in outs])
        if ota is not None or kept is not None:
            update_s = tree_lib.tree_map(lambda *us: torch.stack(us), *updates)
        else:
            if compress:
                bits = qlib.adaptive_bits(payload, budgets)
            else:
                bits = torch.full((rows,), 32, dtype=torch.int32,
                                  device=x.device)
            leaves, treedef = tree_lib.tree_flatten(deltas)
            if use_pallas:
                per_leaf = _pallas_aggregate_seeds(
                    leaves, bits, agg_w, seeds=seeds, compress=compress,
                    paper_exact=paper_exact,
                )
            else:
                per_leaf = [torch.stack([_einsum_aggregate_leaf(
                    leaf[r], bits[r], agg_w[r], compress=compress,
                    paper_exact=paper_exact,
                ) for r in parts]) for leaf in leaves]
            update_s = tree_lib.tree_unflatten(treedef, per_leaf)
        new_params = tree_lib.tree_map(lambda p, u: p + u, params_s, update_s)
    return new_params, bits, kept, norms


# --------------------------------------------------------------------------
# Scanned horizon: every round of a precomputed schedule on device tensors
# --------------------------------------------------------------------------

def _horizon_core(
    params_s, dev_stk, budgets_stk, agg_stk, gains_stk, keys_st, eval_mask_t,
    eval_idx_stn, bank, ebank,
    *, nb, lr, epochs, payload, compress, paper_exact, use_pallas, model,
    topk, ota, ota_noise, ota_threshold, pmax,
):
    """S independent horizons of T rounds, the port of the reference's
    ``lax.scan`` over rounds (``repro/core/fl_engine.py:_horizon_core``)
    and of its ``vmap`` over a seed sweep (``run_horizon_vmapped``): the
    seed axis folds into the client rows, since the kernel launches cannot
    be traced.  The bank, test set and eval cadence are shared, and run s
    is the program :func:`run_horizon` runs for it alone.

    The carry is ``params_s`` (leaves (S, ...), one run per row); the
    per-round inputs are the precomputed plans the fl driver uploaded once:
    ``dev_stk`` (S, T, K) int64 device ids, 0-padded past each round's true
    group size; ``budgets_stk``, ``agg_stk`` and ``gains_stk`` (S, T, K)
    float32 bit budgets, FedAvg weights and channel amplitudes, zero on
    padding (a zero weight multiplies a padded row out of the aggregate
    exactly, so an all-padding round leaves the parameters as they were);
    ``keys_st`` (S, T, 2) uint32 receiver-noise keys, host numpy (the keyed
    OTA kernel takes a key by value; read only under ``ota``);
    ``eval_mask_t`` (T,) host bool; ``eval_idx_stn`` (S, T, n) int64
    eval-row plans, or ``None`` for the full test set; ``bank`` a
    :class:`ClientBank` and ``ebank`` an :class:`EvalBank` on the run's
    device, the bank read ``nb`` batches deep (the horizon-wide count: the
    extra all-padding batches give exactly-zero gradients).

    Round t of all S runs is one :func:`_train_quantize_aggregate` over
    S*K gathered rows, so local SGD takes one forward and backward per
    batch for every run and the dense aggregation one grouped kernel call.
    Nothing reads the card from the host: the gather index, budgets and
    weights are device tensors, and each round writes its bit widths,
    kept-coordinate counts (left ``UNSET`` unless top-k is on) and
    accuracy (``UNSET`` on rounds ``eval_mask_t`` skips; the host
    forward-fills) into one preallocated (S, T, 2K+1) float64 log on the
    device.  Returns ``(final params_s, log)``; :func:`horizon_logs`
    downloads the log.
    """
    seeds, num_rounds, k = dev_stk.shape
    logs = torch.full((seeds, num_rounds, 2 * k + 1), UNSET,
                      dtype=torch.float64, device=dev_stk.device)
    for t in range(num_rounds):
        x, y = bank.take(dev_stk[:, t].reshape(-1), nb)
        ota_round = None
        if ota:
            ota_round = dict(
                gains=gains_stk[:, t].reshape(-1), keys=keys_st[:, t],
                pmax=pmax, noise_std=ota_noise, threshold=ota_threshold,
            )
        params_s, bits, kept, _ = _train_quantize_aggregate(
            params_s, x, y, budgets_stk[:, t].reshape(-1),
            agg_stk[:, t].reshape(-1), lr=lr, epochs=epochs, payload=payload,
            compress=compress, paper_exact=paper_exact, use_pallas=use_pallas,
            model=model, topk=topk, ota=ota_round,
        )
        _log_round(logs[:, t], params_s, bits, kept, eval_mask_t[t],
                   None if eval_idx_stn is None else eval_idx_stn[:, t],
                   ebank, model)
    return params_s, logs


def _log_round(log_s, params_s, bits, kept, do_eval, eval_idx_sn, ebank,
               model):
    """Write one round of S runs into its rows of a horizon log (``log_s``
    (S, 2K+1 or more), a view of the device log): the bit widths, the kept
    counts (top-k only) and, on an evaluated round, each run's accuracy,
    on the full test set (``eval_idx_sn`` None) or its (S, n) sample."""
    seeds = log_s.shape[0]
    k = bits.shape[0] // seeds
    log_s[:, :k] = bits.view(seeds, k)
    if kept is not None:
        log_s[:, k:2 * k] = kept.view(seeds, k)
    if not do_eval:
        return
    for i in range(seeds):
        params = _run_of(params_s, i)
        if eval_idx_sn is None:
            acc = _eval_full(params, ebank.xe, ebank.ye, model=model)
        else:
            acc = _eval_sampled(params, ebank.xe, ebank.ye, eval_idx_sn[i],
                                model=model)
        log_s[i, 2 * k] = acc


def run_horizon(params, dev_tk, budgets_tk, agg_tk, gains_tk, keys_t,
                eval_mask_t, eval_idx_tn, bank, ebank, *, nb, **statics):
    """One precomputed-schedule horizon (:func:`_horizon_core` with S = 1):
    (T, K) plans, (T, 2) keys, (T, n) eval plans or ``None``.  Returns
    ``(final params, log (T, 2K+1))``, both on the device."""
    final_s, logs = _horizon_core(
        _stack_runs([params]), dev_tk[None], budgets_tk[None], agg_tk[None],
        gains_tk[None], keys_t[None], eval_mask_t,
        None if eval_idx_tn is None else eval_idx_tn[None], bank, ebank,
        nb=nb, **statics,
    )
    return _run_of(final_s, 0), logs[0]


def run_horizon_vmapped(params_s, dev_stk, budgets_stk, agg_stk, gains_stk,
                        keys_st, eval_mask_t, eval_idx_stn, bank, ebank, *,
                        nb, **statics):
    """A whole seed sweep of S independent precomputed-schedule horizons,
    one program (:func:`_horizon_core`, the seed axis folded into the
    client rows): leading axis S on ``params_s``, the (S, T, K) plans, the
    (S, T, 2) noise keys and the (S, T, n) eval plans (or ``None``); the
    client bank, test set and eval cadence ``eval_mask_t`` are shared.
    Row s is the program :func:`run_horizon` runs for that seed alone.
    Returns ``(final params_s, log (S, T, 2K+1))`` on the device."""
    return _horizon_core(
        params_s, dev_stk, budgets_stk, agg_stk, gains_stk, keys_st,
        eval_mask_t, eval_idx_stn, bank, ebank, nb=nb, **statics,
    )


def horizon_logs(logs: torch.Tensor):
    """A horizon log (..., T, 2K+1) -> host ``(bits, kept, acc)`` numpy
    arrays ((..., T, K) int32, (..., T, K) int32 or ``None`` where the
    round body kept no counts (top-k off), (..., T) float64): the
    horizon's one read of the card."""
    host = logs.cpu().numpy()
    return _split_log(host, (host.shape[-1] - 1) // 2)


def _split_log(host: np.ndarray, k: int):
    """The (bits, kept, acc) columns of a downloaded horizon log."""
    kept = host[..., k:2 * k]
    kept = None if np.all(kept == UNSET) else kept.astype(np.int32)
    return host[..., :k].astype(np.int32), kept, host[..., 2 * k]


# --------------------------------------------------------------------------
# The cell split: a (C, S) sweep's cells in blocks, one block per card
# --------------------------------------------------------------------------

def _put(a, device):
    """A host array as a tensor on ``device``, queued as the fl driver's
    uploads are (:func:`_to_device`)."""
    return _to_device(torch.from_numpy(np.ascontiguousarray(a)), device)


def _block_world(xb, yb, xe, ye, device):
    """A worker's client bank and test set on its device.  The block's
    horizons only take rows from the bank; its shard sizes (the FedAvg
    weights' source) stay with the caller, whose plans carry the weights."""
    return (ClientBank(_put(xb, device), _put(yb, device), None),
            EvalBank(_put(xe, device), _put(ye, device)))


def _run_instances(block, device, one):
    """Each (c, s) instance of a block through ``one(c, s, params)``, one
    horizon at a time, as the unsplit sweep runs them; returns the stacked
    host results (a result that is ``None`` for one instance is ``None``
    for all)."""
    params_cs = block[0][0]
    cells, seeds = tree_lib.tree_flatten(params_cs)[0][0].shape[:2]
    rows = []
    for c in range(cells):
        for s in range(seeds):
            params = tree_lib.tree_map(lambda w: _put(w[c, s], device),
                                       params_cs)
            final, *logs = one(c, s, params)
            rows.append((tree_lib.tree_map(
                lambda w: w.detach().cpu().numpy(), final), *logs))

    def stack(*parts):
        if parts[0] is None:
            return None
        out = np.stack(parts)
        return out.reshape(cells, seeds, *out.shape[1:])

    return (tree_lib.tree_map(stack, *[r[0] for r in rows]),
            *[stack(*col) for col in list(zip(*rows))[1:]])


def _horizon_block(block, device):
    """A worker's block of precomputed-schedule instances (the target of
    :func:`run_horizon_sharded`): one :func:`run_horizon` per instance at
    its own batch count, the log read once per instance.  Returns host
    ``(final params, bits, kept, accs)`` stacked (Cb, S, ...)."""
    args, nb_cs, statics = block
    (_, dev, bud, agg, gains, keys, emask, eidx, xb, yb, xe, ye) = args
    bank, ebank = _block_world(xb, yb, xe, ye, device)

    def one(c, s, params):
        final, log = run_horizon(
            params, _put(dev[c, s], device), _put(bud[c, s], device),
            _put(agg[c, s], device), _put(gains[c, s], device), keys[c, s],
            emask, None if eidx is None else _put(eidx[c, s], device), bank,
            ebank, nb=int(nb_cs[c, s]), **statics)
        return (final, *horizon_logs(log))

    return _run_instances(block, device, one)


def _run_split(target, args, in_specs, out_specs, nb, statics, shards):
    """A split sweep's common driver: the shards' devices, the contract
    that C is a multiple of their count, the blocks cut by ``in_specs``
    (and the (C, S) batch counts ``nb`` with them), ``target`` run on each
    block (in this process for one shard on the inputs' own device, else
    one worker process per shard, or on ``shards`` if it is a group of
    started :class:`repro_torch.sharding.cells.Workers`), the results
    joined by ``out_specs`` and the final parameters put on the inputs'
    device."""
    from repro_torch.sharding import cells

    params_cs = args[0]
    lead = tree_lib.tree_flatten(params_cs)[0][0]
    home = lead.device
    num_c, num_s = lead.shape[:2]
    devices = cells.shard_devices(shards, home)
    if num_c % len(devices):
        raise ValueError(f"C={num_c} cells must be a multiple of the "
                         f"{len(devices)} shards (pad them: cells.pad_cells)")
    nb_cs = np.broadcast_to(np.asarray(nb, np.int64), (num_c, num_s))
    host = cells.to_host(args)
    blocks = [(blk, nbs, statics) for blk, nbs in zip(
        cells.cut_blocks(host, in_specs, len(devices)),
        np.split(nb_cs, len(devices)))]
    if isinstance(shards, cells.Workers):
        outs = shards.run(target, blocks)
    elif len(devices) == 1 and devices[0] == home:
        outs = [target(blocks[0], home)]
    else:
        outs = cells.run_blocks(target, blocks, devices)
    final, *rest = cells.join_blocks(outs, out_specs)
    return (tree_lib.tree_map(lambda w: _put(w, home), final), *rest)


def run_horizon_sharded(
    params_cs, dev_cstk, budgets_cstk, agg_cstk, gains_cstk, keys_cst,
    eval_mask_t, eval_idx_cstn, xb, yb, xe, ye, *, shards, nb, **statics,
):
    """A (C, S) cells-x-seeds sweep of precomputed-schedule horizons with
    the cell axis split across cards: the port of the reference's
    ``run_horizon_sharded`` (``shard_map`` over ``cell_mesh``).

    The arguments follow :func:`repro_torch.sharding.rules.
    cell_sweep_in_specs`, which decides what is cut into blocks of cells:
    ``params_cs`` a tree of (C, S, ...) leaves; (C, S, T, K) device ids,
    budgets, FedAvg weights and gains; (C, S, T, 2) host noise keys; the
    (T,) host eval mask; (C, S, T, n) eval plans or ``None``; the client
    bank's ``xb`` / ``yb`` and the test set's ``xe`` / ``ye``.  ``shards``
    is a card count (clamped), a sequence of devices or started
    :class:`repro_torch.sharding.cells.Workers`; C must be a multiple of
    its count (:func:`repro_torch.sharding.cells.pad_cells`).  ``nb``
    is one batch count for every instance or a (C, S) array of each one's
    own.  Each shard runs its block one :func:`run_horizon` per instance
    (in a worker process on its card; in this process for one shard on
    the inputs' device), never stacked, so the results do not depend on
    the shard count.  Returns ``(final params (C, S, ...) on the inputs'
    device, bits, kept, accs)``, the logs as host arrays.
    """
    from repro_torch.sharding import rules

    return _run_split(
        _horizon_block,
        (params_cs, dev_cstk, budgets_cstk, agg_cstk, gains_cstk, keys_cst,
         eval_mask_t, eval_idx_cstn, xb, yb, xe, ye),
        rules.cell_sweep_in_specs(), rules.cell_sweep_out_specs(), nb,
        statics, shards)


# --------------------------------------------------------------------------
# Online-policy horizon: selection, powers and budgets inside the rounds
# --------------------------------------------------------------------------

def _scatter_drop(buf, idx, src, *, add=False):
    """``buf`` (S, M) with ``src`` written (or added) at the columns ``idx``
    (S, K), where column M drops the write: the scatter goes into an
    (S, M+1) copy whose last column is cut off, so a padding lane never
    writes device 0 (the reference's out-of-bounds ``mode="drop"``)."""
    ext = torch.cat([buf, buf[:, :1]], dim=1)
    if add:
        ext.scatter_add_(1, idx, src)
    else:
        ext.scatter_(1, idx, src)
    return ext[:, :-1]


def _online_horizon_core(
    params_s, solo_stm, gains_stm, weights_m, sizes_m, keys_st, eval_mask_t,
    eval_idx_stn, bank, ebank,
    *, nb, policy, pcfg, uplink, budget_scale, need_norms, lr, epochs,
    payload, compress, paper_exact, use_pallas, model, topk, ota, ota_noise,
    ota_threshold, pmax,
):
    """S independent online-policy horizons of T rounds, the port of the
    reference's ``_online_horizon_core`` (``lax.scan``) and its seed-sweep
    ``vmap``, with the seed axis folded into the client rows as in
    :func:`_horizon_core`.  Where that one consumes a host-planned
    schedule, each round here runs the policy on the device:

      1. ``policy.select_round_traced`` on round t's rows of the (S, T, M)
         float32 solo table ``solo_stm`` and gains ``gains_stm``, the (M,)
         float32 data weights ``weights_m`` and the carried
         :class:`~repro_torch.core.scheduling.TracedObservation` -> (S, K)
         device ids and validity masks;
      2. the masked lanes' gains and weights ->
         ``power.traced_round_powers`` -> float32 rates
         (``rates_device.sic_rates`` under NOMA and OTA,
         ``noma.tdma_rates`` under TDMA) -> bit budgets ``rates *
         budget_scale`` and FedAvg weights ``raw / max(sum(raw), 1)`` from
         the (M,) float32 shard sizes ``sizes_m``, in float32 as the
         reference computes them (padding lanes get zero power, rate,
         budget and weight);
      3. the rows gathered by ``ClientBank.take`` at ``nb``, the bank-wide
         batch count (the schedule is unknown up front; the extra
         all-padding batches give exactly-zero gradients), and trained,
         quantized and aggregated by :func:`_train_quantize_aggregate`,
         so kernel #1 or the keyed OTA kernel runs every round;
      4. participation, last round and (``need_norms``) the raw deltas'
         norms scattered into the observation, padding lanes dropped.

    ``policy`` is the registered policy object, ``pcfg`` its
    ``PolicyConfig`` and ``budget_scale`` the host-folded bandwidth *
    slot.  The observation's norms start at the policy's
    ``COLD_START_NORM``.  Nothing reads the card from the host: each round
    writes its bit widths, kept counts, accuracy (as :func:`_horizon_core`)
    and its device ids and masks into one preallocated (S, T, 4K+1)
    float64 log.  Returns ``(final params_s, log)``;
    :func:`online_horizon_logs` downloads the log.
    """
    seeds, num_rounds, num_devices = solo_stm.shape
    device = solo_stm.device
    k = min(int(pcfg.group_size), num_devices)
    logs = torch.full((seeds, num_rounds, 4 * k + 1), UNSET,
                      dtype=torch.float64, device=device)
    obs = sched_lib.TracedObservation.initial(
        seeds, num_devices, getattr(policy, "COLD_START_NORM", 1.0),
        device=device,
    )
    for t in range(num_rounds):
        g_row = gains_stm[:, t]
        dev, mask = policy.select_round_traced(
            t, solo_stm[:, t], g_row, weights_m, obs, pcfg
        )
        maskf = mask.to(torch.float32)
        g_k = g_row.gather(1, dev) * maskf
        w_k = weights_m[dev] * maskf
        p_k = power_lib.traced_round_powers(pcfg.power_mode, g_k, w_k,
                                            pcfg.pmax)
        if uplink == "tdma":
            rates_k = noma.tdma_rates(p_k, g_k, pcfg.noise_power)
        else:
            # NOMA and OTA both price the shared slot's SIC rates; padding
            # lanes send at zero power and sort behind every live lane
            rates_k = rates_device.sic_rates(p_k, g_k, pcfg.noise_power)
        bud = rates_k * float(np.float32(budget_scale))
        raw = sizes_m[dev] * maskf
        agg = raw / torch.clamp_min(raw.sum(dim=-1, keepdim=True), 1.0)

        x, y = bank.take(dev.reshape(-1), nb)
        ota_round = None
        if ota:
            ota_round = dict(
                gains=g_k.reshape(-1), keys=keys_st[:, t], pmax=pmax,
                noise_std=ota_noise, threshold=ota_threshold,
            )
        params_s, bits, kept, norms = _train_quantize_aggregate(
            params_s, x, y, bud.reshape(-1), agg.reshape(-1), lr=lr,
            epochs=epochs, payload=payload, compress=compress,
            paper_exact=paper_exact, use_pallas=use_pallas, model=model,
            topk=topk, ota=ota_round, need_norms=need_norms,
        )

        scat = torch.where(mask, dev, num_devices)
        obs = sched_lib.TracedObservation(
            _scatter_drop(obs.update_norms, scat, norms.view(seeds, k))
            if need_norms else obs.update_norms,
            _scatter_drop(obs.participation, scat, torch.ones_like(
                scat, dtype=torch.int32), add=True),
            _scatter_drop(obs.last_round, scat, torch.full_like(
                scat, t, dtype=torch.int32)),
        )
        _log_round(logs[:, t], params_s, bits, kept, eval_mask_t[t],
                   None if eval_idx_stn is None else eval_idx_stn[:, t],
                   ebank, model)
        logs[:, t, 2 * k + 1:3 * k + 1] = dev
        logs[:, t, 3 * k + 1:] = mask.to(torch.float64)
    return params_s, logs


def run_horizon_online(params, solo_tm, gains_tm, weights_m, sizes_m,
                       keys_t, eval_mask_t, eval_idx_tn, bank, ebank, *, nb,
                       **statics):
    """One online-policy horizon (:func:`_online_horizon_core` with
    S = 1): (T, M) solo table and gains, (T, 2) keys, (T, n) eval plan or
    ``None``.  Returns ``(final params, log (T, 4K+1))`` on the device."""
    final_s, logs = _online_horizon_core(
        _stack_runs([params]), solo_tm[None], gains_tm[None], weights_m,
        sizes_m, keys_t[None], eval_mask_t,
        None if eval_idx_tn is None else eval_idx_tn[None], bank, ebank,
        nb=nb, **statics,
    )
    return _run_of(final_s, 0), logs[0]


def run_horizon_online_vmapped(params_s, solo_stm, gains_stm, weights_m,
                               sizes_m, keys_st, eval_mask_t, eval_idx_stn,
                               bank, ebank, *, nb, **statics):
    """An online-policy seed sweep of S independent horizons, one program
    (:func:`_online_horizon_core`): leading axis S on ``params_s``, the
    (S, T, M) solo tables and gains, the (S, T, 2) noise keys and the
    (S, T, n) eval plans (or ``None``); the (M,) data weights and shard
    sizes, eval cadence, client bank and test set are shared.  Row s is
    the program :func:`run_horizon_online` runs for that seed alone.
    Returns ``(final params_s, log (S, T, 4K+1))`` on the device."""
    return _online_horizon_core(
        params_s, solo_stm, gains_stm, weights_m, sizes_m, keys_st,
        eval_mask_t, eval_idx_stn, bank, ebank, nb=nb, **statics,
    )


def online_horizon_logs(logs: torch.Tensor):
    """An online horizon log (..., T, 4K+1) -> host ``(dev, mask, bits,
    kept, acc)`` numpy arrays: the selected (..., T, K) int64 device ids
    and bool masks, then :func:`horizon_logs`' three; the horizon's one
    read of the card."""
    host = logs.cpu().numpy()
    k = (host.shape[-1] - 1) // 4
    dev = host[..., 2 * k + 1:3 * k + 1].astype(np.int64)
    mask = host[..., 3 * k + 1:] > 0.5
    return (dev, mask) + _split_log(host, k)


def _online_block(block, device):
    """A worker's block of online-policy instances (the target of
    :func:`run_horizon_online_sharded`): one :func:`run_horizon_online`
    per instance at the bank-wide batch count, the log read once per
    instance.  Returns host ``(final params, device ids, masks, bits,
    kept, accs)`` stacked (Cb, S, ...)."""
    args, nb_cs, statics = block
    (_, solo, gains, keys, emask, eidx, weights, sizes, xb, yb, xe,
     ye) = args
    bank, ebank = _block_world(xb, yb, xe, ye, device)
    weights, sizes = _put(weights, device), _put(sizes, device)

    def one(c, s, params):
        final, log = run_horizon_online(
            params, _put(solo[c, s], device), _put(gains[c, s], device),
            weights, sizes, keys[c, s], emask,
            None if eidx is None else _put(eidx[c, s], device), bank, ebank,
            nb=int(nb_cs[c, s]), **statics)
        return (final, *online_horizon_logs(log))

    return _run_instances(block, device, one)


def run_horizon_online_sharded(
    params_cs, solo_cstm, gains_cstm, keys_cst, eval_mask_t, eval_idx_cstn,
    weights_m, sizes_m, xb, yb, xe, ye, *, shards, nb, **statics,
):
    """A (C, S) online-policy cells-x-seeds sweep, the cell axis split
    across cards: the port of the reference's
    ``run_horizon_online_sharded``, with :func:`run_horizon_sharded`'s
    contract (C a multiple of ``shards``; one :func:`run_horizon_online`
    per instance).  The arguments follow :func:`repro_torch.sharding.
    rules.cell_sweep_online_in_specs`: (C, S, T, M) float32 solo tables and
    gains, (C, S, T, 2) host noise keys, the (T,) host eval mask, (C, S,
    T, n) eval plans or ``None``, the shared (M,) float32 data weights and
    shard sizes, the bank and the test set.  Returns ``(final params,
    device ids, masks, bits, kept, accs)``, the logs as host arrays.
    """
    from repro_torch.sharding import rules

    return _run_split(
        _online_block,
        (params_cs, solo_cstm, gains_cstm, keys_cst, eval_mask_t,
         eval_idx_cstn, weights_m, sizes_m, xb, yb, xe, ye),
        rules.cell_sweep_online_in_specs(),
        rules.cell_sweep_online_out_specs(), nb, statics, shards)


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

    def run_round(self, params, devs, budgets, agg_w, *,
                  need_norms: bool = False, ota=None):
        """Run one round's local training + upload + aggregation.

        devs: scheduled device ids; budgets: per-device uplink bit budgets
        (float64, host); agg_w: FedAvg weights |D_k| / sum |D_k| (float64,
        host).  ``ota`` (dict or None) switches the upload to the
        over-the-air superposition: ``gains`` (K,) channel amplitudes
        (float64, host), ``key`` (2,) uint32 receiver-noise key and
        ``pmax`` for the round; noise std and truncation threshold come
        from the config.  Returns ``(params, bits, ratios, norms)`` with
        bits (K,) int32 and ratios (K,) float64 numpy arrays for the round
        log, and norms a list of the K raw deltas' float32 norms as Python
        floats (empty unless ``need_norms``: the online policies' signal).
        With the top-k stage on, bits are the widths of the kept
        coordinates and ratios the honest sparse on-air ratios I / S_k
        (``compression.sparse_compression_ratio``).
        """
        k = len(devs)
        if k == 0:    # empty T*K > M tail round: nothing to train or send
            return params, np.zeros(0, np.int32), np.zeros(0), []
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
                gains=_to_device(gains32, self.device), keys=[ota["key"]],
                pmax=float(ota["pmax"]), noise_std=float(cfg.ota_noise),
                threshold=float(cfg.ota_threshold),
            )
        # the round's K shards, cut to the group's own max batch count:
        # batches past a client's own count are all padding and contribute
        # exactly-zero gradients
        x, y = self.bank.gather(devs, nb)
        params_s, bits, kept, norms = _train_quantize_aggregate(
            _stack_runs([params]), x, y, budgets32.to(self.device),
            agg32.to(self.device),
            lr=float(cfg.learning_rate), epochs=int(cfg.local_epochs),
            payload=self.payload, compress=compress,
            paper_exact=bool(cfg.paper_exact_range),
            use_pallas=bool(cfg.use_pallas), model=self.model,
            topk=float(cfg.topk), ota=ota_dev, need_norms=need_norms,
        )
        bits = bits.cpu().numpy()
        ratios = _round_ratios(
            self.payload, compress, None if kept is None else
            kept.cpu().numpy(), bits, budgets32,
        )
        norms = [] if norms is None else norms.cpu().tolist()
        return _run_of(params_s, 0), bits, ratios, norms
