"""Device-resident SIC rates and the lazy GWMIN greedy (paper §III-A,
Algorithm 2).

The port of ``repro.core.rates_jax``: the numpy engine of
:mod:`repro_torch.core.rates` as tensor code on the run's device, in three
layers.

  * :func:`sic_rates` / :func:`batched_weighted_rates` — the sort-based
    mirror of the numpy engine (descending receive power, ties to the lower
    input index via a *stable* argsort, shifted suffix-sum interference),
    broadcasting over any leading axes.  :func:`weighted_rates_cmp` is the
    sort-free O(K^2) comparison-matrix form of the same decode order; it is
    the ``scorer="xla"`` vertex scorer (plain tensor code, float64 in the
    greedy, as the reference's XLA scorer is).

  * :func:`greedy_step` — one greedy step of the lazy GWMIN scheduler
    (``backend="jax-stepwise"``).  The C(pool, K) subset enumeration is
    built once on the host as position tuples into a per-round candidate
    pool; each step re-masks availability, re-ranks the pools by the
    precomputed solo-rate proxy, scores every (round, subset) vertex and
    returns the argmax vertex with the updated masks.  The driver reads
    the result back every step.

  * :func:`greedy_rounds_fused` — the whole selection loop
    (``backend="jax"``), a Python loop of exactly min(T, M // K) steps that
    issues device work and reads nothing back.  The state is

        avail_m   (M,)    bool, device not yet scheduled
        done_t    (T,)    bool, round already assigned
        assign_tk (T, K)  int32 device ids, -1 where unassigned

    A step that finds no feasible vertex leaves the state unchanged (the
    reference's ``lax.while_loop`` exits there), so every later step is a
    no-op too; the caller copies the final state to the host once per
    schedule.

Scorers (``scorer=``): ``"xla"`` scores with :func:`weighted_rates_cmp` in
the gains' dtype (float64: the bit-identical-to-numpy path); ``"pallas"``
flattens the (T, V, K) vertices to one (T*V, K) batch for the hand-written
SIC kernel (:mod:`repro_torch.kernels.sic_rates`, CUDA C++ on the card, its
plain version on the CPU), which accumulates in float32, so its argmax can
tie-flip against the float64 scorer on degenerate instances.  The names
are the reference's, kept because users' configurations carry them.

``shards`` splits the V axis (the reference's ``shard_map`` over its
vertex mesh): an int is clamped to
:func:`repro_torch.sharding.vertex.max_vertex_shards` (the card count), a
sequence of devices is taken as given, and the enumeration is padded with
sentinel rows to a multiple of the shard count.  Each shard scores its
contiguous slice on its own device; per step the shards' argmaxes meet on
the run's device (:func:`_combine`) and only the winner goes back to every
shard, which updates its own copy of the state (:func:`_split_loop`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import sic_rates as sic_kernel
from repro_torch.sharding import vertex as vertex_lib

SCORERS = ("xla", "pallas")


def sic_rates(powers, gains, noise_power: float) -> torch.Tensor:
    """Per-device SIC spectral efficiencies, input order.

    powers, gains: (..., K) tensors.  Decode order = descending receive
    power, ties by lower input index (stable argsort) — identical to
    ``repro_torch.core.rates.sic_rates``.
    """
    p = torch.as_tensor(powers)
    g = torch.as_tensor(gains)
    rx = p * g * g
    order = torch.argsort(-rx, dim=-1, stable=True)
    rx_s = torch.take_along_dim(rx, order, dim=-1)
    # Shifted suffix sum (not suffix - rx): tail_i is exactly the cumsum
    # partial at position i + 1, as in the numpy engine.
    suffix = torch.flip(torch.cumsum(torch.flip(rx_s, (-1,)), dim=-1), (-1,))
    tail = torch.cat([suffix[..., 1:], torch.zeros_like(suffix[..., :1])], dim=-1)
    rates_sorted = torch.log2(1.0 + rx_s / (tail + noise_power))
    return torch.zeros_like(rates_sorted).scatter(-1, order, rates_sorted)


def batched_weighted_rates(powers, gains, weights, noise_power: float) -> torch.Tensor:
    """Weighted SIC sum rates over any leading axes: (..., K) -> (...)."""
    w = torch.as_tensor(weights)
    return torch.sum(w * sic_rates(powers, gains, noise_power), dim=-1)


def weighted_rates_cmp(powers, gains, weights, noise_power: float) -> torch.Tensor:
    """Sort-free weighted SIC sum rates: (..., K) -> (...), K unrolled, in
    the inputs' dtype: the SIC kernel's comparison-matrix loop
    (:func:`repro_torch.kernels.sic_rates.cmp_weighted_sum`).

    Interference is summed in input order rather than decode order, so
    scores differ from :func:`sic_rates` by an ulp at most; the greedy
    argmax does not.
    """
    p = torch.as_tensor(powers)
    g = torch.as_tensor(gains)
    w = torch.as_tensor(weights)
    return sic_kernel.cmp_weighted_sum(p * g * g, w, noise_power)


# --------------------------------------------------------------------------
# GWMIN greedy on the device: shared vertex selection + step-wise / fused
# --------------------------------------------------------------------------

def _score_vertices(g_tvk, w_tvk, pmax: float, noise_power: float, scorer: str):
    """(T, V, K) gains/weights -> (T, V) max-power weighted sum rates."""
    if scorer == "xla":
        p_tvk = torch.full_like(g_tvk, pmax)
        return weighted_rates_cmp(p_tvk, g_tvk, w_tvk, noise_power)
    if scorer == "pallas":
        t_cnt, v_cnt, k = g_tvk.shape
        g_vk = g_tvk.reshape(t_cnt * v_cnt, k)
        w_vk = w_tvk.reshape(t_cnt * v_cnt, k)
        p_vk = torch.full_like(g_vk, pmax)
        out = sic_kernel.sic_weighted_rates(p_vk, g_vk, w_vk, noise_power)
        return out.reshape(t_cnt, v_cnt).to(g_tvk.dtype)
    raise ValueError(f"unknown scorer {scorer!r}; known: {SCORERS}")


def _argmax_vertex(
    gains_tm, weights_m, solo_tm, subs_pos_vk, avail_m, done_t,
    *, pool: int, pmax: float, noise_power: float, scorer: str = "xla",
):
    """Argmax-weight (subset, round) vertex of ``subs_pos_vk`` under the
    current masks.

    Per remaining round, the ``pool`` strongest available devices (by the
    solo-rate proxy, ties to the lower device id) form the candidate pool,
    sorted ascending by device id so the lexicographic position tuples of
    ``subs_pos_vk`` map to the subsets the numpy path enumerates.
    Unavailable pool slots hold the sentinel id M past ``n_valid``; a
    subset touching one (its last position, subsets being sorted) is masked
    to -inf, as are completed rounds.  Positions at or past ``pool``
    (padding rows, or an enumeration over a larger pool) are read clamped
    and masked the same way.  The flat argmax is t-major, subset-lex-minor,
    first maximum: the numpy path's tie-break (earliest round, first
    subset).

    Returns 0-d ``val`` and ``idx`` (the flat index, t * V + v, into this
    enumeration) and the (K,) ``sub_ids``, all on the device, with no host
    sync; ``val == -inf`` means no feasible vertex.
    """
    t_cnt, m = gains_tm.shape
    v_cnt = subs_pos_vk.shape[0]
    subs = subs_pos_vk.long()
    solo_masked = torch.where(avail_m[None, :], solo_tm, -torch.inf)
    order = torch.argsort(-solo_masked, dim=1, stable=True)[:, :pool]
    n_valid = torch.clamp(avail_m.sum(), max=pool)
    valid_slot = torch.arange(pool, device=gains_tm.device)[None, :] < n_valid
    kept = torch.where(valid_slot, order, m)       # sentinel id M past n_valid
    kept_sorted = torch.sort(kept, dim=1).values    # ascending, sentinels last
    safe_ids = torch.clamp(kept_sorted, max=m - 1)
    safe_pos = torch.clamp(subs, max=pool - 1)
    g_pool = torch.gather(gains_tm, 1, safe_ids)               # (T, pool)
    w_pool = weights_m[safe_ids]                                # (T, pool)
    g_tvk = g_pool[:, safe_pos]                                 # (T, V, K)
    w_tvk = w_pool[:, safe_pos]
    scores = _score_vertices(g_tvk, w_tvk, pmax, noise_power, scorer)
    valid_v = subs[:, -1] < n_valid                 # positions ascending per row
    ok = valid_v[None, :] & torch.logical_not(done_t)[:, None]
    flat = torch.where(ok, scores, -torch.inf).reshape(-1)
    idx = torch.argmax(flat)                        # first max: t-major order
    val = torch.take(flat, idx)
    t_star = torch.div(idx, v_cnt, rounding_mode="floor")
    pos = safe_pos.index_select(0, (idx % v_cnt).view(1))          # (1, K)
    sub_ids = torch.gather(kept_sorted.index_select(0, t_star.view(1)), 1, pos)
    return val, idx, sub_ids.view(-1)


def _select_vertex(gains_tm, weights_m, solo_tm, subs_pos_vk, avail_m,
                   done_t, **kw):
    """:func:`_argmax_vertex` over the whole enumeration: returns 0-d
    ``val`` and ``t_star`` and the (K,) ``sub_ids``."""
    val, idx, sub_ids = _argmax_vertex(gains_tm, weights_m, solo_tm,
                                       subs_pos_vk, avail_m, done_t, **kw)
    t_star = torch.div(idx, subs_pos_vk.shape[0], rounding_mode="floor")
    return val, t_star, sub_ids


def _mark_vertex(feasible, t_star, sub_ids, avail_m, done_t, assign_tk):
    """Take the selected vertex off the masks and place it in the
    assignment when it is ``feasible``; an infeasible step leaves all three
    unchanged.  Sentinel ids (only present when infeasible) are clamped, so
    the scatter never leaves the (M,) mask."""
    m = avail_m.shape[0]
    taken = avail_m.index_fill(0, torch.clamp(sub_ids, max=m - 1), False)
    avail_m = torch.where(feasible, taken, avail_m)
    done_t = torch.where(feasible, done_t.index_fill(0, t_star.view(1), True),
                         done_t)
    if assign_tk is not None:
        placed = assign_tk.index_copy(
            0, t_star.view(1), sub_ids.view(1, -1).to(assign_tk.dtype))
        assign_tk = torch.where(feasible, placed, assign_tk)
    return avail_m, done_t, assign_tk


def greedy_step(
    gains_tm: torch.Tensor,     # (T, M) channel gains, whole horizon
    weights_m: torch.Tensor,    # (M,) device weights
    solo_tm: torch.Tensor,      # (T, M) solo-rate pool-ranking proxy
    subs_pos_vk: torch.Tensor,  # (V, K) subsets as pool *positions*, lex order
    avail_m: torch.Tensor,      # (M,) bool: device not yet scheduled
    done_t: torch.Tensor,       # (T,) bool: round already assigned
    *,
    pool: int,
    pmax: float,
    noise_power: float,
):
    """One GWMIN greedy step, scored by the float64 ``"xla"`` scorer.

    ``pool`` is clamped to M as the host driver clamps ``candidate_pool``;
    subsets whose positions reach past the clamped pool are masked
    infeasible.  Returns (best_val, t_star, subset_device_ids, avail_new,
    done_new); a best_val of -inf means no feasible vertex.
    """
    pool = min(pool, gains_tm.shape[1])
    val, t_star, sub_ids = _select_vertex(
        gains_tm, weights_m, solo_tm, subs_pos_vk, avail_m, done_t,
        pool=pool, pmax=pmax, noise_power=noise_power,
    )
    avail_new, done_new, _ = _mark_vertex(val > -torch.inf, t_star, sub_ids,
                                          avail_m, done_t, None)
    return val, t_star, sub_ids, avail_new, done_new


def _initial_state(t_cnt, m, kk, device):
    """(avail, done, assign) before the first step."""
    return (torch.ones(m, dtype=torch.bool, device=device),
            torch.zeros(t_cnt, dtype=torch.bool, device=device),
            torch.full((t_cnt, kk), -1, dtype=torch.int32, device=device))


def _fused_loop(gains_tm, weights_m, solo_tm, subs_pos_vk,
                *, pool: int, pmax: float, noise_power: float, scorer: str):
    """The whole greedy selection loop, device work only (see the module
    docstring for the state)."""
    t_cnt, m = gains_tm.shape
    kk = subs_pos_vk.shape[1]
    avail, done, assign = _initial_state(t_cnt, m, kk, gains_tm.device)
    for _ in range(min(t_cnt, m // kk)):   # the step-wise driver's bound
        val, t_star, sub_ids = _select_vertex(
            gains_tm, weights_m, solo_tm, subs_pos_vk, avail, done,
            pool=pool, pmax=pmax, noise_power=noise_power, scorer=scorer,
        )
        avail, done, assign = _mark_vertex(val > -torch.inf, t_star, sub_ids,
                                           avail, done, assign)
    return assign, done, avail


def _combine(parts, v_local: int, t_cnt: int, home):
    """The reference's in-mesh combine of the shards' argmaxes, on
    ``home``.

    ``parts[j]`` is shard j's local ``(val, idx, sub_ids)`` over its V_local
    rows.  The local flat index becomes the t-major global one, ``t_local *
    V_total + j * V_local + v_local``; the winner has the largest score and,
    among the shards that hold it, the smallest global index (the numpy
    path's earliest round, first subset).  ``(t, j, v_local)`` -> index is
    injective, so exactly one shard owns the winner and a masked sum
    gathers its ids.  Returns one int64 tensor ``[feasible, t_star,
    *sub_ids]``, the only thing that goes back to the shards.  The scores
    stay float64: the max is exact.
    """
    n = len(parts)
    v_total = v_local * n
    vals = torch.stack([p[0].to(home, non_blocking=True) for p in parts])
    idx = torch.stack([p[1].to(home, non_blocking=True) for p in parts])
    subs = torch.stack([p[2].to(home, non_blocking=True) for p in parts])
    shard = torch.arange(n, device=home)
    gidx = (torch.div(idx, v_local, rounding_mode="floor") * v_total
            + shard * v_local + idx % v_local)
    vmax = vals.max()
    cand = torch.where(vals == vmax, gidx, t_cnt * v_total)
    gbest = cand.min()
    mine = (cand == gbest)[:, None]
    sub_ids = torch.where(mine, subs, 0).sum(dim=0)
    t_star = torch.div(gbest, v_total, rounding_mode="floor")
    return torch.cat([(vmax > -torch.inf).long().view(1), t_star.view(1),
                      sub_ids.long()])


def _split_loop(gains_tm, weights_m, solo_tm, subs_pos_vk, devices,
                *, pool: int, pmax: float, noise_power: float, scorer: str):
    """:func:`_fused_loop` with the enumeration cut into ``len(devices)``
    contiguous slices of V / n rows, shard j's slice scored on
    ``devices[j]`` (the reference's ``shard_map`` over its vertex mesh).

    Every shard holds the gains, weights and solo table and its own copy of
    the state.  Per step each shard scores its slice; :func:`_combine`
    meets the argmaxes on the run's device, and the winner goes back to
    every shard, which updates its state.  Device-to-device copies only:
    nothing is read on the host.  Returns the first shard's state on the
    run's device (every shard's is the same).
    """
    home = gains_tm.device
    t_cnt, m = gains_tm.shape
    v_total, kk = subs_pos_vk.shape
    v_local = v_total // len(devices)
    shards = []
    for j, dev in enumerate(devices):
        shards.append(dict(
            dev=dev,
            inputs=tuple(x.to(dev, non_blocking=True)
                         for x in (gains_tm, weights_m, solo_tm)),
            subs=subs_pos_vk[j * v_local:(j + 1) * v_local].to(
                dev, non_blocking=True),
            state=_initial_state(t_cnt, m, kk, dev),
        ))
    for _ in range(min(t_cnt, m // kk)):   # the step-wise driver's bound
        parts = [_argmax_vertex(*sh["inputs"], sh["subs"], *sh["state"][:2],
                                pool=pool, pmax=pmax, noise_power=noise_power,
                                scorer=scorer) for sh in shards]
        won = _combine(parts, v_local, t_cnt, home)
        for sh in shards:
            msg = won.to(sh["dev"], non_blocking=True)
            sh["state"] = _mark_vertex(msg[0].bool(), msg[1], msg[2:],
                                       *sh["state"])
    avail, done, assign = (x.to(home, non_blocking=True)
                           for x in shards[0]["state"])
    return assign, done, avail


def greedy_rounds_fused(
    gains_tm: torch.Tensor,     # (T, M) channel gains, whole horizon
    weights_m: torch.Tensor,    # (M,) device weights
    solo_tm: torch.Tensor,      # (T, M) solo-rate pool-ranking proxy
    subs_pos_vk: torch.Tensor,  # (V, K) subsets as pool *positions*, lex order
    *,
    pool: int,
    pmax: float,
    noise_power: float,
    scorer: str = "xla",
    shards=None,
):
    """Run the entire GWMIN greedy selection on the inputs' device with no
    host sync; the caller reads the result once per schedule.

    Returns ``(assign_tk, done_t, avail_m)``: the (T, K) int32 assignment
    (-1 where unassigned; rows with ``done_t`` hold exactly K device ids),
    the completed-round mask, and the still-available-device mask the host
    tail path resumes from when T*K > M.  ``pool`` must already be clamped
    to M by the caller (the scheduling driver does).

    ``shards`` splits the V axis: an int is clamped to the card count on
    the inputs' device (1 on the CPU), a sequence of devices is one shard
    per entry (:func:`repro_torch.sharding.vertex.shard_devices`).  The
    enumeration is padded with sentinel rows to a multiple of the shard
    count; more than one shard runs :func:`_split_loop`.  The schedule does
    not depend on the shard count.
    """
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}; known: {SCORERS}")
    devices = [gains_tm.device]
    if shards is not None:
        devices = vertex_lib.shard_devices(shards, gains_tm.device)
        pad = vertex_lib.pad_rows_to_multiple(subs_pos_vk.shape[0],
                                              len(devices))
        if pad:
            # Sentinel rows point at position ``pool``: past every ranked
            # pool, so they are masked infeasible.
            subs_pos_vk = torch.cat([subs_pos_vk, torch.full(
                (pad, subs_pos_vk.shape[1]), pool, dtype=subs_pos_vk.dtype,
                device=subs_pos_vk.device,
            )])
    kw = dict(pool=pool, pmax=pmax, noise_power=noise_power, scorer=scorer)
    if len(devices) > 1:
        return _split_loop(gains_tm, weights_m, solo_tm, subs_pos_vk,
                           devices, **kw)
    return _fused_loop(gains_tm, weights_m, solo_tm, subs_pos_vk, **kw)
