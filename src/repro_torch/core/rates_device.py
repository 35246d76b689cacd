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

``shards=N`` is clamped to :func:`repro_torch.sharding.vertex.max_vertex_shards`
and pads the enumeration to a multiple of it; every row is scored on the
run's device (see :mod:`repro_torch.sharding.vertex`).
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


def _select_vertex(
    gains_tm, weights_m, solo_tm, subs_pos_vk, avail_m, done_t,
    *, pool: int, pmax: float, noise_power: float, scorer: str = "xla",
):
    """Argmax-weight (subset, round) vertex under the current masks.

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

    Returns 0-d ``val`` and ``t_star`` and the (K,) ``sub_ids``, all on the
    device, with no host sync; ``val == -inf`` means no feasible vertex.
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
    return val, t_star, sub_ids.view(-1)


def _mark_vertex(val, t_star, sub_ids, avail_m, done_t):
    """Take the selected vertex off the masks when it is feasible; an
    infeasible step leaves both unchanged.  Sentinel ids (only present when
    infeasible) are clamped, so the scatter never leaves the (M,) mask."""
    feasible = val > -torch.inf
    m = avail_m.shape[0]
    taken = avail_m.index_fill(0, torch.clamp(sub_ids, max=m - 1), False)
    avail_m = torch.where(feasible, taken, avail_m)
    done_t = torch.where(feasible, done_t.index_fill(0, t_star.view(1), True),
                         done_t)
    return feasible, avail_m, done_t


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
    _, avail_new, done_new = _mark_vertex(val, t_star, sub_ids, avail_m, done_t)
    return val, t_star, sub_ids, avail_new, done_new


def _fused_loop(gains_tm, weights_m, solo_tm, subs_pos_vk,
                *, pool: int, pmax: float, noise_power: float, scorer: str):
    """The whole greedy selection loop, device work only (see the module
    docstring for the state)."""
    t_cnt, m = gains_tm.shape
    kk = subs_pos_vk.shape[1]
    dev = gains_tm.device
    avail = torch.ones(m, dtype=torch.bool, device=dev)
    done = torch.zeros(t_cnt, dtype=torch.bool, device=dev)
    assign = torch.full((t_cnt, kk), -1, dtype=torch.int32, device=dev)
    for _ in range(min(t_cnt, m // kk)):   # the step-wise driver's bound
        val, t_star, sub_ids = _select_vertex(
            gains_tm, weights_m, solo_tm, subs_pos_vk, avail, done,
            pool=pool, pmax=pmax, noise_power=noise_power, scorer=scorer,
        )
        feasible, avail, done = _mark_vertex(val, t_star, sub_ids, avail, done)
        placed = assign.index_copy(
            0, t_star.view(1), sub_ids.view(1, -1).to(assign.dtype)
        )
        assign = torch.where(feasible, placed, assign)
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
    shards: "int | None" = None,
):
    """Run the entire GWMIN greedy selection on the inputs' device with no
    host sync; the caller reads the result once per schedule.

    Returns ``(assign_tk, done_t, avail_m)``: the (T, K) int32 assignment
    (-1 where unassigned; rows with ``done_t`` hold exactly K device ids),
    the completed-round mask, and the still-available-device mask the host
    tail path resumes from when T*K > M.  ``pool`` must already be clamped
    to M by the caller (the scheduling driver does).
    """
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}; known: {SCORERS}")
    if shards is not None:
        n = max(1, min(int(shards),
                       vertex_lib.max_vertex_shards(gains_tm.device)))
        pad = vertex_lib.pad_rows_to_multiple(subs_pos_vk.shape[0], n)
        if pad:
            # Sentinel rows point at position ``pool``: past every ranked
            # pool, so they are masked infeasible.
            subs_pos_vk = torch.cat([subs_pos_vk, torch.full(
                (pad, subs_pos_vk.shape[1]), pool, dtype=subs_pos_vk.dtype,
                device=subs_pos_vk.device,
            )])
    return _fused_loop(
        gains_tm, weights_m, solo_tm, subs_pos_vk,
        pool=pool, pmax=pmax, noise_power=noise_power, scorer=scorer,
    )
