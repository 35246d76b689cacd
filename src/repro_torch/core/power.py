"""Power allocation for one scheduled NOMA group (paper §III-C).

The weighted sum-rate objective for a fixed decode order is

    max_p  prod_k ( mu_k(p) / phi_k(p) )^{w_k}
    s.t.   0 <= p_k <= p_k^max

with mu_k(p) = sum_{j>=k} p_j h_j^2 + sigma^2 and phi_k = sum_{j>k} p_j h_j^2
+ sigma^2, i.e. z_k := mu_k/phi_k = 1 + SINR_k.  This is a multiplicative
linear fractional program (MLFP); the paper solves it with the MAPEL polyblock
outer-approximation algorithm [Qian et al., 2009].

Key structural fact used throughout (and by the tests): for a *fixed decode
order* and target ratios z_k >= 1, the minimal power vector achieving them is
closed form, solving Eq. (13) back-to-front:

    p_K = (z_K - 1) sigma^2 / h_K^2
    p_k = (z_k - 1) (sum_{j>k} p_j h_j^2 + sigma^2) / h_k^2.

A z-target is feasible iff this minimal p lies in the power box. MAPEL then
reduces to a monotone optimization over the normal set of feasible z vectors,
implemented below with polyblock vertices kept in float64 on the host (this is
control-plane math: K <= 4, a few hundred iterations).

This module is the port's float64 numpy copy of ``repro.core.power`` (the
main-path part and the test oracle :func:`grid_oracle`): the arithmetic is
the reference's op for op, so powers are bit-identical to it.
:func:`traced_round_powers` is the float32 tensor allocator of the scanned
online horizon, for the closed-form modes (:data:`TRACED_POWER_MODES`).

Decode order: following the uplink-NOMA convention (and the paper's WLOG
sorting) we fix the decode order by channel gain, strongest first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rates as rates_lib


@dataclasses.dataclass
class PowerSolution:
    powers: np.ndarray          # (K,) allocated powers, input (unsorted) order
    weighted_rate: float        # sum_k w_k log2(1 + SINR_k)
    iterations: int
    gap: float                  # polyblock optimality gap (objective domain)


def _objective(z: np.ndarray, weights: np.ndarray) -> float:
    """prod z_k^{w_k}, evaluated in log-domain for stability."""
    return float(np.exp(np.sum(weights * np.log(np.maximum(z, 1e-300)))))


def min_powers_for_targets(
    z: np.ndarray, gains_sorted: np.ndarray, noise_power: float
) -> np.ndarray:
    """Minimal powers (decode order) achieving ratio targets z (>=1)."""
    k = len(z)
    p = np.zeros(k, dtype=np.float64)
    # g*g, not g**2: scalar float64 ** goes through pow() and can differ from
    # the array fast path by 1 ulp — the plain multiply is deterministic, so
    # mapel_batched reproduces this back-substitution bit-for-bit.
    g2 = np.asarray(gains_sorted) * np.asarray(gains_sorted)
    interference = noise_power
    for i in range(k - 1, -1, -1):
        p[i] = (z[i] - 1.0) * interference / g2[i]
        interference += p[i] * g2[i]
    return p


def feasible(z: np.ndarray, gains_sorted, pmax, noise_power) -> bool:
    if np.any(z < 1.0):
        return False
    p = min_powers_for_targets(z, gains_sorted, noise_power)
    return bool(np.all(p <= pmax * (1.0 + 1e-12)))


def _project(z: np.ndarray, gains_sorted, pmax, noise_power, tol=1e-12):
    """MAPEL projection: largest lam in (0,1] with 1 + lam*(z-1) feasible.

    We project along the ray in (z - 1) (= SINR) space which keeps the
    projection inside the box [1, z] and preserves the polyblock invariants.
    """
    lo, hi = 0.0, 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if feasible(1.0 + mid * (z - 1.0), gains_sorted, pmax, noise_power):
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 1.0 + lo * (z - 1.0)


def _coordinate_polish(p0, gains, weights, pmax, noise_power,
                       *, rounds: int = 4, points: int = 33) -> np.ndarray:
    """Deterministic coordinate ascent on the box (polishes the MAPEL
    incumbent; the polyblock gives the global-optimality certificate, the
    polish closes the outer-approximation tail quickly for K <= 4)."""
    p = np.array(p0, dtype=np.float64)
    grid = np.linspace(0.0, pmax, points)
    for _ in range(rounds):
        improved = False
        for k in range(len(p)):
            best_v, best_pk = weighted_rate(p, gains, weights, noise_power), p[k]
            for cand in grid:
                p[k] = cand
                v = weighted_rate(p, gains, weights, noise_power)
                if v > best_v + 1e-12:
                    best_v, best_pk = v, cand
                    improved = True
            p[k] = best_pk
        if not improved:
            break
    return p


def mapel(
    gains: np.ndarray,
    weights: np.ndarray,
    pmax: float,
    noise_power: float,
    *,
    eps: float = 1e-3,
    max_iter: int = 300,
) -> PowerSolution:
    """MAPEL polyblock algorithm for the weighted sum-rate MLFP.

    gains, weights: (K,) in arbitrary (input) order. Returns powers in the
    same input order. eps is the relative optimality gap on the objective.
    The polyblock loop is capped at ``max_iter`` vertex expansions and the
    incumbent is finished with a coordinate-ascent polish (the raw outer
    approximation converges slowly near the boundary; see tests/test_power).
    """
    gains = np.asarray(gains, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    k = len(gains)
    # decode order: strongest first; stable so gain ties keep input order
    # (mapel_batched uses the same rule — the two must match exactly)
    order = np.argsort(-gains, kind="stable")
    g = gains[order]
    w = weights[order]

    if k == 1:
        p = np.array([pmax])
        z = 1.0 + p[0] * (g[0] * g[0]) / noise_power
        rate = float(w[0] * np.log2(z))
        out = np.zeros(1)
        out[order] = p
        return PowerSolution(out, rate, 0, 0.0)

    # Initial polyblock vertex: interference-free upper bound on each z_k.
    z_top = 1.0 + pmax * g**2 / noise_power
    vertices = [z_top]
    best_z = _project(z_top, g, pmax, noise_power)
    best_val = _objective(best_z, w)
    # Seed the incumbent with the all-max-power corner (often optimal in the
    # noise-limited regime of the paper's cell).
    z_corner = _z_of_powers(np.full(k, pmax), g, noise_power)
    if _objective(z_corner, w) > best_val:
        best_z, best_val = z_corner, _objective(z_corner, w)

    it = 0
    gap = np.inf
    while it < max_iter and vertices:
        it += 1
        vals = np.array([_objective(v, w) for v in vertices])
        i_best = int(np.argmax(vals))
        v = vertices.pop(i_best)
        ub = vals[i_best]
        gap = (ub - best_val) / max(best_val, 1e-12)
        if gap <= eps:
            break
        proj = _project(v, g, pmax, noise_power)
        val = _objective(proj, w)
        if val > best_val:
            best_val, best_z = val, proj
        # Split the vertex: v_j -> proj_j along each coordinate.
        for j in range(k):
            if proj[j] < v[j] - 1e-12:
                nv = v.copy()
                nv[j] = proj[j]
                vertices.append(nv)
        # Prune vertices that cannot beat the incumbent.
        vertices = [u for u in vertices if _objective(u, w) > best_val * (1 + eps / 4)]

    p_sorted = np.minimum(
        min_powers_for_targets(best_z, g, noise_power), pmax
    )
    # polish from two starts (polyblock incumbent + max-power corner): the
    # coordinate ascent is exact along axes but can sit in a basin when the
    # incumbent projection landed far from the optimum face.
    cands = [
        _coordinate_polish(p_sorted, g, w, pmax, noise_power),
        _coordinate_polish(np.full(k, pmax), g, w, pmax, noise_power),
    ]
    p_sorted = max(cands, key=lambda p: weighted_rate(p, g, w, noise_power))
    powers = np.zeros(k)
    powers[order] = p_sorted
    # Recompute the achieved weighted rate from the actual powers.
    rate = weighted_rate(powers, gains, weights, noise_power)
    return PowerSolution(powers, rate, it, float(max(gap, 0.0)))


def _z_of_powers(p, gains_sorted, noise_power):
    k = len(p)
    z = np.empty(k)
    for i in range(k):
        mu = np.sum(p[i:] * gains_sorted[i:] ** 2) + noise_power
        phi = np.sum(p[i + 1 :] * gains_sorted[i + 1 :] ** 2) + noise_power
        z[i] = mu / phi
    return z


# --------------------------------------------------------------------------
# Batched MAPEL: lockstep polyblock over G independent groups
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedPowerSolution:
    """mapel() over G groups at once; row g mirrors PowerSolution for group g."""

    powers: np.ndarray          # (G, K) allocated powers, input order per row
    weighted_rates: np.ndarray  # (G,)
    iterations: np.ndarray      # (G,) polyblock vertex expansions
    gaps: np.ndarray            # (G,) final optimality gaps


def _objective_rows(z_rows: np.ndarray, weights) -> np.ndarray:
    """prod_k z_k^{w_k} per row; weights broadcasts (K,) or (..., K)."""
    return np.exp(
        np.sum(weights * np.log(np.maximum(z_rows, 1e-300)), axis=-1)
    )


def _min_powers_batched(z_gk, gains_gk_sorted, noise_power) -> np.ndarray:
    """Row-wise min_powers_for_targets: same back-substitution, (G,) lanes."""
    k = z_gk.shape[1]
    p = np.zeros_like(z_gk)
    g2 = gains_gk_sorted * gains_gk_sorted     # see min_powers_for_targets
    interference = np.full(z_gk.shape[0], noise_power, dtype=np.float64)
    for i in range(k - 1, -1, -1):
        p[:, i] = (z_gk[:, i] - 1.0) * interference / g2[:, i]
        interference = interference + p[:, i] * g2[:, i]
    return p


def _feasible_batched(z_gk, gains_gk_sorted, pmax, noise_power) -> np.ndarray:
    ok = ~np.any(z_gk < 1.0, axis=1)
    p = _min_powers_batched(z_gk, gains_gk_sorted, noise_power)
    return ok & np.all(p <= pmax * (1.0 + 1e-12), axis=1)


def _project_batched(z_gk, gains_gk_sorted, pmax, noise_power, tol=1e-12):
    """Row-wise _project: one shared bisection, rows freeze at their own tol
    step so each row reproduces the scalar bisection's early break exactly."""
    g = z_gk.shape[0]
    lo, hi = np.zeros(g), np.ones(g)
    active = np.ones(g, dtype=bool)
    for _ in range(80):
        if not active.any():
            break
        mid = 0.5 * (lo + hi)
        feas = _feasible_batched(
            1.0 + mid[:, None] * (z_gk - 1.0), gains_gk_sorted, pmax, noise_power
        )
        lo = np.where(active & feas, mid, lo)
        hi = np.where(active & ~feas, mid, hi)
        active = active & ((hi - lo) >= tol)
    return 1.0 + lo[:, None] * (z_gk - 1.0)


def _z_of_powers_batched(p_gk, gains_gk_sorted, noise_power) -> np.ndarray:
    k = p_gk.shape[1]
    z = np.empty_like(p_gk)
    for i in range(k):
        mu = np.sum(p_gk[:, i:] * gains_gk_sorted[:, i:] ** 2, axis=1) + noise_power
        phi = (
            np.sum(p_gk[:, i + 1:] * gains_gk_sorted[:, i + 1:] ** 2, axis=1)
            + noise_power
        )
        z[:, i] = mu / phi
    return z


def _polish_batched(p0_gk, gains_gk_sorted, weights_gk_sorted, pmax, noise_power,
                    *, rounds: int = 4, points: int = 33) -> np.ndarray:
    """Row-wise _coordinate_polish: the grid sweep over each coordinate is one
    batched rate-engine call per candidate instead of G scalar evaluations;
    rows keep the scalar's strict-improvement/first-wins acceptance and stop
    sweeping once a full round makes no progress (per-row active mask)."""
    p = np.array(p0_gk, dtype=np.float64)
    g_cnt, k_cnt = p.shape
    grid = np.linspace(0.0, pmax, points)
    active = np.ones(g_cnt, dtype=bool)
    for _ in range(rounds):
        improved = np.zeros(g_cnt, dtype=bool)
        for k in range(k_cnt):
            best_v = rates_lib.batched_weighted_rates(
                p, gains_gk_sorted, weights_gk_sorted, noise_power
            )
            best_pk = p[:, k].copy()
            for cand in grid:
                ptmp = p.copy()
                ptmp[:, k] = cand
                v = rates_lib.batched_weighted_rates(
                    ptmp, gains_gk_sorted, weights_gk_sorted, noise_power
                )
                upd = active & (v > best_v + 1e-12)
                best_v = np.where(upd, v, best_v)
                best_pk = np.where(upd, cand, best_pk)
                improved |= upd
            p[:, k] = np.where(active, best_pk, p[:, k])
        active &= improved
        if not active.any():
            break
    return p


def mapel_batched(
    gains_gk: np.ndarray,
    weights_gk: np.ndarray,
    pmax: float,
    noise_power: float,
    *,
    eps: float = 1e-3,
    max_iter: int = 300,
) -> BatchedPowerSolution:
    """MAPEL over G groups in lockstep — group-for-group identical to
    ``[mapel(g_i, w_i, ...) for i]`` (tests assert bit equality).

    The schedulers' finalization path uses this to refine the power
    allocation of all T selected groups in one call: the polyblock vertex
    bookkeeping stays per group (it is data dependent), but the hot inner
    loops — the 80-step projection bisections, the feasibility
    back-substitutions, and the coordinate-ascent polish grid — run
    vectorized across every still-active group.

    gains_gk / weights_gk: (G, K) rows in arbitrary (input) order; returns
    powers in the same per-row input order.
    """
    gains = np.asarray(gains_gk, dtype=np.float64)
    weights = np.asarray(weights_gk, dtype=np.float64)
    g_cnt, k_cnt = gains.shape
    if g_cnt == 0 or k_cnt == 0:
        return BatchedPowerSolution(
            np.zeros((g_cnt, k_cnt)), np.zeros(g_cnt),
            np.zeros(g_cnt, dtype=int), np.zeros(g_cnt),
        )
    order = np.argsort(-gains, axis=1, kind="stable")   # strongest first
    g = np.take_along_axis(gains, order, axis=1)
    w = np.take_along_axis(weights, order, axis=1)

    if k_cnt == 1:
        p_sorted = np.full((g_cnt, 1), pmax)
        z = 1.0 + p_sorted[:, 0] * (g[:, 0] * g[:, 0]) / noise_power
        rate = w[:, 0] * np.log2(z)
        powers = np.zeros((g_cnt, 1))
        np.put_along_axis(powers, order, p_sorted, axis=1)
        return BatchedPowerSolution(
            powers, rate, np.zeros(g_cnt, dtype=int), np.zeros(g_cnt)
        )

    z_top = 1.0 + pmax * g**2 / noise_power
    verts = [[z_top[i]] for i in range(g_cnt)]
    best_z = _project_batched(z_top, g, pmax, noise_power)
    best_val = _objective_rows(best_z, w)
    z_corner = _z_of_powers_batched(np.full((g_cnt, k_cnt), pmax), g, noise_power)
    corner_val = _objective_rows(z_corner, w)
    take = corner_val > best_val
    best_z = np.where(take[:, None], z_corner, best_z)
    best_val = np.where(take, corner_val, best_val)

    it = np.zeros(g_cnt, dtype=int)
    gap = np.full(g_cnt, np.inf)
    done = np.zeros(g_cnt, dtype=bool)
    while True:
        active = [
            i for i in range(g_cnt) if not done[i] and it[i] < max_iter and verts[i]
        ]
        if not active:
            break
        popped = []
        for i in active:
            it[i] += 1
            vals = _objective_rows(np.asarray(verts[i]), w[i])
            j = int(np.argmax(vals))
            v = verts[i].pop(j)
            ub = float(vals[j])
            gap[i] = (ub - best_val[i]) / max(best_val[i], 1e-12)
            if gap[i] <= eps:
                done[i] = True
            else:
                popped.append((i, v))
        if not popped:
            continue
        idxs = np.asarray([i for i, _ in popped])
        zs = np.stack([v for _, v in popped])
        projs = _project_batched(zs, g[idxs], pmax, noise_power)
        vals_p = _objective_rows(projs, w[idxs])
        for (i, v), proj, val in zip(popped, projs, vals_p):
            if val > best_val[i]:
                best_val[i], best_z[i] = val, proj
            for j in range(k_cnt):
                if proj[j] < v[j] - 1e-12:
                    nv = v.copy()
                    nv[j] = proj[j]
                    verts[i].append(nv)
            if verts[i]:
                keep = _objective_rows(np.asarray(verts[i]), w[i]) > best_val[i] * (
                    1 + eps / 4
                )
                verts[i] = [u for u, kp in zip(verts[i], keep) if kp]

    p_sorted = np.minimum(_min_powers_batched(best_z, g, noise_power), pmax)
    cand_a = _polish_batched(p_sorted, g, w, pmax, noise_power)
    cand_b = _polish_batched(np.full((g_cnt, k_cnt), pmax), g, w, pmax, noise_power)
    val_a = rates_lib.batched_weighted_rates(cand_a, g, w, noise_power)
    val_b = rates_lib.batched_weighted_rates(cand_b, g, w, noise_power)
    use_b = val_b > val_a           # scalar max() keeps the first on ties
    p_fin = np.where(use_b[:, None], cand_b, cand_a)
    powers = np.zeros((g_cnt, k_cnt))
    np.put_along_axis(powers, order, p_fin, axis=1)
    rate = rates_lib.batched_weighted_rates(powers, gains, weights, noise_power)
    return BatchedPowerSolution(powers, rate, it, np.maximum(gap, 0.0))


# --------------------------------------------------------------------------
# PowerAllocator: the one object that owns power allocation
# --------------------------------------------------------------------------

POWER_MODES = ("max", "mapel", "ota-align")


def ota_align_powers(gains, weights, pmax: float) -> np.ndarray:
    """OTA alignment powers: truncated channel inversion at schedule time.

    Under the over-the-air uplink (core/ota.py) device k transmits
    ``sqrt(eta) * w_k / h_k`` per coordinate, so its *planned* power (unit-
    norm update convention: the scheduler never sees realized energies) is

        p_k = eta * w_k^2 / h_k^2,     eta = min_k pmax * h_k^2 / w_k^2

    — the binding device transmits at exactly pmax.  Zero-gain or
    zero-weight devices are left out of the eta min and get zero power.
    Input (unsorted) order in, same order out.
    """
    g = np.asarray(gains, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    live = (g > 0.0) & (w > 0.0)
    if not live.any():
        return np.zeros(g.shape, dtype=np.float64)
    with np.errstate(divide="ignore"):
        caps = np.where(live, pmax * g * g / np.maximum(w * w, 1e-300), np.inf)
    eta = float(np.min(caps))
    with np.errstate(divide="ignore"):
        p = np.where(live, eta * w * w / np.maximum(g * g, 1e-300), 0.0)
    return np.minimum(p, pmax)   # the min-cap guarantees this; belt and braces


TRACED_POWER_MODES = ("max", "ota-align")
# the modes with a closed-form tensor allocator (traced_round_powers), i.e.
# the modes the scanned online horizon supports; "mapel" is the
# host-iterative polyblock search and stays per-round only (FLConfig raises
# errors.ERR_SCAN_ONLINE_MAPEL)


def traced_round_powers(mode: str, gains_k, weights_k, pmax: float):
    """:meth:`PowerAllocator.solve` on tensors for the scanned online
    horizon: (..., K) float32 gains and weights of masked groups (padding
    lanes carry zero gain and weight and get zero power, hence zero rate
    and budget), the reference's float32 op order.  Only the closed-form
    modes of :data:`TRACED_POWER_MODES` are supported."""
    g, w = gains_k, weights_k
    if mode == "max":
        return torch.where(g > 0.0, torch.full_like(g, pmax), 0.0)
    if mode != "ota-align":
        raise ValueError(
            f"power mode {mode!r} has no traced allocator; "
            f"supported: {TRACED_POWER_MODES}"
        )
    live = (g > 0.0) & (w > 0.0)
    caps = torch.where(
        live, pmax * g * g / torch.clamp_min(w * w, 1e-30), float("inf")
    )
    eta = caps.amin(dim=-1, keepdim=True)   # inf when nothing is live
    p = torch.where(live, eta, 0.0) * w * w / torch.clamp_min(g * g, 1e-30)
    return torch.clamp_max(p, pmax)


@dataclasses.dataclass(frozen=True)
class PowerAllocator:
    """Power allocation for scheduled NOMA groups, single or batched.

    ``solve`` allocates one group ((K,) gains/weights -> (K,) powers);
    ``solve_batched`` allocates V groups in one call ((V, K) -> (V, K)).
    For ``mode="mapel"`` the batched form is the lockstep polyblock
    (:func:`mapel_batched`), which reproduces the sequential solver
    group-for-group; ``mode="max"`` is the no-power-control baseline;
    ``mode="ota-align"`` is the over-the-air channel-inversion alignment
    (:func:`ota_align_powers`; FLConfig restricts it to uplink="ota").

    Instances are also callable ((gains, weights) -> powers) and expose
    ``batched`` as an alias of ``solve_batched``, so every legacy
    ``PowerFn`` call site (``scheduling.score_subsets``, the schedulers'
    finalization) works unchanged.
    """

    mode: str
    pmax: float
    noise_power: float
    eps: float = 1e-3           # MAPEL relative optimality gap

    def __post_init__(self):
        if self.mode not in POWER_MODES:
            raise ValueError(
                f"unknown power mode {self.mode!r}; known: {POWER_MODES}"
            )

    def solve(self, gains_k, weights_k) -> np.ndarray:
        """(K,) powers for one group, input (unsorted) order."""
        if self.mode == "max":
            return max_power(gains_k, self.pmax)
        if self.mode == "ota-align":
            return ota_align_powers(gains_k, weights_k, self.pmax)
        return mapel(
            gains_k, weights_k, self.pmax, self.noise_power, eps=self.eps
        ).powers

    def solve_batched(self, gains_vk, weights_vk) -> np.ndarray:
        """(V, K) powers for V groups in one call."""
        if self.mode == "max":
            return np.full(np.shape(gains_vk), self.pmax, dtype=np.float64)
        if self.mode == "ota-align":
            gains_vk = np.asarray(gains_vk, dtype=np.float64)
            weights_vk = np.asarray(weights_vk, dtype=np.float64)
            return np.stack([
                ota_align_powers(g, w, self.pmax)
                for g, w in zip(gains_vk, weights_vk)
            ]) if len(gains_vk) else np.zeros(np.shape(gains_vk))
        return mapel_batched(
            gains_vk, weights_vk, self.pmax, self.noise_power, eps=self.eps
        ).powers

    def __call__(self, gains_k, weights_k) -> np.ndarray:
        return self.solve(gains_k, weights_k)

    @property
    def batched(self):
        return self.solve_batched


def make_power_allocator(
    mode: str, pmax: float, noise_power: float
) -> PowerAllocator:
    """Factory behind ``FLConfig.power_mode`` (raises on unknown modes)."""
    return PowerAllocator(mode, pmax, noise_power)


def max_power(gains: np.ndarray, pmax: float) -> np.ndarray:
    """No-power-control baseline: everyone transmits at p^max (paper §IV)."""
    return np.full(len(np.atleast_1d(gains)), pmax, dtype=np.float64)


def weighted_rate(powers, gains, weights, noise_power) -> float:
    """sum_k w_k log2(1 + SINR_k) under SIC, input order.

    Thin wrapper over the shared batched engine (core/rates.py) so MAPEL,
    the schedulers, and the kernels all agree on one SIC rate definition.
    """
    return rates_lib.weighted_rate(powers, gains, weights, noise_power)


def grid_oracle(
    gains, weights, pmax, noise_power, *, points: int = 40
) -> PowerSolution:
    """Brute-force grid search oracle (tests only; exponential in K)."""
    gains = np.asarray(gains, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    k = len(gains)
    axes = [np.linspace(0.0, pmax, points) for _ in range(k)]
    best, best_p = -np.inf, None
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, k)
    for p in grid:
        val = weighted_rate(p, gains, weights, noise_power)
        if val > best:
            best, best_p = val, p
    return PowerSolution(np.asarray(best_p), float(best), len(grid), 0.0)
