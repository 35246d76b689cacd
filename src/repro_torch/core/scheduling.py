"""User scheduling for FL over NOMA (paper §III): the scheduling policies.

The port of ``repro.core.scheduling``: the policy registry, the shared
finalization (power allocation + SIC rates, :func:`finalize_schedule` and
its per-round twin :func:`finalize_round`), the paper's lazy GWMIN MWIS
greedy (``lazy-gwmin``), the literal Algorithm 2 on the explicit graph
(``literal-gwmin``, small M only), the baselines (``random``,
``round-robin``, ``proportional-fair``), the exponential test oracle
:func:`brute_force_schedule`, and the three online policies
(``update-aware``, ``age-fair``, ``matching-pursuit``).  The host control
plane is float64 numpy, the reference's op for op, Python set operations
and numpy sorts included, so schedules, powers and rates are bit-identical
to it, T*K > M tails included (tests/test_torch_control_plane.py,
tests/test_torch_policies.py, tests/test_torch_online.py).

Policies are looked up by name (:func:`register_policy` /
:func:`get_policy`).  A precomputed policy plans the whole horizon in
``init_state`` and replays it in ``select_round``.  An online policy
(``online = True``) selects each round from FL state in an
:class:`Observation` (update norms, participation, last round, realized
rates), which ``fl.run_federated_learning`` feeds back round by round
(:meth:`Observation.record_round`); it may revisit devices
(``respects_c1 = False``).  All three online policies also implement the
traced protocol (``traced_protocol = True``): ``init_traced`` (the float32
solo-rate table, once per horizon, on the host) and
``select_round_traced``, which selects on tensors of the run's device from
a :class:`TracedObservation` with a leading run axis, reading nothing back,
inside the scanned horizon (``fl_engine._online_horizon_core``).

All three lazy-greedy backends run: ``"numpy"`` on the host, and the
device-resident ``"jax"`` (fused, one host sync per schedule) and
``"jax-stepwise"`` (one sync per greedy step) on the run's device through
:mod:`repro_torch.core.rates_device`.  The device backends keep the
reference's names, which users' configurations carry; they run on ``cuda``
unless given ``device="cpu"``, and their float64 ``scorer="xla"`` schedules
equal the numpy backend's (tests/test_torch_greedy.py).

MWIS formulation (paper §III-A): a vertex v = (S, t) is a K-subset S
proposed for round t; edges join vertices that share a device (C1) or a
round (C2); vertex weight w(v) = sum_{k in S} w_k R_k^t.  In the residual
graph after any number of GWMIN removals every vertex has the same degree,
so Algorithm 2 reduces to repeatedly taking the max-weight (subset, round)
among unused devices and remaining rounds — what the lazy greedy does.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (
    Any, Callable, NamedTuple, Protocol, Sequence, runtime_checkable,
)

import numpy as np
import torch

from repro_torch.core import power as power_lib
from repro_torch.core import rates as rates_lib
from repro_torch.core import rates_device
from repro_torch.device import resolve_device

PowerFn = Callable[[np.ndarray, np.ndarray], np.ndarray]
# (gains_K, weights_K) -> powers_K; may carry a ``batched`` attribute
# (gains_VK, weights_VK) -> powers_VK for vectorized candidate scoring.
# ``power.PowerAllocator`` satisfies this interface.

SCHEDULER_BACKENDS = ("numpy", "jax", "jax-stepwise")
# the reference's lazy-greedy backends: host, device fused, device step-wise

def make_power_fn(
    mode: str, pmax: float, noise_power: float
) -> power_lib.PowerAllocator:
    """Front door to :class:`repro_torch.core.power.PowerAllocator` (the
    allocator is callable and carries ``batched``, so it serves as a
    ``PowerFn``)."""
    return power_lib.make_power_allocator(mode, pmax, noise_power)


def _solo_proxy(gains, weights, pmax: float, noise_power: float) -> np.ndarray:
    """Pool-ranking proxy: weighted interference-free rate of each device
    alone.  ``gains`` keeps the caller's dtype: the reference ranks from the
    float32 channel draws, and numpy evaluates ``pmax * gains**2`` in
    float32 for them, so the port must hand in float32 gains as well."""
    return weights * np.log2(1.0 + (pmax * gains**2) / noise_power)


def _batched_powers(power_fn: PowerFn, gains_vk, weights_vk) -> np.ndarray:
    """(V, K) powers for V candidate groups; row loop only for iterative
    allocators (MAPEL) that expose no vectorized form."""
    batched = getattr(power_fn, "batched", None)
    if batched is not None:
        return batched(gains_vk, weights_vk)
    return np.stack(
        [power_fn(g, w) for g, w in zip(gains_vk, weights_vk)]
    )


def score_subsets(
    subsets_vk: np.ndarray,
    t: int,
    gains_tm: np.ndarray,
    weights_m: np.ndarray,
    power_fn: PowerFn,
    noise_power: float,
) -> np.ndarray:
    """Weighted sum rate of every candidate group in one engine call.

    subsets_vk: (V, K) int array of device ids, one candidate K-subset per
    row, all proposed for round t. Replaces the seed's per-subset Python
    loop (one ``group_weighted_rate`` call per ``itertools.combinations``
    element) with a single (V, K) ``batched_weighted_rates`` evaluation.
    """
    if subsets_vk.size == 0:
        return np.zeros((len(subsets_vk),))
    g = gains_tm[t][subsets_vk]
    w = weights_m[subsets_vk]
    p = _batched_powers(power_fn, g, w)
    return rates_lib.batched_weighted_rates(p, g, w, noise_power)


def group_weighted_rate(
    subset: Sequence[int],
    t: int,
    gains_tm: np.ndarray,
    weights_m: np.ndarray,
    power_fn: PowerFn,
    noise_power: float,
):
    """Weighted sum rate (and powers, rates) of scheduling ``subset`` at
    round t: ``(float, powers (K,), rates (K,))``, numpy float64 through
    :func:`repro_torch.core.rates.sic_rates`, the per-subset form of
    :func:`score_subsets`."""
    idx = np.asarray(subset, dtype=np.intp)
    g = gains_tm[t, idx]
    w = weights_m[idx]
    p = power_fn(g, w)
    rates = rates_lib.sic_rates(p, g, noise_power)
    return float(np.sum(w * rates)), p, rates


def validate_group(group, num_devices: int, k: int, *, label: str = "group"):
    """One round's group invariants: size <= K, distinct, in-range ids.

    The single owner of the per-round rules — ``Schedule.validate`` applies
    it to every round and the live FL loop applies it to each group an
    online policy hands back.  Raises ValueError.
    """
    if (
        len(group) > k
        or len(set(group)) != len(group)
        or any(not 0 <= d < num_devices for d in group)
    ):
        raise ValueError(
            f"invalid {label} {tuple(group)}: at most K={k} distinct "
            f"device ids in [0, {num_devices})"
        )


@dataclasses.dataclass
class Schedule:
    """A complete schedule: device groups, powers and rates per round."""

    rounds: list            # list[T] of tuple[int, ...] device ids
    powers: list            # list[T] of np.ndarray (K,)
    rates: list             # list[T] of np.ndarray (K,) spectral efficiencies
    weighted_sum_rate: float
    method: str
    allow_revisits: bool = False   # True for schedules built by online
                                   # policies (respects_c1 = False)

    def scheduled_devices(self) -> set:
        return set(itertools.chain.from_iterable(self.rounds))

    def validate(self, num_devices: int, k: int, allow_revisits=None):
        """Assert constraints C2 (and C1 unless revisits are allowed) hold.

        ``allow_revisits=None`` defers to the schedule's own flag (set by
        ``build_schedule`` from the producing policy's ``respects_c1``).
        Online policies legitimately re-schedule devices across rounds;
        they still may not duplicate a device within a round or emit
        out-of-range ids.
        """
        if allow_revisits is None:
            allow_revisits = self.allow_revisits
        seen = set()
        for t, grp in enumerate(self.rounds):
            validate_group(grp, num_devices, k, label=f"round-{t} group")
            for d in grp:
                if not allow_revisits and d in seen:
                    raise ValueError(
                        f"C1 violated: device {d} scheduled again in round "
                        f"{t} (set allow_revisits for online-policy schedules)"
                    )
                seen.add(d)
        return True


def finalize_round(group, t, gains_tm, weights_m, power_fn, noise_power):
    """Power allocation + SIC rates for one scheduled group (live mode).

    The per-round twin of :func:`finalize_schedule`: online policies select
    a group inside the FL loop and the runtime finalizes it immediately —
    policies themselves never allocate power.  Returns ``(powers, rates)``,
    both (len(group),), input order.
    """
    idx = np.asarray(group, dtype=np.intp)
    if idx.size == 0:
        return np.zeros(0), np.zeros(0)
    g = gains_tm[t, idx]
    w = weights_m[idx]
    p = np.asarray(power_fn(g, w))
    r = rates_lib.sic_rates(p, g, noise_power)
    return p, r


def finalize_schedule(rounds, gains_tm, weights_m, power_fn, noise_power, method):
    """Powers/rates/weighted-sum for a complete schedule.

    The shared finalization step: every policy's selected rounds pass
    through here, so power allocation and rate computation have exactly one
    owner.  Groups are batched by size and handed to the allocator in one
    call per size (for MAPEL this is the batched polyblock refinement over
    all T selected groups — the per-round loop it replaces solved each
    group separately).  Tail groups smaller than K (T*K > M horizons) and
    empty rounds batch among themselves.
    """
    num_rounds = len(rounds)
    powers, rates = [None] * num_rounds, [None] * num_rounds
    vals = np.zeros(num_rounds)
    by_size = {}
    for t, grp in enumerate(rounds):
        by_size.setdefault(len(grp), []).append(t)
    for kk, ts in sorted(by_size.items()):
        idx = np.array([rounds[t] for t in ts], dtype=np.intp).reshape(len(ts), kk)
        g = gains_tm[np.asarray(ts, dtype=np.intp)[:, None], idx]
        w = weights_m[idx]
        if kk == 0:
            p = np.zeros((len(ts), 0))
        else:
            p = _batched_powers(power_fn, g, w)
        r = rates_lib.sic_rates(p, g, noise_power)
        for row, t in enumerate(ts):
            powers[t] = p[row]
            rates[t] = r[row]
            vals[t] = float(np.sum(w[row] * r[row]))
    total = 0.0
    for t in range(num_rounds):    # accumulate in round order (reproducible)
        total += float(vals[t])
    return Schedule(list(map(tuple, rounds)), powers, rates, total, method)


# --------------------------------------------------------------------------
# Literal Algorithm 2 on the explicit scheduling graph
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SchedulingGraph:
    vertices: list          # list of (subset tuple, t)
    weights: np.ndarray     # (V,)
    adjacency: list         # list[V] of set[int]

    def degree(self, v: int) -> int:
        return len(self.adjacency[v])


def build_scheduling_graph(
    gains_tm: np.ndarray,
    weights_m: np.ndarray,
    k: int,
    power_fn: PowerFn,
    noise_power: float,
) -> SchedulingGraph:
    """Explicit graph with C(M,K)*T vertices (paper §III-A).

    Small M only: the adjacency is built pairwise in Python, O(V^2) with
    V = C(M, K) * T (at the paper's M=300, K=3 that is 4.5e6 * T vertices,
    which cannot be built).
    """
    num_rounds, num_devices = gains_tm.shape
    subsets = list(itertools.combinations(range(num_devices), k))
    vertices = [(subset, t) for t in range(num_rounds) for subset in subsets]
    subs_vk = np.array(subsets, dtype=np.intp).reshape(len(subsets), k)
    weights = np.concatenate(
        [
            score_subsets(subs_vk, t, gains_tm, weights_m, power_fn, noise_power)
            for t in range(num_rounds)
        ]
    )
    adjacency = [set() for _ in vertices]
    for i, (si, ti) in enumerate(vertices):
        set_i = set(si)
        for j in range(i + 1, len(vertices)):
            sj, tj = vertices[j]
            if ti == tj or set_i & set(sj):
                adjacency[i].add(j)
                adjacency[j].add(i)
    return SchedulingGraph(vertices, weights, adjacency)


def gwmin_mwis(graph: SchedulingGraph) -> list:
    """Algorithm 2: greedy maximum-weight independent set (GWMIN).

    Returns selected vertex indices. J(v) = v and its neighbours; beta(v) the
    degree; Q = {v : w(v) >= sum_{u in J(v)} w(u)/(beta(u)+1)};
    v* = argmax_{v in Q} w(v)/(beta(v)+1).  The Python ``set`` operations
    are the reference's, in its order: ``max`` breaks ties by the order in
    which Q was filled from ``alive``, so the same sets pick the same vertex.
    """
    alive = set(range(len(graph.vertices)))
    adj = {v: set(graph.adjacency[v]) for v in alive}
    w = graph.weights
    selected = []
    while alive:
        beta = {v: len(adj[v]) for v in alive}
        q = []
        for v in alive:
            closed = adj[v] | {v}
            thresh = sum(w[u] / (beta[u] + 1) for u in closed)
            if w[v] >= thresh - 1e-12:
                q.append(v)
        if not q:  # theoretical fallback; GWMIN guarantees Q nonempty
            q = list(alive)
        v_star = max(q, key=lambda v: w[v] / (beta[v] + 1))
        selected.append(v_star)
        remove = adj[v_star] | {v_star}
        alive -= remove
        for v in alive:
            adj[v] -= remove
    return selected


def _literal_gwmin_rounds(gains_tm, weights_m, k, power_fn, noise_power):
    """Selection step of the literal Algorithm 2 (graph build + GWMIN)."""
    graph = build_scheduling_graph(gains_tm, weights_m, k, power_fn, noise_power)
    chosen = gwmin_mwis(graph)
    rounds = [()] * gains_tm.shape[0]
    for v in chosen:
        subset, t = graph.vertices[v]
        rounds[t] = subset
    return rounds


def literal_graph_schedule(
    gains_tm, weights_m, k, *, power_mode="max", pmax=0.01, noise_power=1e-13
) -> Schedule:
    """Paper-exact Algorithm 2 (explicit graph). Small M only (see
    :func:`build_scheduling_graph`)."""
    power_fn = make_power_fn(power_mode, pmax, noise_power)
    rounds = _literal_gwmin_rounds(gains_tm, weights_m, k, power_fn, noise_power)
    return finalize_schedule(
        rounds, gains_tm, weights_m, power_fn, noise_power, "literal-gwmin"
    )


def _best_subset_for_round(
    t, avail, gains_tm, weights_m, k, power_fn, noise_power, candidate_pool, pmax
):
    """Best K-subset of `avail` for round t.

    Exact when len(avail) is small; otherwise enumerates subsets of the
    ``candidate_pool`` strongest devices (by singleton weighted rate), which
    preserves the greedy's behaviour in practice (weak devices never enter
    the argmax group). All C(pool, K) candidates are scored in a single
    batched rate-engine call; ties keep the lexicographically first subset,
    matching the seed's sequential strict-improvement loop.
    """
    avail = np.asarray(sorted(avail))
    if len(avail) > candidate_pool:
        # Stable sort so proxy ties keep the lower device id.
        solo = _solo_proxy(gains_tm[t, avail], weights_m[avail], pmax, noise_power)
        keep = avail[np.argsort(-solo, kind="stable")[:candidate_pool]]
    else:
        keep = avail
    kk = min(k, len(keep))
    subs_vk = np.array(
        list(itertools.combinations(sorted(keep.tolist()), kk)), dtype=np.intp
    ).reshape(-1, kk)
    if len(subs_vk) == 0:
        return -np.inf, None
    vals = score_subsets(subs_vk, t, gains_tm, weights_m, power_fn, noise_power)
    i_best = int(np.argmax(vals))
    return float(vals[i_best]), tuple(subs_vk[i_best].tolist())


def _greedy_rounds_numpy(
    gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax,
    *, rounds=None, avail=None, remaining=None,
):
    """Host-path greedy selection loop.

    Mutates/returns ``rounds`` (list[T] of tuples); ``avail``/``remaining``
    default to the full device/round sets (a device-resident backend can
    hand over mid-schedule state when fewer than K devices remain).
    """
    num_rounds, num_devices = gains_tm.shape
    if rounds is None:
        rounds = [()] * num_rounds
    if avail is None:
        avail = set(range(num_devices))
    if remaining is None:
        remaining = set(range(num_rounds))
    while remaining and len(avail) > 0:
        # max-weight vertex across all remaining rounds
        best = (-np.inf, None, None)
        for t in sorted(remaining):
            val, sub = _best_subset_for_round(
                t, avail, gains_tm, weights_m, k, search_fn, noise_power,
                candidate_pool, pmax,
            )
            if val > best[0]:
                best = (val, sub, t)
        _, subset, t = best
        if subset is None:
            break
        rounds[t] = subset
        avail -= set(subset)
        remaining.discard(t)
    return rounds


def _device_greedy_inputs(gains_tm, weights_m, candidate_pool, k, pmax,
                          noise_power, device):
    """Shared prologue of both device drivers (the reference's
    ``_jax_greedy_inputs``): clamp the pool to M, enumerate the C(pool, kk)
    subsets once as pool *positions* (lex order), build the pool-ranking
    proxy with the *host* engine so every backend ranks candidate pools
    from identical float64 values, and move all of it to ``device`` (gains
    and weights as float64, positions as int64)."""
    num_devices = gains_tm.shape[1]
    pool = int(min(candidate_pool, num_devices))
    kk = min(k, pool)
    subs_pos = np.array(
        list(itertools.combinations(range(pool), kk)), dtype=np.int32
    ).reshape(-1, kk)
    solo_tm = _solo_proxy(gains_tm, weights_m[None, :], pmax, noise_power)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    tensors = (
        put(gains_tm, torch.float64), put(weights_m, torch.float64),
        put(solo_tm, torch.float64), put(subs_pos, torch.int64),
    )
    return pool, kk, tensors


def _device_greedy_tail(
    rounds, avail_np, done_np,
    gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax,
):
    """Shared epilogue of both device drivers: once fewer than K devices
    remain (T*K > M horizons), the host loop finishes the leftover smaller
    groups — the device enumeration is fixed-K."""
    avail_host = set(np.flatnonzero(avail_np).tolist())
    remaining_host = set(np.flatnonzero(~done_np).tolist())
    if avail_host and remaining_host:
        _greedy_rounds_numpy(
            gains_tm, weights_m, k, search_fn, noise_power, candidate_pool,
            pmax, rounds=rounds, avail=avail_host, remaining=remaining_host,
        )
    return rounds


def _greedy_rounds_stepwise(
    gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax,
    *, device,
):
    """``backend="jax-stepwise"``: one :func:`rates_device.greedy_step` per
    greedy step, scored in float64, with the argmax read back to the host
    every step (the reference's ``_greedy_rounds_jax_stepwise``)."""
    num_rounds, num_devices = gains_tm.shape
    pool, kk, (g, w, solo, subs) = _device_greedy_inputs(
        gains_tm, weights_m, candidate_pool, k, pmax, noise_power, device
    )
    rounds = [()] * num_rounds
    avail = torch.ones(num_devices, dtype=torch.bool, device=device)
    done = torch.zeros(num_rounds, dtype=torch.bool, device=device)
    avail_count = num_devices
    steps = 0
    while steps < num_rounds and avail_count >= kk:
        val, t_star, sub_ids, avail, done = rates_device.greedy_step(
            g, w, solo, subs, avail, done,
            pool=pool, pmax=float(pmax), noise_power=float(noise_power),
        )
        if not bool(val > -np.inf):
            break
        rounds[int(t_star)] = tuple(int(d) for d in sub_ids.tolist())
        avail_count -= kk
        steps += 1
    return _device_greedy_tail(
        rounds, avail.cpu().numpy(), done.cpu().numpy(),
        gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax,
    )


def _greedy_rounds_fused(
    gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax,
    *, scorer, shards, device,
):
    """``backend="jax"``: the whole selection loop on the device
    (:func:`rates_device.greedy_rounds_fused`) and exactly one copy of its
    state to the host per schedule (the reference's
    ``_greedy_rounds_jax_fused``)."""
    num_rounds = gains_tm.shape[0]
    pool, kk, (g, w, solo, subs) = _device_greedy_inputs(
        gains_tm, weights_m, candidate_pool, k, pmax, noise_power, device
    )
    assign, done, avail = rates_device.greedy_rounds_fused(
        g, w, solo, subs, pool=pool, pmax=float(pmax),
        noise_power=float(noise_power), scorer=scorer, shards=shards,
    )
    # the one host sync per schedule
    state = torch.cat(
        [assign.reshape(-1).long(), done.long(), avail.long()]
    ).cpu().numpy()
    assign_np = state[: num_rounds * kk].reshape(num_rounds, kk)
    done_np = state[num_rounds * kk: num_rounds * (kk + 1)].astype(bool)
    avail_np = state[num_rounds * (kk + 1):].astype(bool)
    rounds = [()] * num_rounds
    for t in np.flatnonzero(done_np):
        rounds[t] = tuple(int(d) for d in assign_np[t])
    return _device_greedy_tail(
        rounds, avail_np, done_np,
        gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax,
    )


def lazy_greedy_schedule(
    gains_tm,
    weights_m,
    k,
    *,
    power_mode="max",
    pmax=0.01,
    noise_power=1e-13,
    candidate_pool=24,
    backend="numpy",
    scorer="xla",
    shards=None,
    device=None,
) -> Schedule:
    """Graph-free Algorithm 2: repeatedly take the max-weight (subset, round)
    among unused devices and remaining rounds (GWMIN on the MWIS graph, whose
    residual vertices all have equal degree, reduces to exactly that).

    ``candidate_pool`` bounds the per-round enumeration to the pool of
    strongest devices; the batched rate engine scores all C(pool, K)
    candidates in one call.

    With power_mode="mapel" the subset *search* runs at max power and MAPEL
    refines only the selected groups — batched over all T groups in one
    ``power.mapel_batched`` call at finalization.

    ``backend="numpy"`` runs the greedy on the host.  ``backend="jax"``
    runs the whole selection loop on ``device`` (``cuda`` unless given
    ``"cpu"``) with one host sync per schedule; ``"jax-stepwise"`` syncs
    every greedy step.  Both give the numpy backend's schedule.  ``scorer``
    and ``shards`` tune ``"jax"`` only: the vertex scorer (``"xla"``,
    float64 tensor code; ``"pallas"``, the hand-written SIC kernel in
    float32) and the split of the vertex axis: an int clamps to the cards
    available (1 on the CPU), a sequence of devices puts one shard on each
    entry (:func:`repro_torch.core.rates_device.greedy_rounds_fused`); the
    schedule does not depend on it.
    """
    power_fn = make_power_fn(power_mode, pmax, noise_power)
    rounds = _lazy_gwmin_rounds(
        gains_tm, weights_m, k, pmax=pmax, noise_power=noise_power,
        candidate_pool=candidate_pool, backend=backend, scorer=scorer,
        shards=shards, device=device,
    )
    return finalize_schedule(
        rounds, gains_tm, weights_m, power_fn, noise_power, "lazy-gwmin"
    )


def _lazy_gwmin_rounds(
    gains_tm, weights_m, k, *, pmax, noise_power, candidate_pool, backend,
    scorer="xla", shards=None, device=None,
):
    """Selection step of the lazy greedy (the subset *search* runs at max
    power regardless of the finalization power mode — see
    ``lazy_greedy_schedule``)."""
    search_fn = make_power_fn("max", pmax, noise_power)
    if backend == "numpy":
        return _greedy_rounds_numpy(
            gains_tm, weights_m, k, search_fn, noise_power, candidate_pool, pmax
        )
    if backend == "jax":
        return _greedy_rounds_fused(
            gains_tm, weights_m, k, search_fn, noise_power, candidate_pool,
            pmax, scorer=scorer, shards=shards, device=resolve_device(device),
        )
    if backend == "jax-stepwise":
        return _greedy_rounds_stepwise(
            gains_tm, weights_m, k, search_fn, noise_power, candidate_pool,
            pmax, device=resolve_device(device),
        )
    raise ValueError(
        f"unknown scheduling backend {backend!r}; known: {SCHEDULER_BACKENDS}"
    )


def _round_robin_rounds(num_rounds, num_devices, k):
    """Selection step of round robin: fixed device order, K per round."""
    return [
        tuple(range(min(t * k, num_devices), min((t + 1) * k, num_devices)))
        for t in range(num_rounds)
    ]


def round_robin_schedule(
    gains_tm, weights_m, k, *, power_mode="max", pmax=0.01, noise_power=1e-13
) -> Schedule:
    """Round robin: fixed device order, K per round (ref [6] policy).

    When T*K > M the tail rounds get the leftover devices (possibly none)
    instead of emitting out-of-range device ids — C1 still holds and every
    id stays < num_devices.
    """
    power_fn = make_power_fn(power_mode, pmax, noise_power)
    num_rounds, num_devices = gains_tm.shape
    rounds = _round_robin_rounds(num_rounds, num_devices, k)
    return finalize_schedule(
        rounds, gains_tm, weights_m, power_fn, noise_power, "round-robin"
    )


# --------------------------------------------------------------------------
# Exact optimum (tests only)
# --------------------------------------------------------------------------

def brute_force_schedule(
    gains_tm, weights_m, k, *, power_mode="max", pmax=0.01, noise_power=1e-13
) -> Schedule:
    """Enumerate every feasible schedule (C1/C2) — exponential, tests only."""
    power_fn = make_power_fn(power_mode, pmax, noise_power)
    num_rounds, num_devices = gains_tm.shape
    subsets = list(itertools.combinations(range(num_devices), k))
    subs_vk = np.array(subsets, dtype=np.intp).reshape(len(subsets), k)
    vals = {
        (s, t): v
        for t in range(num_rounds)
        for s, v in zip(
            subsets,
            score_subsets(subs_vk, t, gains_tm, weights_m, power_fn, noise_power),
        )
    }
    best_total, best_assign = -np.inf, None

    def rec(t, used, total, assign):
        nonlocal best_total, best_assign
        if t == num_rounds:
            if total > best_total:
                best_total, best_assign = total, list(assign)
            return
        for s in subsets:
            if used & set(s):
                continue
            assign.append(s)
            rec(t + 1, used | set(s), total + vals[(s, t)], assign)
            assign.pop()

    rec(0, set(), 0.0, [])
    return finalize_schedule(
        best_assign, gains_tm, weights_m, power_fn, noise_power, "brute-force"
    )


# --------------------------------------------------------------------------
# Baseline schedulers (paper §IV comparisons and ref [6] policies)
# --------------------------------------------------------------------------

def _random_rounds(rng: np.random.Generator, num_rounds, num_devices, k):
    """Selection step of random scheduling: one device permutation, chunked
    into K-groups round by round (tail rounds past the supply come back
    empty)."""
    perm = rng.permutation(num_devices)
    return [tuple(perm[t * k : (t + 1) * k].tolist()) for t in range(num_rounds)]


def random_schedule(
    rng: np.random.Generator, gains_tm, weights_m, k,
    *, power_mode="max", pmax=0.01, noise_power=1e-13,
) -> Schedule:
    """Random scheduling respecting C1 (each device at most once); ``rng``
    a numpy Generator, whose permutation is the reference's."""
    power_fn = make_power_fn(power_mode, pmax, noise_power)
    num_rounds, num_devices = gains_tm.shape
    rounds = _random_rounds(rng, num_rounds, num_devices, k)
    return finalize_schedule(
        rounds, gains_tm, weights_m, power_fn, noise_power, "random"
    )


def _proportional_fair_rounds(
    gains_tm, weights_m, k, *, by_gain, pmax, noise_power
):
    """Selection step of proportional fair: greedy top-K unused devices.

    Default ranking is the weighted solo-proxy rate w_k log2(1 + p g^2 /
    sigma^2) with a stable sort, so score ties keep the lower device id.
    ``by_gain=True`` ranks by raw gain with numpy's default (unstable)
    sort, as the reference does.
    """
    num_rounds, num_devices = gains_tm.shape
    used = set()
    rounds = []
    for t in range(num_rounds):
        avail = np.array(
            [d for d in range(num_devices) if d not in used], dtype=np.intp
        )
        if by_gain:
            order = avail[np.argsort(-gains_tm[t, avail])]
        else:
            score = _solo_proxy(
                gains_tm[t, avail], weights_m[avail], pmax, noise_power
            )
            order = avail[np.argsort(-score, kind="stable")]
        grp = tuple(order[:k].tolist())
        used |= set(grp)
        rounds.append(grp)
    return rounds


def proportional_fair_schedule(
    gains_tm, weights_m, k, *, power_mode="max", pmax=0.01, noise_power=1e-13,
    by_gain=False,
) -> Schedule:
    """Per round, pick the K best unused devices by weighted solo rate
    (``by_gain=True``: by raw channel gain).  When every device has been
    used before the horizon ends (T*K > M) the remaining rounds get empty
    groups; the intp dtype keeps the empty ``avail`` gather legal."""
    power_fn = make_power_fn(power_mode, pmax, noise_power)
    rounds = _proportional_fair_rounds(
        gains_tm, weights_m, k, by_gain=by_gain, pmax=pmax,
        noise_power=noise_power,
    )
    return finalize_schedule(
        rounds, gains_tm, weights_m, power_fn, noise_power, "proportional-fair"
    )


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Everything a policy may read at ``init_state`` time.

    The FL runtime builds this from ``FLConfig`` + the cell physics
    (``fl.policy_config``); standalone callers construct it directly.
    ``seed`` seeds any policy-internal randomness — schedules must be
    reproducible from (inputs, PolicyConfig) alone.
    """

    group_size: int                 # K
    power_mode: str = "max"         # finalization allocator (max | mapel)
    pmax: float = 0.01
    noise_power: float = 1e-13
    candidate_pool: int = 24        # lazy greedy enumeration bound
    backend: str = "numpy"          # lazy greedy driver (SCHEDULER_BACKENDS)
    scorer: str = "xla"             # fused-backend vertex scorer (xla | pallas)
    shards: "int | tuple | None" = None  # fused-backend vertex shards: an
                                    # int (clamped) or a tuple of devices
    device: "str | torch.device | None" = None   # device backends' device;
                                    # None = cuda (repro_torch.device)
    ota_noise: float = 0.0          # OTA receiver noise std (matching-pursuit
                                    # aggregation-error model; 0 = noiseless)
    seed: int = 0


@dataclasses.dataclass
class Observation:
    """Online observables fed to ``select_round`` (all (M,) arrays).

    The FL runtime updates these after every live round
    (:meth:`record_round`); :func:`build_schedule` feeds realized rates and
    participation but no update norms (there is no FL state outside the
    training loop).
    """

    update_norms: np.ndarray    # last observed ||delta W_k||_2; 0 if never
    participation: np.ndarray   # rounds device k was scheduled so far
    last_round: np.ndarray      # last round k participated; -1 if never
    realized_rates: np.ndarray  # rate k achieved when last scheduled; 0 if never

    @classmethod
    def initial(cls, num_devices: int) -> "Observation":
        return cls(
            update_norms=np.zeros(num_devices),
            participation=np.zeros(num_devices, dtype=np.intp),
            last_round=np.full(num_devices, -1, dtype=np.intp),
            realized_rates=np.zeros(num_devices),
        )

    def record_round(self, t, group, rates_k, update_norms_k=None) -> "Observation":
        """Functional update after round t (the caller keeps the new copy,
        so a policy holding an old Observation never sees the future)."""
        obs = Observation(
            self.update_norms.copy(), self.participation.copy(),
            self.last_round.copy(), self.realized_rates.copy(),
        )
        idx = np.asarray(group, dtype=np.intp)
        if idx.size:
            obs.participation[idx] += 1
            obs.last_round[idx] = t
            obs.realized_rates[idx] = np.asarray(rates_k, dtype=np.float64)
            if update_norms_k is not None:
                obs.update_norms[idx] = np.asarray(update_norms_k, dtype=np.float64)
        return obs


class TracedObservation(NamedTuple):
    """The tensor mirror of :class:`Observation` that the scanned online
    horizon carries from round to round (``fl_engine._online_horizon_core``),
    for S runs at once: every field is (S, M) on the run's device.

    ``realized_rates`` is left out, as in the reference: no traced policy
    reads it (the scores take the solo-rate proxy, not the realized SIC
    rate).
    """

    update_norms: torch.Tensor   # (S, M) float32 last observed ||delta W_k||;
                                 # seeded with the policy's COLD_START_NORM
    participation: torch.Tensor  # (S, M) int32 rounds scheduled so far
    last_round: torch.Tensor     # (S, M) int32 last round; -1 if never

    @classmethod
    def initial(cls, runs: int, num_devices: int,
                cold_start_norm: float = 1.0, *,
                device) -> "TracedObservation":
        shape = (runs, num_devices)
        return cls(
            update_norms=torch.full(shape, cold_start_norm,
                                    dtype=torch.float32, device=device),
            participation=torch.zeros(shape, dtype=torch.int32,
                                      device=device),
            last_round=torch.full(shape, -1, dtype=torch.int32,
                                  device=device),
        )


def _norm_estimates_traced(obs: TracedObservation, cold_start: float):
    """The tensor mirror of the host norm-estimate convention
    (``UpdateAwarePolicy._score`` / ``MatchingPursuitPolicy._norm_estimates``)
    in float32, per run: devices never yet observed take the mean of the
    observed norms (``cold_start`` before any observation) and observed
    norms are floored at 1e-3 of it, so no device is starved forever.
    The reference's op order; its two row sums are XLA reductions, which
    sum in another order than ``torch.sum`` (tests/test_torch_online.py
    holds the estimates to the reference's)."""
    seen = obs.participation > 0
    cnt = seen.to(torch.float32).sum(dim=-1, keepdim=True)
    total = torch.where(seen, obs.update_norms, 0.0).sum(dim=-1,
                                                         keepdim=True)
    default = torch.where(cnt > 0.0, total / torch.clamp_min(cnt, 1.0),
                          cold_start)
    default = torch.clamp_min(default, 1e-12)
    return torch.where(seen, torch.maximum(obs.update_norms, 1e-3 * default),
                       default)


@runtime_checkable
class SchedulerPolicy(Protocol):
    """The scheduling policy protocol, the reference's.

    ``online`` declares whether ``select_round`` reads FL state from the
    :class:`Observation` (live mode inside the training loop) or replays a
    precomputed plan; ``respects_c1`` whether the policy schedules each
    device at most once over the horizon (the paper's C1).  Online
    policies may also declare ``needs_norms`` (default True): False tells
    the FL loop not to compute the update norms the policy never reads.

    Online policies that run inside the scanned horizon implement the
    traced protocol on top (``traced_protocol = True``):

        aux = policy.init_traced(gains_tm, weights_m, cfg)   # host, once
        dev, mask = policy.select_round_traced(
            t, solo_m, gains_m, weights_m, obs, cfg)         # on tensors

    ``init_traced`` returns the host float32 (T, M) weighted solo-rate
    table (computed in float64, cast once); ``select_round_traced`` takes
    that table's round-t rows, the round's gains and a
    :class:`TracedObservation`, all with a leading run axis, and returns
    (S, K) int64 device ids with (S, K) bool validity masks (lanes masked
    False are padding: the engine drops their scatter updates and zeroes
    their aggregation weights), reading nothing back from the device.
    """

    name: str
    online: bool
    respects_c1: bool

    def init_state(self, gains_tm: np.ndarray, weights_m: np.ndarray,
                   cfg: "PolicyConfig") -> Any: ...

    def select_round(self, t: int, state: Any,
                     obs: "Observation") -> "tuple[tuple, Any]": ...


_REGISTRY: "dict[str, type[SchedulerPolicy]]" = {}


def register_policy(name: str):
    """Class decorator registering a SchedulerPolicy under ``name``.

    The name immediately becomes a valid ``FLConfig.scheduler`` value
    (config validation reads :func:`available_policies`).
    """

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_policy(name: str, **options) -> SchedulerPolicy:
    """Instantiate the policy registered under ``name``.

    ``options`` are forwarded to the policy constructor.
    """
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {available_policies()}"
        ) from None
    return cls(**options)


def available_policies() -> tuple:
    """Sorted names of all registered policies."""
    return tuple(sorted(_REGISTRY))


def policy_is_online(name: str) -> bool:
    """Whether the policy registered under ``name`` selects from live FL
    state (``online = True``).  Under ``horizon="scan"`` such a policy
    must implement the traced protocol (:func:`policy_is_traced`).
    Raises ValueError for unregistered names (as :func:`get_policy`)."""
    return bool(getattr(get_policy(name), "online", False))


def policy_is_traced(name: str) -> bool:
    """Whether the policy registered under ``name`` implements the traced
    selection protocol (``traced_protocol = True`` + ``init_traced`` /
    ``select_round_traced``): an online policy runs under
    ``horizon="scan"`` iff this is True.  Raises ValueError for
    unregistered names (as :func:`get_policy`)."""
    return bool(getattr(get_policy(name), "traced_protocol", False))


def build_schedule(
    policy: SchedulerPolicy, gains_tm, weights_m, cfg: PolicyConfig
) -> Schedule:
    """Drive any policy over the whole horizon and finalize the result.

    Precomputed policies run their one-shot plan in ``init_state``; this is
    plan + shared finalization, as in the reference.  Online policies are
    driven with realized rates and participation fed back between rounds,
    but no update norms (FL state exists only inside
    ``fl.run_federated_learning``'s live mode), each round finalized as it
    is selected.
    """
    gains_tm = np.asarray(gains_tm)
    weights_m = np.asarray(weights_m)
    num_rounds, num_devices = gains_tm.shape
    power_fn = power_lib.make_power_allocator(
        cfg.power_mode, cfg.pmax, cfg.noise_power
    )
    state = policy.init_state(gains_tm, weights_m, cfg)
    obs = Observation.initial(num_devices)
    online = getattr(policy, "online", False)
    rounds, powers, rates, total = [], [], [], 0.0
    for t in range(num_rounds):
        group, state = policy.select_round(t, state, obs)
        group = tuple(int(d) for d in group)
        rounds.append(group)
        if online:
            # the policy reads the realized rates next round, so each round
            # is finalized here and kept
            p_k, r_k = finalize_round(
                group, t, gains_tm, weights_m, power_fn, cfg.noise_power
            )
            obs = obs.record_round(t, group, r_k)
            powers.append(p_k)
            rates.append(r_k)
            total += float(np.sum(weights_m[np.asarray(group, np.intp)] * r_k))
    revisits = not getattr(policy, "respects_c1", True)
    if online:
        sched = Schedule(rounds, powers, rates, total, policy.name, revisits)
    else:
        sched = finalize_schedule(
            rounds, gains_tm, weights_m, power_fn, cfg.noise_power, policy.name
        )
        sched.allow_revisits = revisits
    sched.validate(num_devices, cfg.group_size)
    return sched


class _PrecomputedPolicy(SchedulerPolicy):
    """Base for offline policies: plan the whole horizon in ``init_state``
    (selection depends only on channel realizations), replay per round."""

    online = False
    respects_c1 = True

    def init_state(self, gains_tm, weights_m, cfg: PolicyConfig):
        return self._plan(np.asarray(gains_tm), np.asarray(weights_m), cfg)

    def select_round(self, t, state, obs):
        return tuple(state[t]), state


@register_policy("lazy-gwmin")
class LazyGwminPolicy(_PrecomputedPolicy):
    """Graph-free Algorithm 2 (the paper's proposed MWIS scheduler)."""

    def _plan(self, gains_tm, weights_m, cfg):
        return _lazy_gwmin_rounds(
            gains_tm, weights_m, cfg.group_size, pmax=cfg.pmax,
            noise_power=cfg.noise_power, candidate_pool=cfg.candidate_pool,
            backend=cfg.backend, scorer=cfg.scorer, shards=cfg.shards,
            device=cfg.device,
        )


@register_policy("round-robin")
class RoundRobinPolicy(_PrecomputedPolicy):
    """Fixed device order, K per round (ref [6] baseline)."""

    def _plan(self, gains_tm, weights_m, cfg):
        num_rounds, num_devices = gains_tm.shape
        return _round_robin_rounds(num_rounds, num_devices, cfg.group_size)


@register_policy("literal-gwmin")
class LiteralGwminPolicy(_PrecomputedPolicy):
    """Algorithm 2 on the explicit scheduling graph (small M only)."""

    def _plan(self, gains_tm, weights_m, cfg):
        power_fn = power_lib.make_power_allocator(
            cfg.power_mode, cfg.pmax, cfg.noise_power
        )
        return _literal_gwmin_rounds(
            gains_tm, weights_m, cfg.group_size, power_fn, cfg.noise_power
        )


@register_policy("random")
class RandomPolicy(_PrecomputedPolicy):
    """Random C1-respecting schedule, reproducible from the policy alone:
    the numpy Generator is seeded ``cfg.seed + SEED_OFFSET`` (the reference's
    offset), so seed s gives the reference's permutation."""

    SEED_OFFSET = 17

    def _plan(self, gains_tm, weights_m, cfg):
        rng = np.random.default_rng(cfg.seed + self.SEED_OFFSET)
        num_rounds, num_devices = gains_tm.shape
        return _random_rounds(rng, num_rounds, num_devices, cfg.group_size)


@register_policy("proportional-fair")
class ProportionalFairPolicy(_PrecomputedPolicy):
    """Greedy top-K unused devices by weighted solo rate (``by_gain=True``
    ranks by raw channel gain)."""

    def __init__(self, by_gain: bool = False):
        self.by_gain = by_gain

    def _plan(self, gains_tm, weights_m, cfg):
        return _proportional_fair_rounds(
            gains_tm, weights_m, cfg.group_size, by_gain=self.by_gain,
            pmax=cfg.pmax, noise_power=cfg.noise_power,
        )


class _ScoreTopKPolicy(SchedulerPolicy):
    """Base for the top-K online policies: rank all devices by a per-round
    score and take the top K (stable sort, ties to the lower device id).
    Subclasses implement ``_score(t, solo, obs) -> (M,)``, where ``solo`` is
    the weighted interference-free rate w_k log2(1 + p g_k^2 / sigma^2) at
    round t, and ``_score_traced``, its float32 tensor mirror.  Online
    policies revisit devices across rounds: long-horizon fairness is the
    score's job, not C1's.
    """

    online = True
    respects_c1 = False
    needs_norms = False     # True: the FL loop computes ||delta W_k|| per
                            # scheduled device and feeds it back via obs
    traced_protocol = True

    def init_state(self, gains_tm, weights_m, cfg: PolicyConfig):
        return {
            "gains": np.asarray(gains_tm),
            "weights": np.asarray(weights_m),
            "cfg": cfg,
        }

    def select_round(self, t, state, obs):
        cfg = state["cfg"]
        solo = _solo_proxy(
            state["gains"][t], state["weights"], cfg.pmax, cfg.noise_power
        )
        score = np.asarray(self._score(t, solo, obs), dtype=np.float64)
        k = min(cfg.group_size, len(score))
        top = np.argsort(-score, kind="stable")[:k]
        return tuple(int(d) for d in top), state

    def init_traced(self, gains_tm, weights_m, cfg: PolicyConfig) -> dict:
        """Host aux for the traced path: the (T, M) weighted solo-rate
        table, computed in float64 and rounded once to float32."""
        solo = _solo_proxy(
            np.asarray(gains_tm, np.float64),
            np.asarray(weights_m, np.float64),
            cfg.pmax, cfg.noise_power,
        )
        return {"solo": np.asarray(solo, np.float32)}

    def select_round_traced(self, t, solo_m, gains_m, weights_m, obs, cfg):
        """Tensor mirror of ``select_round`` for S runs: ``solo_m`` and
        ``gains_m`` (S, M) float32 rows of round ``t``, ``weights_m`` (M,)
        float32, ``obs`` a :class:`TracedObservation`.  The top K of
        ``_score_traced`` by a stable descending sort (``torch.topk`` does
        not order ties on the card; the reference's ``lax.top_k`` gives
        the lower id first, as the stable sort does).  Returns (S, K) int64
        device ids and an all-True (S, K) mask: top-K fills every lane."""
        score = self._score_traced(t, solo_m, obs)
        k = min(int(cfg.group_size), int(score.shape[-1]))
        top = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[..., :k]
        return top, torch.ones_like(top, dtype=torch.bool)


@register_policy("update-aware")
class UpdateAwarePolicy(_ScoreTopKPolicy):
    """Update-aware scheduling (Amiri et al., arXiv:2001.10402).

    Score = (estimated ||delta W_k||_2) * (weighted solo rate), the last
    observed norm standing in for the current one.  Devices never yet
    observed take the mean of the observed norms (1.0 before any
    observation), so round 0 reduces to best-channel; observed-zero norms
    are floored so a device is deprioritized, not starved forever.
    """

    needs_norms = True
    COLD_START_NORM = 1.0   # stands in for ||delta W_k|| before any
                            # observation; the traced carry starts with it

    def _score(self, t, solo, obs):
        norms = obs.update_norms.copy()
        seen = obs.participation > 0
        default = (
            float(norms[seen].mean()) if seen.any() else self.COLD_START_NORM
        )
        default = max(default, 1e-12)
        norms[~seen] = default
        norms[seen] = np.maximum(norms[seen], 1e-3 * default)
        return norms * solo

    def _score_traced(self, t, solo_m, obs):
        return _norm_estimates_traced(obs, self.COLD_START_NORM) * solo_m


@register_policy("age-fair")
class AgeFairPolicy(_ScoreTopKPolicy):
    """Age-fair scheduling (Yang et al., arXiv:1908.06287).

    Score = (1 + age_k) * (weighted solo rate), age_k = rounds since device
    k last participated (never-scheduled devices age from round 0), so
    every device is eventually rescheduled however weak its channel.
    """

    def _score(self, t, solo, obs):
        age = (t - obs.last_round).astype(np.float64)
        return (1.0 + age) * solo

    def _score_traced(self, t, solo_m, obs):
        age = (t - obs.last_round).to(torch.float32)
        return (1.0 + age) * solo_m


@register_policy("matching-pursuit")
class MatchingPursuitPolicy(SchedulerPolicy):
    """Greedy residual-error device selection for over-the-air aggregation.

    The analog PS estimate misses the updates of unscheduled devices and
    pays receiver noise amplified by the weakest admitted channel.  With
    the round's aggregation error of a candidate set S modeled as

        E(S) = sum_{k not in S} (w_k n_k)^2
             + lambda * max_{k in S} (w_k n_k / h_k)^2,
        lambda = ota_noise^2 / pmax,

    the policy starts from S = {} and repeatedly admits the device giving
    the largest *strict* decrease of E, stopping at K devices or when no
    admission helps.  With ``ota_noise = 0`` it reduces to top-K by
    w_k n_k.  Norm estimates follow ``update-aware``'s convention.
    """

    online = True
    respects_c1 = False
    needs_norms = True
    traced_protocol = True
    COLD_START_NORM = 1.0   # shared with update-aware

    def init_state(self, gains_tm, weights_m, cfg: PolicyConfig):
        return {
            "gains": np.asarray(gains_tm),
            "weights": np.asarray(weights_m),
            "cfg": cfg,
        }

    @classmethod
    def _norm_estimates(cls, obs: Observation) -> np.ndarray:
        norms = obs.update_norms.copy()
        seen = obs.participation > 0
        default = (
            float(norms[seen].mean()) if seen.any() else cls.COLD_START_NORM
        )
        default = max(default, 1e-12)
        norms[~seen] = default
        norms[seen] = np.maximum(norms[seen], 1e-3 * default)
        return norms

    def select_round(self, t, state, obs):
        cfg = state["cfg"]
        gains = np.asarray(state["gains"][t], dtype=np.float64)
        weights = np.asarray(state["weights"], dtype=np.float64)
        m = weights * self._norm_estimates(obs)        # w_k n_k
        energy = m * m                                 # omission cost
        lam = float(cfg.ota_noise) ** 2 / max(float(cfg.pmax), 1e-300)
        if lam > 0.0:
            with np.errstate(divide="ignore"):
                pen = lam * np.where(gains > 0.0, (m / gains) ** 2, np.inf)
        else:
            pen = np.zeros_like(m)     # explicit: avoids 0 * inf = nan
        k = min(cfg.group_size, len(m))
        selected: "list[int]" = []
        in_s = np.zeros(len(m), dtype=bool)
        residual = float(energy.sum())     # sum over k not in S
        noise_term = 0.0                   # lambda * max admitted penalty
        cur = residual + noise_term
        for _ in range(k):
            cand_noise = np.maximum(noise_term, pen)
            e = (residual - energy) + cand_noise
            e[in_s] = np.inf
            j = int(np.argmin(e))
            if not e[j] < cur:     # admit only on strict decrease
                break
            selected.append(j)
            in_s[j] = True
            residual -= float(energy[j])
            noise_term = max(noise_term, float(pen[j]))
            cur = float(e[j])
        return tuple(selected), state

    def init_traced(self, gains_tm, weights_m, cfg: PolicyConfig) -> dict:
        """The top-K policies' aux contract (the engine feeds every traced
        policy the solo table); the admit loop reads only the channel row,
        the weights and the norm estimates."""
        return _ScoreTopKPolicy.init_traced(self, gains_tm, weights_m, cfg)

    def select_round_traced(self, t, solo_m, gains_m, weights_m, obs, cfg):
        """The matching-pursuit sweep on tensors, for S runs: K fixed
        iterations, each masked by whether its run is still admitting (the
        reference's ``lax.while_loop`` stops at the first candidate that
        fails the strict-decrease test; here a run that has stopped
        changes nothing in later iterations), with no branch on a tensor
        value, so both paths admit the same devices in the same order.
        ``torch.argmin`` takes the first minimum, as ``jnp.argmin`` does.
        Returns (S, K) int64 ids and (S, K) masks; lanes past a run's
        admit count are padding (id 0, mask False)."""
        m_arr = weights_m * _norm_estimates_traced(obs, self.COLD_START_NORM)
        energy = m_arr * m_arr
        lam = float(cfg.ota_noise) ** 2 / max(float(cfg.pmax), 1e-300)
        if lam > 0.0:
            live = gains_m > 0.0
            q = m_arr / torch.where(live, gains_m, 1.0)
            pen = torch.where(live, lam * (q * q), float("inf"))
        else:
            pen = torch.zeros_like(m_arr)   # explicit: avoids 0 * inf = nan
        runs, num_devices = m_arr.shape
        k = min(int(cfg.group_size), num_devices)
        lanes = torch.arange(num_devices, device=m_arr.device)
        in_s = torch.zeros_like(m_arr, dtype=torch.bool)
        residual = energy.sum(dim=-1)
        noise_term = torch.zeros_like(residual)
        cur = residual
        admitting = torch.ones_like(residual, dtype=torch.bool)
        count = torch.zeros(runs, dtype=torch.int64, device=m_arr.device)
        sel = torch.zeros((runs, k), dtype=torch.int64, device=m_arr.device)
        for step in range(k):
            cand_noise = torch.maximum(noise_term[:, None], pen)
            e = torch.where(in_s, float("inf"),
                            (residual[:, None] - energy) + cand_noise)
            j = torch.argmin(e, dim=-1, keepdim=True)
            e_j = e.gather(-1, j)[:, 0]
            admit = admitting & (e_j < cur)      # strict decrease only
            sel[:, step] = torch.where(admit, j[:, 0], 0)
            in_s = in_s | ((lanes == j) & admit[:, None])
            residual = torch.where(
                admit, residual - energy.gather(-1, j)[:, 0], residual)
            noise_term = torch.where(
                admit, torch.maximum(noise_term, pen.gather(-1, j)[:, 0]),
                noise_term)
            cur = torch.where(admit, e_j, cur)
            count = count + admit.to(torch.int64)
            admitting = admit
        lane = torch.arange(k, device=m_arr.device)
        return sel, lane < count[:, None]
