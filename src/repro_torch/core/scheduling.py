"""User scheduling for FL over NOMA (paper §III), main-path part.

The port's float64 numpy copy of the host control plane in
``repro.core.scheduling``: the policy registry, the shared finalization
(power allocation + SIC rates, :func:`finalize_schedule`), and the paper's
lazy GWMIN MWIS greedy (``lazy-gwmin``) with the numpy backend, plus the
``round-robin`` baseline.  Every function is the reference's op for op, so
schedules, powers and rates are bit-identical to it, T*K > M tails included
(tests/test_torch_control_plane.py).

Policies are looked up by name (:func:`register_policy` /
:func:`get_policy`).  A precomputed policy plans the whole horizon in
``init_state`` and replays it in ``select_round``.  The reference's other
policies (literal-gwmin, random, proportional-fair and the online ones)
come with later slices of the port (``ROADMAP.md`` queue 1);
:data:`REFERENCE_POLICIES` names them so configuration checks can tell "not
ported yet" from "unknown".

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
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import errors
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

REFERENCE_POLICIES = (
    "age-fair", "lazy-gwmin", "literal-gwmin", "matching-pursuit",
    "proportional-fair", "random", "round-robin", "update-aware",
)
# every policy the reference registers; the ones missing from this
# module's registry raise NotImplementedError in FLConfig

REFERENCE_ONLINE_POLICIES = ("age-fair", "matching-pursuit", "update-aware")


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
    float32) and the vertex shard count, which clamps to the cards
    available (the port scores every vertex on ``device``).
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
    shards: "int | None" = None     # fused-backend vertex shards (clamped)
    device: "str | torch.device | None" = None   # device backends' device;
                                    # None = cuda (repro_torch.device)
    seed: int = 0


_REGISTRY: "dict[str, type]" = {}


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


def get_policy(name: str, **options):
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


def build_schedule(
    policy, gains_tm, weights_m, cfg: PolicyConfig
) -> Schedule:
    """Plan the whole horizon with a precomputed policy and finalize it.

    Precomputed policies run their one-shot plan in ``init_state``; this is
    plan + shared finalization, as in the reference.  Online policies (the
    reference drives them with rate feedback here) come with a later slice.
    """
    gains_tm = np.asarray(gains_tm)
    weights_m = np.asarray(weights_m)
    num_rounds, num_devices = gains_tm.shape
    if getattr(policy, "online", False):
        raise NotImplementedError(errors.ERR_NOT_PORTED.format(
            feature=f"online policy {policy.name!r}", item=5,
        ))
    power_fn = power_lib.make_power_allocator(
        cfg.power_mode, cfg.pmax, cfg.noise_power
    )
    state = policy.init_state(gains_tm, weights_m, cfg)
    rounds = [
        tuple(int(d) for d in policy.select_round(t, state, None)[0])
        for t in range(num_rounds)
    ]
    sched = finalize_schedule(
        rounds, gains_tm, weights_m, power_fn, cfg.noise_power, policy.name
    )
    sched.allow_revisits = not getattr(policy, "respects_c1", True)
    sched.validate(num_devices, cfg.group_size)
    return sched


class _PrecomputedPolicy:
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
