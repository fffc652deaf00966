"""Straggler-aware partial participation: deadline masks from fleet traces
— port of ``repro.sim.participation``.

The paper's Algorithm 1 waits for every client every round, but any real
multi-tier fleet (DESIGN.md §8) spreads per-round client latencies over
orders of magnitude — a production deployment closes the round at a
*deadline* and drops the stragglers.  This module is the bridge from the
fleet simulator's sampled per-round latencies into everything downstream
(DESIGN.md §12):

* :func:`participation_masks` — replay a ``SystemTrace`` at a cut vector
  and a deadline into per-round boolean client masks (the masks the
  engines consume via ``build_train_step_a/b(with_mask=True)``), per-round
  capped round times, and per-tier participation rates q_m;
* :func:`deadline_for_rate` — invert the policy: the deadline whose pooled
  per-client finish-time quantile hits a target participation rate;
* :func:`estimate_participation` — package the rates as the analytic
  ``ParticipationSpec`` the Theorem-1 bound inflates by 1/q;
* :class:`DeadlineLatency` — a ``LatencyModel`` pricing T_S as the trace
  *expectation* of the deadline-capped round time (a deadline converts the
  straggler max into E[min(deadline, max)]), with whole-lattice batch
  methods for the batched solver core;
* :func:`participation_problem` — compose both sides onto an
  ``HsflProblem`` so BCD/MA/MS trade a tighter deadline (cheaper expected
  rounds) against the 1/q-inflated bound (more rounds to ε).

Conventions (pinned by ``tests/test_participation.py``):

* a zero-**available** round prices split = 0 (nothing runs — the
  events/fleet/lattice convention);
* the server cannot close a round with zero uploads: when every available
  client would miss the barrier, the effective deadline extends to the
  fastest available client's finish — ``d_eff = max(deadline, min finish)``
  — so each round with available clients keeps ≥ 1 participant (the mask
  analogue of the scenario library's ``_ensure_someone``, and what stops a
  solver from "optimizing" into a cut whose rounds are cheap only because
  nobody survives them);
* masks are per-(round, cut): finish times depend on the cut vector, so a
  client can make the deadline under one split and miss it under another;
* a zero-participant *group* (entity) during aggregation keeps its last
  synced params (``tiers.synchronize`` mask semantics).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.convergence import ParticipationSpec
from ..core.latency import aggregation_phases
from ..core.problem import HsflProblem
from .events import round_stage_durations
from .fleet import simulate_lattice_rounds
from .scenarios import SystemTrace


@dataclass(frozen=True)
class ParticipationResult:
    """One trace replay under a deadline, at one cut vector."""

    masks: np.ndarray        # [R, N] bool — available AND finished by deadline
    round_time: np.ndarray   # [R] min(deadline, max over available finish)
    rates: np.ndarray        # [R] participating fraction of the fleet
    q_tier: np.ndarray       # [M] mean per-tier entity participation rates
    deadline: float
    cuts: Tuple[int, ...]

    @property
    def q(self) -> float:
        """Mean client participation rate (== q_tier[0])."""
        return float(self.q_tier[0])

    def spec(self) -> ParticipationSpec:
        """The analytic view the Theorem-1 bound consumes."""
        return ParticipationSpec(
            q=tuple(float(v) for v in self.q_tier), deadline=self.deadline
        )


def _tier_entity_rates(mask: np.ndarray, entities: Sequence[int]) -> np.ndarray:
    """[M] fraction of tier-m entities with ≥1 participating client.

    Entity groups are the contiguous client blocks of ``TierPlan``/
    ``tiers.synchronize``; tier 1's entities are the clients themselves,
    so the first entry is the plain client participation rate.
    """
    N = mask.shape[0]
    return np.array(
        [mask.reshape(J, N // J).any(axis=1).mean() for J in entities]
    )


def per_client_finish_times(
    trace: SystemTrace, r: int, cuts: Sequence[int]
) -> np.ndarray:
    """[N] round-r chain finish times, accumulated in canonical stage order
    (the ``events.round_stage_durations`` arrays — identical bits to both
    sim paths; absent clients still get a hypothetical time, the caller
    masks with ``round_state(r).available``)."""
    _, durs = round_stage_durations(trace, r, cuts)
    t = np.zeros(trace.system.num_clients)
    for d in durs:
        t = t + d
    return t


def participation_masks(
    trace: SystemTrace,
    cuts: Sequence[int],
    deadline: float,
    rounds: Optional[int] = None,
) -> ParticipationResult:
    """Replay the trace at ``cuts`` under ``deadline`` into per-round masks.

    A client participates in round r iff it is available and its canonical
    stage chain finishes by the round's effective deadline
    ``d_eff = max(deadline, fastest available finish)`` — the barrier
    extends until at least one upload lands (module conventions).  Round
    time is the d_eff-capped straggler max over *available* clients (0 for
    a zero-available round).
    """
    if deadline <= 0:
        raise ValueError(f"deadline must be positive: {deadline}")
    R = trace.rounds if rounds is None else min(rounds, trace.rounds)
    system = trace.system
    N, M = system.num_clients, system.M
    cuts = tuple(int(c) for c in cuts)

    masks = np.zeros((R, N), dtype=bool)
    round_time = np.zeros(R)
    q_rounds = np.zeros((R, M))
    for r in range(R):
        avail = trace.round_state(r).available
        t = per_client_finish_times(trace, r, cuts)
        if avail.any():
            d_eff = max(deadline, float(t[avail].min()))
            masks[r] = avail & (t <= d_eff)
            round_time[r] = min(d_eff, float(t[avail].max()))
        q_rounds[r] = _tier_entity_rates(masks[r], system.entities)
    return ParticipationResult(
        masks=masks,
        round_time=round_time,
        rates=masks.mean(axis=1),
        q_tier=q_rounds.mean(axis=0),
        deadline=float(deadline),
        cuts=cuts,
    )


def deadline_for_rate(
    trace: SystemTrace,
    cuts: Sequence[int],
    target_rate: float,
    rounds: Optional[int] = None,
) -> float:
    """The deadline whose pooled per-client finish-time quantile hits
    ``target_rate`` — e.g. 0.5 drops the slower half of client-rounds,
    1.0 waits for everyone (the full-participation barrier)."""
    if not (0.0 < target_rate <= 1.0):
        raise ValueError(f"target_rate must lie in (0, 1]: {target_rate}")
    R = trace.rounds if rounds is None else min(rounds, trace.rounds)
    pooled = []
    for r in range(R):
        avail = trace.round_state(r).available
        if avail.any():
            pooled.append(per_client_finish_times(trace, r, cuts)[avail])
    if not pooled:
        raise ValueError("trace has no available client in any round")
    return float(np.quantile(np.concatenate(pooled), target_rate))


def estimate_participation(
    trace: SystemTrace,
    cuts: Sequence[int],
    deadline: Optional[float] = None,
    target_rate: Optional[float] = None,
    rounds: Optional[int] = None,
) -> ParticipationSpec:
    """Estimate the analytic ``ParticipationSpec`` (q_m per tier + the
    resolved deadline) for one policy — exactly one of ``deadline`` /
    ``target_rate`` must be given."""
    if (deadline is None) == (target_rate is None):
        raise ValueError(
            "give exactly one of deadline= or target_rate= "
            f"(got deadline={deadline!r}, target_rate={target_rate!r})"
        )
    if deadline is None:
        deadline = deadline_for_rate(trace, cuts, target_rate, rounds=rounds)
    res = participation_masks(trace, cuts, deadline, rounds=rounds)
    return res.spec().validate_for(trace.system.M)


class DeadlineLatency:
    """Expected-round-time pricing of the latency terms under a deadline.

    Where ``TraceLatency`` prices T_S at a straggler quantile of the
    *full-participation* round (every round waits for its slowest client),
    a deadline policy never waits past the barrier: T_S(μ) becomes the
    trace expectation E[min(d_eff, max over available finish)] with
    ``d_eff = max(deadline, fastest available finish)`` (module
    conventions), and T_{m,A}(μ) the expectation of the sync priced over
    that round's *participants* (a client that missed the barrier uploads
    nothing).

    Implements the ``LatencyModel`` protocol plus the whole-lattice batch
    methods of the batched solver core — both read the same stage-chain
    arithmetic, so scalar and batched pricing agree bit-for-bit
    (``tests/test_participation.py``).
    """

    def __init__(
        self,
        trace: SystemTrace,
        deadline: float,
        rounds: Optional[int] = None,
        backend: str = "numpy",
    ):
        if deadline <= 0:
            raise ValueError(f"deadline must be positive: {deadline}")
        self.trace = trace
        self.deadline = float(deadline)
        self.rounds = trace.rounds if rounds is None else min(rounds, trace.rounds)
        self.backend = backend
        self._cache: Dict[Tuple[int, ...], Tuple[np.ndarray, np.ndarray]] = {}
        self._lattice_cache: Optional[
            Tuple[bytes, Tuple[np.ndarray, np.ndarray]]
        ] = None

    def per_round(self, cuts: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(capped split [R], participant-masked agg [M-1, R]), cached.

        Round times and participant sets come from ``participation_masks``
        — the one source of truth for the d_eff convention, so the masks
        ``run(mode="train")`` samples and the expectations priced here can
        never describe different policies.
        """
        key = tuple(int(c) for c in cuts)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        trace, system = self.trace, self.trace.system
        N, M = system.num_clients, system.M
        pr = participation_masks(trace, key, self.deadline, rounds=self.rounds)
        split = pr.round_time
        agg = np.zeros((M - 1, self.rounds))
        for r in range(self.rounds):
            state = trace.round_state(r)
            part = pr.masks[r]
            for m in range(M - 1):
                if system.entities[m] <= 1:
                    continue
                up, down = aggregation_phases(
                    trace.profile, system, key, m,
                    up_rate=system.model_up[m] * state.fed_up_mult[m],
                    down_rate=system.model_down[m] * state.fed_down_mult[m],
                    compression=trace.compression,
                )
                if len(up) == N:  # clients host tier m: only participants sync
                    up, down = up[part], down[part]
                    if len(up) == 0:
                        continue  # zero-participant round: sync prices 0
                agg[m, r] = float(up.max()) + float(down.max())
        hit = self._cache[key] = (split, agg)
        return hit

    def per_round_lattice(
        self, lattice: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(split [K, R], agg [K, M-1, R]) for a whole cut lattice, cached."""
        key = lattice.tobytes()
        if self._lattice_cache is not None and self._lattice_cache[0] == key:
            return self._lattice_cache[1]
        res = simulate_lattice_rounds(
            self.trace, lattice, rounds=self.rounds, backend=self.backend,
            deadline=self.deadline,
        )
        self._lattice_cache = (key, res)
        return res

    # ------------------------------------------------------------------ #
    # LatencyModel protocol (expectation pricing)
    # ------------------------------------------------------------------ #
    def split_T(self, cuts: Sequence[int]) -> float:
        split, _ = self.per_round(cuts)
        return float(np.mean(split))

    def agg_T(self, cuts: Sequence[int], m: int) -> float:
        _, agg = self.per_round(cuts)
        return float(np.mean(agg[m]))

    # ------------------------------------------------------------------ #
    # batched lattice protocol (consumed by core.batched.BatchedEvaluator)
    # ------------------------------------------------------------------ #
    def split_T_batch(self, lattice: np.ndarray) -> np.ndarray:
        split, _ = self.per_round_lattice(lattice)
        return np.mean(split, axis=1)

    def agg_T_batch(self, lattice: np.ndarray) -> np.ndarray:
        _, agg = self.per_round_lattice(lattice)
        return np.mean(agg, axis=2)


def participation_problem(
    problem: HsflProblem,
    trace: SystemTrace,
    deadline: Optional[float] = None,
    target_rate: Optional[float] = None,
    cuts: Optional[Sequence[int]] = None,
    rounds: Optional[int] = None,
    backend: str = "numpy",
) -> HsflProblem:
    """The same MA+MS problem under a straggler deadline: latency terms
    become trace expectations of the deadline-capped round
    (``DeadlineLatency``) and the bound inflates by the estimated 1/q_m
    (``ParticipationSpec``) — the solvers then trade deadline-cheapened
    rounds against the extra rounds the inflated bound demands, unchanged.

    Mirrors ``robust_problem``'s compression handling: a compressed
    problem re-prices the (uncompressed) trace over the same wire; a trace
    already on a *different* wire is a configuration error.
    """
    if problem.compression is not None and trace.compression is None:
        trace = trace.with_compression(problem.compression)
    elif trace.compression != problem.compression:
        raise ValueError(
            "trace and problem carry different CompressionSpecs "
            f"({trace.compression} vs {problem.compression}); price both "
            "over one wire (build the trace uncompressed, or attach the "
            "same spec to both)"
        )
    if cuts is None:
        # the shared evenly-spread anchor (solve_bcd's starting point):
        # q_m is estimated here once and held fixed while the solvers move
        # the cut — DESIGN.md §12 discusses the approximation
        from ..core.bcd import default_init_cuts

        cuts = default_init_cuts(problem.n_units, problem.M)
    spec = estimate_participation(
        trace, cuts, deadline=deadline, target_rate=target_rate, rounds=rounds
    )
    model = DeadlineLatency(trace, spec.deadline, rounds=rounds, backend=backend)
    return dataclasses.replace(
        problem, latency_model=model, participation=spec
    )
