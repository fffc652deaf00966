"""The joint MA+MS optimization problem P'' (Eq. 21–24) as an object — port
of ``repro.core.problem``.

Bundles the three ingredients the solvers need:

* ``LayerProfile``  — per-unit compute/communication quantities (Eq. 11–16),
* ``SystemSpec``    — the multi-tier resource topology,
* ``HyperSpec``     — the convergence-bound constants (Theorem 1),

and exposes the exact objective

    Θ'(I, μ) = (2ϑ/γ) · N(I, μ) / D(I, μ)
    N = T_S(μ) + Σ_{m<M} T_{m,A}(μ) / I_m            (latency numerator)
    D = c − κ · Σ_{m<M} 1{I_m>1} I_m² d_m(μ)         (bound denominator)

with c, κ from ``bound_constants`` and d_m(μ) the tier-m sum of G_l².
A schedule is *feasible* iff D > 0 (the bound can reach ε) and the memory
constraint C5 holds.

The latency terms T_S / T_{m,A} default to the nominal point estimates of
Eqs. (17)–(18); an optional ``latency_model`` (any object with
``split_T(cuts)`` / ``agg_T(cuts, m)`` — see ``repro_torch.sim.robust``) swaps in
empirical per-round quantiles from a fleet-simulation trace, so the same
solvers optimize against heterogeneous / straggler / churn regimes.

An optional ``compression`` (``repro.compress.CompressionSpec``) prices a
lossy wire on both sides of the fraction: per-link byte ratios shrink the
latency numerator (Eqs. 12–16), ω shrinks the denominator headroom c
(Theorem 1's σ² → (1+ω)σ²).  When a trace-based ``latency_model`` is
attached it must price the same ratios itself (``robust_problem`` wires
this up); ω always enters through ``constants()`` here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import (
    TYPE_CHECKING,
    Iterator,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
)

import numpy as np

from ..compress.base import CompressionSpec

from .convergence import (
    HyperSpec,
    ParticipationSpec,
    bound_constants,
    participation_rates,
    tier_G2_sums,
)
from .latency import (
    LayerProfile,
    SystemSpec,
    aggregation_latency,
    memory_ok,
    split_latency,
)

if TYPE_CHECKING:  # pragma: no cover - type hints only (no import cycle)
    from ..energy import EnergySpec
    from ..faults import FaultSpec
    from ..privacy import PrivacySpec

INFEASIBLE = float("inf")


class LatencyModel(Protocol):
    """Pluggable pricing of the latency terms (nominal or trace-based)."""

    def split_T(self, cuts: Sequence[int]) -> float: ...

    def agg_T(self, cuts: Sequence[int], m: int) -> float: ...


@dataclass(frozen=True)
class HsflProblem:
    profile: LayerProfile
    system: SystemSpec
    hyper: HyperSpec
    eps: float
    latency_model: Optional[LatencyModel] = None
    compression: Optional[CompressionSpec] = None
    participation: Optional[ParticipationSpec] = None
    privacy: Optional["PrivacySpec"] = None
    energy: Optional["EnergySpec"] = None
    faults: Optional["FaultSpec"] = None

    @property
    def M(self) -> int:
        return self.system.M

    @property
    def n_units(self) -> int:
        return self.profile.n_units

    @property
    def omega(self) -> float:
        """Compression-error second moment ω (0 for the f32 wire)."""
        return 0.0 if self.compression is None else self.compression.omega

    @property
    def q(self) -> np.ndarray:
        """Per-tier participation rates q_m ``[M]`` (all ones when full)."""
        return participation_rates(self.participation, self.M)

    def with_participation(
        self, participation: Optional[ParticipationSpec]
    ) -> "HsflProblem":
        """The same problem under straggler-aware partial participation
        (DESIGN.md §12): the Theorem-1 terms inflate by 1/q_m, and — when
        the spec carries a ``deadline`` and no trace ``latency_model`` is
        attached — the nominal T_S is capped at the deadline (a round
        never waits past the barrier).

        Like ``with_compression``, this refuses to change the regime under
        an attached ``latency_model``: a trace model's cached latencies
        price one participation policy, so swapping the spec alone would
        leave the latency and bound sides describing different deadlines.
        Compose both at once with ``repro.sim.participation_problem`` (or
        declare a ``participation`` section in an ``ExperimentSpec``).
        """
        if participation is not None:
            participation.validate_for(self.M)
        if self.latency_model is not None and participation != self.participation:
            raise ValueError(
                "cannot change participation under an attached latency_model "
                "(its latencies price the old policy); compose trace pricing "
                "and the participation spec together via "
                "repro.sim.participation_problem, or declare a participation "
                "section in an ExperimentSpec and let repro.api.build "
                "resolve the composition"
            )
        return dataclasses.replace(self, participation=participation)

    def with_compression(self, compression: Optional[CompressionSpec]) -> "HsflProblem":
        """The same problem priced over a compressed wire: byte ratios enter
        the latency terms (Eqs. 12–16), ω enters the bound denominator —
        the solvers then re-optimize (I, μ) under both, unchanged.

        Refuses to change the wire under an attached ``latency_model``: the
        model's cached quantiles price the *old* wire, so ω and the latency
        terms would describe two different codecs.  Attach compression
        first, then re-price (``robust_problem`` threads it to the trace) —
        or declare both in one ``ExperimentSpec`` and let ``repro.api.build``
        resolve the ordering automatically.
        """
        if compression is not None:
            compression.validate_for(self.M)
        if self.latency_model is not None and compression != self.compression:
            raise ValueError(
                "cannot change compression under an attached latency_model "
                "(its quantiles price the old wire); set compression on the "
                "base problem and re-attach via robust_problem, or declare "
                "compression + scenario in an ExperimentSpec and let "
                "repro.api.build resolve the composition order"
            )
        return dataclasses.replace(self, compression=compression)

    @property
    def retry_mult(self) -> Optional[float]:
        """Expected link attempts per traversal under the fault spec
        (DESIGN.md §16) — None when no faults / no link failures, keeping
        the zero-fault latency arithmetic untouched bit-for-bit."""
        return None if self.faults is None else self.faults.retry_mult

    def with_faults(self, faults: Optional["FaultSpec"]) -> "HsflProblem":
        """The same problem priced under a fault regime (DESIGN.md §16):
        link payloads inflate by the expected retry-attempt count in both
        the scalar chain and the batched lattice tables.  Fault-driven
        participation loss enters separately via ``with_participation``
        (``faults.deflate_participation``), keeping q-deflation and retry
        pricing independently composable.

        Refuses to change the regime under an attached ``latency_model``
        (same contract as ``with_compression``): a trace model's cached
        latencies price one fault regime; compose them together via
        ``repro.sim`` (``faults.faulty_trace`` before pricing) or an
        ``ExperimentSpec`` faults section.
        """
        if faults is not None:
            faults.validate_for(self.M, self.system.entities)
        if self.latency_model is not None and faults != self.faults:
            raise ValueError(
                "cannot change faults under an attached latency_model (its "
                "latencies price the old regime); wrap the trace with "
                "faults.faulty_trace before pricing, or declare a faults "
                "section in an ExperimentSpec and let repro.api.build "
                "resolve the composition"
            )
        return dataclasses.replace(self, faults=faults)

    def with_privacy(self, privacy: Optional["PrivacySpec"]) -> "HsflProblem":
        """The same problem under a DP-noised fed uplink (DESIGN.md §15):
        σ²_DP joins the bound's variance term through ``constants()`` and
        the (ε, δ) budget becomes the denominator floor ``d_min()``."""
        return dataclasses.replace(self, privacy=privacy)

    def with_energy(self, energy: Optional["EnergySpec"]) -> "HsflProblem":
        """The same problem under per-tier energy pricing (DESIGN.md §15):
        a ``budget_j_per_round`` masks schedules with E(I, μ) above it —
        energy never enters the Θ' arithmetic."""
        if energy is not None:
            energy.validate_for(self.M)
        return dataclasses.replace(self, energy=energy)

    # ------------------------------------------------------------------ #
    # objective pieces
    # ------------------------------------------------------------------ #
    @property
    def dp_sigma2(self) -> float:
        """Per-round DP uplink noise mass σ²_DP (0 for the noiseless wire)."""
        return 0.0 if self.privacy is None else self.privacy.dp_sigma2

    def constants(self) -> Tuple[float, float]:
        """(c, κ) of the bound denominator (ω-inflated under compression,
        1/q_1-inflated under partial participation, σ²_DP-shrunk under a
        DP-noised uplink).

        Memoized on the instance: every input is a frozen field, and the
        scalar solvers re-read (c, κ) at each coordinate step — which the
        adaptive controller turns into a per-round hot path."""
        cached = self.__dict__.get("_constants_cache")
        if cached is None:
            q1 = 1.0 if self.participation is None else self.q[0]
            cached = bound_constants(
                self.hyper, self.eps, omega=self.omega, q1=q1,
                dp_sigma2=self.dp_sigma2,
            )
            self.__dict__["_constants_cache"] = cached
        return cached

    def d_min(self) -> float:
        """Denominator floor from the privacy budget (DESIGN.md §15).

        Corollary 1 gives R(I, μ) = 2θ₀/(γ·D), so the accountant's round
        cap R ≤ R_max is exactly D ≥ 2θ₀/(γ·R_max) — one uniform
        threshold every feasibility site compares D against.  Without a
        budget this is 0.0, making ``D > d_min`` bit-identical to the
        unconstrained ``D > 0`` check; an unaffordable budget (R_max = 0)
        returns +inf, marking every schedule infeasible.
        """
        cached = self.__dict__.get("_d_min_cache")
        if cached is None:
            cached = 0.0
            if self.privacy is not None and self.privacy.epsilon_budget is not None:
                rmax = self.privacy.max_rounds(sampling_rate=float(self.q[0]))
                if rmax is not None:
                    if rmax <= 0:
                        cached = INFEASIBLE
                    else:
                        cached = 2.0 * self.hyper.theta0 / (
                            self.hyper.gamma * rmax
                        )
            self.__dict__["_d_min_cache"] = cached
        return cached

    def tier_d(self, cuts: Sequence[int]) -> np.ndarray:
        """d_m(μ) = Σ_{l ∈ tier m} G_l² for all tiers — inflated to d_m/q_m
        under partial participation (DESIGN.md §12; the batched lattice
        core applies the identical per-tier division, so scalar and
        batched denominators stay bit-equal).

        Memoized per cut vector (depends only on frozen fields); treat the
        returned array as read-only."""
        cache = self.__dict__.setdefault("_tier_d_cache", {})
        key = tuple(int(c) for c in cuts)
        d = cache.get(key)
        if d is None:
            d = tier_G2_sums(self.hyper.G2, cuts)
            if self.participation is not None:
                d = d / self.q
            cache[key] = d
        return d

    def split_T(self, cuts: Sequence[int]) -> float:
        if self.latency_model is not None:
            return self.latency_model.split_T(cuts)
        t = split_latency(
            self.profile, self.system, cuts, self.compression,
            self.retry_mult,
        )
        if self.participation is not None and self.participation.deadline is not None:
            # nominal view of the deadline barrier: the server never waits
            # past it (trace-based expectation pricing lives in
            # repro.sim.participation.DeadlineLatency)
            t = min(t, self.participation.deadline)
        return t

    def agg_T(self, cuts: Sequence[int]) -> np.ndarray:
        """b_m = T_{m,A} for tiers m < M."""
        if self.latency_model is not None:
            return np.array(
                [self.latency_model.agg_T(cuts, m) for m in range(self.M - 1)]
            )
        return np.array(
            [
                aggregation_latency(
                    self.profile, self.system, cuts, m, self.compression,
                    self.retry_mult,
                )
                for m in range(self.M - 1)
            ]
        )

    def total_T(
        self, intervals: Sequence[int], cuts: Sequence[int], R: float
    ) -> float:
        """T(I, μ) of Eq. (19) under this problem's latency pricing."""
        tot = R * self.split_T(cuts)
        b = self.agg_T(cuts)
        for m in range(self.M - 1):
            tot += np.floor(R / intervals[m]) * b[m]
        return float(tot)

    def numerator(self, intervals: Sequence[int], cuts: Sequence[int]) -> float:
        b = self.agg_T(cuts)
        return self.split_T(cuts) + float(
            np.sum(b / np.asarray(intervals[: self.M - 1], dtype=float))
        )

    def denominator(self, intervals: Sequence[int], cuts: Sequence[int]) -> float:
        c, kappa = self.constants()
        d = self.tier_d(cuts)
        s = sum(
            (I**2) * dm
            for I, dm in zip(intervals[: self.M - 1], d[: self.M - 1])
            if I > 1
        )
        return c - kappa * s

    def theta(self, intervals: Sequence[int], cuts: Sequence[int]) -> float:
        """Exact Θ'(I, μ); +inf when infeasible (D ≤ d_min, C5 violated,
        or the round energy exceeds the budget)."""
        if not self.memory_feasible(cuts):
            return INFEASIBLE
        D = self.denominator(intervals, cuts)
        if D <= self.d_min():
            return INFEASIBLE
        if not self.energy_feasible(intervals, cuts):
            return INFEASIBLE
        return (
            2.0
            * self.hyper.theta0
            / self.hyper.gamma
            * self.numerator(intervals, cuts)
            / D
        )

    def rounds(self, intervals: Sequence[int], cuts: Sequence[int]) -> Optional[float]:
        """R(I, μ) of Corollary 1 (None if unreachable, or if reaching ε
        would overrun the privacy budget's round cap)."""
        D = self.denominator(intervals, cuts)
        if D <= self.d_min():
            return None
        return 2.0 * self.hyper.theta0 / (self.hyper.gamma * D)

    # ------------------------------------------------------------------ #
    # energy pricing (DESIGN.md §15)
    # ------------------------------------------------------------------ #
    def round_energy(
        self, intervals: Sequence[int], cuts: Sequence[int]
    ) -> Optional[float]:
        """E(I, μ) in joules under the attached ``EnergySpec`` (None when
        no spec is attached) — the scalar canonical-chain oracle."""
        if self.energy is None:
            return None
        from ..energy import round_energy

        return round_energy(
            self.profile, self.system, self.energy, cuts, intervals,
            self.compression,
        )

    def energy_feasible(
        self, intervals: Sequence[int], cuts: Sequence[int]
    ) -> bool:
        """E(I, μ) ≤ budget; vacuously True without a spec or budget, so
        the unconstrained path never prices energy at all."""
        if self.energy is None or self.energy.budget_j_per_round is None:
            return True
        e = self.round_energy(intervals, cuts)
        return e <= self.energy.budget_j_per_round

    # ------------------------------------------------------------------ #
    # constraints
    # ------------------------------------------------------------------ #
    def memory_feasible(self, cuts: Sequence[int]) -> bool:
        """C5, memoized per cut vector — a pure function of the frozen
        profile/system, re-asked for the same few cuts thousands of times
        by the scalar walk and the controller's warm re-solves."""
        cache = self.__dict__.setdefault("_memory_cache", {})
        key = tuple(int(c) for c in cuts)
        ok = cache.get(key)
        if ok is None:
            ok = cache[key] = memory_ok(self.profile, self.system, cuts)
        return ok

    def valid_cuts(self, cuts: Sequence[int]) -> bool:
        """C2–C4: M−1 non-decreasing boundaries within [0, U]."""
        if len(cuts) != self.M - 1:
            return False
        prev = 0
        for cval in cuts:
            if cval < prev or cval > self.n_units:
                return False
            prev = cval
        return True

    def cut_lattice(self, min_tier_units: int = 1) -> np.ndarray:
        """The C2–C4-valid cut lattice as one memoized ``[K, M-1]`` int
        array (row order == ``iter_cut_vectors``), shared by every solver
        — the scalar Dinkelbach walk, ``solve_ms_bruteforce``, and the
        batched core all read this one materialization instead of
        re-generating and re-filtering it per call.

        The cache lives on the instance: ``with_compression`` (and any
        ``dataclasses.replace``) returns a NEW problem, so derived
        problems re-materialize against their own wire/caches.
        """
        cache = self.__dict__.setdefault("_lattice_cache", {})
        lat = cache.get(min_tier_units)
        if lat is None:
            from .batched import cut_lattice

            lat = cache[min_tier_units] = cut_lattice(
                self.n_units, self.M, min_tier_units
            )
        return lat

    def evaluator(self, backend: str = "auto"):
        """The memoized whole-lattice ``BatchedEvaluator`` (DESIGN.md §11).

        Built once per (problem instance, resolved backend): BCD's
        repeated MS solves share one latency-table build.  Results are
        bit-identical across backends and to the scalar walk.

        The memo assumes a frozen problem — which holds for the static
        latency models (``TraceLatency``/``DeadlineLatency`` never mutate
        after construction).  A *mutable* model (the controller's
        ``WindowedLatency``, whose tables change every observed round)
        must advertise a monotone ``version`` attribute: the memo stores
        the version the tables were built against and rebuilds when it
        has moved, so a mid-run control step never reads stale split/agg
        tables.  Models without ``version`` keep the frozen fast path.
        """
        from .batched import BatchedEvaluator, resolve_backend

        be = resolve_backend(
            backend,
            work_elems=self.cut_lattice().shape[0] * self.system.num_clients,
        )
        token = getattr(self.latency_model, "version", None)
        cache = self.__dict__.setdefault("_evaluator_cache", {})
        hit = cache.get(be)
        if hit is not None and hit[1] == token:
            return hit[0]
        ev = BatchedEvaluator(self, backend=be)
        cache[be] = (ev, token)
        return ev

    # ------------------------------------------------------------------ #
    # per-class cut assignment (DESIGN.md §14)
    # ------------------------------------------------------------------ #
    def class_theta(self, spec, intervals: Sequence[int]) -> float:
        """Exact Θ'(I, {μ_c}) for a ``classes.CutClassSpec`` — delegates to
        the per-class oracle (``core.classes``), which mirrors this
        problem's single-cut arithmetic term for term."""
        from .classes import class_theta

        return class_theta(self, spec, intervals)

    def class_split_T(self, spec) -> float:
        from .classes import class_split_T

        return class_split_T(self, spec)

    def class_agg_T(self, spec) -> np.ndarray:
        from .classes import class_agg_T

        return class_agg_T(self, spec)

    def class_tier_d(self, spec) -> np.ndarray:
        from .classes import class_tier_d

        return class_tier_d(self, spec)

    def invalidate_caches(self) -> None:
        """Explicitly drop the memoized lattice and evaluator tables.

        For callers that replace or mutate the attached system/latency
        model in place and cannot (or do not want to) rely on the
        ``version`` protocol above — after this, the next ``evaluator()``
        or ``cut_lattice()`` call rebuilds from the live model.
        """
        self.__dict__.pop("_evaluator_cache", None)
        self.__dict__.pop("_lattice_cache", None)
        self.__dict__.pop("_constants_cache", None)
        self.__dict__.pop("_tier_d_cache", None)
        self.__dict__.pop("_memory_cache", None)
        self.__dict__.pop("_d_min_cache", None)

    def iter_cut_vectors(
        self, min_tier_units: int = 1
    ) -> Iterator[Tuple[int, ...]]:
        """All C2–C4-valid cut vectors with every tier holding at least
        ``min_tier_units`` units (the paper requires each tier non-empty so
        the split actually spans the hierarchy).  Yields rows of the
        memoized ``cut_lattice`` in order."""
        for row in self.cut_lattice(min_tier_units):
            yield tuple(int(x) for x in row)
