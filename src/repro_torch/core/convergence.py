"""Theorem 1 / Corollary 1 of the paper: the HSFL convergence bound — port
of ``repro.core.convergence``.

All quantities are per-*unit* (our cut granularity) rather than per-layer;
this is exact when cut layers are restricted to unit boundaries, since only
tier-sums of G_l² enter the bound.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class ParticipationSpec:
    """Analytic view of straggler-aware partial participation (DESIGN.md §12).

    ``q`` holds the per-tier participation rates q_m ∈ (0, 1]: the expected
    fraction of tier-m entities whose round contribution survives the
    deadline (tier 1's entities are the clients themselves, so q_1 is the
    plain client participation rate).  ``deadline`` is the round barrier in
    seconds that produced those rates (None for a rate-only spec).

    Estimated from a fleet trace by ``repro.sim.participation`` and
    attached to an ``HsflProblem``; the Theorem-1 terms inflate by 1/q —
    uniform participant sampling keeps the aggregate unbiased but averages
    over N·q_1 instead of N gradients (σ² term), and a tier whose syncs
    only reach a q_m fraction of its entities accumulates 1/q_m more
    drift between effective aggregations (G² term).  q ≡ 1 recovers the
    paper's full-participation bound exactly.
    """

    q: Tuple[float, ...]               # per-tier rates, len M
    deadline: Optional[float] = None   # seconds (the policy that produced q)

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(float(v) for v in self.q))
        if self.deadline is not None:
            object.__setattr__(self, "deadline", float(self.deadline))

    def validate_for(self, M: int) -> "ParticipationSpec":
        if len(self.q) != M:
            raise ValueError(
                f"ParticipationSpec has {len(self.q)} tier rates for an "
                f"M={M} system"
            )
        for m, v in enumerate(self.q):
            if not (0.0 < v <= 1.0):
                raise ValueError(
                    f"participation rate q_{m+1}={v} outside (0, 1] — a "
                    "tier that never participates has an unbounded variance "
                    "inflation (loosen the deadline)"
                )
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be positive: {self.deadline}")
        return self


def participation_rates(
    participation: Union[None, float, Sequence[float], ParticipationSpec],
    M: int,
) -> np.ndarray:
    """Normalize a participation argument to per-tier rates ``[M]``.

    Accepts None (full participation), one scalar rate (uniform across
    tiers), a per-tier sequence, or a ``ParticipationSpec``.
    """
    if participation is None:
        return np.ones(M)
    if isinstance(participation, ParticipationSpec):
        participation.validate_for(M)
        return np.asarray(participation.q, dtype=np.float64)
    if isinstance(participation, (int, float)):
        q = np.full(M, float(participation))
    else:
        q = np.asarray([float(v) for v in participation], dtype=np.float64)
        if len(q) != M:
            raise ValueError(f"need {M} per-tier rates, got {len(q)}")
    if np.any(q <= 0) or np.any(q > 1):
        raise ValueError(f"participation rates must lie in (0, 1]: {q}")
    return q


@dataclass(frozen=True)
class HyperSpec:
    """Optimization constants of the bound (estimated or configured)."""
    gamma: float          # learning rate (paper: 5e-4)
    beta: float           # smoothness constant
    theta0: float         # f(w0) - f*
    num_clients: int      # N
    sigma2: np.ndarray    # per-unit gradient variance bounds   [U]
    G2: np.ndarray        # per-unit second-moment bounds       [U]

    @property
    def sigma2_sum(self) -> float:
        return float(np.sum(self.sigma2))


def tier_G2_sums(G2: np.ndarray, cuts: Sequence[int]) -> np.ndarray:
    """Σ_{l in tier m} G_l² for every tier (M = len(cuts)+1).

    Computed as leading-zero cumsum differences — the canonical tier-sum
    arithmetic shared with the batched lattice core
    (``core.batched.tier_d_lattice``), so scalar and batched d_m agree
    bit-for-bit.
    """
    bounds = [0, *cuts, len(G2)]
    cs = np.concatenate(([0.0], np.cumsum(np.asarray(G2, dtype=np.float64))))
    return np.array(
        [float(cs[bounds[m + 1]] - cs[bounds[m]]) for m in range(len(bounds) - 1)]
    )


def class_weighted_G2_sums(
    G2: np.ndarray,
    class_cuts: Sequence[Sequence[int]],
    weights: Sequence[float],
) -> np.ndarray:
    """Class-weighted tier drift mass d̄_m = Σ_c (n_c/N) · d_m(μ_c).

    Under per-class split points (DESIGN.md §14) the Theorem-1 drift term
    averages each class's tier-m G² mass by its client share: tier m's
    divergence accumulates per client over *that client's* tier-m units,
    and the round averages clients uniformly.  Accumulated in class order
    with one multiply-add per class, so a single class (w = [1.0]) is
    bit-identical to ``tier_G2_sums`` and power-of-two equal shares
    collapse exactly when all classes hold the same cuts.
    """
    d = weights[0] * tier_G2_sums(G2, class_cuts[0])
    for w, cc in zip(weights[1:], class_cuts[1:]):
        d = d + w * tier_G2_sums(G2, cc)
    return d


def staleness_rounds(
    staleness: Union[None, int, Sequence[int]],
    M: int,
) -> np.ndarray:
    """Normalize a staleness argument to per-tier round counts ``[M]``.

    Accepts None (synchronous — every sync applies the round it is
    computed), one scalar bound (uniform across the async tiers), or a
    per-tier sequence s_m ≥ 0.  The top tier's entry is accepted but
    inert: the drift sum excludes tier M exactly as it excludes its
    interval (the cloud sync defines the round boundary).
    """
    if staleness is None:
        return np.zeros(M, dtype=np.int64)
    if isinstance(staleness, (int, np.integer)):
        s = np.full(M, int(staleness), dtype=np.int64)
    else:
        s = np.asarray([int(v) for v in staleness], dtype=np.int64)
        if len(s) != M:
            raise ValueError(f"need {M} per-tier staleness bounds, got {len(s)}")
    if np.any(s < 0):
        raise ValueError(f"staleness bounds must be >= 0: {s}")
    return s


def bound_round_terms(
    hp: HyperSpec,
    intervals: Sequence[int],
    cuts: Sequence[int],
    omega: float = 0.0,
    participation: Union[None, float, Sequence[float], ParticipationSpec] = None,
    dp_sigma2: float = 0.0,
    staleness: Union[None, int, Sequence[int]] = None,
) -> Tuple[float, float]:
    """The two R-independent (per-round) terms of Eq. (8): (variance, drift).

    Factored out of ``theorem1_bound`` so the piecewise composition of the
    bound across mid-run control switches (``repro.control.bound``) prices
    each segment's schedule with the *identical* arithmetic — that is what
    makes the single-segment composition collapse bit-exactly to the
    static bound.

    ``dp_sigma2`` (DESIGN.md §15) is the per-round DP noise mass injected
    at the client→fed-server uploads: per-coordinate Gaussian noise of
    variance (z·C)² summed over the clipped update's coordinates.  It
    joins the variance term as a *separate* additive contribution, gated
    on being nonzero, so the noiseless path evaluates the exact same
    float expression as before DP existed (bit-exact collapse).

    ``staleness`` (DESIGN.md §17) is the bounded-staleness budget of the
    async aggregation mode: a tier-m sync computed at round r lands at
    most s_m rounds later, so client drift accumulates for up to
    I_m + s_m rounds between *effective* aggregations and the drift term
    reads (I_m + s_m)² in place of I_m².  The inflation is a separate
    additive correction gated per tier on s_m > 0 — the s ≡ 0 path
    evaluates the exact pre-async float expression (bit-exact collapse,
    the same contract omega / participation / dp_sigma2 honor).  A tier
    with I_m = 1 but s_m > 0 drifts too (its every-round sync lands
    late), contributing the full (1 + s_m)².
    """
    g, b = hp.gamma, hp.beta
    M = len(intervals)
    q = participation_rates(participation, M)
    d = tier_G2_sums(hp.G2, cuts)
    term2 = b * g * (1.0 + omega) * hp.sigma2_sum / (hp.num_clients * q[0])
    if dp_sigma2:
        term2 += b * g * dp_sigma2 / (hp.num_clients * q[0])
    term3 = 4.0 * b**2 * g**2 * sum(
        (I**2) * (dm / qm)
        for I, dm, qm in zip(intervals[:-1], d[:-1], q[:-1])
        if I > 1
    )
    s = staleness_rounds(staleness, M)
    if np.any(s[:-1] > 0):
        term3 += 4.0 * b**2 * g**2 * sum(
            ((I + sm) ** 2 - (I**2 if I > 1 else 0.0)) * (dm / qm)
            for I, sm, dm, qm in zip(intervals[:-1], s[:-1], d[:-1], q[:-1])
            if sm > 0
        )
    return term2, term3


def theorem1_bound(
    hp: HyperSpec,
    R: int,
    intervals: Sequence[int],
    cuts: Sequence[int],
    omega: float = 0.0,
    participation: Union[None, float, Sequence[float], ParticipationSpec] = None,
    dp_sigma2: float = 0.0,
    staleness: Union[None, int, Sequence[int]] = None,
) -> float:
    """RHS of Eq. (8): bound on (1/R) Σ_t E||∇f||².

    ``omega`` is the compression-error second moment ω of a lossy
    aggregation wire (DESIGN.md §9): an unbiased codec with
    E‖C(g) − g‖² ≤ ω‖g‖² inflates the stochastic-gradient variance term
    to (1 + ω)σ², leaving the drift term untouched.  ω = 0 recovers the
    paper's full-precision bound exactly.

    ``participation`` (per-tier rates q_m, a scalar rate, or a
    ``ParticipationSpec`` — DESIGN.md §12) inflates the variance term by
    1/q_1 (the round averages over N·q_1 client gradients) and every
    tier's drift term by 1/q_m (syncs only land on the participating
    fraction of entities).  None recovers full participation exactly.

    ``dp_sigma2`` adds the DP uplink noise mass to the variance term
    (see ``bound_round_terms``); 0 recovers the noiseless bound exactly.

    ``staleness`` inflates the drift term to (I_m + s_m)² per tier under
    the bounded-staleness async mode (see ``bound_round_terms``); None or
    all-zero recovers the synchronous bound bit-exactly.
    """
    term1 = 2.0 * hp.theta0 / (hp.gamma * R)
    term2, term3 = bound_round_terms(
        hp, intervals, cuts, omega, participation, dp_sigma2, staleness
    )
    return term1 + term2 + term3


def corollary1_rounds(
    hp: HyperSpec,
    eps: float,
    intervals: Sequence[int],
    cuts: Sequence[int],
    omega: float = 0.0,
    participation: Union[None, float, Sequence[float], ParticipationSpec] = None,
    dp_sigma2: float = 0.0,
    staleness: Union[None, int, Sequence[int]] = None,
) -> Optional[float]:
    """Eq. (10): rounds to reach target ε; None if the schedule cannot reach ε."""
    g, b = hp.gamma, hp.beta
    M = len(intervals)
    q = participation_rates(participation, M)
    d = tier_G2_sums(hp.G2, cuts)
    denom = eps - b * g * (1.0 + omega) * hp.sigma2_sum / (hp.num_clients * q[0])
    if dp_sigma2:
        denom -= b * g * dp_sigma2 / (hp.num_clients * q[0])
    denom -= 4.0 * b**2 * g**2 * sum(
        (I**2) * (dm / qm)
        for I, dm, qm in zip(intervals[:-1], d[:-1], q[:-1])
        if I > 1
    )
    s = staleness_rounds(staleness, M)
    if np.any(s[:-1] > 0):
        denom -= 4.0 * b**2 * g**2 * sum(
            ((I + sm) ** 2 - (I**2 if I > 1 else 0.0)) * (dm / qm)
            for I, sm, dm, qm in zip(intervals[:-1], s[:-1], d[:-1], q[:-1])
            if sm > 0
        )
    if denom <= 0:
        return None
    return 2.0 * hp.theta0 / (g * denom)


def stale_interval_weights(
    intervals: Sequence[int],
    staleness: Union[None, int, Sequence[int]] = None,
) -> np.ndarray:
    """Per-tier drift weights w_m for the denominator D = c − κ·Σ w_m·d_m.

    Synchronously w_m = 1{I_m > 1}·I_m² — exactly the sum
    ``bound_constants`` documents.  Under a bounded-staleness budget the
    same gated additive correction as ``bound_round_terms`` lifts a
    stale tier to (I_m + s_m)², so a solver pricing an async schedule
    through (c, κ) uses arithmetic identical to the bound itself.  The
    top tier's weight is always 0 (its sync defines the round boundary).
    ``staleness`` None / all-zero reproduces the synchronous weights
    bit-exactly.
    """
    M = len(intervals)
    s = staleness_rounds(staleness, M)
    w = np.zeros(M, dtype=np.float64)
    for m, I in enumerate(intervals[:-1]):
        base = float(I) ** 2 if I > 1 else 0.0
        w[m] = base
        if s[m] > 0:
            w[m] = base + ((float(I) + float(s[m])) ** 2 - base)
    return w


def bound_constants(
    hp: HyperSpec,
    eps: float,
    omega: float = 0.0,
    q1: float = 1.0,
    dp_sigma2: float = 0.0,
) -> Tuple[float, float]:
    """(c, kappa) with denominator = c - kappa * Σ 1{I>1} I² d_m  (Eq. 22/24).

    ω shrinks c (the ε headroom left after the (1+ω)-inflated variance
    term), which is how compression noise reaches the MA/MS solvers;
    ``q1`` < 1 (the client participation rate, DESIGN.md §12) shrinks it
    further — a round only averages N·q_1 stochastic gradients.  The
    per-tier drift inflation 1/q_m enters through ``HsflProblem.tier_d``
    instead (it scales d_m, not the shared κ).  ``dp_sigma2`` (DESIGN.md
    §15) shrinks c by the DP uplink noise mass as a *separate* gated
    subtraction, never restructuring the existing float expression, so
    dp_sigma2 = 0 is bit-identical to the noiseless constants.

    Bounded-staleness async aggregation (DESIGN.md §17) leaves (c, κ)
    untouched: staleness inflates the *schedule-side* drift sum — swap
    the 1{I>1}·I² weights for ``stale_interval_weights(intervals,
    staleness)`` — exactly as per-tier participation enters through
    ``HsflProblem.tier_d`` rather than through κ.
    """
    c = eps - hp.beta * hp.gamma * (1.0 + omega) * hp.sigma2_sum / (
        hp.num_clients * q1
    )
    if dp_sigma2:
        c -= hp.beta * hp.gamma * dp_sigma2 / (hp.num_clients * q1)
    kappa = 4.0 * hp.beta**2 * hp.gamma**2
    return c, kappa


def synthetic_hyperspec(
    n_units: int,
    num_clients: int,
    gamma: float = 5e-4,
    beta: float = 50.0,
    theta0: float = 5.0,
    g2_scale: float = 20.0,
    sigma2_scale: float = 4.0,
    decay: float = 0.9,
    seed: int = 0,
) -> HyperSpec:
    """Plausible per-unit G²/σ² profile (earlier layers larger, as in CNN/LLM
    practice); used where no estimation run is available."""
    rng = np.random.default_rng(seed)
    prof = decay ** np.arange(n_units)
    jitter = rng.uniform(0.8, 1.2, n_units)
    return HyperSpec(
        gamma=gamma,
        beta=beta,
        theta0=theta0,
        num_clients=num_clients,
        sigma2=sigma2_scale * prof * jitter,
        G2=g2_scale * prof * jitter,
    )
