"""Heterogeneity-aware per-class cut assignment (HASFL-style, DESIGN.md §14)
— port of ``repro.core.classes``.

The paper optimizes ONE model-splitting vector μ for the whole fleet.  When
device capabilities span orders of magnitude (the lognormal spreads the
fleet simulator generates), a single cut leaves speed on the table: slow
clients want shallow client-side stacks, fast clients can host more.  This
module lets *client classes* hold different split points:

* :class:`CutClassSpec` — the assignment (clients → classes) plus one cut
  vector per class;
* scalar oracle functions (``class_split_T`` / ``class_agg_T`` /
  ``class_tier_d`` / ``class_theta``) that price a per-class schedule with
  the exact arithmetic of ``HsflProblem`` — a single class collapses
  bit-for-bit to the single-cut objective;
* :class:`ClassBatchedEvaluator` — the whole *product* of per-class cut
  lattices ``[K₁×…×K_C]`` evaluated as array arithmetic over assignment
  index matrices (numpy|torch chain backends, same tables as
  ``core.batched``);
* ``solve_ms_classes`` / ``solve_ma_classes`` / ``solve_bcd_classes`` —
  the per-class MS/MA/BCD solvers.  MS enumerates the full lattice product
  when it fits the row budget and otherwise coordinate-descends over
  classes from the single-cut optimum (so the per-class objective is never
  worse than the best single cut, by construction).

Objective semantics.  The round latency T_S is the max over *all* clients
of the canonical stage chain priced at each client's own class cuts.  A
tier-m fed-server sync moves, per entity, the *union* of its member
classes' tier-m unit ranges ``[min_c lo_c, max_c hi_c)`` — clients in one
entity group disagreeing on which units are client-side still synchronize
through one upload whose payload covers every member's tier-m slice (the
ragged aggregation of ``tiers.ragged_synchronize``).  The bound denominator
uses the class-weighted drift mass d̄_m = Σ_c (n_c/N)·d_m(μ_c)
(``convergence.class_weighted_G2_sums``).  Memory (C5) must hold for every
entity's union range.

Trace-based ``latency_model`` pricing of per-class cuts is not implemented
(the attached models price one cut vector per row); constructing a
per-class problem over a trace raises with a pointer here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compress.base import model_ratio
from .batched import (
    chain_sums_torch,
    lattice_bounds,
    nominal_stage_rates,
    resolve_backend,
    split_work_tensor,
    tier_d_lattice,
    torch_device,
)
from .convergence import class_weighted_G2_sums
from .latency import BITS, per_client_split_latency
from .ma_solver import MaSolution, _candidate_intervals, _theta_candidates
from .ms_solver import _INFEASIBLE_MSG, solve_ms
from .problem import INFEASIBLE, HsflProblem


_LATENCY_MODEL_MSG = (
    "per-class cuts are priced nominally: the attached latency_model's "
    "trace tables price one cut vector per lattice row, not a per-class "
    "assignment (price the scenario into the SystemSpec rates instead, "
    "e.g. the 'lognormal-fleet' preset)"
)


# --------------------------------------------------------------------------- #
# the assignment spec
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class CutClassSpec:
    """Clients → classes, plus one cut vector per class.

    ``class_of[i]`` is client i's class id (contiguous ``0..C-1``, every
    class non-empty); ``cuts[c]`` is class c's M-1 cut boundaries.  The
    class *membership* is the search-space structure (it fixes which
    lattice product is optimized and how entities aggregate ragged
    ranges); the per-class ``cuts`` are the decision variables the MS
    solver moves.
    """

    class_of: Tuple[int, ...]              # [N]
    cuts: Tuple[Tuple[int, ...], ...]      # [C][M-1]

    def __post_init__(self):
        object.__setattr__(
            self, "class_of", tuple(int(c) for c in self.class_of)
        )
        object.__setattr__(
            self, "cuts", tuple(tuple(int(x) for x in cc) for cc in self.cuts)
        )
        C = len(self.cuts)
        if C == 0:
            raise ValueError("CutClassSpec needs at least one class")
        ids = set(self.class_of)
        if ids != set(range(C)):
            raise ValueError(
                f"class_of must use contiguous ids 0..{C - 1} with every "
                f"class non-empty; got ids {sorted(ids)} for {C} cut vectors"
            )
        width = len(self.cuts[0])
        for c, cc in enumerate(self.cuts):
            if len(cc) != width:
                raise ValueError(
                    f"every class needs the same number of cuts: class {c} "
                    f"has {len(cc)}, class 0 has {width}"
                )
            if any(cc[i] > cc[i + 1] for i in range(len(cc) - 1)):
                raise ValueError(
                    f"class {c} cuts must be non-decreasing (C4): {cc!r}"
                )
            if any(x < 0 for x in cc):
                raise ValueError(f"class {c} cuts must be >= 0: {cc!r}")

    @property
    def num_classes(self) -> int:
        return len(self.cuts)

    @property
    def num_clients(self) -> int:
        return len(self.class_of)

    def class_sizes(self) -> Tuple[int, ...]:
        sizes = [0] * self.num_classes
        for c in self.class_of:
            sizes[c] += 1
        return tuple(sizes)

    def weights(self) -> np.ndarray:
        """Client-share weights w_c = n_c / N ``[C]``."""
        n = float(self.num_clients)
        return np.array([s / n for s in self.class_sizes()], dtype=np.float64)

    def members(self, c: int) -> np.ndarray:
        """Client indices of class c (sorted)."""
        return np.flatnonzero(np.asarray(self.class_of) == c)

    def client_cuts(self) -> np.ndarray:
        """``[N, M-1]`` each client's own cut vector."""
        table = np.asarray(self.cuts, dtype=np.int64)
        return table[np.asarray(self.class_of)]

    def with_cuts(
        self, cuts: Sequence[Sequence[int]]
    ) -> "CutClassSpec":
        return CutClassSpec(self.class_of, tuple(tuple(c) for c in cuts))

    def is_uniform(self) -> bool:
        """True when every class holds the same cut vector (the spec
        collapses to a single-cut schedule)."""
        return len(set(self.cuts)) == 1

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def uniform(
        cls, num_clients: int, num_classes: int, cuts: Sequence[int]
    ) -> "CutClassSpec":
        """Contiguous equal blocks of clients, every class at ``cuts``."""
        assign = banded_assignment(np.arange(num_clients), num_classes)
        return cls(tuple(assign), tuple(tuple(cuts) for _ in range(num_classes)))

    @classmethod
    def from_rates(
        cls,
        rates: Sequence[float],
        num_classes: int,
        cuts: Sequence[int],
    ) -> "CutClassSpec":
        """Band clients into ``num_classes`` by sorted rate (slowest class
        first), every class initialized at ``cuts``."""
        assign = banded_assignment(np.asarray(rates, dtype=float), num_classes)
        return cls(tuple(assign), tuple(tuple(cuts) for _ in range(num_classes)))


def banded_assignment(rates: np.ndarray, num_classes: int) -> np.ndarray:
    """``[N]`` class ids: sort clients by rate, split into ``num_classes``
    contiguous bands of (near-)equal size — slowest band is class 0.

    Deterministic: ties broken by client index (stable argsort), remainder
    clients spread over the leading bands.
    """
    N = len(rates)
    if not 1 <= num_classes <= N:
        raise ValueError(
            f"num_classes must lie in [1, num_clients={N}]: {num_classes}"
        )
    order = np.argsort(np.asarray(rates), kind="stable")
    base, rem = divmod(N, num_classes)
    assign = np.empty(N, dtype=np.int64)
    start = 0
    for c in range(num_classes):
        size = base + (1 if c < rem else 0)
        assign[order[start : start + size]] = c
        start += size
    return assign


# --------------------------------------------------------------------------- #
# scalar oracle: exact per-class objective pieces (mirrors HsflProblem)
# --------------------------------------------------------------------------- #


def _check_nominal(problem: HsflProblem) -> None:
    if problem.latency_model is not None:
        raise ValueError(_LATENCY_MODEL_MSG)


def _entity_unions(
    spec: CutClassSpec, bounds: np.ndarray, m: int, J: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-entity tier-m union unit ranges ``([J], [J])``.

    ``bounds`` is the [C, M+1] per-class tier-boundary table.  Entity j of
    a J-entity tier hosts clients ``[j·per, (j+1)·per)``; its tier-m slice
    must cover every member class's ``[lo_c, hi_c)``.
    """
    N = spec.num_clients
    per = N // J
    cls = np.asarray(spec.class_of).reshape(J, per)
    lo = bounds[cls, m].min(axis=1)
    hi = bounds[cls, m + 1].max(axis=1)
    return lo, hi


def _class_bounds(spec: CutClassSpec, n_units: int) -> np.ndarray:
    """``[C, M+1]`` per-class tier boundaries 0 | cuts | U."""
    C = spec.num_classes
    table = np.zeros((C, len(spec.cuts[0]) + 2), dtype=np.int64)
    for c, cc in enumerate(spec.cuts):
        table[c] = [0, *cc, n_units]
    return table


def class_split_T(problem: HsflProblem, spec: CutClassSpec) -> float:
    """T_S under per-class cuts: max over clients of the canonical chain
    priced at each client's own class cuts (deadline-capped like
    ``HsflProblem.split_T``)."""
    _check_nominal(problem)
    t = -np.inf
    for c in range(spec.num_classes):
        per_client = per_client_split_latency(
            problem.profile, problem.system, spec.cuts[c],
            problem.compression, problem.retry_mult,
        )
        t = max(t, float(np.max(per_client[spec.members(c)])))
    pp = problem.participation
    if pp is not None and pp.deadline is not None:
        t = min(t, pp.deadline)
    return t


def class_agg_T(problem: HsflProblem, spec: CutClassSpec) -> np.ndarray:
    """``[M-1]`` T_{m,A} with per-entity union payloads.

    Entity j's tier-m upload carries the union of its member classes'
    tier-m slices; the per-entity payload bytes read the same param-bytes
    prefix table as the single-cut path (plus the m=0 frontend extra), so
    identical classes reproduce ``aggregation_latency`` bit-for-bit.
    """
    _check_nominal(problem)
    system, profile = problem.system, problem.profile
    M = problem.M
    bounds = _class_bounds(spec, profile.n_units)
    pb = profile.prefix.param_bytes
    out = np.zeros(M - 1)
    for m in range(M - 1):
        J = system.entities[m]
        if J <= 1:
            continue  # Eq. (15)/(16) indicator
        lo, hi = _entity_unions(spec, bounds, m, J)
        lam = pb[hi] - pb[lo]
        if m == 0:
            lam = lam + profile.frontend_param_bytes
        lam = lam * BITS * model_ratio(problem.compression, m)
        if problem.retry_mult is not None:
            lam = lam * problem.retry_mult
        up = lam / system.model_up[m]
        down = lam / system.model_down[m]
        out[m] = float(np.max(up)) + float(np.max(down))
    return out


def class_memory_ok(problem: HsflProblem, spec: CutClassSpec) -> bool:
    """C5 for per-class cuts: every entity must host its union slice."""
    _check_nominal(problem)
    system, profile = problem.system, problem.profile
    N = system.num_clients
    bounds = _class_bounds(spec, profile.n_units)
    px = profile.prefix
    for m in range(system.M):
        J = system.entities[m]
        hosted = N // J
        lo, hi = _entity_unions(spec, bounds, m, J)
        per_model = (
            (px.act_bytes[hi] - px.act_bytes[lo])
            + (px.grad_act_bytes[hi] - px.grad_act_bytes[lo])
        ) * profile.batch + (
            (px.param_bytes[hi] - px.param_bytes[lo])
            + (px.opt_bytes[hi] - px.opt_bytes[lo])
        )
        if m == 0:
            per_model = per_model + profile.frontend_param_bytes
        if m == system.M - 1:
            per_model = per_model + profile.head_param_bytes
        if np.any(hosted * per_model >= system.memory[m]):
            return False
    return True


def class_tier_d(problem: HsflProblem, spec: CutClassSpec) -> np.ndarray:
    """``[M]`` class-weighted drift mass d̄_m (1/q_m-inflated under partial
    participation, like ``HsflProblem.tier_d``)."""
    d = class_weighted_G2_sums(
        problem.hyper.G2, spec.cuts, spec.weights()
    )
    if problem.participation is not None:
        d = d / problem.q
    return d


def class_denominator(
    problem: HsflProblem, spec: CutClassSpec, intervals: Sequence[int]
) -> float:
    c, kappa = problem.constants()
    d = class_tier_d(problem, spec)
    s = sum(
        (I**2) * dm
        for I, dm in zip(intervals[: problem.M - 1], d[: problem.M - 1])
        if I > 1
    )
    return c - kappa * s


def class_numerator(
    problem: HsflProblem, spec: CutClassSpec, intervals: Sequence[int]
) -> float:
    b = class_agg_T(problem, spec)
    return class_split_T(problem, spec) + float(
        np.sum(b / np.asarray(intervals[: problem.M - 1], dtype=float))
    )


def class_split_energy(problem: HsflProblem, spec: CutClassSpec) -> float:
    """Fleet split energy under per-class cuts: the class-share-weighted
    mean Σ_c w_c·E_S(μ_c), accumulated in class order (the
    ``class_weighted_G2_sums`` shape, so the batched per-class tables
    reproduce it bit-for-bit)."""
    from ..energy import split_energy

    w = spec.weights()
    e = w[0] * split_energy(
        problem.profile, problem.system, problem.energy, spec.cuts[0],
        problem.compression,
    )
    for c in range(1, spec.num_classes):
        e = e + w[c] * split_energy(
            problem.profile, problem.system, problem.energy, spec.cuts[c],
            problem.compression,
        )
    return float(e)


def class_agg_energy(problem: HsflProblem, spec: CutClassSpec) -> np.ndarray:
    """``[M-1]`` fed-server sync energy with per-entity union payloads —
    the energy counterpart of ``class_agg_T`` (same λ bytes, priced
    2 × J/byte over every entity instead of max-latency)."""
    system, profile = problem.system, problem.profile
    en = problem.energy
    M = problem.M
    bounds = _class_bounds(spec, profile.n_units)
    pb = profile.prefix.param_bytes
    out = np.zeros(M - 1)
    for m in range(M - 1):
        J = system.entities[m]
        if J <= 1:
            continue  # Eq. (15)/(16) indicator
        lo, hi = _entity_unions(spec, bounds, m, J)
        lam = pb[hi] - pb[lo]
        if m == 0:
            lam = lam + profile.frontend_param_bytes
        lam = lam * BITS * model_ratio(problem.compression, m)
        price = 2.0 * en.model_j_per_byte[m] / BITS
        out[m] = float(np.sum(lam * price))
    return out


def class_round_energy(
    problem: HsflProblem, spec: CutClassSpec, intervals: Sequence[int]
) -> Optional[float]:
    """E(I, {μ_c}) — amortized like ``energy.round_energy`` (None without
    an attached EnergySpec)."""
    if problem.energy is None:
        return None
    e = class_split_energy(problem, spec)
    b = class_agg_energy(problem, spec)
    acc = b[0] / float(intervals[0])
    for m in range(1, problem.M - 1):
        acc = acc + b[m] / float(intervals[m])
    return float(e + acc)


def class_energy_feasible(
    problem: HsflProblem, spec: CutClassSpec, intervals: Sequence[int]
) -> bool:
    """E ≤ budget; vacuously True without a spec or budget."""
    if problem.energy is None or problem.energy.budget_j_per_round is None:
        return True
    return (
        class_round_energy(problem, spec, intervals)
        <= problem.energy.budget_j_per_round
    )


def class_theta(
    problem: HsflProblem, spec: CutClassSpec, intervals: Sequence[int]
) -> float:
    """Exact Θ'(I, {μ_c}); +inf when infeasible — the scalar oracle the
    batched product evaluation must match bit-for-bit (the arithmetic
    mirrors ``HsflProblem.theta`` term for term, including the privacy
    D-floor and the energy budget mask of DESIGN.md §15)."""
    if not class_memory_ok(problem, spec):
        return INFEASIBLE
    D = class_denominator(problem, spec, intervals)
    if D <= problem.d_min():
        return INFEASIBLE
    if not class_energy_feasible(problem, spec, intervals):
        return INFEASIBLE
    return (
        2.0
        * problem.hyper.theta0
        / problem.hyper.gamma
        * class_numerator(problem, spec, intervals)
        / D
    )


def class_rounds(
    problem: HsflProblem, spec: CutClassSpec, intervals: Sequence[int]
) -> Optional[float]:
    D = class_denominator(problem, spec, intervals)
    if D <= problem.d_min():
        return None
    return 2.0 * problem.hyper.theta0 / (problem.hyper.gamma * D)


def class_total_T(
    problem: HsflProblem,
    spec: CutClassSpec,
    intervals: Sequence[int],
    R: float,
) -> float:
    """T(I, {μ_c}) of Eq. (19) under per-class pricing."""
    tot = R * class_split_T(problem, spec)
    b = class_agg_T(problem, spec)
    for m in range(problem.M - 1):
        tot += np.floor(R / intervals[m]) * b[m]
    return float(tot)


# --------------------------------------------------------------------------- #
# batched product evaluation
# --------------------------------------------------------------------------- #


def chain_matrix(
    works: np.ndarray, rates: Sequence[np.ndarray], backend: str = "numpy"
) -> np.ndarray:
    """``[K, N]`` per-client chain sums Σ_s work/rate in stage order — the
    pre-max form of ``batched.accumulate_chain`` (per-class maxima need
    the per-client column structure)."""
    device = torch_device(backend)
    if device is not None:
        return chain_sums_torch(works, rates, device).cpu().numpy()
    t = np.zeros((works.shape[0], rates[0].shape[0]))
    for s, r in enumerate(rates):
        t = t + works[:, s][:, None] / r[None, :]
    return t


def product_assignments(K: int, C: int) -> np.ndarray:
    """``[K^C, C]`` all class→lattice-row assignments, class 0 slowest
    (lexicographic row order — first-tie argmins are deterministic)."""
    grids = np.meshgrid(*([np.arange(K)] * C), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


class ClassBatchedEvaluator:
    """Product-lattice Θ' evaluation for one (problem, class membership).

    Tables depend on the class *membership* only (never on the per-class
    cut values), so one evaluator serves every MS solve inside a BCD run:

    * ``split_class`` [C, K] — per-class member-max chain latency over the
      shared cut lattice (deadline-capped), from the same ``[K, S]`` work
      tensor and chain accumulation order as ``BatchedEvaluator``;
    * ``d_tab`` [K, M-1] — the tier-G² gather (class weighting happens per
      assignment row);
    * per-tier entity → member-class index lists for the union payloads.

    ``theta_rows(assign, intervals)`` prices ``[R, C]`` assignment index
    matrices; a single class (C=1) reproduces the single-cut
    ``BatchedEvaluator`` tables bit-for-bit, which is what makes
    ``solve_ms_classes`` collapse exactly to ``solve_ms``.
    """

    def __init__(
        self,
        problem: HsflProblem,
        spec: CutClassSpec,
        backend: str = "auto",
    ):
        _check_nominal(problem)
        if spec.num_clients != problem.system.num_clients:
            raise ValueError(
                f"spec assigns {spec.num_clients} clients but the system "
                f"has {problem.system.num_clients}"
            )
        self.problem = problem
        self.class_of = spec.class_of
        self.C = spec.num_classes
        lattice = problem.cut_lattice()
        self.lattice = lattice
        M = problem.M
        self.backend = resolve_backend(
            backend, work_elems=lattice.shape[0] * problem.system.num_clients
        )
        self.bnds = lattice_bounds(lattice, problem.n_units)  # [K, M+1]
        works = split_work_tensor(
            problem.profile, lattice, problem.compression, problem.retry_mult
        )
        rates = nominal_stage_rates(problem.system, M)
        t = chain_matrix(works, rates, self.backend)  # [K, N]
        members = [
            np.flatnonzero(np.asarray(spec.class_of) == c)
            for c in range(self.C)
        ]
        self.split_class = np.stack(
            [t[:, idx].max(axis=1) for idx in members]
        )  # [C, K]
        pp = problem.participation
        if pp is not None and pp.deadline is not None:
            self.split_class = np.minimum(self.split_class, pp.deadline)
        self.d_tab = tier_d_lattice(problem.hyper.G2, lattice)[:, : M - 1]
        self.w = spec.weights()
        self.q = problem.q
        self.c, self.kappa = problem.constants()
        self.scale = 2.0 * problem.hyper.theta0 / problem.hyper.gamma
        # privacy D-floor + energy pricing (DESIGN.md §15): 0.0 / None when
        # unconstrained, keeping theta_rows bit-identical to the pre-§15 path
        self.d_min = problem.d_min()
        en = problem.energy
        self.energy_budget = None if en is None else en.budget_j_per_round
        if en is not None:
            from ..energy import split_energy_lattice

            self.e_split_tab = split_energy_lattice(
                problem.profile, problem.system, en, lattice,
                problem.compression,
            )
        else:
            self.e_split_tab = None
        # entity j of a J-entity tier hosts classes self._entity_classes[J][j]
        self._entity_classes: Dict[int, List[np.ndarray]] = {}
        N = spec.num_clients
        for J in set(problem.system.entities):
            per = N // J
            cls = np.asarray(spec.class_of).reshape(J, per)
            self._entity_classes[J] = [np.unique(cls[j]) for j in range(J)]

    @property
    def K(self) -> int:
        return self.lattice.shape[0]

    def cuts_at(self, assign: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
        return tuple(
            tuple(int(x) for x in self.lattice[k]) for k in assign
        )

    def split_T(self, assign: np.ndarray) -> np.ndarray:
        """[R] T_S — max over classes of the member-max chain latency."""
        t = self.split_class[0][assign[:, 0]]
        for c in range(1, self.C):
            t = np.maximum(t, self.split_class[c][assign[:, c]])
        return t

    def _unions(
        self, assign: np.ndarray, m: int, J: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-entity union unit ranges ``([R, J], [R, J])`` for tier m."""
        blo = self.bnds[:, m]
        bhi = self.bnds[:, m + 1]
        Blo = blo[assign]  # [R, C]
        Bhi = bhi[assign]
        R = assign.shape[0]
        lo = np.empty((R, J), dtype=np.int64)
        hi = np.empty((R, J), dtype=np.int64)
        for j, cls in enumerate(self._entity_classes[J]):
            lo[:, j] = Blo[:, cls].min(axis=1)
            hi[:, j] = Bhi[:, cls].max(axis=1)
        return lo, hi

    def agg_T(self, assign: np.ndarray) -> np.ndarray:
        """[R, M-1] T_{m,A} with per-entity union payloads."""
        problem = self.problem
        system, profile = problem.system, problem.profile
        M = problem.M
        pb = profile.prefix.param_bytes
        out = np.zeros((assign.shape[0], M - 1))
        for m in range(M - 1):
            J = system.entities[m]
            if J <= 1:
                continue
            lo, hi = self._unions(assign, m, J)
            lam = pb[hi] - pb[lo]
            if m == 0:
                lam = lam + profile.frontend_param_bytes
            lam = lam * BITS * model_ratio(problem.compression, m)
            if problem.retry_mult is not None:
                lam = lam * problem.retry_mult
            out[:, m] = (lam / system.model_up[m][None, :]).max(axis=1) + (
                lam / system.model_down[m][None, :]
            ).max(axis=1)
        return out

    def mem_ok(self, assign: np.ndarray) -> np.ndarray:
        """[R] bool — C5 over every entity's union range."""
        problem = self.problem
        system, profile = problem.system, problem.profile
        N = system.num_clients
        px = profile.prefix
        ok = np.ones(assign.shape[0], dtype=bool)
        for m in range(system.M):
            J = system.entities[m]
            hosted = N // J
            lo, hi = self._unions(assign, m, J)
            per_model = (
                (px.act_bytes[hi] - px.act_bytes[lo])
                + (px.grad_act_bytes[hi] - px.grad_act_bytes[lo])
            ) * profile.batch + (
                (px.param_bytes[hi] - px.param_bytes[lo])
                + (px.opt_bytes[hi] - px.opt_bytes[lo])
            )
            if m == 0:
                per_model = per_model + profile.frontend_param_bytes
            if m == system.M - 1:
                per_model = per_model + profile.head_param_bytes
            ok &= np.all(
                hosted * per_model < system.memory[m][None, :], axis=1
            )
        return ok

    def tier_d(self, assign: np.ndarray) -> np.ndarray:
        """[R, M-1] class-weighted d̄ (1/q-inflated) — multiply-add in
        class order, matching ``class_weighted_G2_sums``."""
        d = self.w[0] * self.d_tab[assign[:, 0]]
        for c in range(1, self.C):
            d = d + self.w[c] * self.d_tab[assign[:, c]]
        if self.problem.participation is not None:
            d = d / self.q[: d.shape[1]][None, :]
        return d

    def numerator(self, assign: np.ndarray, intervals: Sequence[int]) -> np.ndarray:
        agg = self.agg_T(assign)
        acc = agg[:, 0] / float(intervals[0])
        for m in range(1, self.problem.M - 1):
            acc = acc + agg[:, m] / float(intervals[m])
        return self.split_T(assign) + acc

    def denominator(self, assign: np.ndarray, intervals: Sequence[int]) -> np.ndarray:
        d = self.tier_d(assign)
        s = np.zeros(assign.shape[0])
        for m in range(self.problem.M - 1):
            I = int(intervals[m])
            if I > 1:
                s = s + (I**2) * d[:, m]
        return self.c - self.kappa * s

    def agg_energy(self, assign: np.ndarray) -> np.ndarray:
        """[R, M-1] sync energy with per-entity union payloads — the
        batched counterpart of ``class_agg_energy`` (same λ·price order)."""
        problem = self.problem
        system, profile = problem.system, problem.profile
        en = problem.energy
        M = problem.M
        pb = profile.prefix.param_bytes
        out = np.zeros((assign.shape[0], M - 1))
        for m in range(M - 1):
            J = system.entities[m]
            if J <= 1:
                continue
            lo, hi = self._unions(assign, m, J)
            lam = pb[hi] - pb[lo]
            if m == 0:
                lam = lam + profile.frontend_param_bytes
            lam = lam * BITS * model_ratio(problem.compression, m)
            price = 2.0 * en.model_j_per_byte[m] / BITS
            out[:, m] = np.sum(lam * price, axis=1)
        return out

    def round_energy_rows(
        self, assign: np.ndarray, intervals: Sequence[int]
    ) -> Optional[np.ndarray]:
        """[R] E(I, {μ_c}) — class-order weighted split tables plus the
        amortized union sync energy, matching ``class_round_energy``."""
        if self.e_split_tab is None:
            return None
        e = self.w[0] * self.e_split_tab[assign[:, 0]]
        for c in range(1, self.C):
            e = e + self.w[c] * self.e_split_tab[assign[:, c]]
        agg = self.agg_energy(assign)
        acc = agg[:, 0] / float(intervals[0])
        for m in range(1, self.problem.M - 1):
            acc = acc + agg[:, m] / float(intervals[m])
        return e + acc

    def theta_rows(
        self, assign: np.ndarray, intervals: Sequence[int]
    ) -> np.ndarray:
        """[R] Θ' in the Dinkelbach q-order ``scale · (N/D)`` — the order
        ``solve_ms`` reports, so the C=1 collapse is bit-exact against the
        single-cut MS optimum; +inf where C5 fails, D ≤ d_min, or the
        round energy overruns the budget."""
        D = self.denominator(assign, intervals)
        N_ = self.numerator(assign, intervals)
        th = np.full(assign.shape[0], INFEASIBLE)
        ok = self.mem_ok(assign) & (D > self.d_min)
        if self.energy_budget is not None:
            ok = ok & (
                self.round_energy_rows(assign, intervals) <= self.energy_budget
            )
        th[ok] = self.scale * (N_[ok] / D[ok])
        return th


# --------------------------------------------------------------------------- #
# solvers
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ClassMsSolution:
    cuts: Tuple[Tuple[int, ...], ...]   # [C][M-1]
    theta: float
    exhaustive: bool                    # full product vs coordinate descent
    rows_evaluated: int = 0


@dataclass(frozen=True)
class ClassBcdResult:
    intervals: Tuple[int, ...]
    spec: CutClassSpec                  # final per-class cuts
    theta: float
    rounds: float
    total_latency: float
    history: Tuple[float, ...] = ()

    @property
    def class_cuts(self) -> Tuple[Tuple[int, ...], ...]:
        return self.spec.cuts


def solve_ms_classes(
    problem: HsflProblem,
    spec: CutClassSpec,
    intervals: Sequence[int],
    backend: str = "auto",
    product_budget: int = 200_000,
    max_sweeps: int = 16,
    evaluator: Optional[ClassBatchedEvaluator] = None,
) -> ClassMsSolution:
    """Optimal per-class cuts for fixed intervals.

    When the full lattice product ``K^C`` fits ``product_budget`` rows the
    objective is evaluated for *every* assignment in one batched pass and
    the argmin is exact.  Otherwise: coordinate descent over classes,
    seeded at the single-cut Dinkelbach optimum (every class at μ*), each
    step re-optimizing one class's row over the full ``[K]`` lattice with
    the others fixed — Θ' is non-increasing from the single-cut optimum,
    so the result is never worse than the best single cut.
    """
    ev = evaluator or ClassBatchedEvaluator(problem, spec, backend)
    K, C = ev.K, ev.C
    if K == 0:
        raise ValueError(_INFEASIBLE_MSG)
    if float(K) ** C <= product_budget:
        A = product_assignments(K, C)
        th = ev.theta_rows(A, intervals)
        j = int(np.argmin(th))
        if not np.isfinite(th[j]):
            raise ValueError(_INFEASIBLE_MSG)
        return ClassMsSolution(
            cuts=ev.cuts_at(A[j]),
            theta=float(th[j]),
            exhaustive=True,
            rows_evaluated=A.shape[0],
        )
    # coordinate descent from the single-cut optimum diagonal
    ms = solve_ms(problem, intervals, backend=backend)
    k0 = np.flatnonzero(
        (ev.lattice == np.asarray(ms.cuts)).all(axis=1)
    )
    assign = np.full(C, int(k0[0]) if k0.size else 0, dtype=np.int64)
    best = float(ev.theta_rows(assign[None, :], intervals)[0])
    rows = 1
    for _ in range(max_sweeps):
        improved = False
        for c in range(C):
            cand = np.tile(assign, (K, 1))
            cand[:, c] = np.arange(K)
            th = ev.theta_rows(cand, intervals)
            rows += K
            j = int(np.argmin(th))
            if th[j] < best:
                best = float(th[j])
                assign[c] = j
                improved = True
        if not improved:
            break
    if not np.isfinite(best):
        raise ValueError(_INFEASIBLE_MSG)
    return ClassMsSolution(
        cuts=ev.cuts_at(assign),
        theta=best,
        exhaustive=False,
        rows_evaluated=rows,
    )


def solve_ma_classes(
    problem: HsflProblem,
    spec: CutClassSpec,
    i_max: int = 10_000,
    backend: str = "auto",
) -> MaSolution:
    """Optimal MA intervals for fixed per-class cuts — Proposition 1 with
    the class-priced scalars (a, b, d̄) in the shared candidate machinery
    of ``ma_solver`` (same enumeration order, same vectorized Θ' pass)."""
    if backend != "scalar":
        resolve_backend(backend)
    M = problem.M
    a = class_split_T(problem, spec)
    b = class_agg_T(problem, spec)
    c, kappa = problem.constants()
    d = class_tier_d(problem, spec)[: M - 1]
    cands = _candidate_intervals(M, a, b, c, kappa, d, i_max)
    if problem.energy is not None and problem.energy.budget_j_per_round is not None:
        e_split: Optional[float] = class_split_energy(problem, spec)
        e_agg: Optional[np.ndarray] = class_agg_energy(problem, spec)
    else:
        e_split, e_agg = None, None
    best: Optional[MaSolution] = None
    if cands:
        arr = np.asarray(cands, dtype=np.int64)
        th = _theta_candidates(
            problem, class_memory_ok(problem, spec), a, b, c, kappa, d, arr,
            e_split, e_agg,
        )
        i = int(np.argmin(th))
        if th[i] < INFEASIBLE:
            best = MaSolution(
                tuple(int(x) for x in arr[i]) + (1,), float(th[i])
            )
    if best is None:
        ones = tuple([1] * (M - 1)) + (1,)
        return MaSolution(ones, class_theta(problem, spec, list(ones)))
    return best


def solve_bcd_classes(
    problem: HsflProblem,
    spec: CutClassSpec,
    init_intervals: Optional[Sequence[int]] = None,
    tol: float = 1e-6,
    max_iters: int = 50,
    backend: str = "auto",
    product_budget: int = 200_000,
) -> ClassBcdResult:
    """Per-class BCD: alternate Proposition-1 intervals and product-lattice
    cuts until |ΔΘ'| ≤ tol, exactly the ``solve_bcd`` alternation with the
    class-priced sub-solvers.  The evaluator tables (class membership ×
    lattice) are built once and shared across every MS solve."""
    M = problem.M
    cur = spec
    intervals = (
        tuple(init_intervals) if init_intervals else tuple([1] * M)
    )
    ev = ClassBatchedEvaluator(problem, cur, backend)
    history: List[float] = []
    theta = class_theta(problem, cur, intervals)
    for _ in range(max_iters):
        ma = solve_ma_classes(problem, cur, backend=backend)
        intervals = ma.intervals
        ms = solve_ms_classes(
            problem, cur, intervals,
            backend=backend, product_budget=product_budget, evaluator=ev,
        )
        cur = cur.with_cuts(ms.cuts)
        new_theta = class_theta(problem, cur, intervals)
        history.append(new_theta)
        if theta < INFEASIBLE and abs(theta - new_theta) <= tol * max(
            1.0, abs(theta)
        ):
            theta = new_theta
            break
        theta = new_theta
    R = class_rounds(problem, cur, intervals)
    T = class_total_T(problem, cur, intervals, R)
    return ClassBcdResult(
        intervals=tuple(intervals),
        spec=cur,
        theta=theta,
        rounds=float(R),
        total_latency=float(T),
        history=tuple(history),
    )
