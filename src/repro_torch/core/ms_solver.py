"""P2 — the model-splitting sub-problem (Dinkelbach MILFP, Sec. VI) — port
of ``repro.core.ms_solver``.

For fixed intervals I, problem (27) is a mixed-integer linear *fractional*
program in (μ, T):  min N(μ)/D(μ)  with both N and D affine in the one-hot
cut indicators μ_{m,l} once the max-constraints R1–R3 are written out.

We solve it with the Dinkelbach parametric scheme [46]: repeatedly solve

    F(q) = min_μ  N(μ) − q · D(μ)   s.t. C2–C5, D(μ) > 0

and update q ← N(μ*)/D(μ*) until F(q) ≈ 0; the fixpoint is the global
optimum of the fraction. The inner parametric problem is solved *exactly*:
because every quantity is additive over tiers given the cut vector, and the
number of C2–C4-valid cut vectors is combinatorial-small
(≈ U^{M-1}/(M-1)! — e.g. 2,016 for U=64, M=3), an exact search over the
feasible lattice is both faster and stronger than an LP-relaxation MILP
here.

Two execution paths, bit-identical by construction (DESIGN.md §11):

* ``backend="scalar"`` walks the lattice one cut vector at a time through
  ``problem.numerator``/``denominator`` — the historical path, kept as
  the test oracle;
* ``backend="numpy"|"torch"|"auto"`` reads the problem's memoized
  ``BatchedEvaluator``: N and D for the whole lattice are precomputed
  arrays, so each Dinkelbach step is one argmin over ``[K]`` — this is
  what lets BCD re-run online at U=128/M=4 (~3·10⁵ lattice points).

``solve_ms_bruteforce`` (direct ratio enumeration) is the test oracle;
Dinkelbach must and does reach the same optimum on either path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .problem import INFEASIBLE, HsflProblem


@dataclass(frozen=True)
class MsSolution:
    cuts: Tuple[int, ...]
    theta: float
    dinkelbach_iters: int = 0


def _nd(problem: HsflProblem, intervals: Sequence[int], cuts) -> Tuple[float, float]:
    return (
        problem.numerator(intervals, cuts),
        problem.denominator(intervals, cuts),
    )


def _feasible_cuts(problem: HsflProblem, intervals: Sequence[int]) -> List[Tuple[int, ...]]:
    d_min = problem.d_min()  # 0.0 unconstrained: bit-identical to D <= 0
    out = []
    for cuts in problem.iter_cut_vectors():
        if not problem.memory_feasible(cuts):
            continue
        if problem.denominator(intervals, cuts) <= d_min:
            continue  # C1 unreachable (or over the ε budget's round cap)
        if not problem.energy_feasible(intervals, cuts):
            continue  # E(I, μ) over the per-round energy budget
        out.append(cuts)
    return out


_INFEASIBLE_MSG = (
    "MS sub-problem infeasible: no cut vector satisfies C2–C5 with "
    "a reachable convergence bound (try larger eps or smaller I; under a "
    "privacy/energy budget, loosen epsilon_budget or budget_j_per_round)."
)


def _solve_ms_scalar(
    problem: HsflProblem,
    intervals: Sequence[int],
    tol: float,
    max_iters: int,
    warm_cuts: Optional[Sequence[int]] = None,
) -> MsSolution:
    """The one-cut-at-a-time Dinkelbach walk (oracle path)."""
    feas = _feasible_cuts(problem, intervals)
    if not feas:
        raise ValueError(_INFEASIBLE_MSG)
    # initial q from the warm-start point when given (and feasible),
    # otherwise an arbitrary feasible point; Dinkelbach's fixpoint is the
    # global optimum of the fraction either way — a warm q just lands the
    # first parametric argmin near it, typically converging in one step
    start = feas[0]
    if warm_cuts is not None:
        w = tuple(int(c) for c in warm_cuts)
        if w in set(feas):
            start = w
    n0, d0 = _nd(problem, intervals, start)
    q = n0 / d0
    best = start
    for it in range(1, max_iters + 1):
        # inner parametric problem: exact search over the feasible lattice
        vals = []
        for cuts in feas:
            n, d = _nd(problem, intervals, cuts)
            vals.append(n - q * d)
        i = int(np.argmin(vals))
        best, fq = feas[i], vals[i]
        n, d = _nd(problem, intervals, best)
        new_q = n / d
        if abs(fq) <= tol * max(1.0, abs(q)) or abs(new_q - q) <= tol * max(1.0, abs(q)):
            q = new_q
            break
        q = new_q
    scale = 2.0 * problem.hyper.theta0 / problem.hyper.gamma
    return MsSolution(tuple(best), scale * q, dinkelbach_iters=it)


def solve_ms(
    problem: HsflProblem,
    intervals: Sequence[int],
    tol: float = 1e-9,
    max_iters: int = 64,
    backend: str = "auto",
    warm_cuts: Optional[Sequence[int]] = None,
) -> MsSolution:
    """Optimal cuts for fixed intervals via Dinkelbach over an exact backend.

    ``backend="scalar"`` re-walks the lattice per iteration (oracle);
    anything else evaluates the whole lattice through the problem's
    memoized ``BatchedEvaluator`` — identical iterates, identical optimum,
    to the last bit.

    ``warm_cuts`` seeds the Dinkelbach ratio q at a known-good cut vector
    (the adaptive controller passes the previous optimum): the fixpoint —
    and hence the returned optimum — is unchanged, but a warm q lets the
    first whole-lattice argmin land on (or next to) it, so a mid-run
    re-solve typically terminates in a single parametric step.
    """
    if backend == "scalar":
        return _solve_ms_scalar(problem, intervals, tol, max_iters, warm_cuts)
    ev = problem.evaluator(backend)
    nums = ev.numerator(intervals)
    dens = ev.denominator(intervals)
    ok = ev.mem_ok & (dens > ev.d_min)
    if ev.energy_budget is not None:
        ok = ok & (ev.round_energy(intervals) <= ev.energy_budget)
    feas = np.flatnonzero(ok)
    if feas.size == 0:
        raise ValueError(_INFEASIBLE_MSG)
    n, d = nums[feas], dens[feas]
    start = 0
    if warm_cuts is not None:
        w = np.flatnonzero((ev.lattice == np.asarray(warm_cuts)).all(axis=1))
        if w.size:
            hit = np.flatnonzero(feas == w[0])
            if hit.size:
                start = int(hit[0])
    q = n[start] / d[start]
    best_i = feas[start]
    for it in range(1, max_iters + 1):
        vals = n - q * d  # whole-lattice parametric step: one argmin
        j = int(np.argmin(vals))
        best_i, fq = feas[j], vals[j]
        new_q = n[j] / d[j]
        if abs(fq) <= tol * max(1.0, abs(q)) or abs(new_q - q) <= tol * max(1.0, abs(q)):
            q = new_q
            break
        q = new_q
    scale = 2.0 * problem.hyper.theta0 / problem.hyper.gamma
    return MsSolution(ev.cuts_at(int(best_i)), float(scale * q), dinkelbach_iters=it)


def solve_ms_bruteforce(
    problem: HsflProblem, intervals: Sequence[int]
) -> MsSolution:
    """Direct ratio enumeration (test oracle; reads the shared lattice)."""
    best_cuts, best_th = None, INFEASIBLE
    for cuts in problem.iter_cut_vectors():
        th = problem.theta(intervals, cuts)
        if th < best_th:
            best_cuts, best_th = cuts, th
    if best_cuts is None:
        raise ValueError("MS sub-problem infeasible")
    return MsSolution(tuple(best_cuts), best_th)
