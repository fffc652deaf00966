"""Algorithm 2 — block-coordinate descent over the MA and MS sub-problems
— port of ``repro.core.bcd``.

Alternates P1 (``solve_ma``) and P2 (``solve_ms``) from a feasible starting
point until |ΔΘ'| ≤ ε_bcd. Each block solve is optimal for its block, so Θ'
is non-increasing and the iteration terminates; the result is the paper's
efficient sub-optimal solution to problem (20).

Compression is a first-class knob here: pass ``compression=`` (or attach it
to the problem via ``HsflProblem.with_compression``) and both block solvers
re-optimize (I, μ) against the compressed wire — cheaper model bytes pull
the optimal cut deeper and the optimal intervals down, which
``benchmarks/compress_sweep.py`` sweeps and asserts.

So is partial participation (DESIGN.md §12): a problem composed through
``repro.sim.participation_problem`` prices T_S as the trace expectation of
the deadline-capped round and inflates the bound denominator by the
estimated 1/q_m — the BCD iteration then trades a tighter deadline
(cheaper expected rounds via ``problem.split_T``/``total_T``) against the
extra rounds-to-ε the inflated D(I, μ) demands, with no changes below;
``benchmarks/participation_sweep.py`` sweeps the crossover.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..compress.base import CompressionSpec
from .ma_solver import solve_ma
from .ms_solver import solve_ms
from .problem import INFEASIBLE, HsflProblem


def default_init_cuts(n_units: int, M: int) -> Tuple[int, ...]:
    """Evenly spread cuts — the feasible starting anchor of ``solve_bcd``,
    shared with eps-floor pricing (``repro.api.build``) and participation
    q_m estimation (``repro.sim.participation``) so every consumer anchors
    at the same reference point."""
    return tuple(max(1, (m + 1) * n_units // M) for m in range(M - 1))


_SEED_INTERVALS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def _feasible_seed(
    problem: HsflProblem,
) -> Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Best feasible (I, μ) over a geometric interval grid × the cut lattice.

    A privacy ε budget (denominator floor) or a per-round energy budget can
    leave the default evenly-spread anchor with *no* feasible interval
    vector — e.g. the intervals large enough to amortize sync energy under
    the budget push D(I, μ) below the budget's round cap.  BCD needs a
    feasible starting point, so when the anchor dead-ends we scan the
    batched evaluator for the lowest-Θ' feasible lattice point and restart
    there.  Unconstrained problems never take this path.
    """
    import itertools

    import numpy as np

    ev = problem.evaluator("numpy")
    best = None
    for combo in itertools.product(_SEED_INTERVALS, repeat=problem.M - 1):
        intervals = (*combo, 1)
        dens = ev.denominator(intervals)
        ok = ev.mem_ok & (dens > ev.d_min)
        if ev.energy_budget is not None:
            ok = ok & (ev.round_energy(intervals) <= ev.energy_budget)
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            continue
        th = ev.numerator(intervals)[idx] / dens[idx]
        j = int(np.argmin(th))
        if best is None or float(th[j]) < best[0]:
            best = (float(th[j]), intervals, ev.cuts_at(int(idx[j])))
    return None if best is None else (best[1], best[2])


@dataclass(frozen=True)
class BcdResult:
    intervals: Tuple[int, ...]
    cuts: Tuple[int, ...]
    theta: float
    rounds: float                      # R(I*, μ*) via Corollary 1
    total_latency: float               # T(I*, μ*) via Eq. (19)
    history: Tuple[float, ...] = ()    # Θ' per BCD iteration


def solve_bcd(
    problem: HsflProblem,
    init_cuts: Optional[Sequence[int]] = None,
    init_intervals: Optional[Sequence[int]] = None,
    tol: float = 1e-6,
    max_iters: int = 50,
    compression: Optional[CompressionSpec] = None,
    backend: str = "auto",
    warm_start: bool = False,
) -> BcdResult:
    """``backend`` selects the block solvers' evaluation path (DESIGN.md
    §11): "scalar" is the historical per-cut walk (test oracle);
    "numpy"/"torch"/"auto" run the batched lattice core — the MS latency
    tables are built once per problem and shared across every Dinkelbach
    step of every BCD iteration.  Results are bit-identical either way.

    ``warm_start=True`` seeds every inner Dinkelbach at the current BCD
    iterate (``warm_cuts``): starting from a previous optimum — the
    adaptive controller's re-solve path — the whole BCD pass is then one
    MA solve, one single-step MS solve, and a converged theta check, all
    against the problem's memoized evaluator tables.  The fixpoint is
    unchanged."""
    if compression is not None:
        problem = problem.with_compression(compression)
    M, U = problem.M, problem.n_units
    if init_cuts is None:
        init_cuts = default_init_cuts(U, M)  # evenly spread starting point
    cuts = tuple(init_cuts)
    intervals = (
        tuple(init_intervals) if init_intervals else tuple([1] * M)
    )

    history: List[float] = []
    theta = problem.theta(intervals, cuts)
    constrained = problem.d_min() > 0.0 or (
        problem.energy is not None
        and problem.energy.budget_j_per_round is not None
    )
    if constrained:
        probe = solve_ma(problem, cuts, backend=backend)
        if not problem.theta(probe.intervals, cuts) < INFEASIBLE:
            # the anchor admits no feasible intervals under the budget(s):
            # restart from the best feasible lattice point instead
            seed = _feasible_seed(problem)
            if seed is not None:
                intervals, cuts = seed
                theta = problem.theta(intervals, cuts)
    for _ in range(max_iters):
        ma = solve_ma(problem, cuts, backend=backend)
        intervals = ma.intervals
        ms = solve_ms(
            problem, intervals, backend=backend,
            warm_cuts=cuts if warm_start else None,
        )
        cuts = ms.cuts
        new_theta = problem.theta(intervals, cuts)
        history.append(new_theta)
        if theta < INFEASIBLE and abs(theta - new_theta) <= tol * max(1.0, abs(theta)):
            theta = new_theta
            break
        theta = new_theta

    R = problem.rounds(intervals, cuts)
    # Eq. (19) under the problem's latency pricing (nominal point estimates,
    # or trace quantiles when a sim latency_model is attached).
    T = problem.total_T(intervals, cuts, R)
    return BcdResult(
        intervals=intervals,
        cuts=cuts,
        theta=theta,
        rounds=float(R),
        total_latency=float(T),
        history=tuple(history),
    )
