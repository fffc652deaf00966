r"""P1 — the model-aggregation sub-problem (Proposition 1) — port of
``repro.core.ma_solver``.

For fixed cuts μ, minimize over I ∈ (ℕ⁺)^{M-1}

    Θ'(I) ∝ (a + Σ_m b_m / I_m) / (c − κ Σ_m 1{I_m>1} d_m I_m²).

Proposition 1 structure:
  * enumerate all 2^{M-1} subsets M' of tiers pinned to I_m = 1;
  * for the free tiers M'', the stationary condition ∂Θ'/∂I_{m'} = 0 is the
    cubic  Ξ_{m'}(I) = 2κ d a' I³ + 3κ d b I² − b c' = 0  with
        a' = a + Σ_{m∈M''\{m'}} b_m/I_m + Σ_{m∈M'} b_m,
        c' = c − κ Σ_{m∈M''\{m'}} d_m I_m²,
    which has exactly one positive root (Ξ is increasing, Ξ(0) < 0);
  * solve the coupled system by Newton–Jacobi sweeps, then pick the best of
    the 2^{|M''|} floor/ceil roundings under the *exact* objective (with the
    I=1 indicator discontinuity honoured).

The candidate set (pinned bases + rounding neighbourhoods) is generated
once by ``_candidate_intervals``; the final exact-objective pick runs
either as the historical per-candidate ``problem.theta`` walk
(``backend="scalar"``, each call re-prices T_S/T_{m,A} from scratch) or
as one vectorized Θ' evaluation over a ``[C, M-1]`` interval array with
the latency terms a/b priced exactly once (any other backend) — same
candidate order, same accumulation order, bit-identical winner
(DESIGN.md §11).

The solver is exact up to the integer rounding neighbourhood, which matches
Eq. (26)/(38); ``tests/test_solvers.py`` verifies optimality against brute
force over the full integer grid.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .problem import INFEASIBLE, HsflProblem

# Newton stop threshold for _cubic_positive_root (hoisted: the controller's
# warm re-solve path prices thousands of cubics per second and
# ``np.finfo(...).eps`` is a surprisingly expensive constructor).
_EPS4 = 4.0 * float(np.finfo(float).eps)


@dataclass(frozen=True)
class MaSolution:
    intervals: Tuple[int, ...]  # length M (top tier forced to 1)
    theta: float


def _cubic_positive_root(
    ka: float, kb: float, kc: float, max_doublings: int = 200
) -> float:
    """Unique positive root of  ka·I³ + kb·I² − kc = 0  (ka, kb, kc > 0).

    For positive coefficients f(I) = ka·I³ + kb·I² − kc is strictly
    increasing and convex on I > 0 with f(0) = −kc < 0, so Newton from any
    point above the root descends monotonically and converges
    quadratically — orders of magnitude cheaper than the companion-matrix
    eigensolve ``np.roots`` runs, which matters because the adaptive
    controller (``repro.control``) prices this root on every warm re-solve.
    The historical bisection fallback still guards degenerate coefficients.
    """
    ka, kb, kc = float(ka), float(kb), float(kc)
    if ka > 0 and kb > 0 and kc > 0:
        # each term alone overshoots kc at these points, so both are upper
        # bounds; start at the tighter one
        x = min((kc / ka) ** (1.0 / 3.0), (kc / kb) ** 0.5)
        for _ in range(100):
            f = (ka * x + kb) * x * x - kc
            df = (3.0 * ka * x + 2.0 * kb) * x
            if df <= 0:
                break
            step = f / df
            x_new = x - step
            if x_new <= 0 or x_new >= x:
                break
            x = x_new
            if abs(step) <= _EPS4 * x:
                break
        else:
            x = None
        if x is not None and x > 0:
            return float(x)
    if kb > 0 and kc > 0:
        # Degenerate-leading-coefficient deflation: when ka ≈ 0 the cubic
        # collapses to  kb·I² − kc = 0.  ``np.roots`` cannot handle this
        # regime — its companion matrix divides by the leading coefficient,
        # so a subnormal ka yields inf/garbage eigenvalues and an empty (or
        # spurious) positive-root set.  Deflate explicitly whenever the
        # cubic term is negligible at the quadratic root: at I = r₂ the
        # cubic contributes ka·r₂³ against kb·r₂², i.e. the test ka·r₂ ≪ kb.
        r2 = math.sqrt(kc / kb)
        if ka <= 0.0 or ka * r2 <= _EPS4 * kb:
            return float(r2)
    try:
        roots = np.roots([ka, kb, 0.0, -kc])
    except np.linalg.LinAlgError:
        roots = np.empty(0, dtype=complex)
    roots = roots[np.isfinite(roots)]
    real = roots[np.abs(roots.imag) < 1e-9].real
    pos = real[real > 0]
    if len(pos) == 0:  # numerical fallback: bisection
        lo, hi = 1e-9, 1.0
        f = lambda x: ka * x**3 + kb * x**2 - kc
        for _ in range(max_doublings):
            if f(hi) >= 0:
                break
            hi *= 2.0
        else:
            # a degenerate coefficient set (e.g. ka = kb = 0, kc > 0) has no
            # positive root at all; without this cap the bracket expansion
            # would double `hi` forever.
            raise ValueError(
                "MA bracket expansion failed: "
                f"Ξ(I) = {ka!r}·I³ + {kb!r}·I² − {kc!r} has no positive root "
                f"within I ≤ {hi:.3g} after {max_doublings} doublings "
                "(Proposition 1 requires ka, kb, kc > 0)"
            )
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if f(mid) < 0:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)
    return float(pos[0])


def _newton_jacobi(
    a: float,
    b: np.ndarray,
    c: float,
    kappa: float,
    d: np.ndarray,
    free: List[int],
    pinned_b_sum: float,
    iters: int = 200,
    tol: float = 1e-10,
) -> Optional[List[float]]:
    """Solve the stationary system for the free tiers; None if c' ≤ 0 always
    (the bound cannot reach ε with any finite interval).

    Pure-scalar sweeps: the free set is at most M−1 ≈ 2 tiers, where numpy
    array dispatch costs more than the arithmetic itself — and this loop
    sits on the adaptive controller's warm re-solve path.
    """
    bs = [float(b[m]) for m in free]
    ds = [float(d[m]) for m in free]
    n = len(free)
    I = [2.0] * n
    for _ in range(iters):
        new = list(I)
        for i in range(n):
            a_eff = a + pinned_b_sum + sum(
                bs[j] / I[j] for j in range(n) if j != i
            )
            c_eff = c - kappa * sum(
                ds[j] * I[j] ** 2 for j in range(n) if j != i
            )
            if c_eff <= 0:
                return None
            if ds[i] <= 0:
                # tier has no G² mass: Θ' strictly decreases in I_m → unbounded;
                # cap at a large interval (aggregation is pure overhead here).
                new[i] = 1e6
                continue
            ka = 2.0 * kappa * ds[i] * a_eff
            kb = 3.0 * kappa * ds[i] * bs[i]
            kc = bs[i] * c_eff
            if kc <= 0:
                return None
            new[i] = _cubic_positive_root(ka, kb, kc)
        if max(abs(new[i] - I[i]) for i in range(n)) < tol * (
            1.0 + max(abs(x) for x in I)
        ):
            return new
        I = new
    return I


def _candidate_intervals(
    M: int,
    a: float,
    b: np.ndarray,
    c: float,
    kappa: float,
    d: np.ndarray,
    i_max: int,
) -> List[Tuple[int, ...]]:
    """Proposition-1 candidate set, in the exact enumeration order the
    scalar path historically evaluated (pinned subsets outer, rounding
    combos inner) — both backends pick argmins over this one list."""
    tiers = list(range(M - 1))
    out: List[Tuple[int, ...]] = []
    for pinned in itertools.chain.from_iterable(
        itertools.combinations(tiers, k) for k in range(M)
    ):
        free = [m for m in tiers if m not in pinned]
        base = {m: 1 for m in pinned}
        if not free:
            out.append(tuple(base[m] for m in tiers))
            continue
        pinned_b = float(sum(b[m] for m in pinned))
        root = _newton_jacobi(a, b, c, kappa, d, free, pinned_b)
        if root is None:
            continue
        # floor/ceil neighbourhood of the continuous stationary point
        cands_per = [
            sorted(
                {
                    min(max(int(math.floor(r)), 1), i_max),
                    min(max(int(math.ceil(r)), 1), i_max),
                }
            )
            for r in root
        ]
        for combo in itertools.product(*cands_per):
            iv = dict(base)
            iv.update({m: v for m, v in zip(free, combo)})
            out.append(tuple(iv[m] for m in tiers))
    return out


def _theta_candidates(
    problem: HsflProblem,
    mem_ok: bool,
    a: float,
    b: np.ndarray,
    c: float,
    kappa: float,
    d: np.ndarray,
    cand: np.ndarray,
    e_split: Optional[float] = None,
    e_agg: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Exact Θ'(I, μ) for ``[C, M-1]`` interval rows at one fixed cut —
    latency terms a/b priced once, accumulation order matching
    ``problem.numerator``/``denominator``/``theta`` bit-for-bit.

    ``e_split``/``e_agg`` (the fixed cut's split/agg round energies, from
    ``repro.energy``) mask candidates whose amortized E(I, μ) overruns
    the problem's energy budget; None skips the pricing entirely, and the
    D-floor ``problem.d_min()`` is 0.0 without a privacy budget — both
    checks are bit-identical no-ops when unconstrained (DESIGN.md §15).
    """
    C = cand.shape[0]
    if not mem_ok:
        return np.full(C, INFEASIBLE)
    M = problem.M
    acc = b[0] / cand[:, 0]
    for m in range(1, M - 1):
        acc = acc + b[m] / cand[:, m]
    num = a + acc
    s = np.zeros(C)
    for m in range(M - 1):
        I = cand[:, m]
        s = s + np.where(I > 1, (I * I) * d[m], 0.0)
    D = c - kappa * s
    th = np.full(C, INFEASIBLE)
    ok = D > problem.d_min()
    if e_split is not None:
        e_acc = e_agg[0] / cand[:, 0]
        for m in range(1, M - 1):
            e_acc = e_acc + e_agg[m] / cand[:, m]
        ok = ok & (e_split + e_acc <= problem.energy.budget_j_per_round)
    scale = 2.0 * problem.hyper.theta0 / problem.hyper.gamma
    th[ok] = scale * num[ok] / D[ok]
    return th


def _budget_grid(
    M: int,
    c: float,
    kappa: float,
    d: np.ndarray,
    d_min: float,
    i_max: int,
) -> List[Tuple[int, ...]]:
    """Interval grid over the D-feasible box, for budget-constrained MA.

    Proposition 1's candidate set is the *unconstrained* stationary
    neighbourhood; a binding energy budget pushes the optimum to the
    E(I) = budget boundary (larger I amortizes sync energy), which that
    set never contains.  But C1 bounds the search: D > d_min forces
    I_m < sqrt((c − d_min)/(κ d_m)), so the feasible region is a finite
    box — enumerate it densely (geometric tail past 128, or past 16 when
    M−1 ≥ 3, to keep the product bounded).  Only priced when a budget
    binds, so the unconstrained path never sees these rows.
    """
    dense = 128 if M <= 3 else 16
    per: List[List[int]] = []
    for m in range(M - 1):
        if kappa > 0 and d[m] > 0:
            cap = int(math.floor(math.sqrt(max(c - d_min, 0.0) / (kappa * float(d[m])))))
        else:
            cap = i_max
        cap = max(1, min(cap, i_max))
        vals = list(range(1, min(cap, dense) + 1))
        v = dense
        while v < cap:
            v = min(cap, int(v * 1.25) + 1)
            vals.append(v)
        per.append(vals)
    return [tuple(combo) for combo in itertools.product(*per)]


def _energy_terms(problem: HsflProblem, cuts: Sequence[int]):
    """(E_S, [E_{m,A}]) of the fixed cut when an energy *budget* binds;
    (None, None) otherwise — the vectorized pass then skips pricing."""
    en = problem.energy
    if en is None or en.budget_j_per_round is None:
        return None, None
    from ..energy import agg_energy, split_energy

    e_split = split_energy(
        problem.profile, problem.system, en, cuts, problem.compression
    )
    e_agg = np.array(
        [
            agg_energy(
                problem.profile, problem.system, en, cuts, m,
                problem.compression,
            )
            for m in range(problem.M - 1)
        ]
    )
    return e_split, e_agg


def solve_ma(
    problem: HsflProblem,
    cuts: Sequence[int],
    i_max: int = 10_000,
    backend: str = "auto",
) -> MaSolution:
    """Optimal MA intervals for fixed cuts (Proposition 1 + enumeration).

    ``backend="scalar"`` evaluates each candidate through
    ``problem.theta`` (re-pricing the latency terms per candidate — the
    oracle path); anything else evaluates all candidates in one
    vectorized pass.  Identical winner either way.
    """
    if backend != "scalar":
        from .batched import resolve_backend

        resolve_backend(backend)  # validate; MA's candidate set is small
        # enough that the vectorized pass below is numpy on every backend
    M = problem.M
    a = problem.split_T(cuts)
    b = problem.agg_T(cuts)  # [M-1]
    c, kappa = problem.constants()
    d = problem.tier_d(cuts)[: M - 1]
    cands = _candidate_intervals(M, a, b, c, kappa, d, i_max)
    e_split, e_agg = _energy_terms(problem, cuts)
    if e_split is not None:
        # budget-constrained optimum sits on the E(I) = budget boundary:
        # append the D-feasible integer box (both backends share the list)
        cands = cands + _budget_grid(M, c, kappa, d, problem.d_min(), i_max)

    best: Optional[MaSolution] = None
    if backend == "scalar":
        for intervals in cands:
            th = problem.theta(list(intervals) + [1], cuts)
            if th < (best.theta if best else INFEASIBLE):
                best = MaSolution(tuple(intervals) + (1,), th)
    elif cands:
        arr = np.asarray(cands, dtype=np.int64)
        th = _theta_candidates(
            problem, problem.memory_feasible(cuts), a, b, c, kappa, d, arr,
            e_split, e_agg,
        )
        i = int(np.argmin(th))  # first-tie, like the scalar strict-< scan
        if th[i] < INFEASIBLE:
            best = MaSolution(
                tuple(int(x) for x in arr[i]) + (1,), float(th[i])
            )

    if best is None:
        # No finite-interval schedule reaches ε: fall back to all-ones
        # (most frequent aggregation = tightest bound).
        ones = tuple([1] * (M - 1)) + (1,)
        return MaSolution(ones, problem.theta(list(ones), cuts))
    return best


def solve_ma_bruteforce(
    problem: HsflProblem, cuts: Sequence[int], i_max: int = 60
) -> MaSolution:
    """Exhaustive grid search (test oracle; exponential in M)."""
    M = problem.M
    best_iv, best_th = None, INFEASIBLE
    for combo in itertools.product(range(1, i_max + 1), repeat=M - 1):
        th = problem.theta(list(combo) + [1], cuts)
        if th < best_th:
            best_iv, best_th = tuple(combo) + (1,), th
    if best_iv is None:
        best_iv = tuple([1] * M)
        best_th = problem.theta(list(best_iv), cuts)
    return MaSolution(best_iv, best_th)
