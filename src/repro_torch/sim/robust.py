"""Robust system optimization: trace quantiles in place of point estimates
— port of ``repro.sim.robust``.

``TraceLatency`` implements the ``LatencyModel`` protocol of
``repro.core.problem``: T_S(μ) and T_{m,A}(μ) become the q-quantile (p50 =
typical, p95 = straggler-robust) of the per-round latencies a scenario
trace produces for that cut vector.  Attaching it to an ``HsflProblem``
(``robust_problem``) leaves the convergence side of Θ' untouched, so the
existing Proposition-1 MA solver, Dinkelbach MS solver, and BCD loop
optimize (I, μ) against the empirical regime with no changes — on the
homogeneous-paper scenario the quantiles collapse to exactly Eq. (17)/(18)
and the robust problem *is* the nominal one.

This is the trace half of the composition order ``repro.api.build`` owns:
compression lands on the base problem first, and ``robust_problem``
re-prices the trace over that same wire — declare both in one
``ExperimentSpec`` and the ordering is resolved for you.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.problem import HsflProblem
from .fleet import simulate_lattice_rounds, simulate_rounds
from .scenarios import SystemTrace


class TraceLatency:
    """q-quantile pricing of the latency terms over a ``SystemTrace``.

    Per-round latencies are simulated once per cut vector through the
    vectorized fleet path and cached — the BCD/Dinkelbach solvers revisit
    the same lattice points many times.

    The batched solver core (``core.batched.BatchedEvaluator``) consumes
    the ``split_T_batch``/``agg_T_batch`` lattice methods instead: one
    ``[K, N]``-per-round sweep prices every cut vector at once, and
    ``np.quantile`` along the rounds axis is bit-identical to the scalar
    per-cut quantile — so robust solves return the same optima on every
    backend (DESIGN.md §11).
    """

    def __init__(
        self,
        trace: SystemTrace,
        quantile: float = 0.95,
        rounds: int = None,
        backend: str = "numpy",
    ):
        self.trace = trace
        self.quantile = float(quantile)
        self.rounds = trace.rounds if rounds is None else min(rounds, trace.rounds)
        self.backend = backend
        self._cache: Dict[Tuple[int, ...], Tuple[np.ndarray, np.ndarray]] = {}
        self._lattice_cache: Optional[
            Tuple[bytes, Tuple[np.ndarray, np.ndarray]]
        ] = None

    def per_round(self, cuts: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(split [R], agg [M-1, R]) for this cut vector, cached."""
        key = tuple(int(c) for c in cuts)
        hit = self._cache.get(key)
        if hit is None:
            res = simulate_rounds(
                self.trace, key, rounds=self.rounds, backend=self.backend
            )
            hit = self._cache[key] = (res.split, res.agg)
        return hit

    def per_round_lattice(
        self, lattice: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(split [K, R], agg [K, M-1, R]) for a whole cut lattice, cached
        (BCD builds one evaluator per problem but may rebuild after
        ``with_compression``; the trace sweep is the expensive part)."""
        key = lattice.tobytes()
        if self._lattice_cache is not None and self._lattice_cache[0] == key:
            return self._lattice_cache[1]
        res = simulate_lattice_rounds(
            self.trace, lattice, rounds=self.rounds, backend=self.backend
        )
        self._lattice_cache = (key, res)
        return res

    # ------------------------------------------------------------------ #
    # LatencyModel protocol
    # ------------------------------------------------------------------ #
    def split_T(self, cuts: Sequence[int]) -> float:
        split, _ = self.per_round(cuts)
        return float(np.quantile(split, self.quantile))

    def agg_T(self, cuts: Sequence[int], m: int) -> float:
        _, agg = self.per_round(cuts)
        return float(np.quantile(agg[m], self.quantile))

    # ------------------------------------------------------------------ #
    # batched lattice protocol (consumed by core.batched.BatchedEvaluator)
    # ------------------------------------------------------------------ #
    def split_T_batch(self, lattice: np.ndarray) -> np.ndarray:
        """[K] q-quantile T_S per lattice row (== ``split_T`` per row)."""
        split, _ = self.per_round_lattice(lattice)
        return np.quantile(split, self.quantile, axis=1)

    def agg_T_batch(self, lattice: np.ndarray) -> np.ndarray:
        """[K, M-1] q-quantile T_{m,A} per row (== ``agg_T`` per row)."""
        _, agg = self.per_round_lattice(lattice)
        return np.quantile(agg, self.quantile, axis=2)


def robust_problem(
    problem: HsflProblem,
    trace: SystemTrace,
    quantile: float = 0.95,
    rounds: int = None,
    backend: str = "numpy",
) -> HsflProblem:
    """The same MA+MS problem, priced at the trace's q-quantile latencies.

    A compressed problem stays compressed: when the problem carries a
    ``CompressionSpec`` and the trace does not, the trace is re-priced over
    the same wire, so the quantiles the solvers consume reflect the ratio
    (ω keeps entering through ``problem.constants()`` as always).  A trace
    already priced over a *different* wire is a configuration error —
    quantiles and ω would describe two different codecs — and raises.
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
    model = TraceLatency(trace, quantile=quantile, rounds=rounds, backend=backend)
    return dataclasses.replace(problem, latency_model=model)
