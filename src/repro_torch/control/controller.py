"""The closed-loop controller: telemetry → window → drift → warm re-solve
— port of ``repro.control.controller``.

``Controller`` owns the feedback loop around a running HSFL schedule:

1. ``observe`` folds each round's measured telemetry into the windowed
   system estimate (``WindowedLatency`` + windowed participation rates);
2. ``maybe_replan`` compares the windowed estimate against the prices the
   current schedule was solved for (``detect_drift``) and, on drift,
   re-solves MS/MA/BCD **warm-started at the current optimum** against a
   problem carrying the windowed model — the versioned evaluator memo
   plus the Dinkelbach warm seed make a control step milliseconds, not
   the seconds a cold trace re-price costs;
3. a confirmed schedule change is returned as a ``ControlDecision`` for
   the training loop to act on (plan rebuild + state migration).

Cooldown, minimum-window, and check-cadence knobs bound how often the
solver runs; the priced snapshot is refreshed after every re-solve so a
drift that doesn't change the optimum doesn't re-trigger each round.

The re-solve's ``backend`` is the port's batched backend: ``numpy``,
``torch`` (float64 tables on the card), ``torch:<device>``, ``scalar`` or
``auto`` (``core.batched.resolve_backend``); a spec's ``"jax"`` reads as
``torch`` (``core.batched.spec_backend``).  The decisions are the same on
every backend; ``resolve_seconds`` is the host's wall clock.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.batched import spec_backend
from ..core.bcd import BcdResult, solve_bcd
from ..core.convergence import ParticipationSpec
from ..core.problem import HsflProblem
from .drift import DriftReport, detect_drift
from .telemetry import RoundObservation, reconstruct_state
from .window import WindowedLatency


@dataclass(frozen=True)
class ControlDecision:
    """One drift-triggered re-solve (``switched`` marks a schedule change)."""

    round_index: int
    trigger: str
    old_cuts: Tuple[int, ...]
    old_intervals: Tuple[int, ...]
    new_cuts: Tuple[int, ...]
    new_intervals: Tuple[int, ...]
    solve_seconds: float
    drift: DriftReport
    switched: bool

    def describe(self) -> str:
        arrow = "->" if self.switched else "== (no change)"
        return (
            f"round {self.round_index:4d}  [{self.trigger}]  "
            f"cuts {self.old_cuts} x I{self.old_intervals} {arrow} "
            f"cuts {self.new_cuts} x I{self.new_intervals}  "
            f"({1e3 * self.solve_seconds:.1f} ms re-solve)"
        )


class Controller:
    """Adaptive (cut, I, μ) control around a running schedule.

    ``problem`` is the experiment's problem (its profile / system / hyper
    / eps / compression seed the windowed re-pricing; any attached
    latency model or participation spec defines the *initially priced*
    reference the drift detector compares against).  ``deadline`` keeps
    the straggler policy: the windowed model then prices deadline-capped
    expected rounds and the windowed q comes from realized deadline
    masks, exactly like the offline ``DeadlineLatency`` pipeline.
    """

    def __init__(
        self,
        problem: HsflProblem,
        cuts: Sequence[int],
        intervals: Sequence[int],
        *,
        window: int = 8,
        check_every: int = 1,
        rel_tol: float = 0.25,
        cooldown: int = 8,
        min_window: int = 4,
        quantile: float = 0.5,
        deadline: Optional[float] = None,
        warm_start: bool = True,
        backend: str = "auto",
        max_switches: int = 0,
        fault_tol: float = 1.0,
    ):
        self.cuts = tuple(int(c) for c in cuts)
        self.intervals = tuple(int(i) for i in intervals)
        self.check_every = max(1, int(check_every))
        self.rel_tol = float(rel_tol)
        self.cooldown = max(0, int(cooldown))
        self.min_window = max(2, int(min_window))
        self.warm_start = bool(warm_start)
        self.backend = spec_backend(backend)
        self.max_switches = int(max_switches)
        # sustained-fault-burst trigger (DESIGN.md §16): windowed mean
        # fraction of clients lost per round; 1.0 disables (rate ≤ 1).
        self.fault_tol = float(fault_tol)
        self._fault_window: List[float] = []
        if deadline is None and problem.participation is not None:
            deadline = problem.participation.deadline
        self.deadline = deadline
        # the windowed re-pricing base: same physics, no offline model
        self.base = dataclasses.replace(
            problem, latency_model=None, participation=None
        )
        lattice_rows = {
            tuple(int(x) for x in row) for row in self.base.cut_lattice()
        }
        if self.cuts not in lattice_rows:
            raise ValueError(
                f"initial cuts {self.cuts} are not on the problem's cut "
                f"lattice ({len(lattice_rows)} rows for n_units="
                f"{self.base.n_units}, M={self.base.M}); the controller can "
                "only price and re-solve lattice schedules — start from a "
                "solver result or a valid iter_cut_vectors row"
            )
        self.window_model = WindowedLatency(
            self.base.profile, self.base.system, self.base.cut_lattice(),
            window=window, quantile=quantile, deadline=deadline,
            compression=self.base.compression,
        )
        self._wproblem: Optional[HsflProblem] = None
        self.decisions: List[ControlDecision] = []
        self.resolve_seconds: List[float] = []
        self._cooldown_until = -1
        self._n_switches = 0
        # what the current schedule was priced against
        self._snapshot_from_problem(problem)

    # ------------------------------------------------------------------ #
    def _snapshot_from_problem(self, problem: HsflProblem) -> None:
        self._priced_split = float(problem.split_T(self.cuts))
        self._priced_agg = np.asarray(problem.agg_T(self.cuts), dtype=float)
        self._priced_q1 = float(problem.q[0])

    def _snapshot_from_window(self) -> None:
        self._priced_split = float(self.window_model.split_T(self.cuts))
        self._priced_agg = np.array(
            [
                self.window_model.agg_T(self.cuts, m)
                for m in range(self.base.M - 1)
            ]
        )
        self._priced_q1 = float(self._windowed_q()[0])

    def _windowed_q(self) -> np.ndarray:
        return np.clip(self.window_model.q_tiers(), 1e-6, 1.0)

    # ------------------------------------------------------------------ #
    def observe(self, obs: RoundObservation) -> None:
        """Fold one round's telemetry into the window (reconstructs the
        round's rate multipliers from the measured durations)."""
        state = reconstruct_state(
            obs, self.base.profile, self.base.system, self.base.compression
        )
        self.window_model.push(state, mask=obs.mask)
        self._fault_window.append(
            float(obs.n_faulty) / float(self.base.system.num_clients)
        )
        if len(self._fault_window) > self.window_model.window:
            self._fault_window.pop(0)

    def fault_rate(self) -> float:
        """Windowed mean fraction of clients lost to faults per round."""
        if not self._fault_window:
            return 0.0
        return float(np.mean(self._fault_window))

    def windowed_problem(self) -> HsflProblem:
        """The problem the re-solve runs against: the base physics with the
        windowed latency model and windowed participation attached.

        Both sides derive from the same observation window, so composing
        them via a direct ``dataclasses.replace`` is the consistent
        online analogue of ``participation_problem``.  The instance is
        reused while the participation view is unchanged — the versioned
        evaluator memo (``HsflProblem.evaluator``) then rebuilds only the
        latency tables that actually moved.
        """
        q = self._windowed_q()
        spec = None
        if self.deadline is not None or bool(np.any(q < 1.0 - 1e-12)):
            spec = ParticipationSpec(
                q=tuple(float(v) for v in q), deadline=self.deadline
            )
        if self._wproblem is None or spec != self._wproblem.participation:
            self._wproblem = dataclasses.replace(
                self.base,
                latency_model=self.window_model,
                participation=spec,
            )
        return self._wproblem

    def resolve(self) -> Tuple[BcdResult, float]:
        """Warm-started BCD against the windowed problem; returns the
        result and the wall-clock seconds the solve took."""
        wp = self.windowed_problem()
        t0 = time.perf_counter()
        res = solve_bcd(
            wp,
            init_cuts=self.cuts if self.warm_start else None,
            init_intervals=self.intervals if self.warm_start else None,
            backend=self.backend,
            warm_start=self.warm_start,
        )
        dt = time.perf_counter() - t0
        self.resolve_seconds.append(dt)
        return res, dt

    def maybe_replan(self, r: int) -> Optional[ControlDecision]:
        """Drift check for round ``r``; re-solves and returns a decision
        when the windowed system has left the priced model."""
        if self.window_model.n_obs < self.min_window:
            return None
        if (r + 1) % self.check_every != 0:
            return None
        if r < self._cooldown_until:
            return None
        if self.max_switches and self._n_switches >= self.max_switches:
            return None
        split_obs = self.window_model.split_T(self.cuts)
        agg_obs = np.array(
            [self.window_model.agg_T(self.cuts, m) for m in range(self.base.M - 1)]
        )
        report = detect_drift(
            split_obs, self._priced_split,
            agg_obs, self._priced_agg,
            float(self._windowed_q()[0]), self._priced_q1,
            self.rel_tol,
            fault_rate_obs=self.fault_rate(),
            fault_tol=self.fault_tol,
        )
        if not report.drifted:
            return None
        res, dt = self.resolve()
        new_cuts = tuple(int(c) for c in res.cuts)
        new_intervals = tuple(int(i) for i in res.intervals)
        switched = (new_cuts, new_intervals) != (self.cuts, self.intervals)
        dec = ControlDecision(
            round_index=int(r),
            trigger=report.trigger,
            old_cuts=self.cuts,
            old_intervals=self.intervals,
            new_cuts=new_cuts,
            new_intervals=new_intervals,
            solve_seconds=dt,
            drift=report,
            switched=switched,
        )
        self.cuts, self.intervals = new_cuts, new_intervals
        # re-anchor the drift reference at what we just solved against
        self._snapshot_from_window()
        self._cooldown_until = r + 1 + self.cooldown
        if switched:
            self._n_switches += 1
        self.decisions.append(dec)
        return dec

    # ------------------------------------------------------------------ #
    @property
    def n_switches(self) -> int:
        return self._n_switches

    def resolve_quantiles(self, qs=(0.5, 0.95)) -> Tuple[float, ...]:
        """Re-solve latency quantiles in seconds (p50/p95 by default)."""
        if not self.resolve_seconds:
            return tuple(float("nan") for _ in qs)
        arr = np.asarray(self.resolve_seconds)
        return tuple(float(np.quantile(arr, q)) for q in qs)
