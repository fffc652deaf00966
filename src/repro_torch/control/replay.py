"""Closed-loop replay: wall-clock time-to-ε over a fleet trace — port of
``repro.control.replay`` (verbatim NumPy float64).

Replays a trace round by round under either a fixed schedule or a live
``Controller``, accruing two ledgers per round:

* **wall clock** — the realized split latency of the round (masked max
  over the round's participants, ``sim.fleet.round_latency``) plus every
  tier sync that fires under the current intervals, plus — for the
  adaptive arm — the measured wall time of every control re-solve (the
  controller pays for its own thinking);
* **ε-progress** — the round's bound headroom D_t =
  c(q₁) − κ·Σ I² d_m/q_m (``control.bound.progress_per_round``) under
  the round's *realized* per-tier participation rates; ε is reached when
  Σ_t D_t ≥ 2ϑ/γ, which for a static schedule under constant q is
  exactly Corollary 1's round count.

Both arms use identical ledgers, so the comparison isolates exactly what
the controller changes: the schedule each round runs under.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.convergence import HyperSpec
from ..sim.events import fires
from ..sim.fleet import round_latency
from ..sim.participation import _tier_entity_rates
from ..sim.scenarios import SystemTrace
from .bound import progress_per_round, progress_target
from .controller import ControlDecision, Controller
from .telemetry import observe_round


@dataclass
class ReplayResult:
    reached: bool
    time_to_eps: float                 # seconds (inf when ε not reached)
    rounds_to_eps: Optional[int]
    wall: np.ndarray                   # [rounds_run] per-round seconds
    progress: np.ndarray               # [rounds_run] per-round D_t
    solve_overhead: float              # seconds of control re-solves paid
    decisions: List[ControlDecision] = field(default_factory=list)
    schedule_log: List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = field(
        default_factory=list
    )                                  # (start_round, cuts, intervals)

    @property
    def n_switches(self) -> int:
        return sum(1 for d in self.decisions if d.switched)


def replay(
    trace: SystemTrace,
    hp: HyperSpec,
    eps: float,
    cuts: Sequence[int],
    intervals: Sequence[int],
    controller: Optional[Controller] = None,
    omega: float = 0.0,
    rounds: Optional[int] = None,
    min_q: float = 1e-6,
) -> ReplayResult:
    """Run up to ``rounds`` rounds (trace replays cyclically beyond its
    length) and report wall-clock time-to-ε.  ``controller=None`` is the
    static arm; with a controller, its decisions change the schedule the
    following round and its re-solve seconds accrue to the wall clock."""
    system = trace.system
    M = system.M
    cuts = tuple(int(c) for c in cuts)
    intervals = tuple(int(i) for i in intervals)
    R = trace.rounds if rounds is None else int(rounds)
    target = progress_target(hp)

    wall: List[float] = []
    progress: List[float] = []
    schedule_log = [(0, cuts, intervals)]
    cum = 0.0
    wall_cum = 0.0
    solve_overhead = 0.0
    reached = False
    rounds_to_eps: Optional[int] = None
    time_to_eps = float("inf")
    for r in range(R):
        rr = r % trace.rounds
        fr = round_latency(trace, rr, cuts, backend="numpy")
        state = trace.round_state(rr)
        q_t = np.clip(
            _tier_entity_rates(state.available, system.entities), min_q, 1.0
        )
        d_t = progress_per_round(
            hp, eps, intervals, cuts, omega, participation=q_t
        )
        w_t = fr.split
        for m in range(M - 1):
            if fires(r, intervals[m]):
                w_t = w_t + fr.agg[m]
        cum += d_t
        wall_cum += w_t
        wall.append(float(w_t))
        progress.append(float(d_t))
        if not reached and cum >= target:
            reached = True
            rounds_to_eps = r + 1
            time_to_eps = wall_cum
            break
        if controller is not None:
            obs = observe_round(trace, rr, cuts)
            controller.observe(obs)
            dec = controller.maybe_replan(r)
            if dec is not None:
                wall_cum += dec.solve_seconds
                solve_overhead += dec.solve_seconds
                if dec.switched:
                    cuts, intervals = dec.new_cuts, dec.new_intervals
                    schedule_log.append((r + 1, cuts, intervals))
    return ReplayResult(
        reached=reached,
        time_to_eps=float(time_to_eps),
        rounds_to_eps=rounds_to_eps,
        wall=np.asarray(wall),
        progress=np.asarray(progress),
        solve_overhead=float(solve_overhead),
        decisions=list(controller.decisions) if controller is not None else [],
        schedule_log=schedule_log,
    )
