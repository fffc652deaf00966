"""Online adaptive control: re-solve (cut, I, μ, deadline) mid-run from
observed fleet telemetry — port of ``repro.control`` (DESIGN.md §13).

The loop: ``telemetry.observe_round`` measures a round →
``Controller.observe`` folds it into the windowed system estimate
(``window.WindowedLatency`` + windowed participation) →
``Controller.maybe_replan`` detects drift against the currently-priced
model (``drift``) and re-solves BCD warm-started from the previous
optimum → the training loop migrates engine state across the switch
(``migrate``) → ``bound.piecewise_bound`` composes Theorem 1 across the
segments.  ``replay`` replays the whole loop analytically over a trace
for time-to-ε comparisons.

Everything but ``migrate`` is NumPy float64, as in the JAX package, and
equals it with ``==``.  ``migrate`` moves engine state on the device:
Engine A's client-stacked tree and Engine B's tier stacks, both through
B1's entity means.
"""
from .bound import (
    BoundSegment,
    piecewise_bound,
    progress_per_round,
    progress_target,
)
from .controller import ControlDecision, Controller
from .drift import DriftReport, detect_drift
from .migrate import (
    migrate_params_a,
    migrate_params_b,
    migrate_state,
    migrate_state_a,
    migrate_state_b,
    resume_with_migration,
)
from .replay import ReplayResult, replay
from .telemetry import RoundObservation, observe_round, reconstruct_state
from .window import WindowedLatency

__all__ = [
    "BoundSegment",
    "piecewise_bound",
    "progress_per_round",
    "progress_target",
    "ControlDecision",
    "Controller",
    "DriftReport",
    "detect_drift",
    "migrate_params_a",
    "migrate_params_b",
    "migrate_state",
    "migrate_state_a",
    "migrate_state_b",
    "resume_with_migration",
    "ReplayResult",
    "replay",
    "RoundObservation",
    "observe_round",
    "reconstruct_state",
    "WindowedLatency",
]
