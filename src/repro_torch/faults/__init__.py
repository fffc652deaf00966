"""Fault injection & fault-tolerant training (DESIGN.md §16) — port of
``repro.faults``.

Deterministic fault regimes (``FaultSpec``) expanded per round from seeded
streams, composed with ``sim`` scenario traces (``faulty_trace``) so both
latency paths price identical fault-adjusted rounds; data-plane corruption
(``apply_corruption``) for the guard in ``tiers.synchronize`` to catch;
cell-outage rerouting over one-hot cell membership (``reroute``); and the
q-deflation accounting that keeps Theorem 1 honest under detected faults.
"""
from .accounting import (
    deflate_participation,
    fault_survival,
    round_healthy,
)
from .inject import apply_corruption, faulty_round_state, faulty_trace
from .reroute import (
    assignment_members,
    membership_mean,
    outage_assignment,
    reroute_entity_sync,
)
from .spec import (
    CORRUPT_MODES,
    CRASH_STAGES,
    FAULT_TAG,
    FaultSpec,
    RoundFaults,
    expand_faults,
    retry_attempts,
)

__all__ = [
    "CORRUPT_MODES",
    "CRASH_STAGES",
    "FAULT_TAG",
    "FaultSpec",
    "RoundFaults",
    "apply_corruption",
    "assignment_members",
    "deflate_participation",
    "expand_faults",
    "fault_survival",
    "faulty_round_state",
    "faulty_trace",
    "membership_mean",
    "outage_assignment",
    "reroute_entity_sync",
    "retry_attempts",
    "round_healthy",
]
