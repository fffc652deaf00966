"""Drift detection: windowed estimate vs. the currently-priced model —
port of ``repro.control.drift`` (verbatim NumPy).

The controller snapshots the latency/participation values its current
schedule was solved against; each check compares the windowed estimate of
those same quantities *at the current schedule* and trips when any
relative deviation exceeds ``rel_tol``.  Checking at the current operating
point (rather than, say, table norms over the whole lattice) keeps the
trigger cheap, scale-free, and aligned with what actually invalidates the
schedule: the prices the solver believed when it chose it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class DriftReport:
    drifted: bool
    trigger: str       # "" or "+"-joined subset of latency/participation/faults
    split_rel: float   # relative deviation of windowed T_S at current cuts
    agg_rel: float     # max relative deviation of windowed T_{m,A}
    q_rel: float       # relative deviation of windowed q_1
    fault_rate: float = 0.0  # windowed fraction of faulty clients per round


def _rel(observed: float, priced: float, floor: float = 1e-12) -> float:
    return abs(float(observed) - float(priced)) / max(abs(float(priced)), floor)


def detect_drift(
    split_obs: float,
    split_priced: float,
    agg_obs: np.ndarray,
    agg_priced: np.ndarray,
    q1_obs: float,
    q1_priced: float,
    rel_tol: float,
    fault_rate_obs: float = 0.0,
    fault_tol: float = 1.0,
) -> DriftReport:
    """Compare windowed vs. priced system values at the current schedule.

    ``fault_rate_obs`` is the windowed mean fraction of clients lost to
    faults per round (crash + quarantine, DESIGN.md §16); a sustained
    burst above ``fault_tol`` is a drift trigger of its own (``"faults"``)
    — the schedule was priced for a healthier fleet.  The default
    ``fault_tol=1.0`` can never trip (the rate is a fraction ≤ 1), so
    fault-blind callers see bit-identical reports.
    """
    split_rel = _rel(split_obs, split_priced)
    agg_rel = 0.0
    for o, p in zip(np.atleast_1d(agg_obs), np.atleast_1d(agg_priced)):
        if float(o) == 0.0 and float(p) == 0.0:
            continue  # single-entity tier: no fed traffic on either side
        agg_rel = max(agg_rel, _rel(o, p))
    q_rel = _rel(q1_obs, q1_priced)
    triggers = []
    if split_rel > rel_tol or agg_rel > rel_tol:
        triggers.append("latency")
    if q_rel > rel_tol:
        triggers.append("participation")
    if float(fault_rate_obs) > float(fault_tol):
        triggers.append("faults")
    return DriftReport(
        drifted=bool(triggers),
        trigger="+".join(triggers),
        split_rel=float(split_rel),
        agg_rel=float(agg_rel),
        q_rel=float(q_rel),
        fault_rate=float(fault_rate_obs),
    )
