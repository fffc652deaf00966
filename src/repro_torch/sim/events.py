"""Discrete-event core of the fleet simulator (small-N oracle).

One HSFL round is a set of independent per-client event chains — the
canonical stage chain of ``repro.core.latency.split_stages`` (fwd compute /
uplink / … / bwd compute / downlink) — followed by per-tier fed-server
syncs (entity model upload → aggregate → broadcast).  Events are processed
through a heap keyed by ``(time, seq)`` with a deterministic insertion
counter, so a given ``SystemTrace`` always replays to the identical event
log.  Dropout / join events are emitted whenever a client's availability
mask flips between rounds.

The event core exists as the *oracle*: the vectorized fast path in
``fleet.py`` advances whole rounds with array ops, and must agree with this
simulation bit-for-bit.  Both therefore consume the same per-stage duration
arrays (``round_stage_durations`` / ``round_agg_phases`` below) and
accumulate them in the same order; the only difference is scalar event
scheduling here vs. ``[N]``-vector arithmetic there.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.latency import (
    Stage,
    aggregation_phases,
    split_stages,
    stage_rate,
)
from .scenarios import SystemTrace

# event kinds, in rough lifecycle order
DROPOUT = "dropout"
JOIN = "join"
COMPUTE_DONE = "compute_done"
UPLINK_DONE = "uplink_done"
DOWNLINK_DONE = "downlink_done"
CLIENT_DONE = "client_round_done"
MODEL_UP_DONE = "model_uplink_done"
AGG_DONE = "fed_aggregate_done"
MODEL_DOWN_DONE = "model_downlink_done"
ENTITY_SYNC = "entity_sync"

_STAGE_EVENT = {
    "compute_fwd": COMPUTE_DONE,
    "compute_bwd": COMPUTE_DONE,
    "uplink": UPLINK_DONE,
    "downlink": DOWNLINK_DONE,
}


@dataclass(frozen=True, order=True)
class Event:
    time: float
    seq: int                       # insertion counter: deterministic ties
    kind: str = field(compare=False)
    actor: int = field(compare=False)   # client id, or entity id for syncs
    stage: int = field(compare=False)   # chain index, or tier for syncs


class EventQueue:
    """Deterministic min-heap of events (ties broken by insertion order)."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, actor: int, stage: int) -> Event:
        ev = Event(time, self._seq, kind, actor, stage)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)


# --------------------------------------------------------------------------- #
# shared round pricing (consumed by the event core AND the fleet fast path)
# --------------------------------------------------------------------------- #


def _stage_mult(state, stage: Stage) -> np.ndarray:
    if stage.kind in ("compute_fwd", "compute_bwd"):
        return state.compute_mult[stage.index]
    if stage.kind == "uplink":
        return state.link_up_mult[stage.index]
    return state.link_down_mult[stage.index]


def round_stage_durations(
    trace: SystemTrace, r: int, cuts: Sequence[int]
) -> Tuple[Tuple[Stage, ...], List[np.ndarray]]:
    """Per-stage per-client durations [N] for round r, canonical chain order.

    The trace's ``compression`` spec (if any) already scaled the boundary
    bits inside ``split_stages``, so both consumers (event oracle + fleet
    fast path) price the compressed wire identically.
    """
    state = trace.round_state(r)
    stages = split_stages(trace.profile, cuts, trace.compression)
    durs = [
        s.work / (stage_rate(trace.system, s) * _stage_mult(state, s))
        for s in stages
    ]
    return stages, durs


def round_agg_phases(
    trace: SystemTrace, r: int, cuts: Sequence[int], m: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-entity (upload, download) times of a tier-m sync in round r;
    None when tier m has a single entity (no fed-server traffic).

    When tier m's entities are the clients themselves (J_m == N, i.e. each
    client hosts its own tier-m sub-model), absent clients have nothing to
    upload: the phase arrays cover only the round's participants.
    """
    system = trace.system
    if system.entities[m] <= 1:
        return None
    state = trace.round_state(r)
    up_rate = system.model_up[m] * state.fed_up_mult[m]
    down_rate = system.model_down[m] * state.fed_down_mult[m]
    up, down = aggregation_phases(
        trace.profile, system, cuts, m, up_rate=up_rate, down_rate=down_rate,
        compression=trace.compression,
    )
    if len(up) == system.num_clients:
        up, down = up[state.available], down[state.available]
        if len(up) == 0:
            return None  # zero-participant round: nothing to upload this tier
    return up, down


def fires(r: int, interval: int) -> bool:
    """Tier sync schedule: aggregate at the end of every ``interval``-th round."""
    return (r + 1) % max(1, int(interval)) == 0


# --------------------------------------------------------------------------- #
# the simulation
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class RoundResult:
    split: float                   # T_S of this round (max over participants)
    per_client: np.ndarray         # [N] finish times; NaN for absent clients
    agg: np.ndarray                # [M-1] priced sync latency of every tier
    events: Tuple[Event, ...]      # full deterministic event log
    n_participants: int


@dataclass(frozen=True)
class EventSimResult:
    split: np.ndarray              # [R]
    agg: np.ndarray                # [M-1, R] priced every round
    fired: np.ndarray              # [M-1, R] bool, sync schedule
    total: np.ndarray              # [R] split + fired syncs
    participants: np.ndarray       # [R]


def simulate_round(
    trace: SystemTrace,
    r: int,
    cuts: Sequence[int],
    prev_available: Optional[np.ndarray] = None,
) -> RoundResult:
    """Run one round through the event queue."""
    system = trace.system
    N, M = system.num_clients, system.M
    state = trace.round_state(r)
    stages, durs = round_stage_durations(trace, r, cuts)

    q = EventQueue()
    log: List[Event] = []
    # availability transitions (bookkeeping events at round start)
    for i in range(N):
        if not state.available[i]:
            if prev_available is None or prev_available[i]:
                q.push(0.0, DROPOUT, i, -1)
        elif prev_available is not None and not prev_available[i]:
            q.push(0.0, JOIN, i, -1)
    # kick off every participant's chain
    for i in range(N):
        if state.available[i]:
            q.push(durs[0][i], _STAGE_EVENT[stages[0].kind], i, 0)

    per_client = np.full(N, np.nan)
    n_part = 0
    while len(q):
        ev = q.pop()
        log.append(ev)
        if ev.kind in (DROPOUT, JOIN):
            continue
        i, s = ev.actor, ev.stage
        if s + 1 < len(stages):
            nxt = s + 1
            q.push(ev.time + durs[nxt][i], _STAGE_EVENT[stages[nxt].kind], i, nxt)
        else:
            per_client[i] = ev.time
            log.append(Event(ev.time, -1, CLIENT_DONE, i, s))
            n_part += 1

    split = float(np.max(per_client[state.available])) if n_part else 0.0

    # per-tier fed-server syncs, priced off the split barrier
    agg = np.zeros(M - 1)
    for m in range(M - 1):
        phases = round_agg_phases(trace, r, cuts, m)
        if phases is None:
            continue
        up, down = phases
        for j in range(len(up)):
            q.push(split + up[j], MODEL_UP_DONE, j, m)
        up_t = float(np.max(up))
        q.push(split + up_t, AGG_DONE, 0, m)
        for j in range(len(down)):
            q.push(split + up_t + down[j], MODEL_DOWN_DONE, j, m)
        down_t = float(np.max(down))
        q.push(split + up_t + down_t, ENTITY_SYNC, 0, m)
        agg[m] = up_t + down_t
        while len(q):
            log.append(q.pop())

    return RoundResult(split, per_client, agg, tuple(log), n_part)


def simulate(
    trace: SystemTrace,
    cuts: Sequence[int],
    intervals: Optional[Sequence[int]] = None,
    rounds: Optional[int] = None,
) -> EventSimResult:
    """Replay ``rounds`` rounds of the trace (default: all of them).

    ``intervals`` gates which rounds actually pay each tier's sync latency
    (Eq. 19 schedule); every round's sync is still *priced* in ``agg`` so
    trace quantiles are well defined.  With no intervals every tier syncs
    every round.
    """
    R = trace.rounds if rounds is None else min(rounds, trace.rounds)
    M = trace.system.M
    iv = [1] * (M - 1) if intervals is None else list(intervals[: M - 1])

    split = np.zeros(R)
    agg = np.zeros((M - 1, R))
    fired = np.zeros((M - 1, R), dtype=bool)
    total = np.zeros(R)
    participants = np.zeros(R, dtype=int)
    prev = None
    for r in range(R):
        res = simulate_round(trace, r, cuts, prev_available=prev)
        split[r] = res.split
        agg[:, r] = res.agg
        participants[r] = res.n_participants
        tot = res.split
        for m in range(M - 1):
            if fires(r, iv[m]):
                fired[m, r] = True
                tot = tot + res.agg[m]
        total[r] = tot
        prev = trace.round_state(r).available
    return EventSimResult(split, agg, fired, total, participants)
