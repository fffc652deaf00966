"""Round telemetry: what the controller can actually measure — port of
``repro.control.telemetry`` (verbatim NumPy float64).

In a deployed HSFL system the orchestrator sees per-stage wall-clock
durations reported by clients and fed servers, the availability /
participation masks, and the training loss — never the underlying rate
multipliers the scenario generators draw.  ``RoundObservation`` is exactly
that sensor payload; ``observe_round`` produces it from a fleet trace
(the "ground truth" in this repro), and ``reconstruct_state`` inverts the
timings back into a ``RoundState`` (rate multipliers) the windowed system
estimate can re-price the whole cut lattice against.

The inversion is exact up to floating-point division error: a stage
duration is ``work / (nominal_rate · mult)``, so ``mult = work /
(duration · nominal_rate)``.  Absent clients report nothing — their
durations are NaN and their reconstructed multipliers default to 1.0,
which is immaterial because every pricing path masks unavailable clients
out of the round reductions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.batched import model_bits_lattice
from ..core.latency import (
    LayerProfile,
    SystemSpec,
    aggregation_phases,
    split_stages,
    stage_rate,
)
from ..sim.events import round_stage_durations
from ..sim.scenarios import RoundState, SystemTrace


@dataclass(frozen=True)
class RoundObservation:
    """One round's measured telemetry (the controller's sensor payload).

    ``stage_durations`` follows the canonical chain order of
    ``core.latency.split_stages`` at ``cuts``; entries are NaN for absent
    clients.  ``fed_up``/``fed_down`` are the per-entity model-exchange
    durations of each client-hosted-or-fed-server tier sync (None for
    single-entity tiers).  ``mask`` is the realized participation mask
    when a deadline policy is active (None = availability is the mask).
    """

    round_index: int
    cuts: Tuple[int, ...]
    stage_durations: Tuple[np.ndarray, ...]       # [S] entries of [N]
    available: np.ndarray                          # [N] bool
    fed_up: Tuple[Optional[np.ndarray], ...]       # [M-1] entries of [J_m]
    fed_down: Tuple[Optional[np.ndarray], ...]     # [M-1] entries of [J_m]
    mask: Optional[np.ndarray] = None              # [N] bool
    loss: Optional[float] = None
    n_faulty: int = 0                              # clients lost to faults
                                                   # this round (crash +
                                                   # quarantine, §16)


def observe_round(
    trace: SystemTrace,
    r: int,
    cuts: Sequence[int],
    mask: Optional[np.ndarray] = None,
    loss: Optional[float] = None,
    n_faulty: int = 0,
) -> RoundObservation:
    """Measure round ``r`` of a fleet trace at the current cut vector.

    This is the sensor of the control loop: it reads the same per-stage
    duration arrays the simulators price (``events.round_stage_durations``)
    and the full per-entity fed-exchange phases, NaN-ing out what absent
    clients would never report.
    """
    system = trace.system
    state = trace.round_state(r)
    avail = state.available
    _, durs = round_stage_durations(trace, r, cuts)
    durs = tuple(np.where(avail, d, np.nan) for d in durs)
    fed_up, fed_down = [], []
    for m in range(system.M - 1):
        if system.entities[m] <= 1:
            fed_up.append(None)
            fed_down.append(None)
            continue
        up_rate = system.model_up[m] * state.fed_up_mult[m]
        down_rate = system.model_down[m] * state.fed_down_mult[m]
        up, down = aggregation_phases(
            trace.profile, system, cuts, m,
            up_rate=up_rate, down_rate=down_rate,
            compression=trace.compression,
        )
        if len(up) == system.num_clients:  # client-hosted: absentees silent
            up = np.where(avail, up, np.nan)
            down = np.where(avail, down, np.nan)
        fed_up.append(up)
        fed_down.append(down)
    return RoundObservation(
        round_index=int(r),
        cuts=tuple(int(c) for c in cuts),
        stage_durations=durs,
        available=avail.copy(),
        fed_up=tuple(fed_up),
        fed_down=tuple(fed_down),
        mask=None if mask is None else np.asarray(mask, dtype=bool).copy(),
        loss=None if loss is None else float(loss),
        n_faulty=int(n_faulty),
    )


def _invert(work: float, durations: np.ndarray, nominal: np.ndarray) -> np.ndarray:
    """mult = work / (duration · nominal_rate), 1.0 where unobserved."""
    with np.errstate(divide="ignore", invalid="ignore"):
        mult = work / (durations * nominal)
    return np.where(np.isfinite(mult) & (mult > 0), mult, 1.0)


def reconstruct_state(
    obs: RoundObservation,
    profile: LayerProfile,
    system: SystemSpec,
    compression=None,
) -> RoundState:
    """Invert measured durations into the round's rate multipliers.

    Compute multipliers come from the forward-compute stages (the
    backward stage yields the identical estimate — every scenario scales
    both by the same device multiplier); link multipliers from the
    uplink/downlink stages; fed multipliers from the model-exchange
    phases against the tier's model bits.  Unobserved entries (absent
    clients, single-entity tiers) reconstruct to 1.0.
    """
    M, N = system.M, system.num_clients
    stages = split_stages(profile, obs.cuts, compression)
    by_key = {}
    for s, st in enumerate(stages):
        by_key[(st.kind, st.index)] = _invert(
            st.work, obs.stage_durations[s], stage_rate(system, st)
        )
    ones = np.ones(N)
    compute = tuple(by_key.get(("compute_fwd", m), ones) for m in range(M))
    link_up = tuple(by_key.get(("uplink", m), ones) for m in range(M - 1))
    link_down = tuple(by_key.get(("downlink", m), ones) for m in range(M - 1))
    lam = model_bits_lattice(
        profile, np.asarray([obs.cuts], dtype=np.int64), compression
    )[0]
    fed_up, fed_down = [], []
    for m in range(M - 1):
        n_ent = len(system.model_up[m])
        if obs.fed_up[m] is None:
            fed_up.append(np.ones(n_ent))
            fed_down.append(np.ones(n_ent))
            continue
        fed_up.append(_invert(lam[m], obs.fed_up[m], system.model_up[m]))
        fed_down.append(_invert(lam[m], obs.fed_down[m], system.model_down[m]))
    return RoundState(
        available=obs.available.copy(),
        compute_mult=compute,
        link_up_mult=link_up,
        link_down_mult=link_down,
        fed_up_mult=tuple(fed_up),
        fed_down_mult=tuple(fed_down),
    )
