"""Fault accounting: deflate the effective q_m fed to Theorem 1.

A detected fault is a lost contribution: a crashed client uploads nothing,
a quarantined (corrupt) client is zeroed out of its group by the guard,
and a cell outage silences a whole fed entity plus its clients.  All three
are *exactly* partial participation in the Theorem-1 sense — the round
averages over fewer gradients and tier syncs land on fewer entities — so
the honest bound is the PR 5 machinery with q_m multiplied by the fault
survival rate (DESIGN.md §16):

    q_m^eff = q_m^base · s_m,   s_m = E_r[ fraction of tier-m entities
                                           with ≥1 healthy participant ]

``fault_survival`` computes s_m from the spec's own seeded expansion over
the run's rounds (the realized masks, not a closed form — bitflips of the
actual streams are what training will see); ``deflate_participation``
folds it into a ``ParticipationSpec``.  A null spec returns the base spec
object unchanged (bit-exact zero-fault collapse).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.convergence import ParticipationSpec, participation_rates
from .spec import FaultSpec, expand_faults


def round_healthy(
    spec: FaultSpec, r: int, num_clients: int, entities: Tuple[int, ...]
) -> np.ndarray:
    """[N] bool — clients whose round-r contribution survives the faults
    (not crashed, not corrupt, not served by a dead cell)."""
    rf = expand_faults(spec, r, num_clients)
    healthy = ~rf.faulty
    if rf.cell_out:
        J = entities[spec.outage_tier]
        per = num_clients // J
        cell_of = np.repeat(np.arange(J), per)
        healthy &= ~np.isin(cell_of, np.asarray(spec.outage_cells))
    return healthy


def fault_survival(
    spec: FaultSpec,
    num_clients: int,
    entities: Tuple[int, ...],
    rounds: int,
) -> np.ndarray:
    """[M] mean per-tier entity survival over the run's realized faults.

    Tier m's per-round rate is the fraction of its entities holding at
    least one healthy client — the same entity-participation convention
    ``sim.participation`` uses for deadline misses, so fault deflation
    and straggler deflation compose multiplicatively.
    """
    if rounds <= 0:
        raise ValueError(f"rounds must be > 0: {rounds}")
    M = len(entities)
    if spec.is_null:
        return np.ones(M)
    acc = np.zeros(M)
    for r in range(rounds):
        healthy = round_healthy(spec, r, num_clients, entities)
        for m, J in enumerate(entities):
            per = num_clients // J
            acc[m] += healthy.reshape(J, per).any(axis=1).mean()
    return acc / rounds


def deflate_participation(
    base: Optional[ParticipationSpec],
    spec: Optional[FaultSpec],
    num_clients: int,
    entities: Tuple[int, ...],
    rounds: int,
) -> Optional[ParticipationSpec]:
    """The participation spec with fault survival multiplied in.

    Returns ``base`` itself for a null/absent fault spec.  Raises when a
    tier's survival hits zero — every round lost a whole tier (the
    all-faulty degenerate input), for which no finite 1/q inflation
    exists.
    """
    if spec is None or spec.is_null:
        return base
    M = len(entities)
    s = fault_survival(spec, num_clients, entities, rounds)
    if np.any(s <= 0.0):
        dead = [m for m in range(M) if s[m] <= 0.0]
        raise ValueError(
            f"all-faulty rounds: tier(s) {dead} have zero surviving "
            "entities across the whole run — the 1/q_m bound inflation "
            "is undefined; lower the fault rates or shorten the outage"
        )
    q = participation_rates(base, M) * s
    deadline = base.deadline if base is not None else None
    return ParticipationSpec(q=tuple(float(v) for v in q), deadline=deadline)
