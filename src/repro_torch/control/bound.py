"""Piecewise Theorem-1 bookkeeping across control switches — port of
``repro.control.bound`` (verbatim NumPy float64).

A controlled run is a sequence of segments, each holding one schedule
(I, μ) — and possibly its own ω / participation view — for R_s rounds.
Summing the paper's per-round descent inequality over each segment and
telescoping f across the switch points (state migration preserves the
client-mean iterate, so the f-terms chain) gives

    (1/R) Σ_t E‖∇f(w_t)‖²  ≤  2ϑ/(γR)  +  Σ_s (R_s/R) · P_s

with P_s the schedule's per-round penalty — exactly the term2+term3 of
``theorem1_bound`` for segment s (``core.convergence.bound_round_terms``).

Bit-exact collapse: with a single segment, R_s/R is exactly 1.0 and the
accumulation below reproduces ``theorem1_bound``'s ``(term1 + term2) +
term3`` association with multiply-by-1.0 no-ops — the composed bound is
bit-identical to the static bound when no switch fires (property-tested
in ``tests/test_torch_control.py``).

``progress_per_round`` is the ε-accounting dual: round t under schedule
s contributes D_t = ε − P_s headroom (with the round's *realized*
participation rates), and ε is reached once Σ_t D_t ≥ 2ϑ/γ — for a
static schedule under constant q this is exactly Corollary 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..core.convergence import (
    HyperSpec,
    ParticipationSpec,
    bound_constants,
    bound_round_terms,
    participation_rates,
    tier_G2_sums,
)


@dataclass(frozen=True)
class BoundSegment:
    """``rounds`` consecutive rounds run under one schedule."""

    rounds: float
    intervals: Tuple[int, ...]
    cuts: Tuple[int, ...]
    omega: float = 0.0
    participation: Union[None, float, Sequence[float], ParticipationSpec] = None
    dp_sigma2: float = 0.0         # DP noise power (privacy.PrivacySpec)

    def __post_init__(self):
        if self.rounds <= 0:
            raise ValueError(f"segment rounds must be positive: {self.rounds}")
        object.__setattr__(self, "intervals", tuple(int(i) for i in self.intervals))
        object.__setattr__(self, "cuts", tuple(int(c) for c in self.cuts))


def piecewise_bound(hp: HyperSpec, segments: Sequence[BoundSegment]) -> float:
    """RHS of the composed Eq. (8) over a switch sequence.

    One segment collapses bit-exactly to ``theorem1_bound(hp, R, I, μ)``.
    """
    if not segments:
        raise ValueError("piecewise bound needs at least one segment")
    R = segments[0].rounds
    for s in segments[1:]:
        R = R + s.rounds
    acc = 2.0 * hp.theta0 / (hp.gamma * R)
    for s in segments:
        w = s.rounds / R
        term2, term3 = bound_round_terms(
            hp, s.intervals, s.cuts, s.omega, s.participation,
            dp_sigma2=s.dp_sigma2,
        )
        acc = acc + w * term2
        acc = acc + w * term3
    return acc


def progress_per_round(
    hp: HyperSpec,
    eps: float,
    intervals: Sequence[int],
    cuts: Sequence[int],
    omega: float = 0.0,
    participation: Union[None, float, Sequence[float], ParticipationSpec] = None,
) -> float:
    """ε-headroom one round under (I, μ) contributes: D = c(q₁) − κ·Σ I²d_m/q_m.

    Summed over a run, ε is reached when Σ_t D_t ≥ 2ϑ/γ
    (``progress_target``); under a static schedule with constant q the
    crossing round is exactly Corollary 1's R.
    """
    M = len(intervals)
    q = participation_rates(participation, M)
    c, kappa = bound_constants(hp, eps, omega, q1=q[0])
    d = tier_G2_sums(hp.G2, cuts)
    drift = sum(
        (I**2) * (dm / qm)
        for I, dm, qm in zip(intervals[:-1], d[:-1], q[:-1])
        if I > 1
    )
    return c - kappa * drift


def progress_target(hp: HyperSpec) -> float:
    """Total ε-headroom a run must accumulate: 2ϑ/γ."""
    return 2.0 * hp.theta0 / hp.gamma
