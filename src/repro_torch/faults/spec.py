"""Deterministic fault model: what can go wrong, expanded per round.

A ``FaultSpec`` is the JSON-serializable description of a fleet's failure
regime — four orthogonal fault classes layered on top of whatever
``sim.scenarios`` regime the trace already carries:

* **crash**   — a client dies mid-round at a named split stage; its upload
  never reaches the server, so the round barrier excludes it (the partial
  chain work is wasted, recorded in telemetry, never waited on).
* **corrupt** — a client's uploaded replica is wrong: ``nan``/``inf``
  poison, a ``scale`` blow-up, or a ``bitflip`` in the exponent bits.
  Timing is unaffected (the bytes arrive on schedule); the guard path in
  ``tiers.synchronize`` is what catches these (DESIGN.md §16).
* **link**    — transient link-layer failures: every link traversal
  independently fails with ``link_fail_rate`` and is retried up to
  ``link_retries`` times.  Realized retries scale the trace's per-round
  link multipliers; the *expected* attempt count prices the analytic
  tables (``retry_attempts``, threaded through ``core.latency``).
* **outage**  — a whole fed-server cell (a tier-``outage_tier`` entity)
  is down for a span of rounds: it contributes nothing to the tier's
  aggregation barrier and its clients reroute to sibling cells
  (``faults.reroute``).

Expansion is seeded exactly like the scenario library: round r's fault
draws come from ``np.random.default_rng([seed, r, FAULT_TAG + class])``,
so faults compose with any scenario without perturbing its streams, and
the event oracle / vectorized fleet path see identical fault-adjusted
states.  A spec with all rates zero and no outage is *null*: every
composition hook returns its input unchanged (bit-for-bit).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

# Stream tags: scenarios use 0–4 (+16 for flaky-wan block outages); faults
# get their own block far away so composing never collides.
FAULT_TAG = 32
_CRASH_STREAM = 0
_CORRUPT_STREAM = 1
_LINK_STREAM = 2

CORRUPT_MODES = ("nan", "inf", "scale", "bitflip")
CRASH_STAGES = ("compute_fwd", "uplink", "compute_bwd", "downlink")


@dataclass(frozen=True)
class FaultSpec:
    """Seeded, JSON-round-trippable fault regime (all classes optional)."""

    seed: int = 0
    crash_rate: float = 0.0            # per-client per-round crash prob
    crash_stage: str = "uplink"        # named split stage the crash hits
    corrupt_rate: float = 0.0          # per-client per-round corruption prob
    corrupt_mode: str = "nan"          # nan | inf | scale | bitflip
    corrupt_scale: float = 1e6         # multiplier for mode="scale"
    link_fail_rate: float = 0.0        # per-traversal failure prob
    link_retries: int = 2              # retry cap per traversal
    outage_cells: Tuple[int, ...] = () # dead tier-`outage_tier` entities
    outage_tier: int = 1               # which tier's fed cells go dark
    outage_start: int = 0              # first outage round
    outage_len: int = 0                # 0 = no outage

    def __post_init__(self):
        object.__setattr__(
            self, "outage_cells", tuple(int(c) for c in self.outage_cells)
        )
        for name in ("crash_rate", "corrupt_rate", "link_fail_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must lie in [0, 1]: {v}")
        if self.link_fail_rate >= 1.0 and self.link_fail_rate > 0.0:
            raise ValueError(
                "link_fail_rate must be < 1 (a link that always fails has "
                "no finite expected traversal count)"
            )
        if self.crash_stage not in CRASH_STAGES:
            raise ValueError(
                f"crash_stage must be one of {CRASH_STAGES}: "
                f"{self.crash_stage!r}"
            )
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"corrupt_mode must be one of {CORRUPT_MODES}: "
                f"{self.corrupt_mode!r}"
            )
        if self.corrupt_scale <= 0 or not np.isfinite(self.corrupt_scale):
            raise ValueError(
                f"corrupt_scale must be finite and > 0: {self.corrupt_scale}"
            )
        if self.link_retries < 0:
            raise ValueError(f"link_retries must be >= 0: {self.link_retries}")
        if self.outage_tier < 0:
            raise ValueError(f"outage_tier must be >= 0: {self.outage_tier}")
        if self.outage_len < 0 or self.outage_start < 0:
            raise ValueError(
                "outage_start/outage_len must be >= 0: "
                f"({self.outage_start}, {self.outage_len})"
            )
        if self.outage_len > 0 and not self.outage_cells:
            raise ValueError(
                "outage_len > 0 needs at least one cell in outage_cells"
            )

    @property
    def is_null(self) -> bool:
        """True when this spec injects nothing — every composition hook
        (``faulty_trace``, guard masks, retry pricing, q-deflation) must
        then leave its input unchanged bit-for-bit."""
        return (
            self.crash_rate == 0.0
            and self.corrupt_rate == 0.0
            and self.link_fail_rate == 0.0
            and (self.outage_len == 0 or not self.outage_cells)
        )

    @property
    def has_outage(self) -> bool:
        return self.outage_len > 0 and bool(self.outage_cells)

    def outage_active(self, r: int) -> bool:
        """Whether the cell outage covers round r."""
        return (
            self.has_outage
            and self.outage_start <= r < self.outage_start + self.outage_len
        )

    @property
    def retry_mult(self) -> Optional[float]:
        """Expected link traversals per transfer (None when no failures —
        the gate that keeps the zero-fault pricing path untouched)."""
        if self.link_fail_rate == 0.0:
            return None
        return retry_attempts(self.link_fail_rate, self.link_retries)

    def validate_for(self, M: int, entities: Tuple[int, ...]) -> "FaultSpec":
        """Check the outage block against a concrete system topology."""
        if self.has_outage:
            if not 0 <= self.outage_tier < M - 1:
                raise ValueError(
                    f"outage_tier must name a fed-synced tier in "
                    f"[0, {M - 1}): {self.outage_tier}"
                )
            J = entities[self.outage_tier]
            bad = [c for c in self.outage_cells if not 0 <= c < J]
            if bad:
                raise ValueError(
                    f"outage_cells {bad} outside tier {self.outage_tier}'s "
                    f"entity range [0, {J})"
                )
            if len(set(self.outage_cells)) >= J:
                raise ValueError(
                    f"outage_cells kills all {J} tier-{self.outage_tier} "
                    "cells — no sibling left to reroute to"
                )
        return self

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["outage_cells"] = list(self.outage_cells)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(**{**d, "outage_cells": tuple(d.get("outage_cells", ()))})


def retry_attempts(fail_rate: float, retries: int) -> float:
    """Expected transmission attempts per link traversal, Σ_{a=0}^{k} p^a.

    Each attempt fails independently with probability p and is retried up
    to k times; the expected number of attempts made (stop at first
    success or after k+1 tries) is the truncated geometric series — the
    factor by which every priced link payload inflates (DESIGN.md §16).
    """
    if not 0.0 <= fail_rate < 1.0:
        raise ValueError(f"fail_rate must lie in [0, 1): {fail_rate}")
    if retries < 0:
        raise ValueError(f"retries must be >= 0: {retries}")
    p = float(fail_rate)
    return float(sum(p**a for a in range(int(retries) + 1)))


@dataclass(frozen=True)
class RoundFaults:
    """One round's realized faults (the per-round expansion of a spec).

    ``crashed``/``corrupt`` are [N] bool; ``attempts`` is the [N] realized
    transmission attempt count per client link traversal (all-ones when
    the link class is off); ``cell_out`` marks the outage span.
    """

    crashed: np.ndarray
    corrupt: np.ndarray
    attempts: np.ndarray
    cell_out: bool

    @property
    def faulty(self) -> np.ndarray:
        """[N] bool — clients whose round contribution is lost (crashed)
        or must be quarantined (corrupt): the mask q-deflation counts."""
        return self.crashed | self.corrupt

    @property
    def n_faulty(self) -> int:
        return int(np.count_nonzero(self.faulty))


def _stream(spec: FaultSpec, r: int, sub: int) -> np.random.Generator:
    return np.random.default_rng([spec.seed, r, FAULT_TAG + sub])


def expand_faults(spec: FaultSpec, r: int, num_clients: int) -> RoundFaults:
    """Round r's fault draws (deterministic in (seed, r); independent
    sub-streams per fault class, so enabling one class never perturbs
    another's draws)."""
    N = num_clients
    crashed = np.zeros(N, dtype=bool)
    corrupt = np.zeros(N, dtype=bool)
    attempts = np.ones(N)
    if spec.crash_rate > 0.0:
        crashed = _stream(spec, r, _CRASH_STREAM).random(N) < spec.crash_rate
    if spec.corrupt_rate > 0.0:
        corrupt = _stream(spec, r, _CORRUPT_STREAM).random(N) < spec.corrupt_rate
        corrupt &= ~crashed  # a crashed client uploads nothing to corrupt
    if spec.link_fail_rate > 0.0:
        attempts = realized_attempts(
            _stream(spec, r, _LINK_STREAM), spec, N
        )
    return RoundFaults(
        crashed=crashed,
        corrupt=corrupt,
        attempts=attempts,
        cell_out=spec.outage_active(r),
    )


def realized_attempts(
    rng: np.random.Generator, spec: FaultSpec, n: int
) -> np.ndarray:
    """[n] realized attempt counts: geometric (first-success) draws with
    success prob 1-p, capped at the retry budget ``link_retries + 1``."""
    draws = rng.geometric(1.0 - spec.link_fail_rate, n)
    return np.minimum(draws, spec.link_retries + 1).astype(np.float64)
