"""``ExperimentResult`` — the uniform return value of ``run(spec)``; port of
``repro.api.result``.

Whatever the run mode (solve / simulate / train), the result always carries
the schedule (I, μ), the exact objective Θ′, R-to-ε from Corollary 1, the
Eq. 19 total latency, a per-stage latency breakdown, and *provenance*: the
fully resolved spec as plain JSON — so a result artifact alone is enough to
re-run the experiment and reproduce the identical numbers
(``tests/test_api.py`` pins this, seeds included).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np


def jsonify(x: Any) -> Any:
    """Recursively coerce numpy scalars/arrays (and tuples) to JSON types."""
    if isinstance(x, dict):
        return {str(k): jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonify(v) for v in x]
    if isinstance(x, np.ndarray):
        return [jsonify(v) for v in x.tolist()]
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        x = x.item()
    if isinstance(x, float) and (np.isnan(x) or np.isinf(x)):
        return None  # JSON has no inf/nan; absent beats invalid output
    return x


@dataclass(frozen=True)
class ExperimentResult:
    mode: str
    cuts: Tuple[int, ...]
    intervals: Tuple[int, ...]
    theta: float
    rounds_to_eps: Optional[float]         # R(I, μ), Corollary 1
    total_latency: Optional[float]         # T(I, μ), Eq. 19
    latency: Dict[str, Any] = field(default_factory=dict)
    sim: Optional[Dict[str, Any]] = None   # per-round trace profile
    train: Optional[Dict[str, Any]] = None # real-training metrics
    control: Optional[Dict[str, Any]] = None  # adaptive-control run log
    classes: Optional[Dict[str, Any]] = None  # per-class cut assignment
    privacy: Optional[Dict[str, Any]] = None  # (ε, δ) accountant report
    energy: Optional[Dict[str, Any]] = None   # per-round / total joules
    provenance: Dict[str, Any] = field(default_factory=dict)  # resolved spec

    @property
    def schedule(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        return self.cuts, self.intervals

    def to_dict(self) -> Dict[str, Any]:
        return jsonify(
            {
                "mode": self.mode,
                "cuts": list(self.cuts),
                "intervals": list(self.intervals),
                "theta": self.theta,
                "rounds_to_eps": self.rounds_to_eps,
                "total_latency": self.total_latency,
                "latency": self.latency,
                "sim": self.sim,
                "train": self.train,
                "control": self.control,
                "classes": self.classes,
                "privacy": self.privacy,
                "energy": self.energy,
                "provenance": self.provenance,
            }
        )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentResult":
        return cls(
            mode=d["mode"],
            cuts=tuple(int(c) for c in d["cuts"]),
            intervals=tuple(int(i) for i in d["intervals"]),
            theta=float(d["theta"]) if d["theta"] is not None else float("inf"),
            rounds_to_eps=d.get("rounds_to_eps"),
            total_latency=d.get("total_latency"),
            latency=dict(d.get("latency", {})),
            sim=d.get("sim"),
            train=d.get("train"),
            control=d.get("control"),
            classes=d.get("classes"),
            privacy=d.get("privacy"),
            energy=d.get("energy"),
            provenance=dict(d.get("provenance", {})),
        )
