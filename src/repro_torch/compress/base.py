"""Compression contract shared by every altitude (DESIGN.md §9) — port of
``repro.compress.base``.

Two views of the same knob:

* ``Compressor`` — the *executable* view: a lossy ``transform`` (the exact
  compress → wire → decompress round trip) plus the two scalars the
  analytic layer prices it with: ``ratio`` (wire bytes / raw f32 bytes,
  enters Eqs. 12–16) and ``omega`` (relative compression-error second
  moment ω = sup_x E‖C(x) − x‖² / ‖x‖², inflates the σ² term of
  Theorem 1).  Engines A/B apply ``transform`` on the fed-server tier
  boundaries; the quantized aggregation kernels (B2, B3) consume the same
  wire format.

* ``CompressionSpec`` — the *analytic* projection: per-boundary activation
  ratios, per-tier model-exchange ratios, and ω.  This is what
  ``core.latency`` / ``core.convergence`` / ``core.problem`` and the fleet
  simulator consume; ``Compressor.spec(M)`` bridges the two.

``base`` is deliberately torch-free (NumPy only) so the analytic layer can
import it without pulling in the execution stack.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class Compressor(Protocol):
    """One lossy wire codec, priced by (ratio, omega)."""

    name: str
    ratio: float   # wire bytes / raw float32 bytes, in (0, 1]
    omega: float   # sup_x E‖transform(x) − x‖² / ‖x‖²  (0 for identity)

    def transform(self, x, generator=None):
        """Compress → decompress round trip of one tensor.

        Deterministic when ``generator`` is None (what the engine tests
        pin); stochastic schemes draw their unbiased rounding from a
        ``torch.Generator`` on the tensor's device.
        """
        ...


@dataclass(frozen=True)
class CompressionSpec:
    """Per-link byte ratios + bound inflation for an M-tier hierarchy.

    ``act_ratio[m]``    scales the boundary-m activation/gradient bits of
                        Eqs. (12)/(14)  (m < M-1),
    ``model_ratio[m]``  scales the tier-m fed-server model bits of
                        Eqs. (15)/(16)  (m < M-1),
    ``omega``           inflates the σ² term of Theorem 1: σ² → (1+ω)σ².
    """

    act_ratio: Tuple[float, ...]
    model_ratio: Tuple[float, ...]
    omega: float = 0.0

    def __post_init__(self):
        for r in (*self.act_ratio, *self.model_ratio):
            if not 0.0 < r <= 1.0:
                raise ValueError(f"compression ratios must be in (0, 1]: {r}")
        if self.omega < 0.0:
            raise ValueError(f"omega must be non-negative: {self.omega}")

    def validate_for(self, M: int) -> "CompressionSpec":
        """Fail fast when the spec's arity doesn't match an M-tier system
        (otherwise a short spec only IndexErrors deep inside a solve)."""
        if len(self.act_ratio) != M - 1 or len(self.model_ratio) != M - 1:
            raise ValueError(
                f"CompressionSpec arity mismatch: M={M} needs {M - 1} "
                f"act/model ratios, got {len(self.act_ratio)}/"
                f"{len(self.model_ratio)}"
            )
        return self

    def to_dict(self) -> dict:
        """Plain-JSON projection (the api layer's provenance format)."""
        return {
            "act_ratio": list(self.act_ratio),
            "model_ratio": list(self.model_ratio),
            "omega": self.omega,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionSpec":
        return cls(
            act_ratio=tuple(float(r) for r in d["act_ratio"]),
            model_ratio=tuple(float(r) for r in d["model_ratio"]),
            omega=float(d.get("omega", 0.0)),
        )

    @classmethod
    def identity(cls, M: int) -> "CompressionSpec":
        return cls((1.0,) * (M - 1), (1.0,) * (M - 1), 0.0)

    @classmethod
    def uniform(
        cls,
        M: int,
        model_ratio: float,
        act_ratio: Optional[float] = None,
        omega: float = 0.0,
    ) -> "CompressionSpec":
        """Same ratio on every link of its kind (the common sweep axis)."""
        ar = 1.0 if act_ratio is None else act_ratio
        return cls((ar,) * (M - 1), (model_ratio,) * (M - 1), omega)


def act_ratio(compression: Optional[CompressionSpec], m: int) -> float:
    """Boundary-m activation byte multiplier (1.0 when uncompressed)."""
    return 1.0 if compression is None else float(compression.act_ratio[m])


def model_ratio(compression: Optional[CompressionSpec], m: int) -> float:
    """Tier-m fed-server model byte multiplier (1.0 when uncompressed)."""
    return 1.0 if compression is None else float(compression.model_ratio[m])


def measure_omega(
    compressor: Compressor,
    shape: Tuple[int, ...] = (4096,),
    samples: int = 8,
    seed: int = 0,
) -> float:
    """Monte-Carlo estimate of E‖C(x) − x‖² / ‖x‖² on Gaussian tensors.

    A sanity probe for the scheme's declared ``omega`` (which is the
    worst-case bound the convergence side prices); tests assert
    measured ≤ declared.  Draws on the CPU from one ``torch.Generator``
    per sample, seeded ``seed * 1000 + s`` as the JAX keys are (the two
    packages draw different numbers from the same seed).
    """
    import torch

    errs = []
    for s in range(samples):
        gen = torch.Generator().manual_seed(int(seed * 1000 + s))
        x = torch.randn(shape, generator=gen)
        xh = compressor.transform(x, generator=gen)
        num = float(np.sum(np.square((xh - x).double().numpy())))
        den = float(np.sum(np.square(x.double().numpy())))
        errs.append(num / den)
    return float(np.mean(errs))
