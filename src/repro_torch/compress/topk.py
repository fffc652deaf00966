"""Top-k magnitude sparsification, plus the error-feedback accumulator —
port of ``repro.compress.topk``.

``TopK(frac)`` keeps the ``k = ceil(frac · d)`` largest-magnitude entries
of a flattened tensor and zeroes the rest.  The wire carries a (f32 value,
int32 index) pair per kept entry, so ``ratio = 2·frac``.  The kept entries
are the largest squares, hence kept energy ≥ (k/d)·‖x‖² and

    ω  =  sup_x ‖C(x) − x‖² / ‖x‖²  ≤  1 − frac.

Plain top-k is biased (it always drops the same small coordinates of a
slowly-moving tensor); ``ErrorFeedback`` wraps any codec with the standard
residual accumulator — compress ``x + e_t``, carry the round-off
``e_{t+1} = x + e_t − C(x + e_t)`` — which restores convergence in
practice and keeps the cumulative emitted signal within one residual of
the cumulative input.

``torch.topk`` and ``jax.lax.top_k`` may order (and so choose among) tied
magnitudes differently; on tie-free inputs the two keep the same set.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .base import Compressor


@dataclass(frozen=True)
class TopK:
    """Keep the ``ceil(frac·d)`` largest-|x| entries of each tensor."""

    frac: float = 0.25
    name: str = "top-k"

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1]: {self.frac}")

    @property
    def ratio(self) -> float:
        return min(1.0, 2.0 * self.frac)  # value + index per kept entry

    @property
    def omega(self) -> float:
        return 1.0 - self.frac

    def k_for(self, size: int) -> int:
        return max(1, int(math.ceil(self.frac * size)))

    def transform(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        flat = x.reshape(-1)
        k = self.k_for(flat.shape[0])
        idx = torch.topk(torch.abs(flat.float()), k).indices
        out = torch.zeros_like(flat)
        out[idx] = flat[idx]
        return out.reshape(x.shape)


@dataclass(frozen=True)
class ErrorFeedback:
    """Residual accumulator around any codec (functional state).

    Note: EF deliberately has *no* ``omega`` — it is not a stateless
    ``Compressor`` and its per-round emitted error relative to the current
    input is NOT bounded by the inner codec's ω (the steady-state residual
    of a slowly-varying signal can be many multiples of ‖x‖, so one
    round's ‖x̂ − x‖ can exceed any per-round bound).  The *byte* ratio of
    the wire is still the inner codec's; Theorem-1 pricing of EF schedules
    is out of scope for the one-shot ω contract of DESIGN.md §9.
    """

    inner: Compressor

    @property
    def name(self) -> str:
        return f"ef({self.inner.name})"

    @property
    def ratio(self) -> float:
        return self.inner.ratio

    def init(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x, dtype=torch.float32)

    def step(
        self, residual: torch.Tensor, x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(emitted x̂, new residual) for one round."""
        y = x.float() + residual
        xh = self.inner.transform(y, generator=generator)
        return xh.to(x.dtype), y - xh.float()
