"""The executable DP mechanism and its analytic spec (DESIGN.md §15) — port
of ``repro.privacy.mechanism``.

``DPMechanism`` is the compressor-shaped stage Engine A applies to the
client→fed-server model uploads: each uploaded replica (axis 0 of a
stacked leaf) is L2-clipped to ``clip`` per leaf and perturbed with
per-coordinate Gaussian noise of std ``noise_multiplier · clip`` — the
noisy wire HierSFL (arXiv:2401.08723) places at exactly this boundary.
Noise draws come from a ``torch.Generator`` on the upload's device, seeded
from (seed, leaf counter, round counter), so every (round, leaf) draw is
independent and a fixed seed reproduces the run.  torch cannot reproduce
``jax.random``'s draws: at a noise multiplier of 0 the clip equals the
JAX package's to f32 rounding, and with noise the two agree in law.  A ``noise_multiplier`` of 0 never constructs a
mechanism at all (``build()`` gates it), so the noiseless path executes
the pre-DP computation graph bit-for-bit.

``PrivacySpec`` is the analytic half the solvers consume: the per-round
noise mass σ²_DP = (z·C)²·dim joins Theorem 1's variance term (gated,
``convergence.bound_round_terms``), and the (ε, δ) budget becomes a
round cap through the accountant — ``HsflProblem.d_min()`` turns
R ≤ R_max into the denominator floor D ≥ 2θ₀/(γ·R_max).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .accountant import DEFAULT_ORDERS, Accountant


@dataclass(frozen=True)
class PrivacySpec:
    """Analytic view of the DP uplink: noise calibration + (ε, δ) budget.

    ``dim`` is the coordinate count of the noised upload (the full model
    parameter count in ``build()`` — an upper bound on the client-side
    upload at any cut, keeping the σ²-inflated bound an envelope).
    ``epsilon_budget`` None/inf means unconstrained accounting-wise.
    """

    noise_multiplier: float          # z = noise std / clip norm
    clip: float                      # C: per-leaf L2 clip on each upload
    delta: float = 1e-5
    epsilon_budget: Optional[float] = None
    dim: int = 1

    def __post_init__(self):
        if self.noise_multiplier < 0:
            raise ValueError(f"noise_multiplier < 0: {self.noise_multiplier}")
        if self.clip <= 0:
            raise ValueError(f"clip must be positive: {self.clip}")
        if not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta outside (0, 1): {self.delta}")
        if self.epsilon_budget is not None and self.epsilon_budget <= 0:
            raise ValueError(
                f"epsilon_budget must be positive: {self.epsilon_budget}"
            )
        if self.dim < 1:
            raise ValueError(f"dim must be >= 1: {self.dim}")

    @property
    def dp_sigma2(self) -> float:
        """Per-round DP noise mass entering the Theorem-1 variance term.

        Exactly 0.0 when z = 0, so the gated bound terms vanish and the
        noiseless constants are bit-identical to the pre-DP arithmetic.
        """
        if self.noise_multiplier == 0.0:
            return 0.0
        return (self.noise_multiplier * self.clip) ** 2 * self.dim

    def accountant(self, sampling_rate: float = 1.0) -> Accountant:
        return Accountant(
            noise_multiplier=self.noise_multiplier,
            sampling_rate=sampling_rate,
            delta=self.delta,
            orders=DEFAULT_ORDERS,
        )

    def max_rounds(self, sampling_rate: float = 1.0) -> Optional[float]:
        """Round cap from the ε budget; None = unlimited."""
        if self.epsilon_budget is None or math.isinf(self.epsilon_budget):
            return None
        return self.accountant(sampling_rate).max_rounds(self.epsilon_budget)


@dataclass(frozen=True)
class DPMechanism:
    """Per-upload clip + Gaussian noise, applied leaf-wise on axis 0.

    ``transform(x, step, salt)`` treats ``x`` as ``[E, ...]`` stacked
    uploads: row e is scaled by min(1, clip/‖x_e‖₂) (the norm taken in f32)
    and perturbed with N(0, (z·clip)²) per coordinate.  ``step`` (the round
    counter, a host int) and ``salt`` (a per-leaf counter) seed the draw
    together with ``seed``, so draws are independent across rounds and
    leaves yet reproducible on one device; a CUDA generator's stream is not
    a CPU generator's.
    """

    clip: float
    noise_multiplier: float
    seed: int = 0

    def __post_init__(self):
        if self.clip <= 0:
            raise ValueError(f"clip must be positive: {self.clip}")
        if self.noise_multiplier < 0:
            raise ValueError(f"noise_multiplier < 0: {self.noise_multiplier}")

    def transform(self, x: torch.Tensor, step: int, salt: int = 0) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        f32 = flat.float()
        norms = torch.sqrt(torch.sum(f32 * f32, dim=1))
        scale = torch.clamp(self.clip / torch.clamp(norms, min=1e-12), max=1.0)
        out = f32 * scale[:, None]
        if self.noise_multiplier > 0.0:
            # one seeded stream per (seed, leaf, round) on the upload's device
            key = np.random.SeedSequence([self.seed, int(salt), int(step)])
            g = torch.Generator(device=x.device)
            g.manual_seed(int(key.generate_state(1, np.uint64)[0] >> np.uint64(1)))
            noise = torch.randn(out.shape, generator=g, dtype=out.dtype, device=x.device)
            out = out + self.noise_multiplier * self.clip * noise
        return out.to(x.dtype).reshape(x.shape)
