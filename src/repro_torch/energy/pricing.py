"""Per-tier energy pricing of the HSFL round (DESIGN.md §15).

An ``EnergySpec`` carries J/FLOP compute prices per tier and J/byte
radio prices per link level; the round energy is the fleet-total

    E(I, μ) = E_S(μ) + Σ_m E_{m,A}(μ) / I_m

with the split energy E_S priced over the *same* canonical stage chain
as the latency model (``latency.split_stages`` / ``batched.stage_meta``)
and the aggregation energy E_{m,A} over the same fed-server model bits
λ_m.  The scalar walk and the lattice tables share one per-stage price
vector (``stage_energy_prices``) and accumulate in the same stage order,
so ``split_energy(cuts) == split_energy_lattice(...)[k]`` bit-for-bit —
the same contract the latency tables hold (``tests/test_energy.py``).

Energy reaches the solvers purely as the feasibility mask
``E(I, μ) ≤ budget_j_per_round``: it never enters the Θ' arithmetic, so
zero prices or an absent budget are exact no-ops on the optimum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from ..compress.base import CompressionSpec, model_ratio
from ..core.latency import BITS, LayerProfile, SystemSpec
from ..core.batched import model_bits_lattice, split_work_tensor, stage_meta


@dataclass(frozen=True)
class EnergySpec:
    """Per-tier energy prices + an optional per-round budget.

    ``compute_j_per_flop`` has one J/FLOP entry per tier (len M);
    ``act_j_per_byte`` one J/byte entry per activation boundary
    (len M−1, prices both the uplink and downlink leg of boundary m);
    ``model_j_per_byte`` one J/byte entry per fed-server level
    (len M−1, prices both the upload and download phase).
    """

    compute_j_per_flop: Tuple[float, ...]
    act_j_per_byte: Tuple[float, ...]
    model_j_per_byte: Tuple[float, ...]
    budget_j_per_round: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(
            self, "compute_j_per_flop",
            tuple(float(v) for v in self.compute_j_per_flop),
        )
        object.__setattr__(
            self, "act_j_per_byte", tuple(float(v) for v in self.act_j_per_byte)
        )
        object.__setattr__(
            self, "model_j_per_byte",
            tuple(float(v) for v in self.model_j_per_byte),
        )
        for name in ("compute_j_per_flop", "act_j_per_byte", "model_j_per_byte"):
            if any(v < 0 for v in getattr(self, name)):
                raise ValueError(f"{name} has a negative price")
        if self.budget_j_per_round is not None:
            object.__setattr__(
                self, "budget_j_per_round", float(self.budget_j_per_round)
            )
            if self.budget_j_per_round <= 0:
                raise ValueError(
                    f"budget_j_per_round must be positive: "
                    f"{self.budget_j_per_round}"
                )

    def validate_for(self, M: int) -> "EnergySpec":
        if len(self.compute_j_per_flop) != M:
            raise ValueError(
                f"compute_j_per_flop has {len(self.compute_j_per_flop)} "
                f"tiers for an M={M} system"
            )
        for name in ("act_j_per_byte", "model_j_per_byte"):
            if len(getattr(self, name)) != M - 1:
                raise ValueError(
                    f"{name} has {len(getattr(self, name))} levels for an "
                    f"M={M} system (need M-1)"
                )
        return self

    @property
    def is_free(self) -> bool:
        """True when every price is zero AND no budget binds — the spec
        cannot move any optimum (the bit-exact-collapse witness)."""
        return (
            self.budget_j_per_round is None
            and not any(self.compute_j_per_flop)
            and not any(self.act_j_per_byte)
            and not any(self.model_j_per_byte)
        )


def default_energy_spec(
    M: int,
    compute_j_per_flop: float = 1e-11,
    act_j_per_byte: float = 2e-7,
    model_j_per_byte: float = 2e-7,
    budget_j_per_round: Optional[float] = None,
) -> EnergySpec:
    """Uniform price tables (edge-device ballpark: ~10 pJ/FLOP, ~0.2 µJ/B
    radio) — a convenient starting point for the presets/benchmarks."""
    return EnergySpec(
        compute_j_per_flop=(compute_j_per_flop,) * M,
        act_j_per_byte=(act_j_per_byte,) * (M - 1),
        model_j_per_byte=(model_j_per_byte,) * (M - 1),
        budget_j_per_round=budget_j_per_round,
    )


def stage_energy_prices(
    spec: EnergySpec, system: SystemSpec, M: int
) -> np.ndarray:
    """Fleet-total J-per-work price of every canonical-chain stage ``[S]``.

    Compute stages pay N · J/FLOP (every client's batch flows through the
    tier's hosted replica); link stages pay N · J/byte / 8 (stage works
    are bits).  Both the scalar walk and the lattice tables multiply
    these exact precomputed scalars, which is what makes them bit-equal.
    """
    N = float(system.num_clients)
    prices = []
    for kind, idx in stage_meta(M):
        if kind in ("compute_fwd", "compute_bwd"):
            prices.append(N * spec.compute_j_per_flop[idx])
        else:  # uplink / downlink share the boundary's radio price
            prices.append(N * spec.act_j_per_byte[idx] / BITS)
    return np.asarray(prices, dtype=np.float64)


def split_energy(
    profile: LayerProfile,
    system: SystemSpec,
    spec: EnergySpec,
    cuts: Sequence[int],
    compression: Optional[CompressionSpec] = None,
) -> float:
    """E_S(μ): fleet split-training energy per round — the scalar oracle,
    accumulated in canonical chain order."""
    from ..core.latency import split_stages

    prices = stage_energy_prices(spec, system, system.M)
    e = 0.0
    for s, p in zip(split_stages(profile, cuts, compression), prices):
        e = e + s.work * p
    return float(e)


def _lam_price(spec: EnergySpec, system: SystemSpec, m: int) -> float:
    """J per λ-bit of a level-m sync: J_m entities × (up + down) × J/byte."""
    return 2.0 * float(system.entities[m]) * spec.model_j_per_byte[m] / BITS


def agg_energy(
    profile: LayerProfile,
    system: SystemSpec,
    spec: EnergySpec,
    cuts: Sequence[int],
    m: int,
    compression: Optional[CompressionSpec] = None,
) -> float:
    """E_{m,A}(μ): fed-server sync energy of one level-m aggregation."""
    if system.entities[m] <= 1:
        return 0.0  # Eq. (15)/(16) indicator: no fed exchange at this level
    lam = profile.tier_param_bytes(cuts, m) * BITS * model_ratio(compression, m)
    return float(lam * _lam_price(spec, system, m))


def round_energy(
    profile: LayerProfile,
    system: SystemSpec,
    spec: EnergySpec,
    cuts: Sequence[int],
    intervals: Sequence[int],
    compression: Optional[CompressionSpec] = None,
) -> float:
    """E(I, μ) = E_S + Σ_m E_{m,A}/I_m — amortized round energy, summed
    in tier order (the accumulation shape of ``problem.numerator``)."""
    e = split_energy(profile, system, spec, cuts, compression)
    acc = agg_energy(profile, system, spec, cuts, 0, compression) / float(
        intervals[0]
    )
    for m in range(1, system.M - 1):
        acc = acc + agg_energy(
            profile, system, spec, cuts, m, compression
        ) / float(intervals[m])
    return float(e + acc)


def split_energy_lattice(
    profile: LayerProfile,
    system: SystemSpec,
    spec: EnergySpec,
    lattice: np.ndarray,
    compression: Optional[CompressionSpec] = None,
) -> np.ndarray:
    """``[K]`` E_S(μ) for every lattice row — identical per-stage
    multiply/accumulate order as the scalar ``split_energy``."""
    M = lattice.shape[1] + 1
    works = split_work_tensor(profile, lattice, compression)
    prices = stage_energy_prices(spec, system, M)
    e = np.zeros(lattice.shape[0])
    for s in range(works.shape[1]):
        e = e + works[:, s] * prices[s]
    return e


def agg_energy_lattice(
    profile: LayerProfile,
    system: SystemSpec,
    spec: EnergySpec,
    lattice: np.ndarray,
    compression: Optional[CompressionSpec] = None,
) -> np.ndarray:
    """``[K, M-1]`` E_{m,A}(μ) for every row — same λ·price order as the
    scalar ``agg_energy``."""
    M = lattice.shape[1] + 1
    lam = model_bits_lattice(profile, lattice, compression)
    out = np.zeros((lattice.shape[0], M - 1))
    for m in range(M - 1):
        if system.entities[m] <= 1:
            continue
        out[:, m] = lam[:, m] * _lam_price(spec, system, m)
    return out
