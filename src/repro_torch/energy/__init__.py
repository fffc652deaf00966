# repro_torch.energy — port of repro.energy: per-tier energy pricing as a
# first-class cost (DESIGN.md §15).
#
# J/FLOP compute and J/byte radio tables priced over the canonical stage
# chain (scalar oracle) and the whole cut lattice (batched tables, exact
# same elementwise multiply/accumulate order — bit-exact against the
# oracle, mirroring the latency contract of core/batched.py).  Energy
# enters the solvers ONLY as a feasibility mask E(I, μ) ≤ budget: it
# never touches the Θ' arithmetic, so zero prices / no budget collapse
# bit-exactly to the unconstrained problem.
from .pricing import (
    EnergySpec,
    agg_energy,
    agg_energy_lattice,
    default_energy_spec,
    round_energy,
    split_energy,
    split_energy_lattice,
    stage_energy_prices,
)

__all__ = [
    "EnergySpec",
    "agg_energy",
    "agg_energy_lattice",
    "default_energy_spec",
    "round_energy",
    "split_energy",
    "split_energy_lattice",
    "stage_energy_prices",
]
