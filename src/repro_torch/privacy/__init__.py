# repro_torch.privacy — port of repro.privacy: DP-noised fed-server uplinks
# as a first-class cost (DESIGN.md §15).
#
# Two halves mirror the compression contract (§9): an *executable*
# DPMechanism (per-client clip + Gaussian noise applied to fed-server
# uploads inside Engine A, bit-exact noiseless collapse) and an *analytic*
# PrivacySpec + RDP Accountant (composition over rounds × the sampling
# rate q from the participation masks) that turns an (ε, δ) budget into a
# round cap R_max, i.e. a denominator floor D ≥ 2θ₀/(γ·R_max) for the
# MA/MS/BCD solvers.
from .accountant import (
    Accountant,
    epsilon_oracle,
    rdp_epsilon,
    rdp_vector,
    rounds_for_budget,
)
from .mechanism import DPMechanism, PrivacySpec

__all__ = [
    "Accountant",
    "DPMechanism",
    "PrivacySpec",
    "epsilon_oracle",
    "rdp_epsilon",
    "rdp_vector",
    "rounds_for_budget",
]
