"""(ε, δ) accounting for the DP-noised fed-server uplink (DESIGN.md §15).

Rényi-DP composition of the subsampled Gaussian mechanism at integer
orders: one HSFL round is one mechanism invocation whose sampling rate is
the client participation rate q₁ (the deadline-surviving fraction of the
fleet, DESIGN.md §12), and rounds compose additively in RDP.  For order
α ≥ 2 and noise multiplier z the per-round RDP is bounded by the
binomial-expansion moment bound (Mironov et al., "Rényi DP of the Sampled
Gaussian Mechanism", Thm. 4 restricted to integer α):

    A(α) = Σ_{k=0}^{α} C(α,k) (1−q)^{α−k} q^k · exp((k² − k) / (2 z²))
    RDP(α) = ln A(α) / (α − 1)

evaluated in log space (log-sum-exp) so large α / small z stay finite.
q = 1 collapses the sum to the plain Gaussian mechanism's α/(2z²)
exactly, and ε(δ) after R rounds is the standard RDP→DP conversion
minimized over the order grid:

    ε = min_α [ R·RDP(α) + ln(1/δ) / (α − 1) ].

``epsilon_oracle`` is the scalar reference: pure-``math`` per-term,
per-round accumulation loops.  ``Accountant`` is the vectorized numpy
path the solvers use; ``tests/test_privacy.py`` pins the two to 1e-9.
Because composition is linear in R, the budget inverts in closed form:
``rounds_for_budget`` returns the largest R whose ε stays ≤ the budget —
the round cap the BCD problem turns into a denominator floor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

# α = 2 … 64: the standard moments-accountant grid; past ~64 the
# conversion term ln(1/δ)/(α−1) has flattened for every practical δ.
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 65))


def _log_a_terms(alpha: int, z: float, q: float) -> list:
    """ln of every k-term of A(α) for the subsampled Gaussian bound."""
    terms = []
    for k in range(alpha + 1):
        lw = math.lgamma(alpha + 1) - math.lgamma(k + 1) - math.lgamma(
            alpha - k + 1
        )
        if k > 0:
            if q <= 0.0:
                continue
            lw += k * math.log(q)
        if alpha - k > 0:
            if q >= 1.0:
                continue
            lw += (alpha - k) * math.log1p(-q)
        terms.append(lw + (k * k - k) / (2.0 * z * z))
    return terms


def _logsumexp(terms: Sequence[float]) -> float:
    m = max(terms)
    return m + math.log(sum(math.exp(t - m) for t in terms))


def rdp_epsilon(alpha: int, z: float, q: float) -> float:
    """Per-round RDP at integer order α of the subsampled Gaussian."""
    if alpha < 2 or int(alpha) != alpha:
        raise ValueError(f"integer order alpha >= 2 required: {alpha}")
    if z <= 0.0:
        return math.inf
    if q <= 0.0:
        return 0.0
    if q >= 1.0:
        return alpha / (2.0 * z * z)
    return _logsumexp(_log_a_terms(int(alpha), z, q)) / (alpha - 1)


def rdp_vector(
    z: float, q: float, orders: Sequence[int] = DEFAULT_ORDERS
) -> np.ndarray:
    """Per-round RDP over the order grid — the vectorized accountant path."""
    return np.array([rdp_epsilon(a, z, q) for a in orders], dtype=np.float64)


def epsilon_oracle(
    z: float,
    q: float,
    rounds: int,
    delta: float,
    orders: Sequence[int] = DEFAULT_ORDERS,
) -> float:
    """Scalar reference: literal per-round composition, plain ``math``.

    Accumulates R·RDP(α) as R explicit additions per order, then takes
    the minimum conversion by a plain loop — the oracle the vectorized
    ``Accountant.epsilon`` must match to 1e-9.
    """
    if rounds <= 0:
        return 0.0
    if z <= 0.0:
        return math.inf
    best = math.inf
    for a in orders:
        r = rdp_epsilon(int(a), z, q)
        total = 0.0
        for _ in range(int(rounds)):
            total += r
        eps = total + math.log(1.0 / delta) / (a - 1)
        if eps < best:
            best = eps
    return best


def rounds_for_budget(
    z: float,
    q: float,
    delta: float,
    eps_budget: float,
    orders: Sequence[int] = DEFAULT_ORDERS,
) -> Optional[float]:
    """Largest round count whose composed ε stays ≤ the budget.

    None means unlimited (no budget, or a noiseless-irrelevant ∞ budget);
    0.0 means even a single round overruns (e.g. z = 0 under a finite ε).
    Linearity of RDP composition in R makes this exact:
    R_max = max_α ⌊(ε_b − ln(1/δ)/(α−1)) / RDP(α)⌋.
    """
    if eps_budget is None or math.isinf(eps_budget):
        return None
    if eps_budget <= 0.0:
        return 0.0
    if z <= 0.0:
        return 0.0  # no noise: any round spends infinite ε
    if q <= 0.0:
        return None  # nothing sampled: zero spend at any R
    best = 0.0
    for a in orders:
        r = rdp_epsilon(int(a), z, q)
        head = eps_budget - math.log(1.0 / delta) / (a - 1)
        if head <= 0.0:
            continue
        if r <= 0.0:
            return None
        best = max(best, math.floor(head / r))
    return best


@dataclass(frozen=True)
class Accountant:
    """Vectorized (ε, δ) accountant for one DP training configuration.

    ``noise_multiplier`` is z (noise std / clip norm), ``sampling_rate``
    the per-round client participation q₁, ``delta`` the target δ.
    """

    noise_multiplier: float
    sampling_rate: float = 1.0
    delta: float = 1e-5
    orders: Tuple[int, ...] = DEFAULT_ORDERS

    def __post_init__(self):
        if self.noise_multiplier < 0:
            raise ValueError(f"noise_multiplier < 0: {self.noise_multiplier}")
        if not (0.0 <= self.sampling_rate <= 1.0):
            raise ValueError(f"sampling_rate outside [0, 1]: {self.sampling_rate}")
        if not (0.0 < self.delta < 1.0):
            raise ValueError(f"delta outside (0, 1): {self.delta}")

    def _rdp(self) -> np.ndarray:
        rdp = self.__dict__.get("_rdp_cache")
        if rdp is None:
            rdp = rdp_vector(self.noise_multiplier, self.sampling_rate, self.orders)
            self.__dict__["_rdp_cache"] = rdp
        return rdp

    def epsilon(self, rounds: int) -> float:
        """ε after composing ``rounds`` rounds at the accountant's δ."""
        if rounds <= 0:
            return 0.0
        if self.noise_multiplier <= 0.0:
            return math.inf
        orders = np.asarray(self.orders, dtype=np.float64)
        eps = rounds * self._rdp() + math.log(1.0 / self.delta) / (orders - 1.0)
        return float(np.min(eps))

    def max_rounds(self, eps_budget: float) -> Optional[float]:
        """Largest R with ε(R) ≤ budget; None = unlimited, 0.0 = none."""
        return rounds_for_budget(
            self.noise_multiplier, self.sampling_rate, self.delta,
            eps_budget, self.orders,
        )
