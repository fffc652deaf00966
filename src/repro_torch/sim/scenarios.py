"""Scenario library: generators of per-round fleet state (``SystemTrace``).

A scenario prices the *same* ``LayerProfile``/``SystemSpec`` terms the
analytic model uses (Eqs. 11–18), but per round and per client: each round
carries multiplicative perturbations of every compute / link rate plus a
client-availability mask.  Traces are generated lazily and deterministically
— round r's state is drawn from ``default_rng([seed, r, tag])`` — so the
discrete-event oracle (``events.py``) and the vectorized fast path
(``fleet.py``) consume identical numbers without materializing [R, N]
arrays up front, and a 10⁶-client trace costs memory only for the rounds
actually touched.

The five regimes (motivated by AdaptSFL / HASFL's system models):

* ``homogeneous-paper``      — all multipliers 1, everyone available; by
  construction reproduces ``split_latency``/``aggregation_latency`` exactly.
* ``lognormal-heterogeneous``— static per-client lognormal compute + access
  link rates (device heterogeneity).
* ``diurnal-churn``          — sinusoidal participation rate (day/night
  cycle) with per-round Bernoulli availability.
* ``flaky-wan``              — per-round lognormal link jitter plus rare
  deep outages (×0.1) on access, backhaul, and fed-server links.
* ``straggler-tail``         — a Pareto-tailed slowdown hits a random few
  clients' on-device compute each round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..compress.base import CompressionSpec
from ..core.latency import LayerProfile, SystemSpec


@dataclass(frozen=True)
class RoundState:
    """Multiplicative fleet state for one round (all float64, masks bool).

    ``compute_mult[m]``            [N]    scales ``system.compute[m]``
    ``link_up_mult[m]``            [N]    scales ``system.act_up[m]``
    ``link_down_mult[m]``          [N]    scales ``system.act_down[m]``
    ``fed_up_mult[m]``             [J_m]  scales ``system.model_up[m]``
    ``fed_down_mult[m]``           [J_m]  scales ``system.model_down[m]``
    ``available``                  [N]    client participates this round
    """
    available: np.ndarray
    compute_mult: Tuple[np.ndarray, ...]
    link_up_mult: Tuple[np.ndarray, ...]
    link_down_mult: Tuple[np.ndarray, ...]
    fed_up_mult: Tuple[np.ndarray, ...]
    fed_down_mult: Tuple[np.ndarray, ...]


class SystemTrace:
    """Lazily generated, seeded sequence of ``RoundState`` for one scenario.

    ``compression`` (a ``repro.compress.CompressionSpec``) puts the trace's
    links on a compressed wire: both the discrete-event oracle and the
    vectorized fast path price boundary bits × ``act_ratio`` and model
    bits × ``model_ratio`` — per-round multipliers stay untouched, so the
    bit-exactness contract between the two paths is preserved.
    """

    def __init__(
        self,
        name: str,
        profile: LayerProfile,
        system: SystemSpec,
        rounds: int,
        seed: int,
        gen: Callable[[int], RoundState],
        compression: Optional[CompressionSpec] = None,
    ):
        self.name = name
        self.profile = profile
        self.system = system
        self.rounds = rounds
        self.seed = seed
        self.compression = compression
        self._gen = gen
        self._cache: Dict[int, RoundState] = {}

    def round_state(self, r: int) -> RoundState:
        if not 0 <= r < self.rounds:
            raise IndexError(f"round {r} outside trace [0, {self.rounds})")
        st = self._cache.get(r)
        if st is None:
            st = self._cache[r] = self._gen(r)
        return st

    def with_compression(
        self, compression: Optional[CompressionSpec]
    ) -> "SystemTrace":
        """The same seeded trace priced over a compressed wire."""
        if compression is not None:
            compression.validate_for(self.system.M)
        return SystemTrace(
            self.name, self.profile, self.system, self.rounds, self.seed,
            self._gen, compression,
        )


# --------------------------------------------------------------------------- #
# scenario constructors
# --------------------------------------------------------------------------- #

# per-scenario stream tags so scenarios sharing a seed stay decorrelated
_TAGS = {
    "homogeneous-paper": 0,
    "lognormal-heterogeneous": 1,
    "diurnal-churn": 2,
    "flaky-wan": 3,
    "straggler-tail": 4,
}


def _rng(seed: int, r: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([seed, r, tag])


def _ones_state(system: SystemSpec) -> RoundState:
    N, M = system.num_clients, system.M
    one_n = np.ones(N)
    return RoundState(
        available=np.ones(N, dtype=bool),
        compute_mult=tuple(one_n for _ in range(M)),
        link_up_mult=tuple(one_n for _ in range(M - 1)),
        link_down_mult=tuple(one_n for _ in range(M - 1)),
        fed_up_mult=tuple(np.ones(len(system.model_up[m])) for m in range(M - 1)),
        fed_down_mult=tuple(np.ones(len(system.model_down[m])) for m in range(M - 1)),
    )


def _ensure_someone(avail: np.ndarray, r: int) -> np.ndarray:
    if not avail.any():  # a round with zero clients has no defined latency
        avail[r % len(avail)] = True
    return avail


def homogeneous_paper(
    profile: LayerProfile, system: SystemSpec, rounds: int, seed: int = 0
) -> SystemTrace:
    """The paper's static model: every round is the nominal system."""
    base = _ones_state(system)
    return SystemTrace(
        "homogeneous-paper", profile, system, rounds, seed, lambda r: base
    )


def lognormal_heterogeneous(
    profile: LayerProfile,
    system: SystemSpec,
    rounds: int,
    seed: int = 0,
    compute_sigma: float = 0.5,
    link_sigma: float = 0.6,
) -> SystemTrace:
    """Static device heterogeneity: per-client lognormal compute and access
    link multipliers drawn once (median 1), constant across rounds."""
    N = system.num_clients
    tag = _TAGS["lognormal-heterogeneous"]
    rng = _rng(seed, 0, tag)
    dev = np.exp(rng.normal(0.0, compute_sigma, N))
    up = np.exp(rng.normal(0.0, link_sigma, N))
    down = np.exp(rng.normal(0.0, link_sigma, N))
    base = _ones_state(system)
    st = RoundState(
        available=base.available,
        compute_mult=(dev,) + base.compute_mult[1:],
        link_up_mult=(up,) + base.link_up_mult[1:],
        link_down_mult=(down,) + base.link_down_mult[1:],
        fed_up_mult=base.fed_up_mult,
        fed_down_mult=base.fed_down_mult,
    )
    return SystemTrace(
        "lognormal-heterogeneous", profile, system, rounds, seed, lambda r: st
    )


def diurnal_churn(
    profile: LayerProfile,
    system: SystemSpec,
    rounds: int,
    seed: int = 0,
    period: int = 24,
    p_min: float = 0.35,
    p_max: float = 0.95,
) -> SystemTrace:
    """Participation follows a day/night sinusoid; each client flips a
    Bernoulli coin against the hour's rate every round (dropout / rejoin)."""
    N = system.num_clients
    tag = _TAGS["diurnal-churn"]
    base = _ones_state(system)

    def gen(r: int) -> RoundState:
        p = p_min + (p_max - p_min) * 0.5 * (1.0 + np.sin(2.0 * np.pi * r / period))
        avail = _ensure_someone(_rng(seed, r, tag).random(N) < p, r)
        return RoundState(
            available=avail,
            compute_mult=base.compute_mult,
            link_up_mult=base.link_up_mult,
            link_down_mult=base.link_down_mult,
            fed_up_mult=base.fed_up_mult,
            fed_down_mult=base.fed_down_mult,
        )

    return SystemTrace("diurnal-churn", profile, system, rounds, seed, gen)


def flaky_wan(
    profile: LayerProfile,
    system: SystemSpec,
    rounds: int,
    seed: int = 0,
    jitter_sigma: float = 0.25,
    outage_p: float = 0.05,
    outage_mult: float = 0.1,
    outage_len: int = 1,
) -> SystemTrace:
    """Per-round WAN weather: lognormal jitter on every link, plus rare deep
    outages that cut a link to ``outage_mult`` of nominal for the round.

    ``outage_len > 1`` makes outages *persistent weather*: the outage
    indicators are drawn once per block of ``outage_len`` consecutive
    rounds (jitter stays per-round), so a hit link stays degraded long
    enough for a sliding-window estimate to see it — the regime the
    adaptive controller (``repro.control``) exploits.  The default
    ``outage_len=1`` reproduces the original per-round-iid stream
    bit-for-bit.
    """
    N, M = system.num_clients, system.M
    tag = _TAGS["flaky-wan"]
    base = _ones_state(system)

    def link(rng: np.random.Generator, n: int,
             orng: Optional[np.random.Generator] = None) -> np.ndarray:
        mult = np.exp(rng.normal(0.0, jitter_sigma, n))
        hit = (orng if orng is not None else rng).random(n) < outage_p
        return np.where(hit, mult * outage_mult, mult)

    def gen(r: int) -> RoundState:
        rng = _rng(seed, r, tag)
        # block stream for persistent outages; same draw order as the
        # per-round calls below, so every round of a block sees one weather
        orng = None if outage_len <= 1 else _rng(seed, r // outage_len, tag + 16)
        return RoundState(
            available=base.available,
            compute_mult=base.compute_mult,
            link_up_mult=tuple(link(rng, N, orng) for _ in range(M - 1)),
            link_down_mult=tuple(link(rng, N, orng) for _ in range(M - 1)),
            fed_up_mult=tuple(
                link(rng, len(system.model_up[m]), orng) for m in range(M - 1)
            ),
            fed_down_mult=tuple(
                link(rng, len(system.model_down[m]), orng) for m in range(M - 1)
            ),
        )

    return SystemTrace("flaky-wan", profile, system, rounds, seed, gen)


def straggler_tail(
    profile: LayerProfile,
    system: SystemSpec,
    rounds: int,
    seed: int = 0,
    straggler_p: float = 0.1,
    pareto_shape: float = 1.5,
    pareto_scale: float = 6.0,
) -> SystemTrace:
    """Pareto-tailed on-device slowdowns: each round a random ~10% of clients
    run their tier-0 compute 1/(1 + Pareto) slower — the heavy tail that
    makes p95 round latency diverge from the nominal max."""
    N = system.num_clients
    tag = _TAGS["straggler-tail"]
    base = _ones_state(system)

    def gen(r: int) -> RoundState:
        rng = _rng(seed, r, tag)
        slow = 1.0 + pareto_scale * rng.pareto(pareto_shape, N)
        straggler = rng.random(N) < straggler_p
        dev = np.where(straggler, 1.0 / slow, 1.0)
        return RoundState(
            available=base.available,
            compute_mult=(dev,) + base.compute_mult[1:],
            link_up_mult=base.link_up_mult,
            link_down_mult=base.link_down_mult,
            fed_up_mult=base.fed_up_mult,
            fed_down_mult=base.fed_down_mult,
        )

    return SystemTrace("straggler-tail", profile, system, rounds, seed, gen)


SCENARIOS: Dict[str, Callable[..., SystemTrace]] = {
    "homogeneous-paper": homogeneous_paper,
    "lognormal-heterogeneous": lognormal_heterogeneous,
    "diurnal-churn": diurnal_churn,
    "flaky-wan": flaky_wan,
    "straggler-tail": straggler_tail,
}


def scenario_params(name: str) -> Tuple[str, ...]:
    """The extra keyword knobs a scenario accepts (beyond rounds/seed) —
    what a serialized ``ScenarioCfg.params`` mapping may contain."""
    import inspect

    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None
    sig = inspect.signature(factory)
    skip = {"profile", "system", "rounds", "seed"}
    return tuple(p for p in sig.parameters if p not in skip)


def make_trace(
    name: str,
    profile: LayerProfile,
    system: SystemSpec,
    rounds: int,
    seed: int = 0,
    compression: Optional[CompressionSpec] = None,
    **kwargs,
) -> SystemTrace:
    """Build a named scenario's trace (see ``SCENARIOS`` for the registry)."""
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None
    # specs arrive from JSON (repro.api.ScenarioCfg.params): fail with the
    # accepted knob list instead of a bare TypeError deep in the factory
    allowed = set(scenario_params(name))
    unknown = sorted(set(kwargs) - allowed)
    if unknown:
        raise ValueError(
            f"scenario {name!r} got unknown param(s) {unknown}; "
            f"accepted: {sorted(allowed)}"
        )
    trace = factory(profile, system, rounds, seed=seed, **kwargs)
    return trace if compression is None else trace.with_compression(compression)
