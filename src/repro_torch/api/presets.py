"""Named ``ExperimentSpec`` presets — the repo's canonical setups as data;
port of ``repro.api.presets``.

``paper_spec`` is the Sec. VII experimental system (the problem every
Fig. 2/4–9 harness prices); the ``EXPERIMENTS`` registry maps short names
to zero-argument spec factories so drivers can look setups up by string.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .spec import (
    ClassesCfg,
    CompressionCfg,
    EnergyCfg,
    ExperimentSpec,
    FaultsCfg,
    HyperCfg,
    ModelCfg,
    ParticipationCfg,
    PrivacyCfg,
    RunCfg,
    ScenarioCfg,
    SolverCfg,
    SystemCfg,
)


def paper_spec(
    seed: int = 0,
    eps_scale: float = 6.0,
    compute_scale: float = 1.0,
    comm_scale: float = 1.0,
    batch: int = 16,
    mode: str = "solve",
) -> ExperimentSpec:
    """The paper's Sec. VII setting: VGG-16 on the 20-client/5-edge WAN
    system, β=3 synthetic Theorem-1 constants, ε = eps_scale × the I=1
    floor — the canonical problem every benchmark harness builds from
    (``build(paper_spec(...)).problem``)."""
    return ExperimentSpec(
        name="paper-sec7",
        model=ModelCfg(arch="vgg16-cifar10", batch=batch),
        system=SystemCfg(
            preset="paper-three-tier",
            num_clients=20,
            num_edges=5,
            seed=seed,
            compute_scale=compute_scale,
            comm_scale=comm_scale,
        ),
        hyper=HyperCfg(beta=3.0, seed=seed, eps_scale=eps_scale),
        solver=SolverCfg(kind="bcd"),
        run=RunCfg(mode=mode, seed=seed),
    )


def two_tier_spec(
    kind: str,
    seed: int = 0,
    eps_scale: float = 6.0,
    compute_scale: float = 1.0,
    comm_scale: float = 1.0,
) -> ExperimentSpec:
    """Fig. 7 baselines: two-tier client-edge / client-cloud SFL."""
    if kind not in ("client-edge", "client-cloud"):
        raise ValueError(f"kind must be client-edge|client-cloud: {kind!r}")
    return ExperimentSpec(
        name=f"two-tier-{kind}",
        model=ModelCfg(arch="vgg16-cifar10", batch=16),
        system=SystemCfg(
            preset=f"two-tier-{kind}",
            num_clients=20,
            num_edges=5 if kind == "client-edge" else 1,
            seed=seed,
            compute_scale=compute_scale,
            comm_scale=comm_scale,
        ),
        hyper=HyperCfg(beta=3.0, seed=seed, eps_scale=eps_scale),
        solver=SolverCfg(kind="bcd"),
        run=RunCfg(mode="solve", seed=seed),
    )


def tpu_pod_spec(seed: int = 0, eps: float = 2.0) -> ExperimentSpec:
    """The same model priced on TPU v5e ICI/DCN links (DESIGN.md §2)."""
    return ExperimentSpec(
        name="tpu-pod",
        model=ModelCfg(arch="vgg16-cifar10", batch=16),
        system=SystemCfg(preset="tpu-pod", num_clients=16, num_edges=4),
        hyper=HyperCfg(seed=seed, eps=eps),
        solver=SolverCfg(kind="bcd"),
        run=RunCfg(mode="solve", seed=seed),
    )


def robust_spec(
    scenario: str,
    seed: int = 0,
    eps_scale: float = 6.0,
    rounds: int = 64,
    quantile: float = 0.95,
) -> ExperimentSpec:
    """Paper problem priced at a fleet-sim regime's q-quantile latencies."""
    base = paper_spec(seed=seed, eps_scale=eps_scale)
    return base.replace(
        name=f"robust-{scenario}",
        scenario=ScenarioCfg(
            name=scenario, rounds=rounds, seed=seed, quantile=quantile
        ),
    )


def participation_spec(
    scenario: str = "straggler-tail",
    target_rate: float = 0.75,
    seed: int = 0,
    eps_scale: float = 6.0,
    rounds: int = 64,
) -> ExperimentSpec:
    """Paper problem under a straggler deadline (DESIGN.md §12): the round
    barrier sits at the scenario's pooled ``target_rate`` finish-time
    quantile, latency terms become deadline-capped trace expectations, and
    the bound inflates by the estimated 1/q_m."""
    base = paper_spec(seed=seed, eps_scale=eps_scale)
    return base.replace(
        name=f"participation-{scenario}",
        scenario=ScenarioCfg(name=scenario, rounds=rounds, seed=seed),
        participation=ParticipationCfg(target_rate=target_rate),
    )


def quickstart_spec(seed: int = 0, rounds: int = 30) -> ExperimentSpec:
    """The README quickstart: reduced smollm trained across 8→4→1 tiers."""
    return ExperimentSpec(
        name="quickstart",
        model=ModelCfg(
            arch="smollm-135m", variant="reduced", num_layers=4, batch=4, seq=32
        ),
        system=SystemCfg(
            preset="paper-three-tier", num_clients=8, num_edges=4, seed=seed
        ),
        hyper=HyperCfg(seed=seed),
        solver=SolverCfg(kind="fixed", cuts=(1, 3), intervals=(4, 2, 1)),
        run=RunCfg(mode="train", seed=seed, rounds=rounds, lr=0.1),
    )


def hetcuts_spec(
    num_classes: int = 2,
    by: str = "uplink",
    seed: int = 0,
    eps_scale: float = 10.0,
    compute_sigma: float = 0.5,
    link_sigma: float = 0.6,
) -> ExperimentSpec:
    """Per-class cut assignment on the statically heterogeneous fleet
    (DESIGN.md §14): clients banded by fed-uplink rate each get their own
    split vector; ``num_classes=1`` collapses bit-exactly to the
    single-cut BCD optimum."""
    return ExperimentSpec(
        name=f"hetcuts-c{num_classes}-{by}",
        model=ModelCfg(arch="vgg16-cifar10", batch=16),
        system=SystemCfg(
            preset="lognormal-fleet",
            num_clients=20,
            num_edges=5,
            seed=seed,
            extras={"compute_sigma": compute_sigma, "link_sigma": link_sigma},
        ),
        hyper=HyperCfg(beta=3.0, seed=seed, eps_scale=eps_scale),
        solver=SolverCfg(kind="bcd"),
        run=RunCfg(mode="solve", seed=seed),
        classes=ClassesCfg(num_classes=num_classes, by=by),
    )


def compressed_spec(
    codec: str = "int8",
    seed: int = 0,
    eps_scale: float = 6.0,
    model_ratio=None,
    omega=None,
    **params,
) -> ExperimentSpec:
    """Paper problem over a compressed fed-server wire."""
    base = paper_spec(seed=seed, eps_scale=eps_scale)
    return base.replace(
        name=f"compressed-{codec}",
        compression=CompressionCfg(
            codec=codec, params=dict(params), model_ratio=model_ratio, omega=omega
        ),
    )


def privacy_energy_spec(
    seed: int = 0,
    eps_scale: float = 6.0,
    noise_multiplier: float = 8.0,
    clip: float = 1e-4,
    epsilon_budget: Optional[float] = None,
    budget_j_per_round: Optional[float] = None,
) -> ExperimentSpec:
    """Paper problem with DP-noised uplinks and per-tier energy pricing
    (DESIGN.md §15): the Gaussian mechanism (z, C) noises the Engine-A
    fed wire, the RDP accountant turns ``epsilon_budget`` into a round
    cap the BCD solvers honour, and the energy tables price every
    (I, μ) with ``budget_j_per_round`` as a feasibility constraint."""
    base = paper_spec(seed=seed, eps_scale=eps_scale)
    return base.replace(
        name="privacy-energy",
        privacy=PrivacyCfg(
            noise_multiplier=noise_multiplier,
            clip=clip,
            epsilon_budget=epsilon_budget,
        ),
        energy=EnergyCfg(budget_j_per_round=budget_j_per_round),
    )


def fault_storm_spec(
    seed: int = 0,
    rounds: int = 40,
    crash_rate: float = 0.08,
    corrupt_rate: float = 0.08,
    corrupt_mode: str = "nan",
    link_fail_rate: float = 0.15,
    checkpoint_every: int = 10,
    engine_crash_round: Optional[int] = None,
) -> ExperimentSpec:
    """The fault-tolerance drill (DESIGN.md §16): the quickstart training
    run under a simultaneous crash + corrupt-update + retried-link +
    cell-outage storm, on the flaky-wan fleet.  Crashed clients drop out
    of the round mask, corrupt replicas are quarantined by the guarded
    sync, retries re-price every link, the dead cell's clients reroute to
    siblings, and the Theorem-1 bound runs on fault-deflated q_m —
    ``benchmarks/fault_tolerance.py`` checks it still envelopes the
    realized loss."""
    return ExperimentSpec(
        name="fault-storm",
        model=ModelCfg(
            arch="smollm-135m", variant="reduced", num_layers=4, batch=4, seq=32
        ),
        system=SystemCfg(
            preset="paper-three-tier", num_clients=8, num_edges=4, seed=seed
        ),
        hyper=HyperCfg(seed=seed),
        solver=SolverCfg(kind="fixed", cuts=(1, 3), intervals=(4, 2, 1)),
        run=RunCfg(mode="train", seed=seed, rounds=rounds, lr=0.1),
        scenario=ScenarioCfg(name="flaky-wan", rounds=rounds, seed=seed),
        faults=FaultsCfg(
            seed=seed,
            crash_rate=crash_rate,
            corrupt_rate=corrupt_rate,
            corrupt_mode=corrupt_mode,
            link_fail_rate=link_fail_rate,
            link_retries=2,
            outage_cells=(0,),
            outage_tier=1,
            outage_start=rounds // 4,
            outage_len=max(1, rounds // 8),
            checkpoint_every=checkpoint_every,
            engine_crash_round=engine_crash_round,
        ),
    )


EXPERIMENTS: Dict[str, Callable[[], ExperimentSpec]] = {
    "paper-sec7": paper_spec,
    "tpu-pod": tpu_pod_spec,
    "quickstart": quickstart_spec,
    "robust-straggler-tail": lambda: robust_spec("straggler-tail"),
    "participation-straggler-tail": lambda: participation_spec("straggler-tail"),
    "compressed-int8": lambda: compressed_spec("int8"),
    "hetcuts-lognormal": hetcuts_spec,
    "privacy-energy": privacy_energy_spec,
    "fault-storm": fault_storm_spec,
}


def register_experiment(name: str, factory: Callable[[], ExperimentSpec]) -> None:
    EXPERIMENTS[name] = factory


def get_experiment(name: str) -> ExperimentSpec:
    try:
        return EXPERIMENTS[name]()
    except KeyError:
        raise KeyError(
            f"unknown experiment {name!r}; available: {sorted(EXPERIMENTS)}"
        ) from None
