"""The declarative experiment specification (DESIGN.md §10) — port of
``repro.api.spec``.  The dataclasses and their JSON are the JAX package's,
field for field, so one spec file drives either package; the sections and
options whose modules are not ported yet are refused by
``build.check_capabilities``, naming their ROADMAP item.

One serializable dataclass tree — ``ExperimentSpec`` — describes everything
this repo can do with the paper's pipeline: which model profile to price
(Eqs. 11–16), which multi-tier system to price it on, which fleet-sim
regime to robustify against, which wire codec to compress with, which
solver to run (Algorithm 2 BCD / Proposition-1 MA / Dinkelbach MS), and
what the run should produce (an optimized schedule, a simulated latency
profile, or a real Engine-A/B training run).

Every field is a plain JSON value (str / int / float / bool, tuples of
those, or a flat mapping), so a spec survives ``json.dumps(spec.to_dict())``
→ disk → ``ExperimentSpec.from_dict(json.loads(...))`` losslessly:
``from_dict(to_dict(s)) == s`` for every spec, which
``tests/test_api.py`` pins for every registry entry.

The spec is *data only*.  Name→object resolution lives in
``repro.api.registry``; the composition order (profile → compression →
trace → robust problem → solver) lives in ``repro.api.build`` — the one
place that knows compression must be attached to the base problem before
trace-quantile pricing, so the historical ``with_compression``-under-
``latency_model`` footgun cannot be expressed here at all.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union


def _int_tuple(x: Optional[Sequence[int]]) -> Optional[Tuple[int, ...]]:
    """Normalize JSON lists (and any int sequence) to an int tuple."""
    if x is None:
        return None
    return tuple(int(v) for v in x)


def _ratio_tuple(
    x: Union[None, float, int, Sequence[float]]
) -> Union[None, float, Tuple[float, ...]]:
    """Ratios may be one scalar (uniform across links) or per-link values."""
    if x is None:
        return None
    if isinstance(x, (int, float)):
        return float(x)
    return tuple(float(v) for v in x)


@dataclass(frozen=True)
class ModelCfg:
    """Which ``repro.configs`` architecture to profile, and at what shape.

    ``arch`` is a registry id (``repro.api.registry.MODEL_IDS``);
    ``variant`` picks the full SPEC or the CPU-runnable REDUCED config;
    ``num_layers`` optionally overrides the unit count (e.g. the quickstart
    bumps reduced smollm to 4 layers so all three tiers hold a unit).
    """

    arch: str = "vgg16-cifar10"
    variant: str = "full"          # "full" | "reduced"
    batch: int = 16
    seq: int = 1
    num_layers: Optional[int] = None
    optimizer: str = "sgd"         # prices optimizer-state bytes (C5)

    def __post_init__(self):
        if self.variant not in ("full", "reduced"):
            raise ValueError(f"variant must be full|reduced: {self.variant!r}")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelCfg":
        return cls(**d)


@dataclass(frozen=True)
class SystemCfg:
    """Which multi-tier resource topology to price against.

    ``preset`` names a builder in ``repro.api.registry.SYSTEMS``
    (paper-three-tier | tpu-pod | two-tier-client-edge |
    two-tier-client-cloud | anything registered via ``register_system``).
    ``extras`` passes preset-specific keyword arguments straight through
    (e.g. ``memory_bytes`` for the paper system, ``chip_flops`` for the
    TPU pod).
    """

    preset: str = "paper-three-tier"
    num_clients: int = 20
    num_edges: int = 5
    seed: int = 0
    compute_scale: float = 1.0
    comm_scale: float = 1.0
    extras: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SystemCfg":
        d = dict(d)
        d["extras"] = dict(d.get("extras", {}))
        return cls(**d)


@dataclass(frozen=True)
class HyperCfg:
    """Theorem-1 constants (``synthetic_hyperspec`` knobs) + the target ε.

    ``eps`` pins the target directly; otherwise ``eps = eps_scale × floor``
    where floor is the I=1 bound at R→∞ (cut-independent, since only
    I_m > 1 tiers contribute drift).
    """

    gamma: float = 5e-4
    beta: float = 50.0
    theta0: float = 5.0
    g2_scale: float = 20.0
    sigma2_scale: float = 4.0
    decay: float = 0.9
    seed: int = 0
    eps: Optional[float] = None
    eps_scale: float = 6.0

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "HyperCfg":
        return cls(**d)


@dataclass(frozen=True)
class ScenarioCfg:
    """Which fleet-sim regime prices the latency terms, and at what quantile.

    ``name`` is a key of ``repro.sim.SCENARIOS``; ``params`` are the
    scenario constructor's extra knobs (e.g. ``compute_sigma`` for
    lognormal-heterogeneous).  ``quantile`` is the robust-pricing level the
    solvers consume (p50 typical, p95 straggler-robust); ``sim_rounds``
    optionally caps how many trace rounds the quantile uses.
    """

    name: str = "homogeneous-paper"
    rounds: int = 64
    seed: int = 0
    quantile: float = 0.95
    backend: str = "numpy"
    sim_rounds: Optional[int] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScenarioCfg":
        d = dict(d)
        d["params"] = dict(d.get("params", {}))
        return cls(**d)


@dataclass(frozen=True)
class ParticipationCfg:
    """Straggler-aware partial participation policy (DESIGN.md §12).

    Exactly one of ``deadline`` (the round barrier in seconds) or
    ``target_rate`` (the pooled per-client finish-time quantile the
    barrier should sit at, e.g. 0.5 = drop the slower half of
    client-rounds) must be set.  Requires a ``scenario`` section — the
    policy is priced against that fleet trace: latency terms become
    deadline-capped trace expectations and the Theorem-1 terms inflate by
    the estimated 1/q_m.  ``cuts`` optionally pins the reference cut
    vector the q_m estimation replays (default: evenly spread, the BCD
    starting anchor).
    """

    deadline: Optional[float] = None
    target_rate: Optional[float] = None
    cuts: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if (self.deadline is None) == (self.target_rate is None):
            raise ValueError(
                "participation needs exactly one of deadline= or "
                f"target_rate= (got deadline={self.deadline!r}, "
                f"target_rate={self.target_rate!r})"
            )
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(f"deadline must be positive: {self.deadline}")
        if self.target_rate is not None and not (0.0 < self.target_rate <= 1.0):
            raise ValueError(
                f"target_rate must lie in (0, 1]: {self.target_rate}"
            )
        object.__setattr__(self, "cuts", _int_tuple(self.cuts))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ParticipationCfg":
        return cls(**d)


@dataclass(frozen=True)
class CompressionCfg:
    """Which wire codec to train with and how the analytic layer prices it.

    ``codec`` names an executable ``Compressor`` in
    ``repro.api.registry.CODECS`` (identity | int8 | top-k | registered);
    ``params`` are its constructor kwargs (``tile`` for int8, ``frac`` for
    top-k).  The analytic ``CompressionSpec`` is derived from the codec's
    declared (ratio, ω) unless overridden: ``model_ratio`` / ``act_ratio``
    accept one scalar (uniform across links) or one value per link, and
    ``omega`` overrides the bound inflation — so a pure pricing sweep uses
    ``codec="identity"`` with explicit ratios.
    """

    codec: str = "identity"
    params: Dict[str, Any] = field(default_factory=dict)
    model_ratio: Union[None, float, Tuple[float, ...]] = None
    act_ratio: Union[None, float, Tuple[float, ...]] = None
    omega: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "model_ratio", _ratio_tuple(self.model_ratio))
        object.__setattr__(self, "act_ratio", _ratio_tuple(self.act_ratio))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CompressionCfg":
        d = dict(d)
        d["params"] = dict(d.get("params", {}))
        return cls(**d)


@dataclass(frozen=True)
class ControlCfg:
    """Online adaptive control knobs (``run.mode="control"``, DESIGN.md §13).

    The controller watches a sliding window of observed round telemetry,
    re-prices the system online (``repro.control.WindowedLatency`` +
    windowed participation), and re-solves BCD warm-started when the
    window drifts ``rel_tol`` away from the prices the current schedule
    was solved for.  ``cooldown`` rounds must pass between re-solves;
    ``max_switches=0`` means unlimited.  Requires a ``scenario`` section —
    telemetry is observed from that fleet trace.
    """

    window: int = 8                # sliding telemetry window (rounds)
    check_every: int = 1           # drift-check cadence (rounds)
    rel_tol: float = 0.25          # relative drift that triggers a re-solve
    cooldown: int = 8              # rounds between re-solves
    min_window: int = 4            # observations before the first check
    quantile: float = 0.5          # windowed robust-pricing level
    warm_start: bool = True        # seed BCD/Dinkelbach at the current optimum
    backend: str = "auto"          # re-solve lattice backend
    max_switches: int = 0          # hard cap on schedule changes (0 = none)
    fault_tol: float = 1.0         # windowed fault-rate drift trigger
    #                                (DESIGN.md §16); 1.0 = never trips

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"control window must be >= 2: {self.window}")
        if not 0.0 < self.fault_tol <= 1.0:
            raise ValueError(
                f"control fault_tol must lie in (0, 1]: {self.fault_tol}"
            )
        if self.min_window < 2:
            raise ValueError(
                f"control min_window must be >= 2: {self.min_window}"
            )
        if not 0.0 < self.quantile <= 1.0:
            raise ValueError(
                f"control quantile must lie in (0, 1]: {self.quantile}"
            )
        if self.rel_tol <= 0.0:
            raise ValueError(f"control rel_tol must be positive: {self.rel_tol}")
        if self.cooldown < 0 or self.check_every < 1 or self.max_switches < 0:
            raise ValueError(
                "control needs cooldown >= 0, check_every >= 1, "
                f"max_switches >= 0 (got {self.cooldown}, "
                f"{self.check_every}, {self.max_switches})"
            )
        if self.backend not in ("auto", "scalar", "numpy", "jax"):
            raise ValueError(
                f"control backend must be auto|scalar|numpy|jax: {self.backend!r}"
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ControlCfg":
        return cls(**d)


@dataclass(frozen=True)
class ClassesCfg:
    """Heterogeneity-aware per-class cut assignment (DESIGN.md §14).

    Clients are banded into ``num_classes`` classes that each hold their
    own split vector; the per-class BCD (``core.classes``) optimizes the
    product of cut lattices.  ``by`` picks the banding signal:
    "compute" (tier-0 device rates), "uplink" (tier-0 fed-server model
    uplink rates — the channel whose stragglers per-class cuts relieve),
    or "explicit" with ``assign`` giving the class id per client.
    ``product_budget`` caps the exhaustively enumerated assignment rows
    (``K^C``); larger products fall back to coordinate descent seeded at
    the single-cut optimum.  Requires nominal pricing — a ``scenario`` or
    ``participation`` section (trace latency models) conflicts.
    """

    num_classes: int = 2
    by: str = "compute"            # "compute" | "uplink" | "explicit"
    assign: Optional[Tuple[int, ...]] = None
    product_budget: int = 200_000

    def __post_init__(self):
        if self.num_classes < 1:
            raise ValueError(
                f"classes.num_classes must be >= 1: {self.num_classes}"
            )
        if self.by not in ("compute", "uplink", "explicit"):
            raise ValueError(
                f"classes.by must be compute|uplink|explicit: {self.by!r}"
            )
        if (self.by == "explicit") != (self.assign is not None):
            raise ValueError(
                "classes.assign must be given exactly when by='explicit' "
                f"(got by={self.by!r}, assign={self.assign!r})"
            )
        if self.product_budget < 1:
            raise ValueError(
                f"classes.product_budget must be >= 1: {self.product_budget}"
            )
        object.__setattr__(self, "assign", _int_tuple(self.assign))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClassesCfg":
        return cls(**d)


@dataclass(frozen=True)
class PrivacyCfg:
    """Client-level DP on the fed-server uplink (DESIGN.md §15).

    ``noise_multiplier`` (z) and ``clip`` (C) parameterize the Gaussian
    mechanism the Engine-A wire applies per client replica; z = 0 keeps
    the wire noiseless — ``build`` then constructs no mechanism at all, so
    the training graph is bit-identical to a spec without this section.
    ``epsilon_budget`` (with ``delta``) caps the RDP-accounted privacy
    spend: the solvers turn it into a round cap R ≤ R_max(ε, δ) — i.e. a
    denominator floor D ≥ 2θ₀/(γ R_max) — and retreat to schedules whose
    bound reaches the target within the budget.  The mechanism dimension
    (Theorem-1 σ²-inflation) is resolved by ``build`` from the model
    profile; it is not a spec knob.
    """

    noise_multiplier: float = 0.0
    clip: float = 1.0
    delta: float = 1e-5
    epsilon_budget: Optional[float] = None

    def __post_init__(self):
        if self.noise_multiplier < 0:
            raise ValueError(
                f"privacy.noise_multiplier must be >= 0: {self.noise_multiplier}"
            )
        if self.clip <= 0:
            raise ValueError(f"privacy.clip must be positive: {self.clip}")
        if not 0.0 < self.delta < 1.0:
            raise ValueError(f"privacy.delta must lie in (0, 1): {self.delta}")
        if self.epsilon_budget is not None and self.epsilon_budget <= 0:
            raise ValueError(
                f"privacy.epsilon_budget must be positive: {self.epsilon_budget}"
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "PrivacyCfg":
        return cls(**d)


@dataclass(frozen=True)
class EnergyCfg:
    """Per-tier energy pricing of the round (DESIGN.md §15).

    Prices accept one scalar (uniform across tiers/links, the common case)
    or one value per tier (``compute_j_per_flop``, len M) / per link
    (``act_j_per_byte`` / ``model_j_per_byte``, len M−1).
    ``budget_j_per_round`` caps the amortized fleet round energy
    E(I, μ) = E_S + Σ E_{m,A}/I_m as a solver feasibility constraint;
    without it the section is reporting-only.  All-zero prices with no
    budget are an exact no-op on every optimum.
    """

    compute_j_per_flop: Union[float, Tuple[float, ...]] = 1e-11
    act_j_per_byte: Union[float, Tuple[float, ...]] = 2e-7
    model_j_per_byte: Union[float, Tuple[float, ...]] = 2e-7
    budget_j_per_round: Optional[float] = None

    def __post_init__(self):
        for name in ("compute_j_per_flop", "act_j_per_byte", "model_j_per_byte"):
            object.__setattr__(self, name, _ratio_tuple(getattr(self, name)))
            v = getattr(self, name)
            vals = (v,) if isinstance(v, float) else v
            if any(x < 0 for x in vals):
                raise ValueError(f"energy.{name} has a negative price")
        if self.budget_j_per_round is not None and self.budget_j_per_round <= 0:
            raise ValueError(
                f"energy.budget_j_per_round must be positive: "
                f"{self.budget_j_per_round}"
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EnergyCfg":
        return cls(**d)


@dataclass(frozen=True)
class FaultsCfg:
    """Fault injection + fault-tolerant training (DESIGN.md §16).

    The fault fields mirror ``repro.faults.FaultSpec`` one-to-one:
    per-round crash / corrupt-update / link-retry / cell-outage draws from
    the spec's own seeded streams, layered on whatever scenario the run
    prices (a spec with all rates zero and no outage composes to a
    bit-exact no-op).  ``build`` threads the spec everywhere at once —
    retry-priced latency tables, fault-adjusted trace, deflated q_m for
    the Theorem-1 bound — and ``run`` modes "train"/"control" inject the
    data-plane faults into the engine loop behind the guarded sync.

    ``guard_norm_factor`` sets the quarantine threshold of the non-finite
    / norm-blow-up guard (``core.tiers.GuardSpec``).  ``checkpoint_every``
    > 0 saves an atomic engine checkpoint that cadence (to
    ``checkpoint_dir`` or a run-temp dir); ``engine_crash_round`` r kills
    the engine after round r's step and resumes from the last checkpoint
    (``control.resume_with_migration``) — the recovery drill the
    fault-tolerance benchmark times.
    """

    seed: int = 0
    crash_rate: float = 0.0
    crash_stage: str = "uplink"
    corrupt_rate: float = 0.0
    corrupt_mode: str = "nan"      # nan | inf | scale | bitflip
    corrupt_scale: float = 1e6
    link_fail_rate: float = 0.0
    link_retries: int = 2
    outage_cells: Tuple[int, ...] = ()
    outage_tier: int = 1
    outage_start: int = 0
    outage_len: int = 0
    guard_norm_factor: float = 1e4
    checkpoint_every: int = 0      # 0 = no checkpoints
    checkpoint_dir: Optional[str] = None
    engine_crash_round: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(
            self, "outage_cells", _int_tuple(self.outage_cells) or ()
        )
        # the JAX package delegates fault-field validation to its
        # FaultSpec and GuardSpec here; those come with ROADMAP A11, and
        # until then build.check_capabilities refuses a faults section
        if self.checkpoint_every < 0:
            raise ValueError(
                f"faults.checkpoint_every must be >= 0: {self.checkpoint_every}"
            )
        if self.engine_crash_round is not None:
            if self.engine_crash_round < 0:
                raise ValueError(
                    "faults.engine_crash_round must be >= 0: "
                    f"{self.engine_crash_round}"
                )
            if self.checkpoint_every < 1:
                raise ValueError(
                    "faults.engine_crash_round needs checkpoint_every >= 1 "
                    "— recovery resumes from the last saved checkpoint"
                )

    def to_fault_spec(self):
        """The analytic/injection ``FaultSpec`` this declares (ROADMAP A11)."""
        raise NotImplementedError("the faults module is ported with ROADMAP A11")

    def to_guard_spec(self):
        """The ``GuardSpec`` the engine's guarded syncs use (ROADMAP A11)."""
        raise NotImplementedError("guarded sync is ported with ROADMAP A11")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultsCfg":
        d = dict(d)
        d["outage_cells"] = tuple(d.get("outage_cells", ()))
        return cls(**d)


@dataclass(frozen=True)
class SolverCfg:
    """Which optimizer of problem (20) runs, with its budgets.

    ``kind``: "bcd" (Algorithm 2), "ma" (Proposition 1, needs ``cuts``),
    "ms" (Dinkelbach, needs ``intervals``), or "fixed" (evaluate the given
    schedule without optimizing).  For "bcd", ``cuts``/``intervals`` seed
    the iteration.

    ``backend`` picks the lattice-evaluation path (DESIGN.md §11):
    "scalar" walks one cut vector at a time (the historical oracle path),
    "numpy"/"jax" run the batched whole-lattice core — "jax", the JAX
    package's device backend, reads as the port's ``torch`` (float64
    tables on the card) — and "auto" (default) picks numpy or, for
    lattices big enough, the card.  All four return bit-identical optima.
    """

    kind: str = "bcd"
    cuts: Optional[Tuple[int, ...]] = None
    intervals: Optional[Tuple[int, ...]] = None
    tol: float = 1e-6
    max_iters: int = 50
    backend: str = "auto"

    def __post_init__(self):
        if self.kind not in ("bcd", "ma", "ms", "fixed"):
            raise ValueError(f"solver kind must be bcd|ma|ms|fixed: {self.kind!r}")
        if self.backend not in ("auto", "scalar", "numpy", "jax"):
            raise ValueError(
                f"solver backend must be auto|scalar|numpy|jax: {self.backend!r}"
            )
        object.__setattr__(self, "cuts", _int_tuple(self.cuts))
        object.__setattr__(self, "intervals", _int_tuple(self.intervals))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SolverCfg":
        return cls(**d)


@dataclass(frozen=True)
class ShardingCfg:
    """Mesh geometry for the sharded Engine-A step (DESIGN.md §17).

    The client-stacked parameter axis shards over ``data`` (or
    ``pod × data`` when ``pods`` > 0) and trailing weight dims get
    Megatron TP over ``model`` — exactly ``launch.sharding``'s layout
    contract.  The mesh needs data·model·max(pods, 1) devices; on a CPU
    host that means ``--xla_force_host_platform_device_count`` set
    before jax initializes (``launch.mesh.make_debug_mesh`` checks and
    says so).  ``data=1, model=1, pods=0`` is a valid degenerate mesh
    (useful for exercising the sharded code path on one device).
    """

    data: int = 2
    model: int = 1
    pods: int = 0                  # 0 = single-pod (data, model) mesh

    def __post_init__(self):
        if self.data < 1 or self.model < 1 or self.pods < 0:
            raise ValueError(
                f"sharding needs data >= 1, model >= 1, pods >= 0: "
                f"data={self.data}, model={self.model}, pods={self.pods}"
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ShardingCfg":
        return cls(**d)


@dataclass(frozen=True)
class RunCfg:
    """What ``run(spec)`` produces.

    ``mode``: "solve" (optimized schedule + analytic latency breakdown),
    "simulate" (schedule + per-round trace latency profile; needs a
    ``scenario``), "train" (real Engine-A/B split training with the
    schedule), or "control" (training under the online adaptive
    controller — needs a ``scenario``; knobs come from the spec's
    ``control`` section).  Training knobs are ignored by solve/simulate.

    ``sharding`` (a ``ShardingCfg``) runs the Engine-A step sharded over
    a device mesh (DESIGN.md §17); Engine A only.  ``staleness`` — one
    bound or per-tier bounds s_m ≥ 0 — switches training to the async
    bounded-staleness aggregation mode: tier m's fed-server sync
    computed at round r applies at round r + s_m, overlapping client
    compute, and the reported Theorem-1 bound carries the (I_m + s_m)²
    drift inflation.  All-zero staleness is the synchronous engine
    bit-exactly.
    """

    mode: str = "solve"
    seed: int = 0
    rounds: int = 30               # training rounds (mode="train")
    lr: float = 0.1
    engine: str = "a"              # "a" (sync groups) | "b" (per-entity)
    non_iid: bool = False
    dataset_size: int = 512
    log_every: int = 0             # 0 = silent
    sharding: Optional[ShardingCfg] = None
    staleness: Union[int, Tuple[int, ...]] = 0

    def __post_init__(self):
        if self.mode not in ("solve", "simulate", "train", "control"):
            raise ValueError(
                f"run mode must be solve|simulate|train|control: {self.mode!r}"
            )
        if self.engine not in ("a", "b"):
            raise ValueError(f"engine must be a|b: {self.engine!r}")
        s = self.staleness
        if not isinstance(s, int):
            object.__setattr__(
                self, "staleness", tuple(int(v) for v in s)
            )
            s = self.staleness
        vals = (s,) if isinstance(s, int) else s
        if any(v < 0 for v in vals):
            raise ValueError(f"run.staleness bounds must be >= 0: {s!r}")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunCfg":
        d = dict(d)
        sh = d.get("sharding")
        if sh is not None and not isinstance(sh, ShardingCfg):
            d["sharding"] = ShardingCfg.from_dict(sh)
        st = d.get("staleness")
        if st is not None and not isinstance(st, int):
            d["staleness"] = tuple(int(v) for v in st)
        return cls(**d)


@dataclass(frozen=True)
class ExperimentSpec:
    """The whole experiment as one declarative, serializable value."""

    model: ModelCfg = field(default_factory=ModelCfg)
    system: SystemCfg = field(default_factory=SystemCfg)
    hyper: HyperCfg = field(default_factory=HyperCfg)
    solver: SolverCfg = field(default_factory=SolverCfg)
    run: RunCfg = field(default_factory=RunCfg)
    scenario: Optional[ScenarioCfg] = None
    compression: Optional[CompressionCfg] = None
    participation: Optional[ParticipationCfg] = None
    control: Optional[ControlCfg] = None
    classes: Optional[ClassesCfg] = None
    privacy: Optional[PrivacyCfg] = None
    energy: Optional[EnergyCfg] = None
    faults: Optional[FaultsCfg] = None
    name: str = ""

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON projection (tuples become lists; None sections stay None)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        scenario = d.get("scenario")
        compression = d.get("compression")
        participation = d.get("participation")
        control = d.get("control")
        classes = d.get("classes")
        privacy = d.get("privacy")
        energy = d.get("energy")
        faults = d.get("faults")
        return cls(
            model=ModelCfg.from_dict(d.get("model", {})),
            system=SystemCfg.from_dict(d.get("system", {})),
            hyper=HyperCfg.from_dict(d.get("hyper", {})),
            solver=SolverCfg.from_dict(d.get("solver", {})),
            run=RunCfg.from_dict(d.get("run", {})),
            scenario=None if scenario is None else ScenarioCfg.from_dict(scenario),
            compression=(
                None if compression is None
                else CompressionCfg.from_dict(compression)
            ),
            participation=(
                None if participation is None
                else ParticipationCfg.from_dict(participation)
            ),
            control=None if control is None else ControlCfg.from_dict(control),
            classes=None if classes is None else ClassesCfg.from_dict(classes),
            privacy=None if privacy is None else PrivacyCfg.from_dict(privacy),
            energy=None if energy is None else EnergyCfg.from_dict(energy),
            faults=None if faults is None else FaultsCfg.from_dict(faults),
            name=d.get("name", ""),
        )

    def replace(self, **kwargs) -> "ExperimentSpec":
        """Convenience ``dataclasses.replace`` that reads like the spec."""
        return dataclasses.replace(self, **kwargs)
