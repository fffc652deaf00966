"""``build(spec)`` — the one owner of the composition order; port of
``repro.api.build``.

The paper's pipeline composes in exactly one valid order:

    profile (Eqs. 11–16)
      → compression attached to the *base* problem (ratios + ω)
        → scenario trace priced over the same wire
          → robust problem (trace-quantile LatencyModel)
            → solver / simulator / engine

Historically every example and benchmark re-assembled this chain by hand,
and the one illegal order — ``with_compression`` *after* a trace-based
``latency_model`` is attached — was only caught by a runtime raise in
``repro.core.problem``.  ``build`` makes that ordering unrepresentable:
compression always lands on the base problem first, and ``robust_problem``
re-prices the trace over the same wire.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..compress.base import CompressionSpec
from ..core.convergence import (
    HyperSpec,
    ParticipationSpec,
    synthetic_hyperspec,
    theorem1_bound,
)
from ..core.latency import LayerProfile, SystemSpec, build_profile
from ..configs import PORTED_ARCH_IDS
from ..core.problem import HsflProblem
from .registry import resolve_codec, resolve_model, resolve_system
from .spec import CompressionCfg, ExperimentSpec


@dataclass
class BuiltExperiment:
    """Everything ``build`` resolved, with the composed problem ready to use.

    ``problem`` carries compression and (when a scenario is configured) the
    trace-quantile latency model; ``base_problem`` is the same problem
    before trace pricing — the nominal Eq. 17/18 view.
    """

    spec: ExperimentSpec
    model_spec: object                      # ModelSpec | VggSpec
    profile: LayerProfile
    system: SystemSpec
    hyper: HyperSpec
    eps: float
    compression: Optional[CompressionSpec]
    compressor: Optional[object]            # executable Compressor (engines)
    trace: Optional[object]                 # sim.SystemTrace
    base_problem: HsflProblem
    problem: HsflProblem
    participation: Optional[ParticipationSpec] = None  # resolved q_m/deadline
    class_spec: Optional[object] = None     # core.classes.CutClassSpec
    privacy: Optional[object] = None        # privacy.PrivacySpec (analytic)
    dp_mechanism: Optional[object] = None   # privacy.DPMechanism (engines);
    #                                         None at z=0 — noiseless graph
    energy: Optional[object] = None         # energy.EnergySpec
    faults: Optional[object] = None         # faults.FaultSpec (None = no
    #                                         faults section; a null spec
    #                                         still resolves, as a no-op)
    guard: Optional[object] = None          # core.tiers.GuardSpec


def resolve_compression(
    cfg: Optional[CompressionCfg], M: int
) -> Tuple[Optional[object], Optional[CompressionSpec]]:
    """``CompressionCfg`` → (executable codec, analytic CompressionSpec).

    Ratios/ω default to the codec's declared values; scalar ratios broadcast
    uniformly across the M-1 links, sequences are taken per link.
    """
    if cfg is None:
        return None, None
    codec = resolve_codec(cfg.codec, cfg.params)

    def links(value, default: float) -> Tuple[float, ...]:
        if value is None:
            value = default
        if isinstance(value, tuple):
            return tuple(float(v) for v in value)
        return (float(value),) * (M - 1)

    spec = CompressionSpec(
        act_ratio=links(cfg.act_ratio, 1.0),
        model_ratio=links(cfg.model_ratio, codec.ratio),
        omega=float(codec.omega if cfg.omega is None else cfg.omega),
    ).validate_for(M)
    return codec, spec


def _unsupported(combo: str, need: str, why: str) -> ValueError:
    """The one message shape every capability failure uses."""
    return ValueError(
        f"unsupported spec combination: {combo} requires {need} — {why}"
    )


def check_capabilities(spec: ExperimentSpec) -> None:
    """Engine/feature capability matrix — every unsupported spec
    combination fails HERE, at build time, with one message shape.

    Historically Engine B's missing features raised three divergent
    ``NotImplementedError``s at step-build time (classes / privacy /
    masked-MoE, deep in ``core.engine``) while faults × Engine B had its
    own ad-hoc build-time ValueError; sharded/async execution (DESIGN.md
    §17) adds more combinations.  The engine-level raises remain as
    backstops for direct ``core.engine`` users, but the declarative API
    rejects every combination before any state is allocated.

    After the JAX package's matrix, the port's: a section or option whose
    modules are not ported yet raises ``NotImplementedError`` in the same
    message shape, naming its ROADMAP item (``_check_port_capabilities``).
    """
    training = spec.run.mode in ("train", "control")
    sharded = spec.run.sharding is not None
    st = spec.run.staleness
    async_mode = bool(
        st if isinstance(st, int) else any(v > 0 for v in st)
    )
    if training and spec.run.engine != "a":
        eng = f'engine={spec.run.engine!r}'
        if spec.classes is not None:
            raise _unsupported(
                f"classes × {eng}", 'engine="a"',
                "Engine B physically places each tier's units on its "
                "hosts, and a per-class cut assignment has no single "
                "placement; Engine A runs the ragged sync-groups path "
                "(DESIGN.md §14)",
            )
        if spec.privacy is not None and spec.privacy.noise_multiplier > 0:
            raise _unsupported(
                f"privacy × {eng}", 'engine="a"',
                "Engine B's fed wire carries one model per entity, so "
                "per-client clipping (the unit the (ε, δ) accountant "
                "meters) has no faithful placement (DESIGN.md §15)",
            )
        if spec.faults is not None:
            raise _unsupported(
                f"faults × {eng}", 'engine="a"',
                "the guarded sync + quarantine path (DESIGN.md §16) "
                "lives on the Engine-A client-stacked wire",
            )
        if sharded:
            raise _unsupported(
                f"sharding × {eng}", 'engine="a"',
                "the sharded step shards the client-stacked parameter "
                "axis over the mesh (DESIGN.md §17); Engine B has no "
                "client-stacked layout to shard",
            )
        if async_mode:
            raise _unsupported(
                f"staleness × {eng}", 'engine="a"',
                "the async bounded-staleness schedule overlaps the "
                "Engine-A fed-server syncs (DESIGN.md §17)",
            )
    if sharded or async_mode:
        feature = "sharding" if sharded else "staleness"
        if spec.privacy is not None and spec.privacy.noise_multiplier > 0:
            raise _unsupported(
                f"{feature} × privacy", "noise_multiplier=0",
                "DP noise keys fold (seed, leaf, step), so the draw "
                "cannot be reproduced bit-exactly across shard layouts "
                "or stale apply rounds — the single-host synchronous "
                "engine is the DP path (DESIGN.md §15/§17)",
            )
        if spec.classes is not None:
            raise _unsupported(
                f"{feature} × classes", "no classes section",
                "the ragged per-class sync has no sharded/async "
                "collective lowering yet (DESIGN.md §14/§17)",
            )
        if spec.faults is not None:
            raise _unsupported(
                f"{feature} × faults", "no faults section",
                "crash-recovery checkpoints cannot capture the in-flight "
                "async aggregation queue, and the fault drill's "
                "corruption/outage hooks assume the single-host "
                "synchronous loop (DESIGN.md §16/§17)",
            )
        if spec.run.mode == "control":
            raise _unsupported(
                f'{feature} × mode="control"', 'mode="train"',
                "the controller re-plans (cut, I) mid-run, which would "
                "have to re-shard state and re-time in-flight async "
                "syncs across the switch (DESIGN.md §13/§17)",
            )
    _check_port_capabilities(spec)


def _unported(feature: str, modules: str, item: str) -> NotImplementedError:
    """A spec section or option whose modules the port does not have yet,
    in the capability matrix's message shape, naming its ROADMAP item."""
    return NotImplementedError(
        f"unsupported spec combination: {feature} requires {modules} — not "
        f"ported yet (ROADMAP {item})"
    )


def _check_port_capabilities(spec: ExperimentSpec) -> None:
    """What the port runs of a spec the JAX package accepts: every section
    and option whose modules are not ported raises here, before any state
    is allocated."""
    for name, modules in (("privacy", "the privacy module"),
                          ("energy", "the energy module"),
                          ("faults", "the faults module")):
        if getattr(spec, name) is not None:
            raise _unported(f"a {name} section", modules, "A11")
    if spec.run.mode == "control":
        raise _unported('mode="control"', "the control module", "A11")
    st = spec.run.staleness
    if st if isinstance(st, int) else any(v > 0 for v in st):
        raise _unported("staleness > 0", "core.async_agg", "A11")
    if spec.run.engine != "a":
        raise _unported(f"engine={spec.run.engine!r}", "Engine B", "A12")
    if spec.run.sharding is not None:
        raise _unported("a sharding section", "core.sharded and launch.mesh", "A13")
    if spec.model.arch != "vgg16-cifar10" and spec.model.arch not in PORTED_ARCH_IDS:
        raise _unported(f"arch {spec.model.arch!r}",
                        "its model family's layers", "A14")


def build(spec: ExperimentSpec) -> BuiltExperiment:
    """Resolve every registry name and compose the problem in the one
    valid order (see module docstring)."""
    check_capabilities(spec)
    if spec.run.mode == "control" and spec.scenario is None:
        raise ValueError(
            'run mode="control" needs a scenario section: the controller '
            "observes round telemetry from that fleet trace (add scenario=, "
            'e.g. ScenarioCfg(name="flaky-wan"))'
        )
    if spec.classes is not None and (
        spec.scenario is not None or spec.participation is not None
    ):
        raise ValueError(
            "a classes section needs nominal pricing: per-class cuts are "
            "priced on the system's rate arrays, not a trace latency model "
            "(drop scenario=/participation=, and bake heterogeneity into "
            'the system preset instead, e.g. SystemCfg(preset="lognormal-fleet"))'
        )
    model_spec = resolve_model(spec.model)
    profile = build_profile(
        model_spec,
        batch=spec.model.batch,
        seq=spec.model.seq,
        optimizer=spec.model.optimizer,
    )
    system = resolve_system(spec.system)

    h = spec.hyper
    hyper = synthetic_hyperspec(
        model_spec.n_units,
        system.num_clients,
        gamma=h.gamma,
        beta=h.beta,
        theta0=h.theta0,
        g2_scale=h.g2_scale,
        sigma2_scale=h.sigma2_scale,
        decay=h.decay,
        seed=h.seed,
    )
    if h.eps is not None:
        eps = float(h.eps)
    else:
        # the I=1 floor at R→∞ is cut-independent (no I_m>1 drift term),
        # so any valid cut vector prices it; use the shared evenly-spread
        # anchor (also BCD's starting point and the q_m reference cut).
        from ..core.bcd import default_init_cuts

        M = system.M
        cuts = default_init_cuts(model_spec.n_units, M)
        floor = theorem1_bound(hyper, 10**9, [1] * M, cuts)
        eps = h.eps_scale * floor

    compressor, compression = resolve_compression(spec.compression, system.M)

    # compression attaches to the BASE problem, before any trace pricing —
    # the ordering core.problem.with_compression would otherwise refuse.
    base = HsflProblem(profile, system, hyper, eps=eps)
    if compression is not None:
        base = base.with_compression(compression)

    # privacy, energy and faults also land on the base problem in the JAX
    # package; check_port_capabilities refuses those sections (ROADMAP A11)

    trace = None
    problem = base
    participation = None
    if spec.scenario is not None:
        from ..sim import make_trace, participation_problem, robust_problem

        sc = spec.scenario
        trace = make_trace(
            sc.name, profile, system, rounds=sc.rounds, seed=sc.seed, **sc.params
        )
        if spec.participation is not None:
            # deadline policy: expectation pricing of the deadline-capped
            # round + 1/q_m bound inflation, composed in one step so the
            # latency and convergence sides describe the same barrier.
            pc = spec.participation
            problem = participation_problem(
                base,
                trace,
                deadline=pc.deadline,
                target_rate=pc.target_rate,
                cuts=pc.cuts,
                rounds=sc.sim_rounds,
                backend=sc.backend,
            )
            participation = problem.participation
        else:
            # robust_problem re-prices the (uncompressed) trace over the
            # problem's wire, keeping quantiles and ω on the same codec.
            problem = robust_problem(
                base,
                trace,
                quantile=sc.quantile,
                rounds=sc.sim_rounds,
                backend=sc.backend,
            )
        trace = problem.latency_model.trace  # the (possibly re-priced) wire
    elif spec.participation is not None:
        raise ValueError(
            "a participation section needs a scenario section: the deadline "
            "policy is priced against a fleet trace (add scenario=, e.g. "
            'ScenarioCfg(name="straggler-tail"))'
        )

    class_spec = None
    if spec.classes is not None:
        from ..core.classes import CutClassSpec, banded_assignment

        cc = spec.classes
        if cc.by == "explicit":
            class_of = cc.assign
            if len(class_of) != system.num_clients:
                raise ValueError(
                    "classes.assign must give one class id per client: "
                    f"{len(class_of)} != {system.num_clients}"
                )
        elif cc.by == "uplink":
            class_of = banded_assignment(system.model_up[0], cc.num_classes)
        else:  # "compute"
            class_of = banded_assignment(system.compute[0], cc.num_classes)
        # every class starts on BCD's evenly-spread anchor; the per-class
        # MS step moves them apart where heterogeneity pays.
        from ..core.bcd import default_init_cuts

        anchor = default_init_cuts(model_spec.n_units, system.M)
        num_classes = int(max(class_of)) + 1
        class_spec = CutClassSpec(
            class_of=tuple(class_of), cuts=(tuple(anchor),) * num_classes
        )

    return BuiltExperiment(
        spec=spec,
        model_spec=model_spec,
        profile=profile,
        system=system,
        hyper=hyper,
        eps=eps,
        compression=compression,
        compressor=compressor,
        trace=trace,
        base_problem=base,
        problem=problem,
        participation=participation,
        class_spec=class_spec,
    )
