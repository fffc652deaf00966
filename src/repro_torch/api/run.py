"""``run(spec)`` — one dispatcher over the three things the repo can do;
port of ``repro.api.run``.

* ``mode="solve"``    — optimize (I, μ) with the configured solver and
  report the schedule, Θ′, R-to-ε, and the Eq. 17/18 latency breakdown.
* ``mode="simulate"`` — same solve (typically against trace quantiles),
  then replay the schedule through the fleet simulator and report the
  per-round latency profile (p50/p95/worst, participants).
* ``mode="train"``    — real Engine-A/B split training with the schedule
  (solved or fixed), the spec's codec on the fed-server wire, and the
  Theorem-1 bound for the schedule actually trained.

``mode="control"`` (the online adaptive controller) is ported with ROADMAP
A11; ``build.check_capabilities`` refuses it.  Training runs Engine A on
``run(..., device=)``: the first CUDA device unless the caller asks for
another, and never the CPU in place of a missing card.  A solver backend of
``"jax"`` (the JAX package's device backend, which spec files carry) runs
the port's ``torch`` tables on the card (``core.batched.spec_backend``).

Every mode returns the same ``ExperimentResult``; ``provenance`` is the
resolved spec, so the artifact alone reproduces the run.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.batched import spec_backend
from ..core.bcd import solve_bcd
from ..core.engine import build_train_step_a, init_state_a
from ..core.ma_solver import solve_ma
from ..core.ms_solver import solve_ms
from .build import BuiltExperiment, build
from .result import ExperimentResult, jsonify
from .spec import ExperimentSpec


def _schedule(built: BuiltExperiment) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Resolve the (cuts, intervals) the run uses, per the solver config."""
    s = built.spec.solver
    p = built.problem
    backend = spec_backend(s.backend)
    if s.kind == "bcd":
        res = solve_bcd(
            p,
            init_cuts=s.cuts,
            init_intervals=s.intervals,
            tol=s.tol,
            max_iters=s.max_iters,
            backend=backend,
        )
        return res.cuts, tuple(res.intervals)
    if s.kind == "ma":
        if s.cuts is None:
            raise ValueError('solver kind="ma" needs solver.cuts (fixed μ)')
        ma = solve_ma(p, s.cuts, backend=backend)
        return tuple(s.cuts), tuple(ma.intervals)
    if s.kind == "ms":
        if s.intervals is None:
            raise ValueError('solver kind="ms" needs solver.intervals (fixed I)')
        ms = solve_ms(p, s.intervals, backend=backend)
        return tuple(ms.cuts), tuple(s.intervals)
    # "fixed": evaluate the given schedule as-is
    if s.cuts is None or s.intervals is None:
        raise ValueError('solver kind="fixed" needs both solver.cuts and '
                         "solver.intervals")
    return tuple(s.cuts), tuple(s.intervals)


def _run_classes(built: BuiltExperiment) -> ExperimentResult:
    """Per-class cut assignment solve (DESIGN.md §14).

    ``result.cuts`` reports class 0's vector (with one class this IS the
    single-cut schedule and the whole result collapses bit-exactly to the
    classless run); the full assignment lives in ``result.classes``.
    """
    from ..core.classes import solve_bcd_classes

    s = built.spec.solver
    if s.kind != "bcd":
        raise ValueError(
            'a classes section needs solver kind="bcd": the per-class '
            f"optimizer is the BCD loop (got kind={s.kind!r})"
        )
    if built.spec.run.mode != "solve":
        raise ValueError(
            'a classes section supports run mode="solve"; mixed-cut '
            "training runs through core.engine.build_train_step_a("
            f"class_members=...) directly (got mode={built.spec.run.mode!r})"
        )
    res = solve_bcd_classes(
        built.problem,
        built.class_spec,
        init_intervals=s.intervals,
        tol=s.tol,
        max_iters=s.max_iters,
        backend=spec_backend(s.backend),
        product_budget=built.spec.classes.product_budget,
    )
    p = built.problem
    cs = res.spec
    latency = {
        "split_T": float(p.class_split_T(cs)),
        "agg_T": [float(t) for t in p.class_agg_T(cs)],
        "pricing": "nominal",
    }
    payload = {
        "num_classes": cs.num_classes,
        "by": built.spec.classes.by,
        "class_of": [int(c) for c in cs.class_of],
        "class_cuts": [list(c) for c in cs.cuts],
        "class_sizes": [int(n) for n in cs.class_sizes()],
        "product_budget": built.spec.classes.product_budget,
    }
    return ExperimentResult(
        mode="solve",
        cuts=tuple(cs.cuts[0]),
        intervals=tuple(res.intervals),
        theta=float(res.theta),
        rounds_to_eps=float(res.rounds) if res.rounds is not None else None,
        total_latency=(
            float(res.total_latency) if res.total_latency is not None else None
        ),
        latency=latency,
        classes=payload,
        provenance=jsonify(built.spec.to_dict()),
    )


def _latency_breakdown(built: BuiltExperiment, cuts, intervals) -> Dict[str, Any]:
    p = built.problem
    if built.spec.scenario is None:
        pricing = "nominal"
    elif built.participation is not None and built.participation.deadline is not None:
        pricing = (
            f"{built.spec.scenario.name}"
            f"@deadline{built.participation.deadline:.4g}s"
        )
    else:
        # covers fault-deflated participation with no deadline policy:
        # latency stays quantile-priced, only the q_m side deflates
        pricing = f"{built.spec.scenario.name}@q{built.spec.scenario.quantile}"
    out = {
        "split_T": float(p.split_T(cuts)),
        "agg_T": [float(t) for t in p.agg_T(cuts)],
        "pricing": pricing,
    }
    if built.participation is not None:
        out["participation"] = {
            "deadline": built.participation.deadline,
            "q_tier": [float(v) for v in built.participation.q],
        }
    return out


def _simulate(built: BuiltExperiment, cuts, intervals) -> Dict[str, Any]:
    from ..sim import simulate_rounds

    sc = built.spec.scenario
    res = simulate_rounds(
        built.trace, cuts, intervals=intervals, backend=sc.backend
    )
    p50, p95, worst = np.quantile(res.total, [0.5, 0.95, 1.0])
    out = {
        "scenario": sc.name,
        "rounds": int(res.total.shape[0]),
        "split_p50": float(np.quantile(res.split, 0.5)),
        "split_p95": float(np.quantile(res.split, 0.95)),
        "total_p50": float(p50),
        "total_p95": float(p95),
        "total_worst": float(worst),
        "mean_participants": float(np.mean(res.participants)),
    }
    if built.participation is not None:
        from ..sim import participation_masks

        pr = participation_masks(
            built.trace, cuts, built.participation.deadline
        )
        out["participation"] = {
            "deadline": built.participation.deadline,
            "mean_rate": float(np.mean(pr.rates)),
            "q_tier": [float(v) for v in pr.q_tier],
            "expected_round_time": float(np.mean(pr.round_time)),
            "full_round_time": float(np.mean(res.split)),
        }
    return out


def _training_setup(built: BuiltExperiment):
    """Data / model / optimizer assembly for train mode (and, in the JAX
    package, the control loop, which rebuilds the plan and step on every
    schedule switch): returns ``(model, loader, opt, N)``.
    """
    from ..data import (
        image_loader,
        lm_loader,
        make_cifar10_like,
        make_lm_stream,
        partition_iid,
        partition_sort_and_shard,
    )
    from ..models.vgg import VggSpec, build_model
    from ..optim import adam, momentum, sgd

    spec = built.spec
    rc = spec.run
    model_spec = built.model_spec
    N = built.system.num_clients

    if isinstance(model_spec, VggSpec):
        ds = make_cifar10_like(rc.dataset_size, seed=rc.seed)
        labels = ds.labels
        mk_loader = lambda parts: image_loader(ds, parts, spec.model.batch, rc.seed)
    else:
        # train at the spec's literal seq so pricing, Theorem-1 bound, and
        # provenance all describe the run that actually happened
        if spec.model.seq < 2:
            raise ValueError(
                f'run mode="{rc.mode}" on LM arch {spec.model.arch!r} needs '
                f"model.seq >= 2 (next-token loss); got {spec.model.seq}"
            )
        ds = make_lm_stream(
            rc.dataset_size, spec.model.seq, model_spec.vocab_size, seed=rc.seed
        )
        labels = ds.tokens[:, 0] % 10
        mk_loader = lambda parts: lm_loader(ds, parts, spec.model.batch, rc.seed)

    parts = (
        partition_sort_and_shard(labels, N, 2, rc.seed)
        if rc.non_iid
        else partition_iid(len(labels), N, rc.seed)
    )
    loader = mk_loader(parts)
    model = build_model(model_spec)
    opt = {"sgd": sgd, "momentum": momentum, "adam": adam}[spec.model.optimizer](rc.lr)
    return model, loader, opt, N


def _participation_masks(built: BuiltExperiment, cuts) -> Optional[np.ndarray]:
    """Deadline-driven per-round client masks sampled from the fleet trace
    at the schedule actually trained (DESIGN.md §12); the trace replays
    cyclically past its horizon.  ``None`` without a participation policy
    (a fault-deflated spec with no deadline carries q_m only — the fault
    loop masks crashed clients itself; there is no barrier to miss)."""
    if built.participation is None or built.participation.deadline is None:
        return None
    from ..sim import participation_masks

    return participation_masks(
        built.trace, cuts, built.participation.deadline
    ).masks


def _make_step(built: BuiltExperiment, model, plan, opt, with_mask: bool):
    """Engine-A step for one tier plan, its fed levels read from the round
    counter on the host (``fed_round=None``)."""
    return build_train_step_a(
        model, plan, opt, compressor=built.compressor, with_mask=with_mask,
    )


def _train(built: BuiltExperiment, cuts, intervals, device=None) -> Dict[str, Any]:
    """Real split training of the spec's model under the schedule, on
    ``device``; the initial state is ``init_state_a``'s from a
    ``torch.Generator`` seeded with ``run.seed``.  Under a participation
    policy each round's deadline mask (``sim.participation_masks`` at the
    trained cuts, replayed cyclically) drives the masked step, whose syncs
    run on B1m."""
    import torch

    from ..core.convergence import theorem1_bound
    from ..core.tiers import TierPlan

    device = resolve_device(device)
    spec = built.spec
    rc = spec.run
    model, loader, opt, N = _training_setup(built)
    plan = TierPlan(
        n_units=built.model_spec.n_units,
        num_clients=N,
        cuts=tuple(cuts),
        intervals=tuple(intervals),
        entities=built.system.entities,
    )
    masks = _participation_masks(built, cuts)
    with_mask = masks is not None
    state = init_state_a(
        model, plan, opt, torch.Generator().manual_seed(rc.seed), device
    )
    # staleness > 0 is refused by check_capabilities (ROADMAP A11): the
    # schedule is the synchronous one
    st = rc.staleness
    if not isinstance(st, int) and len(st) != plan.M:
        raise ValueError(
            f"need {plan.M} per-tier staleness bounds, got {len(st)}: {st!r}"
        )
    s_eff = (0,) * plan.M
    step = _make_step(built, model, plan, opt, with_mask)

    losses = []
    for r in range(rc.rounds):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in loader.next_round().items()}
        if with_mask:
            mrow = torch.as_tensor(
                masks[r % masks.shape[0]], dtype=torch.float32, device=device
            )
            state, loss = step(state, batch, mrow)
        else:
            state, loss = step(state, batch)
        losses.append(float(loss))
        if rc.log_every and ((r + 1) % rc.log_every == 0 or r == 0):
            print(f"round {r+1:5d}  loss {losses[-1]:.4f}")

    omega = 0.0 if built.compression is None else built.compression.omega
    bound = theorem1_bound(
        built.hyper, max(1, rc.rounds), intervals, cuts, omega=omega,
        participation=built.participation,
        dp_sigma2=built.problem.dp_sigma2,
        staleness=s_eff,
    )
    out = {
        "engine": rc.engine,
        "rounds": rc.rounds,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "thm1_bound": float(bound),
        "async": False,
        "staleness": [int(v) for v in s_eff],
    }
    if masks is not None:
        out["mean_participation"] = float(
            np.mean(masks[np.arange(rc.rounds) % masks.shape[0]])
        )
        out["deadline"] = built.participation.deadline
    return out


def evaluate_schedule(
    built: BuiltExperiment,
    cuts,
    intervals,
    mode: str = "solve",
) -> ExperimentResult:
    """Price one (I, μ) schedule under the built problem as a result.

    This is the solve-mode result body; benchmarks that already hold a
    solved schedule use it to emit artifacts without re-solving.
    """
    p = built.problem
    theta = float(p.theta(intervals, cuts))
    R = p.rounds(intervals, cuts)
    total = float(p.total_T(intervals, cuts, R)) if R is not None else None

    # privacy and energy reports: their sections are refused (ROADMAP A11)
    return ExperimentResult(
        mode=mode,
        cuts=tuple(int(c) for c in cuts),
        intervals=tuple(int(i) for i in intervals),
        theta=theta,
        rounds_to_eps=float(R) if R is not None else None,
        total_latency=total,
        latency=_latency_breakdown(built, cuts, intervals),
        provenance=jsonify(built.spec.to_dict()),
    )


def run(
    spec: ExperimentSpec, built: Optional[BuiltExperiment] = None,
    device: Optional[DeviceLike] = None,
) -> ExperimentResult:
    """Build the spec, resolve its schedule, and produce the mode's result.

    Callers that already hold the ``build(spec)`` output pass it as
    ``built`` to avoid re-resolving registries / re-drawing the system.
    ``device`` is where train mode trains (default: the first CUDA device,
    raising when there is none; ``"cpu"`` on request).
    """
    import dataclasses

    if built is None:
        built = build(spec)
    elif built.spec != spec:
        raise ValueError("built was constructed from a different spec")
    if spec.run.mode == "simulate" and built.trace is None:
        # fail before the (expensive) solve, not after
        raise ValueError('run mode="simulate" needs a scenario section')
    if built.class_spec is not None:
        return _run_classes(built)
    cuts, intervals = _schedule(built)
    result = evaluate_schedule(built, cuts, intervals, mode=spec.run.mode)

    if spec.run.mode == "simulate":
        result = dataclasses.replace(
            result, sim=_simulate(built, cuts, intervals)
        )
    elif spec.run.mode == "train":
        result = dataclasses.replace(
            result, train=_train(built, cuts, intervals, device)
        )
    return result
