"""``run(spec)`` — one dispatcher over the three things the repo can do;
port of ``repro.api.run``.

* ``mode="solve"``    — optimize (I, μ) with the configured solver and
  report the schedule, Θ′, R-to-ε, and the Eq. 17/18 latency breakdown.
* ``mode="simulate"`` — same solve (typically against trace quantiles),
  then replay the schedule through the fleet simulator and report the
  per-round latency profile (p50/p95/worst, participants).
* ``mode="train"``    — real Engine-A/B split training with the schedule
  (solved or fixed), the spec's codec (and DP) on the fed-server wire,
  under the spec's faults and bounded staleness, and the Theorem-1 bound
  for the schedule actually trained.
* ``mode="control"``  — the train loop under the online adaptive
  controller (``repro_torch.control``): round telemetry feeds a
  sliding-window system estimate, drift triggers warm-started re-solves,
  engine state migrates across switches, and the Theorem-1 bound is
  composed piecewise over the schedule segments.

Training and control run the spec's engine (``run.engine``: ``"a"``, the
sync-groups engine, or ``"b"``, the split-placement engine of
``core.engine``) on ``run(..., device=)``: the first CUDA
device unless the caller asks for another, and never the CPU in place of a
missing card.  A solver backend of
``"jax"`` (the JAX package's device backend, which spec files carry) runs
the port's ``torch`` tables on the card (``core.batched.spec_backend``).

A ``run.sharding`` section trains the sharded Engine A (``core.sharded``)
over data·model·max(pods, 1) ranks of ``torch.distributed`` that
``launch.mesh.run_on_ranks`` provides — an initialized ``torchrun`` world,
a one-rank group in process, or spawned ranks on a ``FileStore`` — NCCL on
the card, gloo on the CPU; the result is rank 0's.

Every mode returns the same ``ExperimentResult``; ``provenance`` is the
resolved spec, so the artifact alone reproduces the run.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.batched import spec_backend
from ..core.bcd import solve_bcd
from ..core.engine import (
    build_train_step_a, build_train_step_b, init_state_a, init_state_b,
)
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
    """Data / model / optimizer assembly for train mode and the control
    loop (which rebuilds the plan and step on every schedule switch):
    returns ``(model, loader, opt, N)``.
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
    """The spec's engine step for one tier plan, its fed levels read from
    the round counter on the host (``fed_round=None``).  Engine B takes no
    guard: the capability check refuses faults on it."""
    kwargs = dict(
        compressor=built.compressor, with_mask=with_mask,
        privacy=built.dp_mechanism,
    )
    if built.spec.run.engine == "b":
        return build_train_step_b(model, plan, opt, **kwargs)
    if built.guard is not None and built.faults is not None and not built.faults.is_null:
        # live faults: every sync runs behind the non-finite/norm guard; a
        # null spec builds the exact clean step instead
        kwargs["guard"] = built.guard
    return build_train_step_a(model, plan, opt, **kwargs)


def _train(built: BuiltExperiment, cuts, intervals, device=None) -> Dict[str, Any]:
    """Real split training of the spec's model under the schedule, on
    ``device``; the initial state is ``init_state_a``'s (``init_state_b``'s
    for Engine B) from a
    ``torch.Generator`` seeded with ``run.seed``.  Under a participation
    policy each round's deadline mask (``sim.participation_masks`` at the
    trained cuts, replayed cyclically) drives the masked step, whose syncs
    run on B1m.

    With a faults section the loop becomes the fault-tolerant variant
    (DESIGN.md §16): each round's seeded fault draws (NumPy streams on the
    host) corrupt the marked clients' replicas *before* the step (the guard
    quarantines them inside it), crashed clients drop out of the round
    mask — one [N] mask tensor moved to the device a round — a cell outage
    re-routes its clients' tier sync to sibling cells after the step, and
    the atomic checkpoint cadence + simulated engine crash exercise
    ``resume_with_migration`` recovery mid-run.  With staleness > 0 the
    bounded-staleness ``AsyncTrainer`` drives the rounds and drains its
    in-flight fed levels at the end.
    """
    import os
    import tempfile

    import torch

    from ..core.async_agg import make_async_trainer, normalize_staleness
    from ..core.convergence import theorem1_bound
    from ..core.engine import TrainState
    from ..core.tiers import TierPlan

    spec = built.spec
    # sharded execution (DESIGN.md §17) — capability-checked at build time
    # (engine A, no privacy/classes/faults/control); this runs on every rank
    mesh, client_axes = None, ("data",)
    if spec.run.sharding is not None:
        from ..launch.mesh import make_debug_mesh, mesh_device

        sh = spec.run.sharding
        mesh = make_debug_mesh(data=sh.data, model=sh.model, pods=sh.pods, device=device)
        client_axes = ("pod", "data") if sh.pods else ("data",)
        device = mesh_device(mesh)
    device = resolve_device(device)
    rc = spec.run
    fc = spec.faults
    fs = built.faults
    inject = fs is not None and not fs.is_null
    model, loader, opt, N = _training_setup(built)
    plan = TierPlan(
        n_units=built.model_spec.n_units,
        num_clients=N,
        cuts=tuple(cuts),
        intervals=tuple(intervals),
        entities=built.system.entities,
    )

    def init():
        generator = torch.Generator().manual_seed(rc.seed)
        if mesh is not None:
            from ..core.sharded import init_sharded_state_a

            return init_sharded_state_a(model, plan, opt, generator, mesh, client_axes)
        make = init_state_a if rc.engine == "a" else init_state_b
        return make(model, plan, opt, generator, device)

    masks = _participation_masks(built, cuts)
    with_mask = masks is not None or inject
    state = init()

    s_eff = normalize_staleness(rc.staleness, plan)
    use_async = any(s_eff)
    trainer, step = None, None
    if use_async:
        trainer = make_async_trainer(
            model, plan, opt, staleness=rc.staleness,
            compressor=built.compressor, with_mask=with_mask,
            guard=built.guard if built.guard is not None and inject else None,
            mesh=mesh, client_axes=client_axes,
        )
    elif mesh is not None:
        from ..core.sharded import build_sharded_train_step_a

        step = build_sharded_train_step_a(
            model, plan, opt, mesh, client_axes=client_axes,
            compressor=built.compressor, with_mask=with_mask,
        )
    else:
        step = _make_step(built, model, plan, opt, with_mask)

    members = None
    if inject:
        from ..faults import (
            apply_corruption,
            assignment_members,
            expand_faults,
            outage_assignment,
            reroute_entity_sync,
        )

        if fs.has_outage:
            J = built.system.entities[fs.outage_tier]
            members = torch.as_tensor(
                assignment_members(outage_assignment(N, J, fs.outage_cells), J),
                device=device,
            )

    ckpt_path = None
    n_ckpts = 0
    recovered_round = None
    if fc is not None and fc.checkpoint_every > 0:
        from ..checkpoint import save_checkpoint

        d = fc.checkpoint_dir or tempfile.mkdtemp(prefix="repro-ckpt-")
        ckpt_path = os.path.join(d, "engine.npz")

    n_faulty_total = 0
    faulty_rounds = 0
    losses = []
    for r in range(rc.rounds):
        batch = loader.next_round()
        if mesh is not None:
            # every rank draws the global batch and keeps its client rows
            from ..core.sharded import local_rows

            batch = local_rows(batch, mesh, client_axes, N)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        mrow = None
        if masks is not None:
            mrow = np.asarray(masks[r % masks.shape[0]], dtype=bool)
        if inject:
            rf = expand_faults(fs, r, N)
            if rf.corrupt.any():
                state = TrainState(
                    apply_corruption(state.params, rf.corrupt, fs),
                    state.opt_state,
                    state.step,
                )
            base_m = np.ones(N, dtype=bool) if mrow is None else mrow
            mrow = base_m & ~rf.crashed
            if not mrow.any():
                raise ValueError(
                    f"round {r}: every client crashed or missed the "
                    "deadline — an all-faulty round has no aggregate; "
                    "lower crash_rate or loosen the deadline"
                )
            if rf.faulty.any():
                faulty_rounds += 1
                n_faulty_total += rf.n_faulty
        if with_mask:
            m_arr = torch.as_tensor(mrow, dtype=torch.float32, device=device)
            if trainer is not None:
                state, loss = trainer.run_round(state, batch, r, m_arr)
            else:
                state, loss = step(state, batch, m_arr)
        elif trainer is not None:
            state, loss = trainer.run_round(state, batch, r)
        else:
            state, loss = step(state, batch)
        if inject and rf.cell_out and members is not None:
            # dead cells' clients adopt their sibling cell's tier mean
            state = TrainState(
                reroute_entity_sync(state.params, plan, fs.outage_tier, members),
                state.opt_state,
                state.step,
            )
        losses.append(float(loss))
        if ckpt_path is not None and (r + 1) % fc.checkpoint_every == 0:
            save_checkpoint(
                ckpt_path, state, step=r + 1,
                meta={"cuts": list(cuts), "intervals": list(intervals)},
            )
            n_ckpts += 1
        if fc is not None and fc.engine_crash_round == r:
            from ..control import resume_with_migration

            if n_ckpts == 0:
                raise ValueError(
                    f"engine crashed at round {r} before the first "
                    f"checkpoint (checkpoint_every={fc.checkpoint_every}) "
                    "— nothing to resume from"
                )
            state, _, _ = resume_with_migration(ckpt_path, init(), plan)
            recovered_round = r
        if rc.log_every and ((r + 1) % rc.log_every == 0 or r == 0):
            print(f"round {r+1:5d}  loss {losses[-1]:.4f}")

    if trainer is not None:
        # fold any still in-flight aggregations in before reporting
        state = trainer.drain(state)

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
        "async": bool(use_async),
        "staleness": [int(v) for v in s_eff],
    }
    if mesh is not None:
        from ..core.sharded import num_client_shards

        out["sharding"] = {
            "data": spec.run.sharding.data,
            "model": spec.run.sharding.model,
            "pods": spec.run.sharding.pods,
            "client_shards": num_client_shards(mesh, client_axes),
        }
    if fc is not None:
        out["faults"] = {
            "n_faulty_total": int(n_faulty_total),
            "faulty_rounds": int(faulty_rounds),
            "fault_rate": float(n_faulty_total) / float(N * max(1, rc.rounds)),
            "checkpoints": int(n_ckpts),
            "recovered_round": recovered_round,
            "deflated_q": (
                None if built.participation is None
                else [float(v) for v in built.participation.q]
            ),
            "retry_mult": fs.retry_mult if fs is not None else None,
        }
    if built.privacy is not None:
        q1 = float(built.problem.q[0])
        out["privacy"] = {
            "noise_multiplier": built.privacy.noise_multiplier,
            "clip": built.privacy.clip,
            "dp_sigma2": built.problem.dp_sigma2,
            "epsilon_spent": built.privacy.accountant(q1).epsilon(rc.rounds),
            "delta": built.privacy.delta,
        }
    if masks is not None:
        out["mean_participation"] = float(
            np.mean(masks[np.arange(rc.rounds) % masks.shape[0]])
        )
        out["deadline"] = built.participation.deadline
    return out


def _control(built: BuiltExperiment, cuts, intervals, device=None) -> Dict[str, Any]:
    """Training under the online adaptive controller (DESIGN.md
    §13), on ``device`` as ``_train`` trains.

    Each round the engine trains under the current schedule, the round's
    telemetry is observed from the fleet trace and folded into the
    controller's window, and a drift-triggered warm re-solve may switch
    the schedule — at which point the tier plan is rebuilt, the engine
    state (params + optimizer moments) is migrated without loss (one B1
    launch per leaf of each tier whose entities pool clients), the step
    rebuilt, and
    participation masks re-sampled at the new cuts.  The fault draws and
    the masks stay on the host; one ``[N]`` mask moves to the device a
    round, and the loss of each round is the loop's only device read.  The
    Theorem-1 bound is kept piecewise across the segments and collapses
    bit-exactly to the static bound when no switch fires.
    """
    import torch

    from ..control import (
        BoundSegment,
        Controller,
        migrate_state,
        observe_round,
        piecewise_bound,
    )
    from ..core.convergence import theorem1_bound
    from ..core.engine import TrainState
    from ..core.tiers import TierPlan
    from .spec import ControlCfg

    device = resolve_device(device)
    spec = built.spec
    rc = spec.run
    cc = spec.control if spec.control is not None else ControlCfg()
    trace = built.trace
    model, loader, opt, N = _training_setup(built)
    cuts = tuple(int(c) for c in cuts)
    intervals = tuple(int(i) for i in intervals)
    init_cuts, init_intervals = cuts, intervals

    def make_plan(c, i):
        return TierPlan(
            n_units=built.model_spec.n_units,
            num_clients=N,
            cuts=tuple(c),
            intervals=tuple(i),
            entities=built.system.entities,
        )

    plan = make_plan(cuts, intervals)
    masks = _participation_masks(built, cuts)
    fs = built.faults
    inject = fs is not None and not fs.is_null
    members = None
    if inject:
        from ..faults import (
            apply_corruption,
            assignment_members,
            expand_faults,
            outage_assignment,
            reroute_entity_sync,
        )

        if fs.has_outage:
            J = built.system.entities[fs.outage_tier]
            members = torch.as_tensor(
                assignment_members(outage_assignment(N, J, fs.outage_cells), J),
                device=device,
            )
    with_mask = masks is not None or inject
    init = init_state_a if rc.engine == "a" else init_state_b
    state = init(model, plan, opt, torch.Generator().manual_seed(rc.seed), device)
    step = _make_step(built, model, plan, opt, with_mask)

    controller = Controller(
        built.problem,
        cuts,
        intervals,
        window=cc.window,
        check_every=cc.check_every,
        rel_tol=cc.rel_tol,
        cooldown=cc.cooldown,
        min_window=cc.min_window,
        quantile=cc.quantile,
        warm_start=cc.warm_start,
        backend=cc.backend,
        max_switches=cc.max_switches,
        fault_tol=cc.fault_tol,
    )

    omega = 0.0 if built.compression is None else built.compression.omega
    segments = []
    seg_rounds = 0
    losses = []
    n_faulty_total = 0
    for r in range(rc.rounds):
        rr = r % trace.rounds
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in loader.next_round().items()}
        mrow = None
        if masks is not None:
            mrow = np.asarray(masks[r % masks.shape[0]], dtype=bool)
        n_faulty = 0
        if inject:
            rf = expand_faults(fs, rr, N)
            if rf.corrupt.any():
                state = TrainState(
                    apply_corruption(state.params, rf.corrupt, fs),
                    state.opt_state,
                    state.step,
                )
            base_m = np.ones(N, dtype=bool) if mrow is None else mrow
            mrow = base_m & ~rf.crashed
            if not mrow.any():
                raise ValueError(
                    f"round {r}: every client crashed or missed the "
                    "deadline — an all-faulty round has no aggregate"
                )
            n_faulty = rf.n_faulty
            n_faulty_total += n_faulty
        if with_mask:
            m_arr = torch.as_tensor(mrow, dtype=torch.float32, device=device)
            state, loss = step(state, batch, m_arr)
        else:
            state, loss = step(state, batch)
        if inject and rf.cell_out and members is not None:
            state = TrainState(
                reroute_entity_sync(state.params, plan, fs.outage_tier, members),
                state.opt_state,
                state.step,
            )
        losses.append(float(loss))
        seg_rounds += 1
        if rc.log_every and ((r + 1) % rc.log_every == 0 or r == 0):
            print(f"round {r+1:5d}  loss {losses[-1]:.4f}  "
                  f"cuts {cuts} I{intervals}")

        obs = observe_round(
            trace, rr, cuts,
            mask=None if mrow is None else np.asarray(mrow, dtype=bool),
            loss=losses[-1],
            n_faulty=n_faulty,
        )
        controller.observe(obs)
        dec = controller.maybe_replan(r)
        if dec is not None and dec.switched:
            segments.append(
                BoundSegment(
                    seg_rounds, intervals, cuts,
                    omega=omega, participation=built.participation,
                    dp_sigma2=built.problem.dp_sigma2,
                )
            )
            seg_rounds = 0
            old_plan = plan
            cuts, intervals = dec.new_cuts, dec.new_intervals
            plan = make_plan(cuts, intervals)
            state = migrate_state(
                state, plan, opt, engine=rc.engine, model=model,
                old_plan=old_plan,
            )
            step = _make_step(built, model, plan, opt, with_mask)
            if with_mask:
                masks = _participation_masks(built, cuts)
            if rc.log_every:
                print("  " + dec.describe())
    if seg_rounds:
        segments.append(
            BoundSegment(
                seg_rounds, intervals, cuts,
                omega=omega, participation=built.participation,
                dp_sigma2=built.problem.dp_sigma2,
            )
        )

    bound = piecewise_bound(built.hyper, segments) if segments else None
    static_bound = theorem1_bound(
        built.hyper, max(1, rc.rounds), init_intervals, init_cuts,
        omega=omega, participation=built.participation,
        dp_sigma2=built.problem.dp_sigma2,
    )
    p50, p95 = controller.resolve_quantiles((0.5, 0.95))
    return {
        "engine": rc.engine,
        "rounds": rc.rounds,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "initial_cuts": list(init_cuts),
        "initial_intervals": list(init_intervals),
        "final_cuts": list(cuts),
        "final_intervals": list(intervals),
        "n_switches": controller.n_switches,
        "n_resolves": len(controller.resolve_seconds),
        "switches": [
            {
                "round": d.round_index,
                "trigger": d.trigger,
                "old_cuts": list(d.old_cuts),
                "old_intervals": list(d.old_intervals),
                "new_cuts": list(d.new_cuts),
                "new_intervals": list(d.new_intervals),
                "solve_ms": 1e3 * d.solve_seconds,
            }
            for d in controller.decisions
            if d.switched
        ],
        "switch_log": [
            d.describe() for d in controller.decisions if d.switched
        ],
        "segments": [
            {"rounds": s.rounds, "cuts": list(s.cuts),
             "intervals": list(s.intervals)}
            for s in segments
        ],
        "piecewise_bound": None if bound is None else float(bound),
        "static_bound": float(static_bound),
        "resolve_p50_s": p50,
        "resolve_p95_s": p95,
        "n_faulty_total": int(n_faulty_total),
        "windowed_fault_rate": float(controller.fault_rate()),
    }


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

    privacy = None
    if built.privacy is not None:
        q1 = float(p.q[0])
        acc = built.privacy.accountant(q1)
        r_max = built.privacy.max_rounds(q1)
        privacy = {
            "noise_multiplier": built.privacy.noise_multiplier,
            "clip": built.privacy.clip,
            "delta": built.privacy.delta,
            "dp_sigma2": p.dp_sigma2,
            "epsilon_budget": built.privacy.epsilon_budget,
            "max_rounds": r_max,
            # ε actually spent by the schedule's R-to-target rounds
            "epsilon_at_schedule": (
                None if R is None or not np.isfinite(R)
                else acc.epsilon(int(np.ceil(R)))
            ),
        }
    energy = None
    if built.energy is not None:
        e = p.round_energy(intervals, cuts)
        energy = {
            "round_energy_j": e,
            "budget_j_per_round": built.energy.budget_j_per_round,
            "feasible": p.energy_feasible(intervals, cuts),
            # total campaign energy to the ε target, when R is finite
            "total_energy_j": (
                None if R is None or not np.isfinite(R) else float(e * R)
            ),
        }

    return ExperimentResult(
        mode=mode,
        cuts=tuple(int(c) for c in cuts),
        intervals=tuple(int(i) for i in intervals),
        theta=theta,
        rounds_to_eps=float(R) if R is not None else None,
        total_latency=total,
        latency=_latency_breakdown(built, cuts, intervals),
        privacy=privacy,
        energy=energy,
        provenance=jsonify(built.spec.to_dict()),
    )


def run(
    spec: ExperimentSpec, built: Optional[BuiltExperiment] = None,
    device: Optional[DeviceLike] = None,
) -> ExperimentResult:
    """Build the spec, resolve its schedule, and produce the mode's result.

    Callers that already hold the ``build(spec)`` output pass it as
    ``built`` to avoid re-resolving registries / re-drawing the system.
    ``device`` is where train and control modes train (default: the first
    CUDA device, raising when there is none; ``"cpu"`` on request).
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
    elif spec.run.mode == "train" and spec.run.sharding is not None:
        from ..launch.mesh import run_on_ranks

        sh = spec.run.sharding
        train = run_on_ranks(_train, sh.data * sh.model * max(sh.pods, 1), device=device,
                             args=(built, cuts, intervals, device))
        result = dataclasses.replace(result, train=train)
    elif spec.run.mode == "train":
        result = dataclasses.replace(
            result, train=_train(built, cuts, intervals, device)
        )
    elif spec.run.mode == "control":
        result = dataclasses.replace(
            result, control=_control(built, cuts, intervals, device)
        )
    return result
