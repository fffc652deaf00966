"""Engine state migration when the schedule moves mid-run — port of
``repro.control.migrate``.

A control switch changes the cut vector, which changes which tier — and
therefore which aggregation entity — owns each unit.  Training state must
be re-partitioned without losing optimizer moments:

* **Engine A** (client-stacked full models): leaf shapes are
  cut-independent, so migration is a *consistency* operation — apply the
  new plan's entity-level group means once (the Eq. 3 sync of the new
  plan), so every entity's replicas agree before training resumes.  A
  unit moving to a finer tier (entity → per-client) keeps each client's
  replica untouched; a unit moving to a coarser tier adopts its new
  entity's client-mean.  Momentum / Adam moments are client-stacked like
  params and migrate through the same means, mirroring the engine's
  ``sync_opt_state`` schedule.

* **Engine B** (per-tier entity stacks): leaf shapes *are* cut-dependent.
  Migration materializes the client-stacked view (``engine_b_to_full``'s
  entity repeat), re-slices the unit ranges under the new plan, and
  reduces each new tier back to its entity stack by the client-weighted
  mean — coarsening averages the old entity copies, refining replicates.
  In the port the client mean is B1's entity level followed by a pick of
  each group's first row.

Both directions preserve the global client-mean iterate (means of means
over uniform groups), which is what lets the piecewise Theorem-1 bound
telescope f across switch points (``control.bound``).  The arithmetic is
float32 group-mean — in the port one B1 launch per leaf with the entity
level only (``do_entity=1, do_global=0``) — so values that merely stay put
are preserved up to mean-roundtrip rounding, not bitwise.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..core.engine import TrainState, engine_b_to_full
from ..core.tiers import TierPlan, combine_tiers, tier_subtrees
from ..kernels.tiered_aggregate import aggregate_tree
from ..optim import Optimizer

Params = Any


def _group_mean(part: Params, J: int, N: int) -> Params:
    """The entity-level group mean over J contiguous client groups,
    broadcast back (the JAX ``tiers._group_mean``), on B1."""
    leaves = tree_leaves(part)
    if not leaves:
        return part
    w = torch.full((N,), 1.0 / N, dtype=torch.float32, device=leaves[0].device)
    return aggregate_tree(part, w, True, False, J)


def migrate_params_a(params: Params, new_plan: TierPlan) -> Params:
    """Make a client-stacked tree consistent with ``new_plan``'s entities."""
    parts = tier_subtrees(params, new_plan)
    out = []
    for m, part in enumerate(parts):
        J = new_plan.entities[m]
        if J < new_plan.num_clients:
            part = _group_mean(part, J, new_plan.num_clients)
        out.append(part)
    return combine_tiers(out, params)


def _migrate_opt(opt_tree, opt: Optimizer, migrate_fn) -> Any:
    """Apply a params-migration to the optimizer moments (sgd: no state;
    momentum: the whole state is params-shaped; adam: m and v are)."""
    if not tree_leaves(opt_tree):
        return opt_tree
    if opt.name == "momentum":
        return migrate_fn(opt_tree)
    if opt.name == "adam":
        new = dict(opt_tree)
        new["m"] = migrate_fn(new["m"])
        new["v"] = migrate_fn(new["v"])
        return new
    return opt_tree


def migrate_state_a(
    state: TrainState, new_plan: TierPlan, opt: Optimizer
) -> TrainState:
    """Engine-A state under a new tier plan (same leaf shapes, re-grouped)."""
    return TrainState(
        params=migrate_params_a(state.params, new_plan),
        opt_state=_migrate_opt(
            state.opt_state, opt, lambda t: migrate_params_a(t, new_plan)
        ),
        step=state.step,
    )


def _entity_stack(part: Params, J: int, N: int) -> Params:
    """Reduce a client-stacked tier subtree to its [J, ...] entity stack by
    the float32 client-mean (the JAX ``_entity_stack``): B1's entity level,
    then each group's first row.  A tier with one client per entity keeps
    its rows as they are."""
    per = N // J
    if per > 1:
        part = _group_mean(part, J, N)
    return tree_map(lambda x: x[::per].contiguous(), part)


def migrate_params_b(model, tier_params, old_plan: TierPlan, new_plan: TierPlan):
    """Re-partition Engine-B tier stacks from ``old_plan`` to ``new_plan``."""
    full = engine_b_to_full(model, old_plan, tier_params)
    parts = tier_subtrees(full, new_plan)
    return [
        _entity_stack(part, new_plan.entities[m], new_plan.num_clients)
        for m, part in enumerate(parts)
    ]


def migrate_state_b(
    state: TrainState, model, old_plan: TierPlan, new_plan: TierPlan,
    opt: Optimizer,
) -> TrainState:
    """Engine-B state under a new tier plan (re-sliced entity stacks)."""
    fn = lambda t: migrate_params_b(model, t, old_plan, new_plan)  # noqa: E731
    return TrainState(
        params=fn(state.params),
        opt_state=_migrate_opt(state.opt_state, opt, fn),
        step=state.step,
    )


def migrate_state(
    state: TrainState,
    new_plan: TierPlan,
    opt: Optimizer,
    engine: str = "a",
    model=None,
    old_plan: Optional[TierPlan] = None,
) -> TrainState:
    """Engine-dispatching migration (the controller's switch hook)."""
    if engine == "a":
        return migrate_state_a(state, new_plan, opt)
    if old_plan is None or model is None:
        raise ValueError("engine-b migration needs model and old_plan")
    return migrate_state_b(state, model, old_plan, new_plan, opt)


def resume_with_migration(
    path: str, template: Params, plan: TierPlan
) -> Tuple[Params, int, dict]:
    """Load an Engine-A checkpoint saved under a possibly different cut
    vector and migrate the tier assignment to ``plan`` (the loud-failure
    alternative is ``load_checkpoint(..., expect_cuts=plan.cuts)``).

    ``template`` may also be a whole ``TrainState``, as the fault-tolerant
    training loop checkpoints it and resumes it under the same cuts."""
    from ..checkpoint import load_checkpoint

    tree, step, meta = load_checkpoint(path, template)
    saved = meta.get("cuts")
    if saved is not None and tuple(int(c) for c in saved) != tuple(plan.cuts):
        tree = migrate_params_a(tree, plan)
    return tree, step, meta
