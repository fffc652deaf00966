"""HSFL execution engine A — port of ``repro.core.engine``.

Engine A ("sync-groups"): every tier's parameters are stacked per client on
axis 0, and the hierarchy is realized as the multi-timescale aggregation
schedule of ``tiers.synchronize``.  It implements Algorithm 1 of the paper
(per-client SGD on replicas + Eq. 3 entity sync + Eq. 4 fed-server
aggregation at I_m).  Engine B, the split-placement proof engine, is not
ported yet (ROADMAP A12).

The engine is functional over client-stacked parameter trees, as in JAX: the
per-client update is ``torch.func.vmap(torch.func.grad_and_value(loss))``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves, tree_map
from ..optim import Optimizer
from .tiers import TierPlan, ragged_synchronize, synchronize

Params = Dict[str, Any]


@dataclass
class TrainState:
    params: Params
    opt_state: Any
    step: int  # host-side round counter (the JAX package keeps an int32 array)


def replicate_for_clients(params: Params, num_clients: int) -> Params:
    """Copy a single-model tree into the client-stacked layout."""
    return tree_map(
        lambda x: x[None].expand((num_clients,) + tuple(x.shape)).contiguous(), params
    )


def unreplicate(params: Params) -> Params:
    return tree_map(lambda x: x[0], params)


def init_state_a(
    model, plan: TierPlan, opt: Optimizer, generator: torch.Generator,
    device: Optional[DeviceLike] = None,
) -> TrainState:
    """The replicated initial state on ``device`` (default: the first CUDA
    device, raising when there is none)."""
    p0 = model.init_params(generator, resolve_device(device))
    params = replicate_for_clients(p0, plan.num_clients)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def build_train_step_a(
    model, plan: TierPlan, opt: Optimizer, *, sync_opt_state: bool = False,
    fed_round=None, compressor=None, with_mask: bool = False,
    class_members=None, privacy=None, guard=None,
    with_sync_weights: bool = False,
) -> Callable[[TrainState, Params], Tuple[TrainState, torch.Tensor]]:
    """Engine-A step: vmapped per-client update + hierarchical aggregation.

    batch leaves have a leading client axis [N, b, ...].  Returns
    ``step(state, batch) -> (new_state, mean loss)``.

    ``fed_round``: None reads the round counter each step; False/True or a
    per-tier tuple fixes which fed-server levels run (see
    ``tiers.synchronize``) — the production dispatch is
    ``launch.train.make_dispatch``.

    ``compressor`` (a ``compress`` codec) puts the fed-server model
    exchange on a lossy wire, key-less, as in the JAX engine: the int8
    codec fused into the aggregation kernel (B2, or B3 per class), any
    other codec's ``transform`` per client replica before the f32 mean.
    Optimizer moments are synchronized full-precision.

    ``class_members`` (the ``tiers.class_tier_members`` matrices for a
    per-class cut assignment, DESIGN.md §14) switches every aggregation —
    params and, under ``sync_opt_state``, the optimizer moments — to
    ``tiers.ragged_synchronize``: tier m's levels average each unit only
    over the clients whose class holds it there.

    ``with_mask`` (ROADMAP A10), ``privacy`` (A11), ``guard`` (A11) and
    ``with_sync_weights`` (A11, async aggregation) are not ported yet and
    raise.
    """
    for name, value, item in (
        ("with_mask", with_mask, "A10"), ("privacy", privacy, "A11"),
        ("guard", guard, "A11"), ("with_sync_weights", with_sync_weights, "A11"),
    ):
        if value is not None and value is not False:
            raise NotImplementedError(
                f"build_train_step_a({name}=...) is ported with ROADMAP {item}"
            )
    per_client = vmap(grad_and_value(model.loss_fn))

    def _sync(tree, step, compress=None):
        if class_members is not None:
            return ragged_synchronize(
                tree, plan, class_members, step, fed_round=fed_round,
                compressor=compress,
            )
        return synchronize(
            tree, plan, step, fed_round=fed_round, compressor=compress
        )

    def step(state: TrainState, batch: Params) -> Tuple[TrainState, torch.Tensor]:
        grads, losses = per_client(state.params, batch)
        new_params, new_opt = opt.update(state.params, grads, state.opt_state)
        loss = torch.mean(losses)
        new_params = _sync(new_params, state.step, compress=compressor)
        if sync_opt_state and tree_leaves(new_opt):
            # momentum/adam moments are client-stacked like params: apply the
            # same schedule so replicas stay consistent after aggregation.
            if opt.name == "momentum":
                new_opt = _sync(new_opt, state.step)
            elif opt.name == "adam":
                new_opt = dict(new_opt)
                new_opt["m"] = _sync(new_opt["m"], state.step)
                new_opt["v"] = _sync(new_opt["v"], state.step)
        return TrainState(new_params, new_opt, state.step + 1), loss

    return step
