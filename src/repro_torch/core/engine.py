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
from .tiers import FedWire, TierPlan, guard_health, ragged_synchronize, synchronize

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


def _masked_select(new, old, w: torch.Tensor):
    """Per-client select: participants take the updated leaf, absentees keep
    the old one.  Only client-stacked leaves (leading axis N) are masked;
    scalar bookkeeping leaves (e.g. adam's step counter) pass through."""

    def f(n, o):
        if n.ndim == 0 or n.shape[0] != w.shape[0]:
            return n
        return torch.where(w.reshape((-1,) + (1,) * (n.ndim - 1)) > 0.0, n, o)

    return tree_map(f, new, old)


def masked_mean_loss(losses: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Participation-weighted round loss Σ w_i·loss_i / Σ w_i (0.0 for a
    zero-participant round — the round is a no-op, DESIGN.md §12)."""
    total = torch.sum(w)
    return torch.where(
        total > 0.0, torch.sum(losses * w) / torch.clamp(total, min=1.0),
        torch.zeros((), dtype=losses.dtype, device=losses.device),
    )


def build_train_step_a(
    model, plan: TierPlan, opt: Optimizer, *, sync_opt_state: bool = False,
    fed_round=None, compressor=None, with_mask: bool = False,
    class_members=None, privacy=None, guard=None,
    with_sync_weights: bool = False,
) -> Callable[..., Tuple]:
    """Engine-A step: vmapped per-client update + hierarchical aggregation.

    batch leaves have a leading client axis [N, b, ...].  Returns
    ``step(state, batch) -> (new_state, mean loss)`` (with a third output
    under ``with_sync_weights``).

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

    ``with_mask=True`` returns ``step(state, batch, mask)`` instead: the
    [N] participation mask (1 = the client made the round's deadline)
    restricts the local update to participants — absentees keep their
    params and optimizer moments untouched — and every aggregation level
    averages participants only, on B1m (``tiers.synchronize`` mask
    semantics, DESIGN.md §12).  The reported loss is the
    participation-weighted mean; an all-zero mask leaves the state exactly
    as it was and reports 0.0.  Per-class cuts under a mask run
    ``tiers.ragged_synchronize(mask=)``, its unit levels on B3m.

    ``privacy`` (a ``privacy.DPMechanism``) puts the *same* fed-server
    params wire under client-level DP: each uploaded replica is per-client
    L2-clipped and Gaussian-noised *before* the codec sees it and before
    the Eq. 4 mean (``tiers.FedWire``); the noise is seeded from (seed,
    leaf, round).  Optimizer-moment syncs, local entity syncs and the
    single-entity top tier stay untouched — only the wire the (ε, δ)
    accountant meters is noised.

    ``guard`` (a ``tiers.GuardSpec``) arms fault tolerance (DESIGN.md §16):
    each step quarantines clients whose update is non-finite or a norm
    blow-up — their local update rolls back and every aggregation runs the
    guarded masked path (B1m, or B3m per class), which sanitizes corrupt
    replicas before any arithmetic and heals them with the group broadcast
    at zero weight.  The health stays on the device; the step reads nothing
    on the host.  On an all-healthy round the reported loss is exactly
    ``mean(losses)`` and the state is the all-ones mask's step, bit for
    bit.

    ``with_sync_weights=True`` makes the step additionally return the
    effective per-client sync weights [N] (participation mask × guard
    health × finite loss; all-ones when neither masking nor a guard is
    armed) — the weights every aggregation level used this round, which
    the async runner (``core.async_agg``) captures at snapshot time.
    """
    per_client = vmap(grad_and_value(model.loss_fn))

    def _fed_wire(step):
        # the round's fed-upload transform: DP (clip + noise), then the codec
        return compressor if privacy is None else FedWire(privacy, step, compressor)

    def _sync(tree, step, compress=None, mask=None):
        if class_members is not None:
            return ragged_synchronize(
                tree, plan, class_members, step, fed_round=fed_round,
                compressor=compress, mask=mask, guard=guard,
            )
        return synchronize(
            tree, plan, step, fed_round=fed_round, compressor=compress, mask=mask,
            guard=guard,
        )

    def _step(state: TrainState, batch: Params, mask):
        grads, losses = per_client(state.params, batch)
        new_params, new_opt = opt.update(state.params, grads, state.opt_state)
        if guard is not None:
            # quarantine clients whose update went non-finite or blew up in
            # norm: their local update rolls back (the guarded syncs below
            # sanitize and heal them), and the loss is the health-weighted
            # mean over finite losses only
            health, _ = guard_health(new_params, plan.num_clients, guard, sanitize=False)
            lfin = torch.isfinite(losses)
            health = health * lfin.float()
            w = health if mask is None else mask.to(health.device, torch.float32) * health
            new_params = _masked_select(new_params, state.params, w)
            new_opt = _masked_select(new_opt, state.opt_state, w)
            lsafe = torch.where(lfin, losses, torch.zeros((), dtype=losses.dtype,
                                                          device=losses.device))
            loss = masked_mean_loss(lsafe, w)
            if mask is None:
                # an all-healthy unmasked round reports the exact plain mean
                loss = torch.where(torch.all(w >= 1.0), torch.mean(lsafe), loss)
            sync_mask = w
        elif mask is None:
            loss = torch.mean(losses)
            sync_mask = None
        else:
            w = mask.to(device=losses.device, dtype=torch.float32)
            new_params = _masked_select(new_params, state.params, w)
            new_opt = _masked_select(new_opt, state.opt_state, w)
            loss = masked_mean_loss(losses, w)
            sync_mask = w
        new_params = _sync(new_params, state.step, compress=_fed_wire(state.step),
                           mask=sync_mask)
        if sync_opt_state and tree_leaves(new_opt):
            # momentum/adam moments are client-stacked like params: apply the
            # same schedule so replicas stay consistent after aggregation.
            if opt.name == "momentum":
                new_opt = _sync(new_opt, state.step, mask=sync_mask)
            elif opt.name == "adam":
                new_opt = dict(new_opt)
                new_opt["m"] = _sync(new_opt["m"], state.step, mask=sync_mask)
                new_opt["v"] = _sync(new_opt["v"], state.step, mask=sync_mask)
        new_state = TrainState(new_params, new_opt, state.step + 1)
        if with_sync_weights:
            ww = (torch.ones((plan.num_clients,), dtype=torch.float32, device=losses.device)
                  if sync_mask is None else sync_mask)
            return new_state, loss, ww
        return new_state, loss

    if with_mask:
        return _step
    return lambda state, batch: _step(state, batch, None)
