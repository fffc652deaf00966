"""HSFL execution engines — port of ``repro.core.engine``.

Engine A ("sync-groups", production): every tier's parameters are stacked
per client on axis 0, and the hierarchy is realized as the multi-timescale
aggregation schedule of ``tiers.synchronize``.  It implements Algorithm 1
of the paper (per-client SGD on replicas + Eq. 3 entity sync + Eq. 4
fed-server aggregation at I_m).

Engine B ("split placement", the proof engine): each tier-m entity holds
one sub-model (no per-client replicas above tier 1) and activations flow up
the tiers, the literal split-learning dataflow.  Engine A == Engine B (same
losses and parameters) is the correctness proof of the sync-group
formulation.

Both engines are functional over parameter trees, as in JAX: Engine A's
per-client update is ``torch.func.vmap(torch.func.grad_and_value(loss))``,
Engine B's one ``torch.autograd.grad`` around inner ``vmap``s (which keeps
less of the forward alive than ``torch.func.grad`` does).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves, tree_map
from ..optim import Optimizer
from ..kernels.tiered_aggregate import aggregate_tree
from .tiers import (
    FedWire, TierPlan, _compressed, _masked_tier_levels, _tier_levels, combine_tiers,
    guard_health, ragged_synchronize, synchronize, tier_subtrees,
)

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
        # the gradients go before the sync, which copies every synced leaf
        # (a 4-layer full-width paligemma-3b's four replicas: 15.5 GB)
        del grads
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


# --------------------------------------------------------------------------- #
# Engine B — split placement (the proof engine)
# --------------------------------------------------------------------------- #


def init_state_b(
    model, plan: TierPlan, opt: Optimizer, generator: torch.Generator,
    device: Optional[DeviceLike] = None,
) -> TrainState:
    """Params: a list of per-tier trees, tier m stacked over its J_m
    entities — one ``init_params`` draw, cut by ``tier_subtrees``, on
    ``device`` (default: the first CUDA device, raising when there is
    none)."""
    p0 = model.init_params(generator, resolve_device(device))
    N = plan.num_clients
    full = tree_map(lambda x: x[None].expand((N,) + tuple(x.shape)), p0)
    tier_params = [
        tree_map(lambda x, per=N // plan.entities[m]: x[::per].contiguous(), part)
        for m, part in enumerate(tier_subtrees(full, plan))
    ]
    return TrainState(params=tier_params, opt_state=opt.init(tier_params), step=0)


def _fed_mean_b(tree, J: int, w: Optional[torch.Tensor], compressor):
    """Eq. 4 across the J entity rows of one tier's ``[J, ...]`` leaves: the
    fed level of ``tiers.synchronize`` over the entity stack, one kernel
    launch per leaf — B1 with weights 1/J, or under a mask B1m weighted by
    the entities' participant counts ``w`` ([J]), a silent round keeping
    the pre-codec rows.  Over a compressed wire each entity's upload goes
    through the codec first (fused into B2, or B1m's int8 load, for the
    int8 codec)."""
    if w is not None:
        return _masked_tier_levels(tree, w, 0, True, compressor)
    weights = torch.full((J,), 1.0 / J, dtype=torch.float32,
                         device=tree_leaves(tree)[0].device)
    return _tier_levels(tree, lambda t, *flags, **wire: aggregate_tree(t, weights, *flags, **wire),
                        0, True, compressor)


def build_train_step_b(
    model, plan: TierPlan, opt: Optimizer, *, compressor=None,
    with_mask: bool = False, class_members=None, privacy=None,
) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """Engine-B step: literal split execution.

    Forward: tier 1 ``torch.func.vmap``-ed over the N clients; the
    activations regrouped into J_m entity batches of ``per·b`` rows for
    each middle tier, vmapped over its entities; the single top-tier model
    on the flattened global batch.  The attention kernels fold a vmapped
    axis into their batch axis, so each layer launches B4 (and each B5
    pass) once a round.  Backward: one ``torch.autograd.grad`` through the
    composed function; per-tier gradients rescaled to implement
    per-client SGD + Eq. 3 exactly.  Tied logits use tier 1's per-client
    embedding, as the JAX engine does (a batched product outside any
    kernel; the padded vocabulary columns are not masked there either).

    ``compressor`` compresses each entity's model upload before the Eq. 4
    fed-server mean, placed as ``tiers.synchronize`` places it (tiers
    below the top with more than one entity).

    ``with_mask=True`` returns ``step(state, batch, mask)``: the global
    objective becomes the participation-weighted mean Σ w_i·loss_i / Σ w_i,
    each tier-m entity's gradient is rescaled by Σw / Σ_{i∈j} w_i (zero
    for a zero-participant entity) and the Eq. 4 mean weights entities by
    their participant counts, on B1m.

    The fed levels are chosen on the host from the int round counter;
    every fed mean is a kernel launch per leaf (``_fed_mean_b``).  The
    dense, MoE, SSM, hybrid, VLM and audio transformer families run here;
    the audio model's carry takes the encoder's output ``enc`` [N, b,
    encoder_len, d] across every cut beside ``h``, regrouped as ``h`` is,
    and each tier runs exactly its own encoder and decoder units
    (``SplittableModel.apply_units``: the JAX package's Engine B skips a
    tier's decoder units, ROADMAP §C); a MoE layer
    dispatches each client's tokens in a group of their own
    (``model.moe_groups``: 1 on tier 1, ``per`` on a middle tier, N on
    the top), so capacity is per client as in Engine A, and the loss adds
    ``0.01·(aux below the top / N + the top tier's aux)``, Engine A's
    ``0.01·aux`` of the client mean.  The VLM runs its prefix-LM mask on
    every tier and takes its loss on the text positions, as the JAX
    package's step does (which computes the prefix's logits and drops them;
    here they are not computed); its tied logits, like every tied model's here, skip
    ``head_apply``'s pad mask (ROADMAP §C).  VGG is refused:
    ``VggModel.apply_units`` reads absolute unit indices, which the tiers'
    local slices do not carry — the JAX package's step fails on VGG too
    (ROADMAP §C).
    """
    N, M = plan.num_clients, plan.M
    spec = model.spec
    if class_members is not None:
        raise NotImplementedError(
            "Engine B physically places each tier's units on its hosts — a "
            "per-class cut assignment has no single placement (clients "
            "disagree on which units are client-side).  Use Engine A with "
            "class_members (ragged sync-groups), the production path for "
            "DESIGN.md §14."
        )
    if privacy is not None:
        raise NotImplementedError(
            "Engine B does not support DP-noised uploads: its fed wire "
            "carries one model per *entity*, so per-client clipping (the "
            "unit the (ε, δ) accountant meters) has no faithful placement. "
            "Use Engine A with privacy (the production DP path), or run "
            "Engine B noiseless (privacy=None)."
        )
    if with_mask and getattr(spec, "moe", None) is not None:
        raise NotImplementedError(
            "masked Engine B does not support MoE specs: the aux-loss "
            "regroup means are participation-unweighted (use Engine A for "
            "masked MoE training)"
        )
    if getattr(spec, "family", None) == "vgg":
        raise NotImplementedError(
            "Engine B runs the transformer family: VggModel.apply_units reads "
            "absolute unit indices (conv or dense by index), and Engine B "
            "applies each tier's slice with tier-local indices; the JAX "
            "package's Engine-B step fails on VGG the same way (TypeError in "
            "its convolution).  Use Engine A for VGG."
        )
    from ..models import layers as L

    # the VLM's prefix-LM mask on every tier (its image tokens), else 0
    prefix = getattr(model, "prefix_len", 0)

    def tier_apply(m):
        lo, hi = plan.tier_bounds(m)
        return lambda p, c: model.apply_units(p["units"], c, 0, hi - lo, prefix_len=prefix)

    def global_loss(tier_params, batch, w):
        # MoE capacity is per client: an entity that pools k clients'
        # tokens dispatches them in k groups, so they do not compete for
        # each other's expert slots
        model.moe_groups = 1  # tier 1 is vmapped per client
        carry = vmap(lambda p, b: tier_apply(0)(p, model.frontend_apply(p["frontend"], b)))(
            tier_params[0], batch)  # leaves [N, b, ...], the aux scalar [N]
        for m in range(1, M - 1):
            J = plan.entities[m]
            per = N // J
            # scalars (the aux) carry *means*: regroup averages over an
            # entity's clients and split_back replicates the mean
            carry_e = tree_map(
                lambda x: (x.reshape(J, per * x.shape[1], *x.shape[2:]) if x.ndim >= 2
                           else x.reshape(J, per).mean(1)), carry)
            model.moe_groups = per  # each entity batch pools ``per`` clients
            carry_e = vmap(tier_apply(m))(tier_params[m], carry_e)
            carry = tree_map(
                lambda x: (x.reshape(N, x.shape[1] // per, *x.shape[2:]) if x.ndim >= 2
                           else x.repeat_interleave(per)), carry_e)
        carry_g = tree_map(
            lambda x: x.reshape(N * x.shape[1], *x.shape[2:]) if x.ndim >= 2 else x.mean() * N,
            carry)
        pM = tree_map(lambda x: x[0], tier_params[M - 1])
        model.moe_groups = N  # the cloud batch pools all N clients
        aux_pre = carry_g["aux"]
        carry_g = tier_apply(M - 1)(pM, carry_g)
        # the VLM's loss is on the text positions only: the prefix's logits,
        # which JAX computes and drops, are not computed
        carry_g["h"] = carry_g["h"][:, prefix:]
        if spec.tie_embeddings:
            h = L.rms_norm(carry_g["h"], pM["head"]["norm"], spec.norm_eps)
            hn = h.reshape(N, h.shape[0] // N, *h.shape[1:])
            emb = tier_params[0]["frontend"]["embed"]  # [N, V, d]
            logits = torch.einsum("nbsd,nvd->nbsv", hn, emb.to(hn.dtype))
            logits = logits.reshape(h.shape[0], h.shape[1], -1)
        else:
            logits = model.head_apply({"head": pM["head"], "frontend": None}, carry_g)
        labels = batch["labels"].reshape(-1, batch["labels"].shape[-1])
        lmask = (labels >= 0).float()
        if w is None:
            loss = L.cross_entropy(logits, torch.clamp(labels, min=0), lmask)
            if spec.moe is not None:
                # the aux below the top tier arrives as its client mean
                # times N (the scalar flatten), so it is divided back; the
                # top tier's own aux is every client's in Engine A and
                # enters at full weight
                loss = loss + 0.01 * (aux_pre / N + (carry_g["aux"] - aux_pre))
            return loss
        # per-client CE, then the participation-weighted mean: clients
        # enter the objective as in Engine A's vmapped loss
        per_client = vmap(lambda lo, la, mk: L.cross_entropy(lo, torch.clamp(la, min=0), mk))(
            *(t.reshape(N, -1, *t.shape[1:]) for t in (logits, labels, lmask)))
        return masked_mean_loss(per_client, w)

    def grad_loss(tier_params, batch, w):
        # reverse-mode autograd around the tiers' vmaps: torch.func.grad
        # keeps 2-3x the activations of torch.autograd here (a Mamba block
        # at 2048 tokens: ~2.2 GB against ~0.9 GB)
        leaves = tree_leaves(tier_params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        it = iter(live)
        params = tree_map(lambda _: next(it), tier_params)
        try:
            with torch.enable_grad():
                loss = global_loss(params, batch, w)
                grads = torch.autograd.grad(loss, live, allow_unused=True)
        finally:
            model.moe_groups = 1
        it = iter(torch.zeros_like(x) if g is None else g for x, g in zip(live, grads))
        return tree_map(lambda _: next(it), tier_params), loss.detach()

    def _step(state: TrainState, batch: Params, mask):
        w = None
        if mask is not None:
            device = tree_leaves(state.params)[0].device
            w = mask.to(device=device, dtype=torch.float32).contiguous()
        grads, loss = grad_loss(state.params, batch, w)
        # per-client SGD: tier m's entity model moves by the mean of its
        # clients' gradients = (N / N_m^j)·dL/dw_m; under a mask the mean
        # runs over the entity's participants (zero for a silent entity).
        # Each tier's gradients are dropped once scaled, and the scaled ones
        # once the optimizer has read them, so the step holds one copy of
        # the gradients beside the old and the new params (full-width
        # paligemma-3b's tier-1 embeddings alone are 8.4 GB)
        grads, scaled, counts = list(grads), [], []
        for m in range(len(grads)):
            g, grads[m] = grads[m], None
            J = plan.entities[m]
            if w is None:
                scaled.append(tree_map(lambda x, J=J: x * J, g))
                counts.append(None)
                continue
            wj = w.reshape(J, N // J).sum(dim=1)  # [J] participant counts
            sc = torch.where(wj > 0.0, torch.sum(w) / torch.clamp(wj, min=1.0),
                             torch.zeros((), device=w.device))
            scaled.append(tree_map(
                lambda x, sc=sc: x * sc.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype), g))
            counts.append(wj)
        del grads, g
        new_params, new_opt = opt.update(state.params, scaled, state.opt_state)
        del scaled
        out = []
        for m, p in enumerate(new_params):
            interval = int(plan.intervals[m])
            J = plan.entities[m]
            if J > 1 and interval >= 1 and (state.step + 1) % interval == 0:
                wire = compressor if _compressed(plan, m, compressor) else None
                p = _fed_mean_b(p, J, counts[m], wire)
            out.append(p)
        return TrainState(out, new_opt, state.step + 1), loss

    if with_mask:
        return _step
    return lambda state, batch: _step(state, batch, None)


def engine_b_to_full(model, plan: TierPlan, tier_params) -> Params:
    """Materialize Engine-B tier params back into a client-stacked tree:
    each tier's entity rows repeated over their clients, then
    ``combine_tiers``."""
    parts = [
        tree_map(lambda x, per=plan.num_clients // plan.entities[m]:
                 x.repeat_interleave(per, dim=0), p)
        for m, p in enumerate(tier_params)
    ]
    template = {"units": parts[0]["units"], "frontend": parts[0]["frontend"],
                "head": parts[-1]["head"]}
    return combine_tiers(parts, template)
