"""Async hierarchical aggregation: bounded-staleness fed-server syncs — port
of ``repro.core.async_agg``.

The synchronous engine applies tier m's fed-server level (Eq. 4) inside
the training step of every I_m-th round — the fleet blocks on the
aggregation wire before the next round starts.  This module overlaps
that wire with client compute instead: at round r with (r+1) % I_m == 0
the due tier's client replicas are *snapshotted* (the upload leaves),
clients keep stepping, and the fed aggregate folds back in at round
r + s_m — the paper-style bounded-staleness schedule, priced in
Theorem 1 by ``convergence.bound_round_terms(staleness=...)`` as the
gated drift inflation (I_m + s_m)² − I_m².

Folding a stale aggregate back cannot simply overwrite the replicas:
clients made s_m rounds of local progress since the snapshot.  The
apply is *delta-retaining*:

    params_new = fed_mean(snapshot) + (params_now − snapshot)

i.e. the aggregate replaces the snapshot-time component and local
progress since the snapshot rides on top — at s_m = 0 the delta term
vanishes structurally (apply happens the same round, snapshot ==
params_now) and the apply is the plain in-step fed mean, which is why
staleness 0 collapses *bit-identically* onto the synchronous engine
(``tests/test_async.py``), mirroring the participation/dp_sigma2/omega
gating pattern everywhere else in this repo.

Tiers with s_m = 0 never enter the queue at all: their fed levels stay
inside the step via the ``fed_round`` dispatch — the async trainer with
all-zero staleness IS the synchronous production dispatch.

In the port a fed level runs on the aggregation kernels as in
``tiers.synchronize``: B1 (``do_entity=0, do_global=1``), B2 over the int8
wire, B1m (and its int8 load) under a mask with the snapshot as ``keep``.
Over a mesh (``mesh=``, ``client_axes=``) the steps are the sharded
engine's (``core.sharded``) and the deferred fed level spans the client
shards as ``sharded_synchronize``'s does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..kernels.tiered_aggregate import aggregate_tree
from ..optim import Optimizer
from .engine import TrainState, build_train_step_a
from .sharded import build_sharded_train_step_a, num_client_shards, sharded_fed_level
from .tiers import (
    GuardSpec,
    TierPlan,
    _masked_tier_levels,
    _tier_levels,
    combine_tiers,
    tier_subtrees,
)

Params = Dict[str, Any]


def normalize_staleness(staleness, plan: TierPlan) -> Tuple[int, ...]:
    """Per-tier staleness bounds s_m, validated against the plan.

    A scalar applies to every *deferrable* tier (non-top, I_m > 1) and 0
    elsewhere.  s_m > 0 requires I_m > 1: a tier whose fed level runs
    every round (interval ≤ 1) is applied unconditionally inside
    ``tiers.synchronize`` — there is no round boundary to defer across —
    and the top tier's cloud sync is the round barrier itself.
    """
    M = plan.M
    if staleness is None:
        s = (0,) * M
    elif isinstance(staleness, int):
        s = tuple(
            staleness if (m < M - 1 and plan.intervals[m] > 1) else 0
            for m in range(M)
        )
    else:
        s = tuple(int(v) for v in staleness)
        if len(s) != M:
            raise ValueError(
                f"need {M} per-tier staleness bounds, got {len(s)}: {s!r}"
            )
    for m, sm in enumerate(s):
        if sm < 0:
            raise ValueError(f"staleness bounds must be >= 0: {s!r}")
        if sm > 0 and m == M - 1:
            raise ValueError(
                "the top tier's cloud sync is the round barrier itself "
                f"and cannot run stale: staleness={s!r}"
            )
        if sm > 0 and plan.intervals[m] <= 1:
            raise ValueError(
                f"tier {m} syncs every round (I_m={plan.intervals[m]}); "
                "its fed level is applied unconditionally in-step and "
                f"cannot be deferred: staleness={s!r} (raise I_m or set "
                "s_m=0)"
            )
    return s


def fed_level_apply(
    params: Params,
    plan: TierPlan,
    m: int,
    *,
    snapshot: Optional[Params] = None,
    compressor=None,
    mask=None,
    mesh=None,
    client_axes=("data",),
) -> Params:
    """Apply ONLY tier m's fed-server level (Eq. 4) to a client-stacked tree.

    This deliberately does *not* call ``tiers.synchronize`` with a
    crafted ``fed_round``: synchronize would also re-apply every
    interval-1 entity level, and a group mean is not bit-idempotent
    ((x+x+x)/3 ≠ x in f32) — re-running an already-applied level moves
    the params.  Only the gated fed level of tier m runs here, with
    exactly synchronize's semantics for that level: fed-wire compression
    (``compressor``, a codec) iff the tier has >1 entities,
    participation-weighted mean under ``mask`` with the pre-compression
    tree as the zero-participant fallback, broadcast to every member — one
    B1 launch per leaf (``do_entity=0, do_global=1``), B2 over the int8
    wire, B1m under a mask.

    ``snapshot`` switches on stale (delta-retaining) application: the
    mean is taken over the *snapshot's* tier-m replicas and local
    progress since the snapshot (params − snapshot on the tier slice)
    is added back on top.  ``snapshot=None`` is the fresh in-step apply.

    With a ``mesh`` the tree is this rank's client shard (and ``mask`` its
    rows): over several shards the level spans them, lowered as in
    ``sharded.sharded_synchronize``; over one it is the launch above.
    """
    if m >= plan.M - 1:
        raise ValueError(
            f"tier {m} is the top tier — its sync is never deferred"
        )
    parts = tier_subtrees(params, plan)
    src = (
        parts[m] if snapshot is None
        else tier_subtrees(snapshot, plan)[m]
    )
    wire = compressor if compressor is not None and plan.entities[m] > 1 else None
    if mesh is not None and num_client_shards(mesh, client_axes) > 1:
        agg = sharded_fed_level(src, plan, mesh=mesh, client_axes=client_axes,
                                compressor=wire, mask=mask)
    elif mask is not None:
        mask = mask.to(dtype=torch.float32).contiguous()
        agg = _masked_tier_levels(src, mask, 0, True, wire)
    else:
        leaves = tree_leaves(params)
        N = plan.num_clients
        w = torch.full((N,), 1.0 / N, dtype=torch.float32, device=leaves[0].device)
        agg = _tier_levels(
            src, lambda t, *f, **k: aggregate_tree(t, w, *f, **k), 0, True, wire)
    if snapshot is not None:
        agg = tree_map(lambda a, now, snap: a + (now - snap), agg, parts[m], src)
    parts[m] = agg
    return combine_tiers(parts, params)


@dataclass
class PendingSync:
    """One in-flight fed-server aggregation."""

    tier: int
    snapshot_round: int
    apply_round: int          # snapshot_round + s_m
    snapshot: Params          # full client-stacked params at snapshot time
    weights: Optional[torch.Tensor]  # the snapshot round's effective sync mask


class AsyncTrainer:
    """Drive Engine A on the bounded-staleness aggregation schedule.

    One instance owns the per-round ``fed_round`` step dispatch (the
    production specialization — at most 2^(#gated tiers) step variants),
    the pending-sync queue, and the per-tier ``fed_level_apply`` calls.

    Per round r::

        state, loss, w = step[fed(r)](state, batch[, mask])   # async tiers' fed OFF
        for m due ((r+1) % I_m == 0, s_m > 0):  queue snapshot(apply at r+s_m)
        for pending with apply_round <= r:      state.params = fed_level_apply(...)

    The snapshot captures the step's effective sync weights ``w``
    (participation × guard health × finite loss) so the deferred apply
    weights clients exactly as the in-step levels did; re-deriving guard
    health at apply time would quarantine a different set (health is a
    function of the pre-sync tree, which no longer exists).  The weights
    stay on the device.
    """

    def __init__(
        self,
        plan: TierPlan,
        step_builder: Callable[[Any], Callable],
        *,
        staleness,
        compressor=None,
        with_mask: bool = False,
        guard: Optional[GuardSpec] = None,
        mesh=None,
        client_axes=("data",),
    ):
        self.plan = plan
        self._mesh, self._client_axes = mesh, client_axes
        self.s = normalize_staleness(staleness, plan)
        self.async_tiers = [
            m for m in range(plan.M - 1) if self.s[m] > 0
        ]
        self._builder = step_builder
        self._with_mask = with_mask
        self._use_weights = with_mask or guard is not None
        self._compressor = compressor
        self._steps: Dict[Tuple[bool, ...], Callable] = {}
        self.pending: List[PendingSync] = []

    # -- step dispatch ------------------------------------------------------ #

    def _fed_tuple(self, r: int) -> Tuple[bool, ...]:
        return tuple(
            False if self.s[m] > 0
            else (True if I <= 1 else (r + 1) % I == 0)
            for m, I in enumerate(self.plan.intervals)
        )

    def _get_step(self, fed: Tuple[bool, ...]) -> Callable:
        fn = self._steps.get(fed)
        if fn is None:
            fn = self._steps[fed] = self._builder(fed)
        return fn

    # -- deferred fed applies ----------------------------------------------- #

    def _apply(self, params, p: PendingSync):
        return fed_level_apply(
            params, self.plan, p.tier, snapshot=p.snapshot,
            compressor=self._compressor, mask=p.weights,
            mesh=self._mesh, client_axes=self._client_axes,
        )

    # -- one round ---------------------------------------------------------- #

    def run_round(self, state: TrainState, batch, r: int, mask=None):
        step = self._get_step(self._fed_tuple(r))
        if self._with_mask:
            state, loss, w = step(state, batch, mask)
        else:
            state, loss, w = step(state, batch)
        for m in self.async_tiers:
            if (r + 1) % self.plan.intervals[m] == 0:
                self.pending.append(PendingSync(
                    tier=m,
                    snapshot_round=r,
                    apply_round=r + self.s[m],
                    snapshot=state.params,
                    weights=(w if self._use_weights else None),
                ))
        due = [p for p in self.pending if p.apply_round <= r]
        if due:
            # deterministic fold-in order: apply time, then tier ascending
            # (the order synchronize visits tiers on a synchronous round)
            due.sort(key=lambda p: (p.apply_round, p.tier))
            self.pending = [p for p in self.pending if p.apply_round > r]
            params = state.params
            for p in due:
                params = self._apply(params, p)
            state = TrainState(params, state.opt_state, state.step)
        return state, loss

    def drain(self, state: TrainState) -> TrainState:
        """Fold every still-pending aggregation in (end of training)."""
        params = state.params
        for p in sorted(self.pending, key=lambda q: (q.apply_round, q.tier)):
            params = self._apply(params, p)
        self.pending = []
        return TrainState(params, state.opt_state, state.step)


def make_async_trainer(
    model,
    plan: TierPlan,
    opt: Optimizer,
    *,
    staleness,
    compressor=None,
    with_mask: bool = False,
    guard: Optional[GuardSpec] = None,
    mesh=None,
    client_axes=("data",),
) -> AsyncTrainer:
    """AsyncTrainer over the single-process engine, or the sharded engine
    when ``mesh`` is given (``core.sharded``)."""
    if mesh is None:
        def builder(fed):
            return build_train_step_a(
                model, plan, opt, fed_round=fed, compressor=compressor,
                with_mask=with_mask, guard=guard, with_sync_weights=True,
            )
    else:
        def builder(fed):
            return build_sharded_train_step_a(
                model, plan, opt, mesh, client_axes=client_axes,
                fed_round=fed, compressor=compressor, with_mask=with_mask,
                guard=guard, with_sync_weights=True,
            )
    return AsyncTrainer(
        plan, builder, staleness=staleness, compressor=compressor,
        with_mask=with_mask, guard=guard, mesh=mesh, client_axes=client_axes,
    )


def async_round_time(
    split_T: float,
    agg_T: Sequence[float],
    intervals: Sequence[int],
    staleness: Sequence[int],
) -> Tuple[float, float]:
    """(sync, async) amortized wall-clock per round.

    Synchronous barrier (the latency model's round):
        T_sync = T_S + Σ_m T_m^A / I_m
    Bounded staleness hides tier m's aggregation inside the next s_m
    rounds of split compute; only the residual beyond s_m·T_S still
    blocks the fleet:
        T_async = T_S + Σ_m max(0, T_m^A − s_m·T_S) / I_m
    s ≡ 0 reproduces T_sync exactly (the same gating as the bound).
    """
    split_T = float(split_T)
    sync = split_T + sum(
        float(T) / max(1, int(I)) for T, I in zip(agg_T, intervals)
    )
    asyn = split_T + sum(
        (float(T) if s == 0 else max(0.0, float(T) - s * split_T))
        / max(1, int(I))
        for T, I, s in zip(agg_T, intervals, staleness)
    )
    return sync, asyn
