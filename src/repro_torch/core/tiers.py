"""Tier plans: HSFL's model-splitting + multi-timescale aggregation schedule
— port of ``repro.core.tiers``.

A ``TierPlan`` captures the paper's (μ, I) decisions plus the entity topology:

* ``cuts``       — M-1 unit boundaries; tier m owns units [cuts[m-1], cuts[m])
                   (frontend ∈ tier 1, head ∈ tier M).
* ``intervals``  — I_m per tier; I_M is forced to 1 (single cloud server).
* ``levels``     — per tier, a list of (num_groups, interval) levels.  The
                   paper's scheme is [(J_m, 1), (1, I_m)] (entity sync every
                   round — Eq. 3; fed-server aggregation every I_m — Eq. 4).

Synchronization operates on client-stacked parameter trees (axis 0 = client).
Unlike the JAX package, whose ``synchronize`` and ``ragged_synchronize``
take plain group means, every level here goes through the fused
aggregation kernels (``kernels.tiered_aggregate``): B1/B2 for the dense
levels, one launch per leaf per tier and round, B1m for the
participation-masked levels, and B3's twin / B3 for the per-class (ragged)
unit levels, one launch per (unit leaf, tier) that some client holds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves, tree_map
from ..compress.quantize import Int8Stochastic
from ..kernels.tiered_aggregate import (
    aggregate_tree, masked_aggregate_tree, ragged_aggregate_tree,
)

Params = Dict[str, Any]


@dataclass(frozen=True)
class TierPlan:
    n_units: int
    num_clients: int
    cuts: Tuple[int, ...]          # len M-1, non-decreasing, in [0, n_units]
    intervals: Tuple[int, ...]     # len M (last forced 1)
    entities: Tuple[int, ...]      # J_m per tier; J_1 = num_clients, J_M = 1
    pod_interval: int = 0          # >0: extra cross-pod level on the top tier
    num_pods: int = 1

    def __post_init__(self):
        # User-facing invariants raise ValueError (not ``assert``): plans are
        # built from config files / API specs, and asserts vanish under
        # ``python -O``, silently admitting invalid plans.
        M = len(self.intervals)
        if len(self.cuts) != M - 1:
            raise ValueError(
                f"TierPlan needs exactly M-1 = {M - 1} cuts for "
                f"{M} intervals, got {len(self.cuts)}: "
                f"cuts={self.cuts!r}, intervals={self.intervals!r}"
            )
        if any(
            self.cuts[i] > self.cuts[i + 1] for i in range(len(self.cuts) - 1)
        ):
            raise ValueError(
                f"cuts must be non-decreasing (C4): {self.cuts!r}"
            )
        if any(not 0 <= c <= self.n_units for c in self.cuts):
            raise ValueError(
                f"every cut must lie in [0, n_units={self.n_units}]: "
                f"{self.cuts!r}"
            )
        if self.intervals[-1] != 1:
            raise ValueError(
                "top tier is always synchronized: intervals[-1] must be 1, "
                f"got {self.intervals!r}"
            )
        if len(self.entities) != M:
            raise ValueError(
                f"entities must list J_m for each of the {M} tiers, got "
                f"{len(self.entities)}: {self.entities!r}"
            )
        for j in self.entities:
            if j <= 0 or self.num_clients % j != 0:
                raise ValueError(
                    f"each tier's entity count must evenly divide "
                    f"num_clients={self.num_clients}: entities="
                    f"{self.entities!r} (offending J_m={j})"
                )

    @property
    def M(self) -> int:
        return len(self.intervals)

    def tier_bounds(self, m: int) -> Tuple[int, int]:
        """Unit range [lo, hi) of tier m (0-indexed)."""
        lo = 0 if m == 0 else self.cuts[m - 1]
        hi = self.n_units if m == self.M - 1 else self.cuts[m]
        return lo, hi

    def tier_of_unit(self, u: int) -> int:
        for m in range(self.M):
            lo, hi = self.tier_bounds(m)
            if lo <= u < hi:
                return m
        return self.M - 1

    def levels(self, m: int) -> List[Tuple[int, int]]:
        """Aggregation levels (num_groups, interval) for tier m."""
        lv: List[Tuple[int, int]] = []
        if self.entities[m] < self.num_clients:
            lv.append((self.entities[m], 1))  # Eq. (3): entity-local, per-round
        if m == self.M - 1:
            if self.pod_interval > 0 and self.num_pods > 1:
                # per-pod logical cloud every round; cross-pod at I_pod
                lv = [(self.num_pods, 1), (1, self.pod_interval)]
            else:
                lv.append((1, 1))
        else:
            lv.append((1, int(self.intervals[m])))  # Eq. (4): fed server
        return lv


# --------------------------------------------------------------------------- #
# tree partition by tier
# --------------------------------------------------------------------------- #


def _slice_units(units: Any, lo: int, hi: int) -> Any:
    """Slice a unit container to the range [lo, hi): a python list (VGG), or
    stacked leaves, sliced on the axis after the client axis (views).  The
    audio model's two stacks (``{"enc", "dec"}``) come with ROADMAP A14."""
    if isinstance(units, (list, tuple)):
        return list(units)[lo:hi]
    if isinstance(units, dict) and set(units) == {"enc", "dec"}:
        raise NotImplementedError("the audio model's unit stacks come with ROADMAP A14")
    return tree_map(lambda x: x[:, lo:hi], units)


def tier_subtrees(params: Params, plan: TierPlan) -> List[Params]:
    """Split a client-stacked model tree into per-tier trees (views)."""
    parts: List[Params] = []
    for m in range(plan.M):
        lo, hi = plan.tier_bounds(m)
        part: Params = {"units": _slice_units(params["units"], lo, hi)}
        if m == 0:
            part["frontend"] = params["frontend"]
        if m == plan.M - 1:
            part["head"] = params["head"]
        parts.append(part)
    return parts


def combine_tiers(parts: List[Params], template: Params) -> Params:
    """Inverse of tier_subtrees (same cut structure).  Stacked leaves are
    concatenated on the unit axis, which copies them."""
    units_parts = [p["units"] for p in parts]
    tu = template["units"]
    if isinstance(tu, (list, tuple)):
        units = [u for part in units_parts for u in part]
    elif isinstance(tu, dict) and set(tu) == {"enc", "dec"}:
        raise NotImplementedError("the audio model's unit stacks come with ROADMAP A14")
    else:
        units = tree_map(lambda *xs: torch.cat(xs, dim=1), *units_parts)
    return {"units": units, "frontend": parts[0]["frontend"], "head": parts[-1]["head"]}


# --------------------------------------------------------------------------- #
# synchronization (the HSFL aggregation schedule, Eqs. 3–4)
# --------------------------------------------------------------------------- #


def _per_client(compressor, x: torch.Tensor) -> torch.Tensor:
    """A codec's round trip of each client's replica of one leaf — the JAX
    ``vmap(compressor.transform)``, as a loop over the client axis."""
    if x.numel() == 0:  # the stacked leaves of a tier that holds no unit
        return x
    return torch.stack([compressor.transform(x[i]) for i in range(x.shape[0])])


def _fused_q8(compressor) -> bool:
    """The int8 codec runs fused into the aggregation (B2, B3); any other
    codec runs its ``transform`` first and the f32 kernels take the mean."""
    return isinstance(compressor, Int8Stochastic)


def _fed_do(plan: TierPlan, m: int, step: int, fed_round) -> bool:
    """Whether tier m's one-group (fed or cloud) level runs this round."""
    interval = plan.levels(m)[-1][1]
    if interval <= 1:
        return True
    if fed_round is None:
        return (step + 1) % interval == 0
    return bool(fed_round[m])


def _entity_groups(plan: TierPlan, m: int) -> int:
    """J of tier m's every-round entity level, 0 when it has none."""
    *entity, _ = plan.levels(m)
    return entity[0][0] if entity else 0


def _compressed(plan: TierPlan, m: int, compressor) -> bool:
    """Tier m's fed level is a priced wire only when several entities
    actually exchange — the JAX ``compress_fn`` placement."""
    return compressor is not None and m < plan.M - 1 and plan.entities[m] > 1


def _tier_levels(tree, aggregate, groups: int, do_global: bool, compressor, member=None):
    """One tier's levels over ``tree`` through ``aggregate(tree, do_entity,
    do_global, num_entities, **wire)`` — B1/B2 (``aggregate_tree``) or, for
    per-class units, B3's twin / B3 (``ragged_aggregate_tree``).

    The entity mean and the fed mean run fused, one launch per leaf; over a
    compressed fed wire the entity level runs first, then the fed mean of
    the uploads (fused with the int8 codec; after any other codec's round
    trip).  With a ``member``, the clients outside it keep their
    pre-compression replica (the JAX ``keep`` tree)."""
    if compressor is not None and do_global:
        if groups:
            tree = aggregate(tree, True, False, groups)
        if _fused_q8(compressor):
            out = aggregate(tree, False, True, 1, tile_p=compressor.tile, quantized=True)
        else:
            out = aggregate(tree_map(lambda x: _per_client(compressor, x), tree),
                            False, True, 1)
        if member is None:
            return out
        return tree_map(lambda a, k: _keep_non_members(a, k, member), out, tree)
    if groups or do_global:
        return aggregate(tree, bool(groups), do_global, groups or 1)
    return tree


def _masked_tier_levels(tree, mask: torch.Tensor, groups: int, do_global: bool,
                        compressor):
    """One tier's participation-masked levels (B1m), in the JAX
    ``synchronize(mask=)`` order: the entity and fed means fused into one
    launch per leaf; over a compressed fed wire the entity level first,
    then the fed mean of the uploads, where a silent group keeps the
    *pre-compression* entity result (the JAX ``keep=original``)."""
    if compressor is not None and do_global:
        if groups:
            tree = masked_aggregate_tree(tree, mask, True, False, groups)
        if _fused_q8(compressor):
            return masked_aggregate_tree(tree, mask, False, True, 1, keep=tree,
                                         tile_p=compressor.tile, quantized=True)
        uploads = tree_map(lambda x: _per_client(compressor, x), tree)
        return masked_aggregate_tree(uploads, mask, False, True, 1, keep=tree)
    if groups or do_global:
        return masked_aggregate_tree(tree, mask, bool(groups), do_global, groups or 1)
    return tree


def synchronize(
    params: Params,
    plan: TierPlan,
    step: int,
    *,
    fed_round=None,
    compressor=None,
    mask=None,
    guard=None,
) -> Params:
    """Apply the per-tier aggregation schedule at round ``step`` (post-update).

    Rounds are 1-indexed in the paper; we sync when (step+1) % I == 0 so that
    interval I=k aggregates after every k-th update.  ``step`` is a host-side
    int, so choosing the round's levels never waits for the device.

    ``fed_round`` fixes which tiers' interval-gated fed-server levels run:
    None reads ``step``; a bool or a per-tier sequence of bools applies
    tier m's fed level iff ``fed_round[m]`` (the JAX package's specialised
    round variants, ``launch.train.make_dispatch``).

    ``compressor`` (any ``compress`` codec) puts the fed-server exchange of
    the tiers m < M−1 with more than one entity on a lossy wire, never the
    local entity syncs (Eq. 3) or the single-entity top tier — the JAX
    ``compress_fn`` placement.  It is the codec rather than a leaf function
    because the fused int8 kernel needs its scale tile; codecs run
    key-less.  Any other codec's ``transform`` runs per client replica in
    plain PyTorch, as ``jnp`` does in the JAX engine.

    Each tier's levels run as fused kernel launches, one per leaf, with
    uniform fed weights 1/N: the entity mean (``do_entity``) and the fed
    mean (``do_global``, when it runs this round) in one launch; with a
    compressed fed level, the entity level first, then the fed mean over
    the uploads (the fused dequantize + fed mean B2 for the int8 codec).

    ``mask`` ([N] bool/float on the params' device, 1 = the client
    participated this round) switches every level to the
    participation-weighted mean of the JAX ``_group_mean_masked`` on B1m
    (DESIGN.md §12): participants are averaged with weight 1/|group
    participants|, the aggregate is broadcast to every member, and a
    zero-participant group keeps its last synced params — over a compressed
    fed wire, its pre-compression ones.  An all-zero mask returns every
    leaf bit for bit.  The fused levels compute Σ w·x / Σ w, which equals
    the JAX package's level-by-level means to f32 rounding; an all-ones
    mask equals the unmasked path to the same rounding (B1 sums x/N).

    ``guard`` (fault quarantine, ROADMAP A11) is not ported yet.
    """
    if guard is not None:
        raise NotImplementedError("guarded sync is ported with ROADMAP A11")
    N = plan.num_clients
    parts = tier_subtrees(params, plan)
    if fed_round is not None and not isinstance(fed_round, (tuple, list)):
        fed_round = (bool(fed_round),) * plan.M
    leaves = tree_leaves(params)
    weights = torch.full((N,), 1.0 / N, dtype=torch.float32, device=leaves[0].device)
    out_parts: List[Params] = []
    def dense(tree, *flags, **wire):
        return aggregate_tree(tree, weights, *flags, **wire)

    if mask is not None:
        mask = mask.to(device=leaves[0].device, dtype=torch.float32).contiguous()
    for m, part in enumerate(parts):
        wire = compressor if _compressed(plan, m, compressor) else None
        if mask is not None:
            out_parts.append(_masked_tier_levels(
                part, mask, _entity_groups(plan, m), _fed_do(plan, m, step, fed_round), wire
            ))
            continue
        out_parts.append(_tier_levels(
            part, dense, _entity_groups(plan, m), _fed_do(plan, m, step, fed_round), wire
        ))
    return combine_tiers(out_parts, params)


# --------------------------------------------------------------------------- #
# ragged synchronization: per-class cut assignments (DESIGN.md §14)
# --------------------------------------------------------------------------- #


class TierMembers(list):
    """``class_tier_members``' output: a list of M f32 0/1 ``[N, U]``
    tensors on the device, as the JAX function returns, which also carries

    * ``host`` — the same M tables as NumPy bool arrays, so choosing which
      (unit, tier) pairs to launch never reads the device;
    * ``columns`` — each table transposed to a contiguous ``[U, N]``, whose
      row u is the ``[N]`` member vector of a per-unit launch.
    """

    def __init__(self, tables: Sequence[torch.Tensor], host: Sequence[np.ndarray]):
        super().__init__(tables)
        self.host = [np.asarray(h, dtype=bool) for h in host]
        self.columns = [t.t().contiguous() for t in tables]


def class_tier_members(
    n_units: int,
    class_cuts: Sequence[Sequence[int]],
    class_of: Sequence[int],
    device: Optional[DeviceLike] = None,
) -> TierMembers:
    """Per-tier membership matrices ``[M][N, U]`` (float32 0/1) on
    ``device`` (default: the first CUDA device).

    ``members[m][i, u] == 1`` iff unit u lies in tier m *for client i's
    class* — clients in different classes disagree on which units are
    client-side, which is exactly the raggedness ``ragged_synchronize``
    aggregates over.  Every (client, unit) pair belongs to exactly one
    tier, so the per-tier member matrices partition the unit axis per
    client.
    """
    device = resolve_device(device)
    class_of = np.asarray([int(c) for c in class_of])
    M = len(class_cuts[0]) + 1
    bounds = [[0, *[int(x) for x in cc], n_units] for cc in class_cuts]
    u = np.arange(n_units)
    host = []
    for m in range(M):
        table = np.stack([(u >= b[m]) & (u < b[m + 1]) for b in bounds])  # [C, U]
        host.append(table[class_of])  # [N, U]
    tables = [torch.as_tensor(h, dtype=torch.float32, device=device) for h in host]
    return TierMembers(tables, host)


def _keep_non_members(out: torch.Tensor, original: torch.Tensor, member: torch.Tensor):
    """Non-members keep their pre-compression replica (the JAX ``keep``
    tree): the fed mean over a lossy wire reaches members only."""
    m = member.reshape(member.shape + (1,) * (out.ndim - member.ndim))
    return torch.where(m > 0.0, out, original)


def ragged_synchronize(
    params: Params,
    plan: TierPlan,
    members: Sequence[torch.Tensor],
    step: int,
    *,
    fed_round=None,
    compressor=None,
    mask=None,
    guard=None,
) -> Params:
    """``synchronize`` for per-class cut assignments (DESIGN.md §14).

    ``members`` is the ``class_tier_members`` output: tier m's levels
    average unit u only over the clients whose class holds u in tier m,
    and only those clients receive the broadcast — the rest keep their
    replica untouched for their own tier's schedule.  The entity topology,
    interval gating, ``fed_round`` specialization and fed-wire compression
    are exactly those of ``synchronize``, including the pre-compression
    replica that non-members keep.  The frontend always joins tier 0 and
    the head tier M−1, for every class, through B1/B2 as in
    ``synchronize``.

    Unlike ``synchronize`` this operates on the *unsliced* params: the
    unit → tier map varies per client, so there is no common
    ``tier_subtrees`` partition to slice.  Every unit level runs B3's twin
    (or B3 itself on the int8 fed wire) with fed weights 1, so the fed
    mean is Σ m·y / Σ m, the JAX ``_ragged_units_mean`` arithmetic: one
    launch per leaf of a per-unit list and tier, skipped where no client
    holds the unit in that tier (its replicas are then kept exactly), and
    one launch per stacked ``[N, U, ...]`` leaf and tier with the ``[N, U]``
    member.  With identical classes the result equals ``synchronize`` to
    f32 rounding (B1 sums w·y with w = 1/N; the twin divides Σ y by N).

    ``mask`` and ``guard`` (the fault path's masked ragged sync, ROADMAP
    A11) are not ported yet.
    """
    if mask is not None:
        raise NotImplementedError("masked ragged sync is ported with ROADMAP A11")
    if guard is not None:
        raise NotImplementedError("guarded sync is ported with ROADMAP A11")
    units = params["units"]
    if isinstance(units, dict) and set(units) == {"enc", "dec"}:
        raise NotImplementedError(
            "ragged per-class sync over enc/dec unit stacks is not "
            "implemented"
        )
    if len(members) != plan.M:
        raise ValueError(
            f"need one member matrix per tier: got {len(members)} for "
            f"M={plan.M}"
        )
    if not isinstance(members, TierMembers):  # plain tensors: read them once
        members = TierMembers(members, [t.detach().cpu().numpy() > 0 for t in members])
    if fed_round is not None and not isinstance(fed_round, (tuple, list)):
        fed_round = (bool(fed_round),) * plan.M
    N = plan.num_clients
    device = members[0].device
    dense_w = torch.full((N,), 1.0 / N, dtype=torch.float32, device=device)
    ones = torch.ones((N,), dtype=torch.float32, device=device)

    def dense(tree, *flags, **wire):
        return aggregate_tree(tree, dense_w, *flags, **wire)

    def ragged(member):
        return lambda tree, *flags, **wire: ragged_aggregate_tree(
            tree, ones, member, *flags, **wire)

    listed = isinstance(units, (list, tuple))
    out = dict(params)
    units = list(units) if listed else units
    for m in range(plan.M):
        levels = (_entity_groups(plan, m), _fed_do(plan, m, step, fed_round),
                  compressor if _compressed(plan, m, compressor) else None)
        held = members.host[m].any(axis=0)  # [U]: some client holds u in tier m
        if listed:
            for u in np.flatnonzero(held):
                col = members.columns[m][u]
                units[u] = _tier_levels(units[u], ragged(col), *levels, member=col)
        elif held.any():
            units = _tier_levels(units, ragged(members[m]), *levels, member=members[m])
        if m == 0:
            out["frontend"] = _tier_levels(out["frontend"], dense, *levels)
        if m == plan.M - 1:
            out["head"] = _tier_levels(out["head"], dense, *levels)
    out["units"] = units
    return out


def default_plan(
    n_units: int,
    num_clients: int = 16,
    cuts: Tuple[int, ...] = None,
    intervals: Tuple[int, ...] = None,
    entities: Tuple[int, ...] = None,
    num_pods: int = 1,
    pod_interval: int = 0,
) -> TierPlan:
    """Paper-style 3-tier client-edge-cloud plan with sensible defaults."""
    if cuts is None:
        c1 = max(1, n_units // 5)
        c2 = max(c1, n_units // 2)
        cuts = (c1, c2)
    if intervals is None:
        intervals = (8, 4, 1)
    if entities is None:
        entities = (num_clients, max(1, num_clients // 4), 1)
    return TierPlan(
        n_units=n_units,
        num_clients=num_clients,
        cuts=tuple(cuts),
        intervals=tuple(intervals),
        entities=tuple(entities),
        num_pods=num_pods,
        pod_interval=pod_interval,
    )
