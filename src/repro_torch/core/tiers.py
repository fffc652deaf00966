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
Unlike the JAX package, whose ``synchronize`` takes plain group means, every
dense level here goes through the fused aggregation kernels
(``kernels.tiered_aggregate``): one launch per leaf per tier and round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..kernels.tiered_aggregate import aggregate_tree

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

    ``compressor`` (an ``Int8Stochastic``) puts the fed-server exchange of
    the tiers m < M−1 with more than one entity on the int8 wire, never the
    local entity syncs (Eq. 3) or the single-entity top tier — the JAX
    ``compress_fn`` placement.  It is the codec rather than a leaf function
    because the fused kernel needs its scale tile; the codec runs key-less.

    Each tier's levels run as fused kernel launches, one per leaf, with
    uniform fed weights 1/N: the entity mean (``do_entity``) and the fed
    mean (``do_global``, when it runs this round) in one launch; with a
    compressed fed level, the entity level first, then the fused
    dequantize + fed mean (B2) over the quantized upload.

    ``mask`` (partial participation, ROADMAP A10) and ``guard`` (fault
    quarantine, ROADMAP A11) are not ported yet.
    """
    if mask is not None:
        raise NotImplementedError("masked sync is ported with ROADMAP A10")
    if guard is not None:
        raise NotImplementedError("guarded sync is ported with ROADMAP A11")
    N = plan.num_clients
    parts = tier_subtrees(params, plan)
    if fed_round is not None and not isinstance(fed_round, (tuple, list)):
        fed_round = (bool(fed_round),) * plan.M
    leaves = tree_leaves(params)
    weights = torch.full((N,), 1.0 / N, dtype=torch.float32, device=leaves[0].device)
    out_parts: List[Params] = []
    for m, part in enumerate(parts):
        # ``levels`` is an optional every-round entity level of J groups
        # followed by a one-group (fed or cloud) level: one fused launch
        *entity, (_, interval) = plan.levels(m)
        groups = entity[0][0] if entity else 0
        if interval <= 1:
            do_global = True
        elif fed_round is None:
            do_global = (step + 1) % interval == 0
        else:
            do_global = bool(fed_round[m])
        compressed = (
            compressor is not None and m < plan.M - 1 and plan.entities[m] > 1
        )
        if compressed and do_global:
            if groups:
                part = aggregate_tree(part, weights, True, False, groups)
            part = aggregate_tree(
                part, weights, False, True, 1, tile_p=compressor.tile,
                quantized=True,
            )
        elif groups or do_global:
            part = aggregate_tree(part, weights, bool(groups), do_global, groups or 1)
        out_parts.append(part)
    return combine_tiers(out_parts, params)


def class_tier_members(*args, **kwargs):
    """Per-class tier membership matrices — ported with ROADMAP A11."""
    raise NotImplementedError(
        "per-class cuts (class_tier_members) are ported with ROADMAP A11"
    )


def ragged_synchronize(*args, **kwargs):
    """``synchronize`` for per-class cuts (kernel B3) — ported with ROADMAP A11."""
    raise NotImplementedError(
        "per-class ragged sync (kernel B3) is ported with ROADMAP A11"
    )


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
