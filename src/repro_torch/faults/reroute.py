"""Cell-outage rerouting: dead cells' clients join sibling cells' syncs — port
of ``repro.faults.reroute``.

The dense sync path (``tiers._group_mean``) realizes entity grouping as a
contiguous ``reshape(J, N//J)`` — it cannot express a client served by a
cell other than its own.  This module generalizes the grouping the same
way DESIGN.md §14's ragged machinery generalized the unit axis: an
explicit 0/1 *membership matrix*, here ``[N, J]`` over cells instead of
``[N, U]`` over units.  ``outage_assignment`` remaps every dead cell's
clients round-robin onto the surviving cells; ``reroute_entity_sync``
then runs the tier's entity-level mean (Eq. 3) under that membership:

    mean_j = Σ_i members[i,j]·w_i·x_i / Σ_i members[i,j]·w_i
    out_i  = Σ_j members[i,j]·mean_j      (broadcast back to every member)

Because a completed level leaves every member carrying its cell's
weighted mean, the rerouted mean over (sibling cell ∪ adopted clients)
is exactly the joint participant-weighted mean — the same hierarchical-
weighting argument as ``_group_mean_masked``'s docstring.  With the
identity assignment the matrix is the plan's contiguous grouping, but
the rerouted path is only ever entered on outage rounds: clean rounds
never leave today's reshape-based code (the bit-exactness gate).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._tree import tree_leaves, tree_map


def outage_assignment(
    num_clients: int, num_cells: int, out_cells: Sequence[int]
) -> np.ndarray:
    """[N] int — each client's serving cell with dead cells remapped.

    Healthy cells keep their contiguous client block; a dead cell's
    clients are dealt round-robin across the surviving cells (balanced,
    deterministic in client order).  Raises when nothing survives.
    """
    J, N = num_cells, num_clients
    if N % J != 0:
        raise ValueError(f"num_clients={N} not divisible by num_cells={J}")
    dead = sorted({int(c) for c in out_cells})
    bad = [c for c in dead if not 0 <= c < J]
    if bad:
        raise ValueError(f"out_cells {bad} outside [0, {J})")
    alive = [j for j in range(J) if j not in dead]
    if not alive:
        raise ValueError(
            f"all {J} cells are out — no sibling cell left to reroute to"
        )
    per = N // J
    assign = np.repeat(np.arange(J), per)
    orphans = np.flatnonzero(np.isin(assign, dead))
    assign[orphans] = np.asarray(alive, dtype=assign.dtype)[
        np.arange(len(orphans)) % len(alive)
    ]
    return assign


def assignment_members(assign: np.ndarray, num_cells: int) -> np.ndarray:
    """[N, J] float32 one-hot membership matrix for an assignment vector."""
    N = len(assign)
    members = np.zeros((N, num_cells), dtype=np.float32)
    members[np.arange(N), assign] = 1.0
    return members


def membership_mean(tree, members, w=None, keep=None):
    """Membership-weighted cell mean, broadcast back to members.

    ``members`` [N, J] gates which cell averages a client's replica and
    which mean the client receives; ``w`` [N] is the usual participation
    weight (``tiers._group_mean_masked`` semantics: a zero-weight cell
    keeps its members' ``keep`` values).  Leaves without a leading client
    axis pass through untouched.  The means are ``torch.einsum`` products,
    as the JAX package's are ``jnp.einsum`` outside any kernel, so this
    launches no aggregation kernel.
    """
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    mem = torch.as_tensor(members, dtype=torch.float32, device=device)
    N = mem.shape[0]
    cw = mem if w is None else mem * w.to(device=device, dtype=torch.float32)[:, None]
    s = torch.sum(cw, dim=0)  # [J] per-cell participant weight
    if keep is None:
        keep = tree

    def f(x, k):
        if x.ndim == 0 or x.shape[0] != N:
            return x
        flat = x.reshape(N, -1)
        tot = torch.einsum("nj,nd->jd", cw, flat.float())
        mean = tot / torch.clamp(s, min=1.0)[:, None]
        back = torch.einsum("nj,jd->nd", mem, mean).to(x.dtype)
        ok = (torch.einsum("nj,j->n", mem, s) > 0.0)[:, None]
        out = torch.where(ok, back, k.reshape(N, -1))
        return out.reshape(x.shape)

    return tree_map(f, tree, keep)


def reroute_entity_sync(params, plan, m: int, members, mask=None):
    """Tier m's entity-level sync (Eq. 3) under a rerouted membership.

    Slices tier m's subtree, applies the membership mean, and recombines.
    On an outage round the fault-aware loop zeroes the dead cells'
    clients out of the step's mask (their serving fed cell is
    unreachable, so their round contribution is lost — the same loss the
    q-deflation accounting charges), then calls this with the rerouted
    membership and that same mask: the adopted clients contribute no
    weight to the sibling's mean but *receive* its broadcast, so they
    rejoin healed instead of drifting for the whole outage span.
    """
    from ..core.tiers import combine_tiers, tier_subtrees

    parts = tier_subtrees(params, plan)
    parts[m] = membership_mean(parts[m], members, w=mask)
    return combine_tiers(parts, params)
