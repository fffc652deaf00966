"""Plain PyTorch versions of the fused two-level HSFL aggregation (Eqs. 3–4)
— ports of ``repro.kernels.tiered_aggregate.ref``.

Semantics (one tier's parameter shard, client-stacked):

    x        [N, P]   per-client parameter values
    weights  [N]      fed-server aggregation weights (uniform = 1/N), sum 1
    do_entity bool    apply Eq. (3) entity-local mean (every round)
    do_global bool    apply Eq. (4) fed-server weighted mean (at I_m)

    y1 = do_entity ? mean within each of the J contiguous client groups : x
    y2 = do_global ? Σ_n w_n · y1_n  (broadcast back)                  : y1

The ragged (per-class cut) variants add a 0/1 ``member`` [N] — or [N, U]
over a shard of U units of E = P / U columns each — and only members feed
and receive either level (``ragged_tiered_aggregate_ref``).  The masked
variant (partial participation) weights each row by its non-negative
``mask`` [N] (0/1 participation, or Engine B's entity participant counts),
broadcasts to every row, and lets a group of zero total weight keep its
rows of ``keep`` (``masked_tiered_aggregate_ref``); the masked ragged
variant weights each client by ``member × mask`` and lets only members
receive (``masked_ragged_tiered_aggregate_ref``).

The CPU tests run these, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  Flags are host-side Python values.
"""
from __future__ import annotations

import torch


def tiered_aggregate_ref(
    x: torch.Tensor, weights: torch.Tensor, do_entity, do_global, num_entities: int
) -> torch.Tensor:
    N, P = x.shape
    J = num_entities
    per = N // J
    xf = x.float()
    y1 = xf
    if do_entity:
        grouped = xf.reshape(J, per, P)
        y1 = grouped.mean(dim=1, keepdim=True).expand(J, per, P).reshape(N, P)
    y2 = y1
    if do_global:
        w = weights.float()[:, None]
        y2 = torch.sum(y1 * w, dim=0, keepdim=True).expand(N, P)
    return y2.to(x.dtype).contiguous()


def quantized_tiered_aggregate_ref(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
    do_entity, do_global, num_entities: int, tile_p: int,
) -> torch.Tensor:
    """Dequantize each ``tile_p`` chunk of the int8 wire payload against its
    scale, then the Eq. 3/4 reduction; returns f32 [N, Pp].

    The JAX oracle loops over tiles to mirror its kernel's grid; every step
    here is column-wise, so the whole payload is dequantized at once — the
    same products and the same per-column reduction.

    q       [N, Pp] int8 wire payload (Pp a multiple of ``tile_p``)
    scales  [N, Pp // tile_p] f32 per-tile scales
    """
    N, Pp = q.shape
    if Pp % tile_p:
        raise ValueError(f"payload width {Pp} is not a multiple of tile {tile_p}")
    x = q.reshape(N, Pp // tile_p, tile_p).float() * scales.float()[..., None]
    return tiered_aggregate_ref(
        x.reshape(N, Pp), weights, do_entity, do_global, num_entities
    )


def ragged_tiered_aggregate_ref(
    x: torch.Tensor, weights: torch.Tensor, member: torch.Tensor,
    do_entity, do_global, num_entities: int,
) -> torch.Tensor:
    """Member-gated two-level aggregation of a dense [N, P] shard (B3's
    twin) — the arithmetic of the JAX ``tiers._ragged_units_mean`` levels
    and of ``_ragged_q8_kernel`` after its dequantizing load:

        em_g = Σ_{i∈g} m_i·x_i / max(Σ_{i∈g} m_i, 1)
        y1_i = (do_entity ∧ m_i ∧ Σ_g > 0) ? em_g : x_i
        sw   = Σ_i w_i·m_i,   gm = Σ_i y1_i·w_i·m_i / (sw > 0 ? sw : 1)
        y2_i = (do_global ∧ m_i ∧ sw > 0) ? gm : y1_i

    member  [N] or [N, U] 0/1; column p belongs to unit p // (P / U).
    """
    N, P = x.shape
    J = num_entities
    per = N // J
    m = member.float().reshape(N, -1)
    U = m.shape[1]
    E = P // U
    x3 = x.float().reshape(N, U, E)
    m3 = m.reshape(N, U, 1)
    grouped = x3.reshape(J, per, U, E)
    mg = m3.reshape(J, per, U, 1)
    sg = torch.sum(mg, dim=1, keepdim=True)                     # [J, 1, U, 1]
    emean = torch.sum(grouped * mg, dim=1, keepdim=True) / torch.clamp(sg, min=1.0)
    y1 = torch.where(
        bool(do_entity) & (mg > 0.0) & (sg > 0.0), emean, grouped
    ).reshape(N, U, E)
    wm = weights.float()[:, None, None] * m3                    # [N, U, 1]
    sw = torch.sum(wm, dim=0, keepdim=True)                     # [1, U, 1]
    gmean = torch.sum(y1 * wm, dim=0, keepdim=True) / torch.where(
        sw > 0.0, sw, torch.ones_like(sw)
    )
    y2 = torch.where(bool(do_global) & (m3 > 0.0) & (sw > 0.0), gmean, y1)
    return y2.reshape(N, P).to(x.dtype).contiguous()


def ragged_quantized_tiered_aggregate_ref(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
    member: torch.Tensor, do_entity, do_global, num_entities: int,
    tile_p: int, width: int = None,
) -> torch.Tensor:
    """B3: dequantize the int8 wire, then ``ragged_tiered_aggregate_ref`` —
    a port of ``ref.ragged_quantized_tiered_aggregate_ref``, whose per-tile
    loop is column-wise and so is taken over the whole payload at once.
    Returns f32 [N, Pp].

    ``width`` (default Pp) is the unpadded U·E columns a [N, U] member
    covers; the padded tail takes the last unit's member column, as the
    kernel does.
    """
    N, Pp = q.shape
    if Pp % tile_p:
        raise ValueError(f"payload width {Pp} is not a multiple of tile {tile_p}")
    x = (q.reshape(N, Pp // tile_p, tile_p).float() * scales.float()[..., None]).reshape(N, Pp)
    width = Pp if width is None else width
    m = member.reshape(N, -1)
    out = ragged_tiered_aggregate_ref(
        x[:, :width], weights, m, do_entity, do_global, num_entities
    )
    if width == Pp:
        return out
    tail = ragged_tiered_aggregate_ref(
        x[:, width:], weights, m[:, -1], do_entity, do_global, num_entities
    )
    return torch.cat([out, tail], dim=1)


def _group_mean_masked(x: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor,
                       groups: int) -> torch.Tensor:
    """One participation-weighted level over [N, P] — the arithmetic of the
    JAX ``tiers._group_mean_masked``: f32 sums of w·x per group, divided by
    max(Σ w, 1), broadcast to every member; zero-participant groups keep."""
    N, P = x.shape
    per = N // groups
    g = x.reshape(groups, per, P)
    gk = keep.reshape(groups, per, P)
    wg = mask.float().reshape(groups, per)
    s = torch.sum(wg, dim=1).reshape(groups, 1, 1)
    tot = torch.sum(g * wg[..., None].to(g.dtype), dim=1, keepdim=True, dtype=torch.float32)
    m = (tot / torch.clamp(s, min=1.0)).to(x.dtype)
    return torch.where(s > 0.0, m.expand(g.shape), gk).reshape(N, P)


def masked_tiered_aggregate_ref(
    x: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor,
    do_entity, do_global, num_entities: int,
) -> torch.Tensor:
    """Participation-masked two-level aggregation (B1m's plain version),
    level by level as the JAX ``synchronize(mask=)`` applies them:

        entity (J groups):  y_i = s_g > 0 ? Σ_{g} w·x / s_g : keep_i
        fed (one group):    y_i = S > 0 ? Σ w·y / S : keep'_i

    with keep' = the entity level's output (which is ``keep`` wherever S = 0,
    the only place the fed level reads it).  x and keep are [N, P] of one
    dtype; ``mask`` is a non-negative weight vector [N]: 0/1 participation,
    or the entity participant counts of Engine B's fed mean, where
    Σ w·x / Σ w is the JAX ``wm`` (counts are >= 1 wherever S > 0, so its
    max(S, 1) is S).  The levels run in f32 and the output is cast
    to x's dtype once, as the kernel and B1's plain version do.  For bf16
    the JAX package rounds between the levels too; the two agree within two
    bf16 ulps of a column's largest |x| (``tests/test_torch_participation``
    holds this version to JAX's chain at that bound)."""
    y, keep = x.float(), keep.float()
    if do_entity:
        y = _group_mean_masked(y, mask, keep, num_entities)
    if do_global:
        y = _group_mean_masked(y, mask, y if do_entity else keep, 1)
    return y.to(x.dtype).contiguous()


def masked_quantized_tiered_aggregate_ref(
    q: torch.Tensor, scales: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor,
    do_entity, do_global, num_entities: int, tile_p: int,
) -> torch.Tensor:
    """B1m over the int8 wire: dequantize q [N, Pp], then the masked levels
    over its first P = keep.shape[1] columns; returns f32 [N, P]."""
    N, Pp = q.shape
    if Pp % tile_p:
        raise ValueError(f"payload width {Pp} is not a multiple of tile {tile_p}")
    x = (q.reshape(N, Pp // tile_p, tile_p).float() * scales.float()[..., None]).reshape(N, Pp)
    return masked_tiered_aggregate_ref(
        x[:, :keep.shape[1]], mask, keep.float(), do_entity, do_global, num_entities
    )


def _ragged_level_masked(y: torch.Tensor, keep: torch.Tensor, member: torch.Tensor,
                         cw: torch.Tensor, groups: int) -> torch.Tensor:
    """One member-gated, participation-weighted level over [N, U, E] — the
    arithmetic of the JAX ``tiers._ragged_units_mean`` with a mask: f32 sums
    of cw·y per group and unit, divided by max(Σ cw, 1), received by the
    members of groups with Σ cw > 0; every other row takes ``keep``."""
    N, U, E = y.shape
    per = N // groups
    g = y.reshape(groups, per, U, E)
    gk = keep.reshape(groups, per, U, E)
    wg = cw.reshape(groups, per, U, 1)
    mg = member.reshape(groups, per, U, 1)
    s = torch.sum(wg, dim=1, keepdim=True)                       # [G, 1, U, 1]
    tot = torch.sum(g * wg, dim=1, keepdim=True)
    mean = tot / torch.clamp(s, min=1.0)
    return torch.where((mg > 0.0) & (s > 0.0), mean, gk).reshape(N, U, E)


def masked_ragged_tiered_aggregate_ref(
    x: torch.Tensor, mask: torch.Tensor, member: torch.Tensor, keep: torch.Tensor,
    do_entity, do_global, num_entities: int,
) -> torch.Tensor:
    """Member-gated, participation-masked two-level aggregation (B3m's plain
    version), level by level as the JAX ``ragged_synchronize(mask=)``
    applies ``_ragged_units_mean``, with cw = member × mask:

        entity (J groups):  y_i = (m_i ∧ s_g > 0) ? Σ_g cw·x / s_g : keep_i
        fed (one group):    y_i = (m_i ∧ S > 0)   ? Σ cw·y / S     : keep'_i

    with keep' the entity level's output.  x and keep are [N, P] of one
    dtype, ``mask`` [N] 0/1 and ``member`` [N] or [N, U] 0/1 (column p
    belongs to unit p // (P / U)).  The levels run in f32 and the output is
    cast to x's dtype once, as the kernel does; the JAX package rounds a
    bf16 leaf between the levels too."""
    N, P = x.shape
    m = member.float().reshape(N, -1)
    U = m.shape[1]
    m3 = m.reshape(N, U, 1)
    cw = m3 * mask.float().reshape(N, 1, 1)
    y, k = x.float().reshape(N, U, P // U), keep.float().reshape(N, U, P // U)
    if do_entity:
        y = _ragged_level_masked(y, k, m3, cw, num_entities)
    if do_global:
        y = _ragged_level_masked(y, y if do_entity else k, m3, cw, 1)
    return y.reshape(N, P).to(x.dtype).contiguous()


def masked_ragged_quantized_tiered_aggregate_ref(
    q: torch.Tensor, scales: torch.Tensor, mask: torch.Tensor, member: torch.Tensor,
    keep: torch.Tensor, do_entity, do_global, num_entities: int, tile_p: int,
) -> torch.Tensor:
    """B3m over the int8 wire: dequantize q [N, Pp], then the masked ragged
    levels over its first P = keep.shape[1] columns; returns f32 [N, P]."""
    N, Pp = q.shape
    if Pp % tile_p:
        raise ValueError(f"payload width {Pp} is not a multiple of tile {tile_p}")
    x = (q.reshape(N, Pp // tile_p, tile_p).float() * scales.float()[..., None]).reshape(N, Pp)
    return masked_ragged_tiered_aggregate_ref(
        x[:, :keep.shape[1]], mask, member, keep.float(), do_entity, do_global, num_entities
    )
