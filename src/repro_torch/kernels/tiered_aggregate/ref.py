"""Plain PyTorch versions of the fused two-level HSFL aggregation (Eqs. 3–4)
— ports of ``repro.kernels.tiered_aggregate.ref``.

Semantics (one tier's parameter shard, client-stacked):

    x        [N, P]   per-client parameter values
    weights  [N]      fed-server aggregation weights (uniform = 1/N), sum 1
    do_entity bool    apply Eq. (3) entity-local mean (every round)
    do_global bool    apply Eq. (4) fed-server weighted mean (at I_m)

    y1 = do_entity ? mean within each of the J contiguous client groups : x
    y2 = do_global ? Σ_n w_n · y1_n  (broadcast back)                  : y1

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
