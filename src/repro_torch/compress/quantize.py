"""Stochastic int8 quantization with per-tile f32 scales — port of
``repro.compress.quantize``.

Wire format (shared verbatim with the fused aggregation kernel in
``kernels/tiered_aggregate``): a tensor is flattened, zero-padded to a
multiple of ``tile``, and every tile carries ``tile`` int8 values plus one
f32 scale ``s = max|x| / 127`` — so the wire is ``(tile + 4)`` bytes per
``4·tile`` raw bytes, ≈ 4× smaller.

Rounding is nearest without a generator and stochastic (``floor(y + u)``,
unbiased) with one.  ``torch.round`` rounds half to even, like
``jnp.round``, so the key-less path quantizes identical inputs to identical
bits in both packages.  The error bound is the JAX module's:

    ω  =  sup_x ‖Q(x) − x‖² / ‖x‖²  ≤  tile / (4 · 127²)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

QMAX = 127.0


def q8_quantize(
    x: torch.Tensor, tile: int, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, P] f32 → (int8 values [N, Pp], f32 scales [N, Pp/tile]).

    Pp = P rounded up to a multiple of ``tile`` (zero padding; zeros
    quantize to zero and never move a tile's abs-max).  ``generator`` (on
    ``x``'s device) switches to stochastic rounding.
    """
    N, P = x.shape
    pad = (-P) % tile
    xp = F.pad(x, (0, pad)) if pad else x
    T = xp.shape[1] // tile
    xt = xp.float().reshape(N, T, tile)
    absmax = torch.amax(torch.abs(xt), dim=-1)
    scales = torch.where(absmax > 0.0, absmax / QMAX, torch.ones_like(absmax))
    y = xt / scales[..., None]
    if generator is None:
        q = torch.round(y)
    else:
        u = torch.rand(y.shape, generator=generator, device=y.device)
        q = torch.floor(y + u)
    q = torch.clamp(q, -QMAX, QMAX).to(torch.int8)
    return q.reshape(N, T * tile), scales


def q8_dequantize(q: torch.Tensor, scales: torch.Tensor, tile: int) -> torch.Tensor:
    """Inverse wire map: (int8 [N, Pp], scales [N, T]) → f32 [N, Pp]."""
    N, Pp = q.shape
    qt = q.reshape(N, Pp // tile, tile).float()
    return (qt * scales[..., None]).reshape(N, Pp)


@dataclass(frozen=True)
class Int8Stochastic:
    """Per-tile-scaled int8 codec (see module docstring for ω derivation)."""

    tile: int = 256
    name: str = "int8"

    @property
    def ratio(self) -> float:
        # int8 payload + one f32 scale per tile, over 4 bytes per element
        return (self.tile + 4.0) / (4.0 * self.tile)

    @property
    def omega(self) -> float:
        return self.tile / (4.0 * QMAX * QMAX)

    def transform(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        flat = x.reshape(1, -1)
        q, scales = q8_quantize(flat, self.tile, generator=generator)
        deq = q8_dequantize(q, scales, self.tile)
        return deq[:, : flat.shape[1]].reshape(x.shape).to(x.dtype)
