"""One definition of "the int8-wire aggregation kernels match their
oracle" — port of ``repro.kernels.tiered_aggregate.check``.

``chip_smoke.py`` (its B2 and B3 checks) and ``tests/test_torch_cuda.py``
both call it, so a wire-format or tolerance change cannot leave one of
them stale.  Each function works from one shared wire payload (the port's
``q8_quantize``) and checks every ``(do_entity, do_global)`` flag pair:

(a) B2 / B3 through ``ops`` on ``device`` against its ``ref.py`` plain
    version at the f32 tolerance of ``chip_smoke.py`` (rtol 1e-5, atol
    1e-6: the kernel sums in another order).  The JAX package asks
    interpret-mode Pallas for bit equality here, which fails on this tree
    (ROADMAP §C).  On the CPU both sides are the plain version;
(b) the end-to-end entry (quantize, then the mean) equals the payload
    route bit for bit;
(c) ragged only: all-ones membership with uniform 1/N weights reproduces
    the dense kernel bit for bit, under JAX's condition for it — a
    power-of-two group size and weights whose f32 sum is exactly 1.0, so
    every division the two take is exact.  The sum is taken in each order
    the two sides take it: the kernels' (left to right, one column a
    thread) and ``torch.sum``'s (the plain versions).  JAX takes
    ``jnp.sum``'s alone; twenty weights of 1/20 sum to 1.0 in the card's
    ``torch.sum`` but to 1.0000001 left to right, and B3 divides by that.

Each returns the largest |kernel − plain version| of leg (a).  The inputs
are drawn on ``device`` from the seed (standard normal rows, softmax
weights, members at ``density``); ``x``, ``weights`` and ``member`` replace
the draws where a caller holds the kernels at its own shapes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ...compress.quantize import q8_quantize
from .ops import (
    quantized_tiered_aggregate, ragged_quantized_tiered_aggregate, ragged_tiered_aggregate_q8,
    tiered_aggregate_q8,
)
from .ref import quantized_tiered_aggregate_ref, ragged_quantized_tiered_aggregate_ref

F32_RTOL, F32_ATOL = 1e-5, 1e-6
FLAGS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _close(out: torch.Tensor, ref: torch.Tensor, what) -> float:
    """Largest |out − ref|, asserting the f32 tolerance."""
    err = (out - ref).abs()
    bad = err > F32_ATOL + F32_RTOL * ref.abs()
    assert not bool(bad.any()), (what, int(bad.sum()), float(err.max()))
    return float(err.max()) if err.numel() else 0.0


def _equal(a: torch.Tensor, b: torch.Tensor, what) -> None:
    assert torch.equal(a, b), (what, float((a - b).abs().max()))


def _draws(N: int, P: int, seed: int, salt: int, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(seed * 7919 + N * P + salt)
    x = torch.randn(N, P, generator=gen, device=device)
    w = torch.softmax(torch.randn(N, generator=gen, device=device), 0)
    return x, w, gen


def _sums_to_one(w: torch.Tensor) -> bool:
    """The f32 sum of ``w`` is exactly 1.0 left to right and in
    ``torch.sum``'s order."""
    total = np.float32(0.0)
    for v in w.cpu().numpy():
        total = np.float32(total + v)
    return total == np.float32(1.0) and float(torch.sum(w)) == 1.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def assert_q8_matches_oracle(
    N: int, J: int, P: int, tile: int, seed: int = 0, device: Optional[DeviceLike] = None,
    *, x: Optional[torch.Tensor] = None, weights: Optional[torch.Tensor] = None,
) -> float:
    """Raise AssertionError unless, at this (N, J, P, tile) and every flag
    pair, (a) B2 on ``device`` holds to its plain version on one shared
    wire payload and (b) ``tiered_aggregate_q8`` (quantize, then B2) equals
    the payload route bit for bit; returns leg (a)'s largest error."""
    dev = resolve_device(device)
    dx, dw, _ = _draws(N, P, seed, 0, dev)
    x = dx if x is None else x
    w = dw if weights is None else weights
    q, s = q8_quantize(x, tile)  # one shared wire payload for both paths
    worst = 0.0
    for de, dg in FLAGS:
        out = quantized_tiered_aggregate(q, s, w, de, dg, J, tile)
        _sync(dev)
        ref = quantized_tiered_aggregate_ref(q, s, w, de, dg, J, tile)
        worst = max(worst, _close(out, ref, ("B2 vs plain", N, J, P, tile, de, dg)))
        end = tiered_aggregate_q8(x, w, de, dg, J, tile_p=tile)
        _equal(end, out[:, :P], ("entry vs payload", N, J, P, tile, de, dg))
    return worst


def assert_ragged_q8_matches_oracle(
    N: int, J: int, P: int, tile: int, seed: int = 0, density: float = 0.6,
    device: Optional[DeviceLike] = None, *, x: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None, member: Optional[torch.Tensor] = None,
) -> float:
    """The ragged (per-class membership) analogue of
    ``assert_q8_matches_oracle``: at every flag pair, (a) B3 holds to its
    plain version on one shared wire payload, (b) the ragged entry equals
    the payload route bit for bit, and (c) with all-ones membership and
    uniform 1/N weights B3 reproduces B2 bit for bit, where JAX's condition
    holds (module docstring).  ``member`` is f32 0/1 [N] or [N, U] over the
    P columns; returns leg (a)'s largest error."""
    dev = resolve_device(device)
    dx, dw, gen = _draws(N, P, seed, 1, dev)
    x = dx if x is None else x
    w = dw if weights is None else weights
    if member is None:
        member = (torch.rand(N, generator=gen, device=dev) < density).float()
    ones = torch.ones((N,), dtype=torch.float32, device=dev)
    uw = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)
    per = N // J
    check_collapse = per & (per - 1) == 0 and _sums_to_one(uw)
    q, s = q8_quantize(x, tile)  # one shared wire payload for all paths
    worst = 0.0
    for de, dg in FLAGS:
        out = ragged_quantized_tiered_aggregate(q, s, w, member, de, dg, J, tile, width=P)
        _sync(dev)
        ref = ragged_quantized_tiered_aggregate_ref(q, s, w, member, de, dg, J, tile, P)
        worst = max(worst, _close(out, ref, ("B3 vs plain", N, J, P, tile, de, dg)))
        end = ragged_tiered_aggregate_q8(x, w, member, de, dg, J, tile_p=tile)
        _equal(end, out[:, :P], ("ragged entry vs payload", N, J, P, tile, de, dg))
        if check_collapse:
            ragged = ragged_quantized_tiered_aggregate(q, s, uw, ones, de, dg, J, tile)
            dense = quantized_tiered_aggregate(q, s, uw, de, dg, J, tile)
            _equal(ragged, dense, ("all-ones collapse to dense", N, J, P, tile, de, dg))
    return worst
