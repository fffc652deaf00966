"""Public wrappers of the fused aggregation — port of
``repro.kernels.tiered_aggregate.ops``.

``tiered_aggregate`` (B1), ``quantized_tiered_aggregate`` (B2),
``ragged_quantized_tiered_aggregate`` (B3, per-class cuts), B3's dense
twin ``ragged_tiered_aggregate`` and the participation-masked
``masked_tiered_aggregate`` / ``masked_quantized_tiered_aggregate`` (B1m,
dense and over the int8 wire) choose their implementation from the device
of the tensor they are given:

* a CUDA tensor launches the hand-written kernel in
  ``csrc/tiered_aggregate.cu`` on the current stream, or raises — there is
  no fallback;
* a CPU tensor runs the plain version in ``ref.py`` (the CPU tests).

Each launch adds one to ``launches[<kernel>]``; the plain version counts
nothing.  ``aggregate_tree`` applies B1 or B2 to every leaf of a
client-stacked tree, as ``tiers.synchronize`` does per (tier, level);
``ragged_aggregate_tree`` applies the twin or B3, as
``tiers.ragged_synchronize`` does per (unit, tier, level);
``masked_aggregate_tree`` applies B1m, as ``tiers.synchronize(mask=)`` does.
Flags are host-side Python values, so choosing a round's levels never waits
for the device.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..._tree import tree_map
from ...compress.quantize import q8_quantize
from .. import build
from .ref import (
    masked_quantized_tiered_aggregate_ref,
    masked_tiered_aggregate_ref,
    quantized_tiered_aggregate_ref,
    ragged_quantized_tiered_aggregate_ref,
    ragged_tiered_aggregate_ref,
    tiered_aggregate_ref,
)

TILE_P = 2048  # default scale tile of the q8 wire (the JAX package's TILE_P)
SOURCE = Path(__file__).resolve().parent / "csrc" / "tiered_aggregate.cu"

launches: Dict[str, int] = {
    "tiered_aggregate": 0, "tiered_aggregate_q8": 0,
    "ragged_tiered_aggregate": 0, "ragged_tiered_aggregate_q8": 0,
    "masked_tiered_aggregate": 0, "masked_tiered_aggregate_q8": 0,
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        dense = [p, p, p, i, ll, i, i, i, p]
        for fn in (lib.tiered_aggregate_f32, lib.tiered_aggregate_bf16):
            fn.argtypes, fn.restype = dense, i
        lib.tiered_aggregate_q8.argtypes = [p, p, p, p, i, ll, i, i, i, i, p]
        lib.tiered_aggregate_q8.restype = i
        ragged = [p, p, p, p, i, ll, i, ll, ll, i, i, p]
        for fn in (lib.ragged_tiered_aggregate_f32, lib.ragged_tiered_aggregate_bf16):
            fn.argtypes, fn.restype = ragged, i
        lib.ragged_tiered_aggregate_q8.argtypes = [p, p, p, p, p, i, ll, i, i, ll, ll, i, i, p]
        lib.ragged_tiered_aggregate_q8.restype = i
        masked = [p, p, p, p, i, ll, i, i, i, p]
        for fn in (lib.masked_tiered_aggregate_f32, lib.masked_tiered_aggregate_bf16):
            fn.argtypes, fn.restype = masked, i
        lib.masked_tiered_aggregate_q8.argtypes = [p, p, p, p, p, i, ll, i, ll, i, i, i, p]
        lib.masked_tiered_aggregate_q8.restype = i
        _lib = lib
    return _lib


def _on_cuda(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version; raises otherwise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"tensor on {x.device}: the aggregation runs on cuda (kernel) "
            "or cpu (plain version)"
        )
    for o in others:
        if o.device != x.device:
            raise ValueError(f"tensors on {x.device} and {o.device}")
    return x.device.type == "cuda"


def _check_weights(weights: torch.Tensor, N: int) -> None:
    if weights.shape != (N,) or weights.dtype != torch.float32:
        raise ValueError(
            f"weights must be f32 [{N}], got {weights.dtype} {tuple(weights.shape)}"
        )


def _raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")


def tiered_aggregate(
    x: torch.Tensor, weights: torch.Tensor, do_entity, do_global, num_entities: int
) -> torch.Tensor:
    """[N, P] fused two-level aggregation (B1); see ``ref.py`` for semantics.

    x is f32 or bf16 and the output keeps its dtype; the kernel sums in f32.
    """
    if x.ndim != 2 or x.shape[0] % num_entities:
        raise ValueError(
            f"x must be [N, P] with N divisible by {num_entities}, "
            f"got {tuple(x.shape)}"
        )
    N, P = x.shape
    _check_weights(weights, N)
    if not _on_cuda(x, weights):
        return tiered_aggregate_ref(x, weights, do_entity, do_global, num_entities)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes f32 or bf16")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("x and weights must be contiguous")
    lib = _library()
    fn = lib.tiered_aggregate_f32 if x.dtype == torch.float32 else lib.tiered_aggregate_bf16
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            x.data_ptr(), weights.data_ptr(), out.data_ptr(), N, P, num_entities,
            int(bool(do_entity)), int(bool(do_global)), stream,
        )
    _raise_on(status, "tiered_aggregate")
    launches["tiered_aggregate"] += 1
    return out


def quantized_tiered_aggregate(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
    do_entity, do_global, num_entities: int, tile_p: int = TILE_P,
) -> torch.Tensor:
    """Fused dequantize → two-level aggregate over the q8 wire (B2).

    q [N, Pp] int8 with Pp a multiple of ``tile_p``, scales [N, Pp/tile_p]
    f32.  Returns f32 [N, Pp]; the padded tail is the caller's to slice off.
    """
    if q.ndim != 2 or q.shape[0] % num_entities or q.shape[1] % tile_p:
        raise ValueError(
            f"q must be [N, Pp] with N divisible by {num_entities} and Pp by "
            f"{tile_p}, got {tuple(q.shape)}"
        )
    N, Pp = q.shape
    _check_weights(weights, N)
    if scales.shape != (N, Pp // tile_p) or scales.dtype != torch.float32:
        raise ValueError(
            f"scales must be f32 [{N}, {Pp // tile_p}], got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if q.dtype != torch.int8:
        raise ValueError(f"q dtype {q.dtype}: the wire payload is int8")
    if not _on_cuda(q, scales, weights):
        return quantized_tiered_aggregate_ref(
            q, scales, weights, do_entity, do_global, num_entities, tile_p
        )
    if not (q.is_contiguous() and scales.is_contiguous() and weights.is_contiguous()):
        raise ValueError("q, scales and weights must be contiguous")
    lib = _library()
    out = torch.empty((N, Pp), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tiered_aggregate_q8(
            q.data_ptr(), scales.data_ptr(), weights.data_ptr(), out.data_ptr(),
            N, Pp, tile_p, num_entities, int(bool(do_entity)), int(bool(do_global)),
            stream,
        )
    _raise_on(status, "tiered_aggregate_q8")
    launches["tiered_aggregate_q8"] += 1
    return out


def tiered_aggregate_q8(
    x: torch.Tensor, weights: torch.Tensor, do_entity, do_global,
    num_entities: int, tile_p: int = TILE_P,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Quantize [N, P] to the q8 wire format, aggregate fused, return f32.

    The codec (``compress.quantize.q8_quantize``) is plain PyTorch, as it is
    ``jnp`` outside the kernel in the JAX package; ``generator`` switches it
    to stochastic rounding.
    """
    P = x.shape[1]
    q, scales = q8_quantize(x.float(), tile_p, generator=generator)
    out = quantized_tiered_aggregate(
        q, scales, weights, do_entity, do_global, num_entities, tile_p
    )
    return out if out.shape[1] == P else out[:, :P].contiguous()


def _member_matrix(member: torch.Tensor, N: int, width: int) -> torch.Tensor:
    """``member`` as f32 [N, U] with U dividing ``width`` (the columns)."""
    if member.dtype != torch.float32 or member.ndim not in (1, 2) or member.shape[0] != N:
        raise ValueError(
            f"member must be f32 [{N}] or [{N}, U], got {member.dtype} "
            f"{tuple(member.shape)}"
        )
    m = member.reshape(N, -1)
    if m.shape[1] == 0 or width % m.shape[1]:
        raise ValueError(f"{m.shape[1]} member units do not divide {width} columns")
    return m


def ragged_tiered_aggregate(
    x: torch.Tensor, weights: torch.Tensor, member: torch.Tensor,
    do_entity, do_global, num_entities: int,
) -> torch.Tensor:
    """[N, P] member-gated two-level aggregation (B3's dense twin); see
    ``ref.ragged_tiered_aggregate_ref`` for semantics.

    ``member`` is f32 0/1 [N], or [N, U] for a shard of U units of P / U
    columns each.  x is f32 or bf16 and the output keeps its dtype.
    """
    if x.ndim != 2 or x.shape[0] % num_entities:
        raise ValueError(
            f"x must be [N, P] with N divisible by {num_entities}, "
            f"got {tuple(x.shape)}"
        )
    N, P = x.shape
    _check_weights(weights, N)
    m = _member_matrix(member, N, P)
    if not _on_cuda(x, weights, m):
        return ragged_tiered_aggregate_ref(x, weights, m, do_entity, do_global, num_entities)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes f32 or bf16")
    if not (x.is_contiguous() and weights.is_contiguous() and m.is_contiguous()):
        raise ValueError("x, weights and member must be contiguous")
    U = m.shape[1]
    lib = _library()
    fn = (lib.ragged_tiered_aggregate_f32 if x.dtype == torch.float32
          else lib.ragged_tiered_aggregate_bf16)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            x.data_ptr(), weights.data_ptr(), m.data_ptr(), out.data_ptr(), N, P,
            num_entities, U, P // U, int(bool(do_entity)), int(bool(do_global)), stream,
        )
    _raise_on(status, "ragged_tiered_aggregate")
    launches["ragged_tiered_aggregate"] += 1
    return out


def ragged_quantized_tiered_aggregate(
    q: torch.Tensor, scales: torch.Tensor, weights: torch.Tensor,
    member: torch.Tensor, do_entity, do_global, num_entities: int,
    tile_p: int = TILE_P, width: Optional[int] = None,
) -> torch.Tensor:
    """Fused dequantize → member-gated two-level aggregate over the q8 wire
    (B3).  Returns f32 [N, Pp].

    ``member`` is f32 0/1 [N], or [N, U] over ``width`` (default Pp)
    unpadded columns, U·E of them; the padded tail takes the last unit's
    member column.  Non-members receive their dequantized upload, as the
    TPU kernel writes it: keeping the pre-compression replica is the
    caller's (``tiers.ragged_synchronize``).
    """
    if q.ndim != 2 or q.shape[0] % num_entities or q.shape[1] % tile_p:
        raise ValueError(
            f"q must be [N, Pp] with N divisible by {num_entities} and Pp by "
            f"{tile_p}, got {tuple(q.shape)}"
        )
    N, Pp = q.shape
    width = Pp if width is None else width
    if not 0 < width <= Pp:
        raise ValueError(f"width {width} outside (0, {Pp}]")
    _check_weights(weights, N)
    m = _member_matrix(member, N, width)
    if scales.shape != (N, Pp // tile_p) or scales.dtype != torch.float32:
        raise ValueError(
            f"scales must be f32 [{N}, {Pp // tile_p}], got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if q.dtype != torch.int8:
        raise ValueError(f"q dtype {q.dtype}: the wire payload is int8")
    if not _on_cuda(q, scales, weights, m):
        return ragged_quantized_tiered_aggregate_ref(
            q, scales, weights, m, do_entity, do_global, num_entities, tile_p, width
        )
    if not all(t.is_contiguous() for t in (q, scales, weights, m)):
        raise ValueError("q, scales, weights and member must be contiguous")
    U = m.shape[1]
    lib = _library()
    out = torch.empty((N, Pp), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ragged_tiered_aggregate_q8(
            q.data_ptr(), scales.data_ptr(), weights.data_ptr(), m.data_ptr(),
            out.data_ptr(), N, Pp, tile_p, num_entities, U, width // U,
            int(bool(do_entity)), int(bool(do_global)), stream,
        )
    _raise_on(status, "ragged_tiered_aggregate_q8")
    launches["ragged_tiered_aggregate_q8"] += 1
    return out


def ragged_tiered_aggregate_q8(
    x: torch.Tensor, weights: torch.Tensor, member: torch.Tensor,
    do_entity, do_global, num_entities: int, tile_p: int = TILE_P,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Quantize [N, P] to the q8 wire, aggregate member-gated fused (B3),
    return f32 [N, P] — the port of the JAX ``ops.ragged_tiered_aggregate_q8``.
    Each client row is tiled whole, as the JAX codec tiles a flattened
    leaf, so a scale tile may straddle a unit boundary of a [N, U] member.
    """
    P = x.shape[1]
    q, scales = q8_quantize(x.float(), tile_p, generator=generator)
    out = ragged_quantized_tiered_aggregate(
        q, scales, weights, member, do_entity, do_global, num_entities, tile_p, width=P
    )
    return out if out.shape[1] == P else out[:, :P].contiguous()


def _check_mask(mask: torch.Tensor, N: int) -> None:
    if mask.shape != (N,) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be f32 [{N}], got {mask.dtype} {tuple(mask.shape)}")


def masked_tiered_aggregate(
    x: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor,
    do_entity, do_global, num_entities: int,
) -> torch.Tensor:
    """[N, P] participation-masked two-level aggregation (B1m); see
    ``ref.masked_tiered_aggregate_ref`` for semantics.

    ``mask`` is f32 0/1 [N]; ``keep`` [N, P] of x's dtype holds what a
    group with no participant keeps (x itself for the clients' current
    state).  x is f32 or bf16 and the output keeps its dtype; the kernel
    sums in f32 and fuses the two levels into T / S.
    """
    if x.ndim != 2 or x.shape[0] % num_entities:
        raise ValueError(
            f"x must be [N, P] with N divisible by {num_entities}, "
            f"got {tuple(x.shape)}"
        )
    N, P = x.shape
    _check_mask(mask, N)
    if keep.shape != x.shape or keep.dtype != x.dtype:
        raise ValueError(
            f"keep must be {x.dtype} {tuple(x.shape)}, got {keep.dtype} {tuple(keep.shape)}"
        )
    if not _on_cuda(x, mask, keep):
        return masked_tiered_aggregate_ref(x, mask, keep, do_entity, do_global, num_entities)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes f32 or bf16")
    if not (x.is_contiguous() and mask.is_contiguous() and keep.is_contiguous()):
        raise ValueError("x, mask and keep must be contiguous")
    lib = _library()
    fn = (lib.masked_tiered_aggregate_f32 if x.dtype == torch.float32
          else lib.masked_tiered_aggregate_bf16)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            x.data_ptr(), mask.data_ptr(), keep.data_ptr(), out.data_ptr(), N, P,
            num_entities, int(bool(do_entity)), int(bool(do_global)), stream,
        )
    _raise_on(status, "masked_tiered_aggregate")
    launches["masked_tiered_aggregate"] += 1
    return out


def masked_quantized_tiered_aggregate(
    q: torch.Tensor, scales: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor,
    do_entity, do_global, num_entities: int, tile_p: int = TILE_P,
) -> torch.Tensor:
    """Fused dequantize → participation-masked aggregate over the q8 wire
    (B1m with the int8 load).  q [N, Pp] int8, scales [N, Pp/tile_p] f32,
    ``keep`` f32 [N, P] with P <= Pp the unpadded width — the
    pre-compression tree a silent group keeps.  Returns f32 [N, P]."""
    if q.ndim != 2 or q.shape[0] % num_entities or q.shape[1] % tile_p:
        raise ValueError(
            f"q must be [N, Pp] with N divisible by {num_entities} and Pp by "
            f"{tile_p}, got {tuple(q.shape)}"
        )
    N, Pp = q.shape
    _check_mask(mask, N)
    if scales.shape != (N, Pp // tile_p) or scales.dtype != torch.float32:
        raise ValueError(
            f"scales must be f32 [{N}, {Pp // tile_p}], got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if q.dtype != torch.int8:
        raise ValueError(f"q dtype {q.dtype}: the wire payload is int8")
    if keep.ndim != 2 or keep.shape[0] != N or not 0 < keep.shape[1] <= Pp \
            or keep.dtype != torch.float32:
        raise ValueError(
            f"keep must be f32 [{N}, P <= {Pp}], got {keep.dtype} {tuple(keep.shape)}"
        )
    if not _on_cuda(q, scales, mask, keep):
        return masked_quantized_tiered_aggregate_ref(
            q, scales, mask, keep, do_entity, do_global, num_entities, tile_p
        )
    if not all(t.is_contiguous() for t in (q, scales, mask, keep)):
        raise ValueError("q, scales, mask and keep must be contiguous")
    P = keep.shape[1]
    lib = _library()
    out = torch.empty((N, P), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.masked_tiered_aggregate_q8(
            q.data_ptr(), scales.data_ptr(), mask.data_ptr(), keep.data_ptr(),
            out.data_ptr(), N, Pp, tile_p, P, num_entities, int(bool(do_entity)),
            int(bool(do_global)), stream,
        )
    _raise_on(status, "masked_tiered_aggregate_q8")
    launches["masked_tiered_aggregate_q8"] += 1
    return out


def masked_tiered_aggregate_q8(
    x: torch.Tensor, mask: torch.Tensor, keep: torch.Tensor, do_entity, do_global,
    num_entities: int, tile_p: int = TILE_P,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Quantize [N, P] to the q8 wire, aggregate participation-masked fused
    (B1m), return f32 [N, P]; ``keep`` (f32 [N, P]) is what a group with no
    participant keeps."""
    q, scales = q8_quantize(x.float(), tile_p, generator=generator)
    return masked_quantized_tiered_aggregate(
        q, scales, mask, keep, do_entity, do_global, num_entities, tile_p
    )


def aggregate_tree(
    tree: Any, weights: torch.Tensor, do_entity, do_global, num_entities: int,
    tile_p: int = TILE_P, quantized: bool = False,
) -> Any:
    """Apply the fused aggregation leaf-wise to a client-stacked tree.

    ``quantized=True`` routes every leaf through the q8 wire; outputs are
    cast back to the leaf dtype.  ``tile_p`` is the codec's scale tile.
    """

    def f(x):
        if x.numel() == 0:  # the stacked leaves of a tier that holds no unit
            return x
        n = x.shape[0]
        # a no-op on contiguous leaves; a copy of a tier's slice of stacked units
        flat = x.reshape(n, -1).contiguous()
        if quantized:
            out = tiered_aggregate_q8(
                flat, weights, do_entity, do_global, num_entities, tile_p
            ).to(x.dtype)
        else:
            out = tiered_aggregate(flat, weights, do_entity, do_global, num_entities)
        return out.reshape(x.shape)

    return tree_map(f, tree)


def ragged_aggregate_tree(
    tree: Any, weights: torch.Tensor, member: torch.Tensor, do_entity, do_global,
    num_entities: int, tile_p: int = TILE_P, quantized: bool = False,
) -> Any:
    """Apply the member-gated aggregation leaf-wise: one twin launch (or,
    with ``quantized=True``, one B3 launch over the q8 wire) per leaf.

    ``member`` is [N] for a tree of per-unit leaves [N, ...], or [N, U] for
    stacked leaves [N, U, ...], each launched whole over its [N, U·E] row.
    Outputs are cast back to the leaf dtype.
    """

    def f(x):
        if x.numel() == 0:
            return x
        flat = x.reshape(x.shape[0], -1).contiguous()
        if quantized:
            out = ragged_tiered_aggregate_q8(
                flat, weights, member, do_entity, do_global, num_entities, tile_p
            ).to(x.dtype)
        else:
            out = ragged_tiered_aggregate(
                flat, weights, member, do_entity, do_global, num_entities
            )
        return out.reshape(x.shape)

    return tree_map(f, tree)


def masked_aggregate_tree(
    tree: Any, mask: torch.Tensor, do_entity, do_global, num_entities: int,
    keep: Any = None, tile_p: int = TILE_P, quantized: bool = False,
) -> Any:
    """Apply the participation-masked aggregation (B1m) leaf-wise: one
    launch per leaf.  ``keep`` (a tree like ``tree``, default ``tree``
    itself) holds what a group with no participant keeps; with
    ``quantized=True`` every leaf goes over the q8 wire and ``keep`` is the
    pre-compression tree.  Outputs are cast back to the leaf dtype."""

    def f(x, k):
        if x.numel() == 0:
            return x
        n = x.shape[0]
        flat = x.reshape(n, -1).contiguous()
        kflat = flat if k is x else k.reshape(n, -1).contiguous()
        if quantized:
            out = masked_tiered_aggregate_q8(
                flat, mask, kflat.float(), do_entity, do_global, num_entities, tile_p
            ).to(x.dtype)
        else:
            out = masked_tiered_aggregate(
                flat, mask, kflat.to(x.dtype), do_entity, do_global, num_entities
            )
        return out.reshape(x.shape)

    return tree_map(f, tree, tree if keep is None else keep)
