"""Public wrapper of the flash-attention kernels — port of
``repro.kernels.swa_attention.ops``.

``swa_attention(q, k, v, window, prefix_len)`` takes q [B, Sq, H, hd] and
k, v [B, Sk, K, hd] (GQA) and is differentiable.  ``prefix_len`` P > 0 is
the VLM's prefix-LM mask: every query also sees the keys below P (within
the window); P = 0 launches the causal kernels' arithmetic bit for bit.
P >= Sk (window 0) lets every query see every key: the audio encoder's
bidirectional self-attention, and with Sq != Sk the decoder's
cross-attention to the encoder's output.  Query and key positions both
count from 0; Sq = Sk is self-attention.  The forward (B4) and the
backward (B5: a q-parallel dq pass, then a kv-parallel dk/dv pass) choose
their implementation from the device of the tensors they are given:

* CUDA tensors launch the hand-written kernels in ``csrc/swa_attention.cu``
  on the current stream, or raise — there is no fallback;
* CPU tensors run the plain versions in ``ref.py`` (the CPU tests).

The kernels mask the ragged sequence tails and apply the 1/√hd scale
themselves (to the scores after the product on wgmma, to q as they load it
on mma.sync), so nothing is padded or rescaled here; a window of at least
Sq is full causal attention (window 0), as in the JAX wrapper, and a prefix
of at least Sk lets every query see every key.  The C dispatch picks the
kernels by head dim: at hd <= ``WG_HEAD_DIM`` (32, 64) B4 and both B5
passes run on wgmma, their tiles brought by TMA (16-byte aligned f32) or
by a producer warp's plain loads (bf16, or f32 off alignment), with no
workspace; so do B4 at 256 (``swa_fwd_wg_wide_kernel``: two consumer
warpgroups on one 64-row q tile, each over half of hd, the kv tiles
streamed in pieces along hd) and B5 at ``HALF_HEAD_DIM`` (128:
``swa_bwd_dq_wg_half_kernel`` and ``swa_bwd_dkv_wg_half_kernel``, two
consumer warpgroups on one 64-row q tile or 64-key kv tile, each over half
of hd, the rest streamed in pieces); B4 at 80-128 and B5 at 80, 96 and 256
run on mma.sync, B5 at 80 and 96 in 4-warp kernels and at 256 in the
8-warp kernels.  The dk/dv pass at 128 and 256 cuts each kv tile's (query
head, q tile) iterations into ``dkv_splits`` ranges, each a block, whose
f32 sums go to a workspace allocated here and are added in split order by
a second, merge launch; ``launches`` counts one a call either way.

Gradients go through two ``torch.autograd.Function``s in the functorch
style (``setup_context`` and a ``vmap`` rule), so Engine A's
``vmap(grad_and_value(loss))`` runs through them.  The backward is itself
a Function with its own ``vmap`` rule, because autograd calls it under the
outer ``vmap``.  Both rules fold the vmapped axis into the batch axis B
and make one launch for all of it: one B4 launch per layer for all
clients.  Each launch adds one to ``launches[<kernel>]``; the plain
versions count nothing.

``swa_decode(q, k, v, cache_pos, q_pos, window)`` is decode attention (B4d,
``csrc/swa_decode.cu``): one query token [B, 1, H, hd] against a KV cache
[B, C, K, hd] whose slots hold the positions ``cache_pos`` [C].  It has no
backward, so no ``autograd.Function``: it raises when q requires grad.  On
a CUDA tensor it launches B4d or raises; on a CPU tensor it runs
``swa_decode_ref``.  B4d splits the cache's 32-slot tiles over
``decode_splits`` blocks a (b, kv head) and merges the
splits' partials in a second launch when there is more than one split;
``decode_launches`` counts one a call either way, apart from the training
kernels' ``launches``; ``reset_launches`` sets both to 0.

On ``meta`` tensors every wrapper launches nothing and counts nothing: it
returns empty outputs of the kernel's shapes and tells the dry-run's
recorder the call (``kernels.meta``).
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .. import build, meta
from .ref import (
    swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref, swa_attention_ref, swa_decode_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_attention.cu"
DECODE_SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_decode.cu"
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
DECODE_MAX_GROUP = 16  # query heads a kv head that B4d takes
DECODE_TILE = 32  # cache slots a B4d tile
DECODE_MIN_SPLIT_TILES = 4  # tiles a split holds at the least
DECODE_MAX_BLOCKS_PER_SM = 4  # the most that the split count plans for
WG_HEAD_DIM = 64  # at and below it B4 and B5's two passes run on wgmma
HALF_HEAD_DIM = 128  # at it B5's two passes run on wgmma, each warpgroup over half of hd
WIDE_HEAD_DIM = 128  # above it B5 runs the 8-warp kernels
DKV_WIDE_KEYS = 32  # those kernels' dk/dv pass: its kv tile ...
DKV_WIDE_ROWS = 16  # ... and the q tiles that it walks
# the head dims whose dk/dv pass is split: (its kv tile, the q tiles it walks)
DKV_TILES = {HALF_HEAD_DIM: (64, 32), 256: (DKV_WIDE_KEYS, DKV_WIDE_ROWS)}
DRYRUN_NUM_SMS = 132  # an H100 SXM's SMs: the split count reckoned on ``meta``
# rows (B·K·Sk) whose workspace costs a split about one block-iteration:
# 1.0–1.3 of one at paligemma-3b's [4, 512, 8, 1, 256] (B·K·Sk = 2048) on
# an H100 (chip_smoke.py's split sweep)
DKV_MERGE_ROWS = 1600
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {
    "swa_attention_fwd": 0, "swa_attention_bwd_dq": 0, "swa_attention_bwd_dkv": 0,
}
decode_launches: Dict[str, int] = {"swa_decode": 0}

_lib: Optional[ctypes.CDLL] = None
_decode_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for counts in (launches, decode_launches):
        for k in counts:
            counts[k] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # dtype, B, Sq, Sk, H, K, hd, window, prefix, scale, stream
        dims = [i] * 9 + [f, p]
        lib.swa_attention_fwd.argtypes = [p] * 5 + dims
        lib.swa_attention_bwd_dq.argtypes = [p] * 8 + dims
        lib.swa_attention_bwd_dkv.argtypes = [p] * 8 + [p, i] + dims  # ws, splits
        # pass, dtype, hd, *smem
        lib.swa_attention_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        for fn in (lib.swa_attention_fwd, lib.swa_attention_bwd_dq,
                   lib.swa_attention_bwd_dkv, lib.swa_attention_occupancy):
            fn.restype = i
        _lib = lib
    return _lib


def bind_decode(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``DECODE_SOURCE``, with its C entries' signatures."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, k, v, cache_pos, q_pos, o, workspace; dtype, B, C, H, K, hd, window,
    # scale, splits, stream
    lib.swa_decode.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
    lib.swa_decode.restype = i
    lib.swa_decode_blocks_per_sm.argtypes = [i, i, i]  # dtype, hd, G
    lib.swa_decode_blocks_per_sm.restype = i
    return lib


def _decode_library() -> ctypes.CDLL:
    global _decode_lib
    if _decode_lib is None:
        _decode_lib = bind_decode(build.load(DECODE_SOURCE))
    return _decode_lib


def effective_window(window: int, Sq: int) -> int:
    """0 (no window) for window 0 or a window that covers every query row."""
    return 0 if (window == 0 or window >= Sq) else int(window)


def effective_prefix(prefix_len: int, Sk: int) -> int:
    """The prefix the kernels take, 0 <= P <= Sk: none for P <= 0, every key
    for P >= Sk."""
    return min(max(int(prefix_len), 0), Sk)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Validate shapes and devices; True for the kernel, False for the plain
    version."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be [B, S, H, hd] and k, v [B, Sk, K, hd], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, hd = q.shape
    if (k.shape[0] != B or k.shape[1] == 0 or k.shape[3] != hd or k.shape[2] == 0
            or H % k.shape[2]):
        raise ValueError(
            f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: need "
            f"[{B}, Sk >= 1, K, {hd}] with H={H} divisible by K"
        )
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"tensor on {q.device}: attention runs on cuda (kernel) or cpu "
            "(plain version)"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"tensors on {q.device}, {k.device} and {v.device}")
    if q.device.type == "cpu":
        return False
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes f32 or bf16, "
            "the same for q, k and v"
        )
    return True


def _raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")


def _record_meta(name: str, q, k, window, prefix_len, **extra) -> None:
    """Tell the dry-run's recorder of one attention call on ``meta``."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    meta.record(name, B=B, Sq=Sq, Sk=Sk, H=H, K=k.shape[2], hd=hd,
                window=effective_window(window, Sq), prefix=effective_prefix(prefix_len, Sk),
                elt=q.element_size(), **extra)


def _lse_like(q: torch.Tensor) -> torch.Tensor:
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


def swa_attention_fwd(q, k, v, window: int = 0,
                      prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: (o [B, Sq, H, hd] in q's dtype, lse [B, H, Sq] f32)."""
    if meta.is_meta(q):
        _record_meta("swa_attention_fwd", q, k, window, prefix_len)
        return torch.empty_like(q), _lse_like(q)
    if not _check(q, k, v):
        return swa_attention_ref(q, k, v, window, prefix_len)
    B, S, H, hd = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.swa_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_dims(q, k, window, prefix_len), stream,
        )
    _raise_on(status, "swa_attention_fwd")
    launches["swa_attention_fwd"] += 1
    return o, lse


def _check_bwd(q, lse, *rows):
    B, S, H, _ = q.shape
    for t in rows:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"o and do must be {q.dtype} {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse and delta must be f32 [{B}, {H}, {S}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")


def _dims(q, k, window, prefix_len):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    return (_DTYPES[q.dtype], B, Sq, Sk, H, k.shape[2], hd, effective_window(window, Sq),
            effective_prefix(prefix_len, Sk), 1.0 / math.sqrt(hd))


def swa_attention_bwd_dq(q, k, v, o, lse, do, window: int = 0, prefix_len: int = 0):
    """B5's q-parallel pass: (dq in q's dtype, delta = rowsum(o·do) [B, H, Sq])."""
    if meta.is_meta(q):
        _record_meta("swa_attention_bwd_dq", q, k, window, prefix_len)
        return torch.empty_like(q), _lse_like(q)
    if not _check(q, k, v):
        return swa_attention_bwd_dq_ref(q, k, v, o, lse, do, window, prefix_len)
    _check_bwd(q, lse, o, do)
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.swa_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_dims(q, k, window, prefix_len),
            stream,
        )
    _raise_on(status, "swa_attention_bwd_dq")
    launches["swa_attention_bwd_dq"] += 1
    return dq, delta


def dkv_tile_iterations(Sq: int, Sk: int, G: int, window: int, prefix: int, hd: int = 256):
    """The (query head, q tile) iterations of each kv tile of the dk/dv pass
    at a split head dim (``DKV_TILES``: 32-key kv tiles over 16-row q tiles
    at 256, ``swa_bwd_dkv_wide_kernel``; 64 over 32 at 128,
    ``swa_bwd_dkv_wg_half_kernel``), as the kernel walks them: G times the
    q tiles i_lo..i_hi whose rows see a key of the tile (``window`` and
    ``prefix`` as the kernel takes them: ``effective_window``,
    ``effective_prefix``)."""
    keys, rows = DKV_TILES[hd]
    nq = -(-Sq // rows)
    out = []
    for j in range(-(-Sk // keys)):
        k0 = j * keys
        i_lo = 0 if k0 < prefix else k0 // rows
        i_hi = nq - 1
        if window > 0:
            i_hi = min(i_hi, (k0 + keys - 1 + window - 1) // rows)
        out.append(G * max(i_hi - i_lo + 1, 0))
    return out


def dkv_makespan(iterations, bk: int, splits: int, num_sms: int) -> int:
    """Iterations of the busiest SM when the blocks, one an SM, go in launch
    order (kv tile, then (b, kv head), then split) to the first free SM."""
    free = [0] * num_sms
    for n in iterations:
        for _ in range(bk):
            for z in range(splits):
                heapq.heappush(free, heapq.heappop(free) + (z + 1) * n // splits - z * n // splits)
    return max(free)


@functools.lru_cache(maxsize=None)
def dkv_splits(B: int, Sq: int, Sk: int, K: int, G: int, hd: int, window: int, prefix: int,
               num_sms: int) -> int:
    """S, the ranges into which B5's dk/dv pass cuts each kv tile's
    (query head, q tile) iterations at head dims 128 and 256
    (``DKV_TILES``), one block each (1 at the others, where the pass takes no
    split): a function of the shapes and the card's SM count, so it reads
    nothing from the card.

    The kernel takes one block an SM, and its kv tiles differ in length (a
    tile under the prefix is seen by every q tile, the last causal one by
    one), so S is the count, at most G, whose blocks finish first: the
    busiest SM's iterations under the launch order's greedy schedule
    (``dkv_makespan``), plus the workspace's cost of each split (its f32
    dk and dv written, then read by the merge), B·K·Sk / ``DKV_MERGE_ROWS``
    iterations a split.  Only counts that fill the SMs are weighed (the
    least, at most G, whose B·K·⌈Sk/32⌉·S blocks reach ``num_sms``), up to
    four blocks an SM.  ``window`` and ``prefix`` are the kernel's
    (``effective_window``, ``effective_prefix``)."""
    if hd not in DKV_TILES:
        return 1
    iterations = dkv_tile_iterations(Sq, Sk, G, window, prefix, hd)
    blocks = max(B * K * len(iterations), 1)
    lo = min(G, -(-num_sms // blocks))
    hi = min(G, max(lo, -(-4 * num_sms // blocks)))
    if lo == hi:
        return lo
    return min(range(lo, hi + 1), key=lambda n: dkv_makespan(iterations, B * K, n, num_sms)
               + n * B * K * Sk / DKV_MERGE_ROWS)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits_of(q, k, window: int, prefix_len: int, num_sms: int) -> int:
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    return dkv_splits(B, Sq, Sk, K, H // K, hd, effective_window(window, Sq),
                      effective_prefix(prefix_len, Sk), num_sms)


def dkv_launch_splits(q: torch.Tensor, k: torch.Tensor, window: int = 0,
                      prefix_len: int = 0) -> int:
    """The S that ``swa_attention_bwd_dkv`` launches for q and k on the card:
    ``dkv_splits`` with the device's SM count."""
    return _splits_of(q, k, window, prefix_len, _num_sms(q.device.index))


def _dkv_workspace(k: torch.Tensor, splits: int) -> Optional[torch.Tensor]:
    """The splits' f32 partial dk and dv, [splits, 2, B, Sk, K, hd]; none at 1."""
    if splits == 1:
        return None
    return torch.empty((splits, 2, *k.shape), dtype=torch.float32, device=k.device)


def swa_attention_bwd_dkv(q, k, v, lse, delta, do, window: int = 0, prefix_len: int = 0):
    """B5's kv-parallel pass: (dk, dv), each summed over the G query heads of
    its kv head."""
    if meta.is_meta(q):
        splits = _splits_of(q, k, window, prefix_len, DRYRUN_NUM_SMS)
        _record_meta("swa_attention_bwd_dkv", q, k, window, prefix_len, splits=splits)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _dkv_workspace(k, splits)  # allocated and freed as on the card, for the tally
        return dk, dv
    if not _check(q, k, v):
        return swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, window, prefix_len)
    _check_bwd(q, lse, do)
    _check_bwd(q, delta)
    q, k, v, lse, delta, do = (t.contiguous() for t in (q, k, v, lse, delta, do))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    splits = dkv_launch_splits(q, k, window, prefix_len)
    ws = _dkv_workspace(k, splits)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.swa_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(),
            splits, *_dims(q, k, window, prefix_len), stream,
        )
    _raise_on(status, "swa_attention_bwd_dkv")
    launches["swa_attention_bwd_dkv"] += 1
    return dk, dv


def swa_attention_bwd(q, k, v, o, lse, do, window: int = 0, prefix_len: int = 0):
    """B5: (dq, dk, dv) from the forward's o and lse and the output grad:
    the dq pass, which also writes delta, then the dk/dv pass."""
    do = do.to(q.dtype)
    dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, window, prefix_len)
    dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, window, prefix_len)
    return dq, dk, dv


def _fold(x: torch.Tensor, bdim: Optional[int], n: int) -> torch.Tensor:
    """A vmapped tensor with its vmapped axis at ``bdim`` (None: not
    vmapped) -> the axis folded into axis 0, [n·B, ...]."""
    x = x.expand(n, *x.shape) if bdim is None else x.movedim(bdim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:])


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


class _SwaAttention(torch.autograd.Function):
    """(o, lse) = B4(q, k, v); lse is not differentiable."""

    @staticmethod
    def forward(q, k, v, window, prefix_len):
        return swa_attention_fwd(q, k, v, window, prefix_len)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, prefix_len = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        ctx.prefix_len = prefix_len
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _SwaAttentionBwd.apply(q, k, v, o, lse, do, ctx.window, ctx.prefix_len)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, window, prefix_len):
        n = info.batch_size
        q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        o, lse = _SwaAttention.apply(q, k, v, window, prefix_len)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _SwaAttentionBwd(torch.autograd.Function):
    """(dq, dk, dv) = B5(q, k, v, o, lse, do); no double backward."""

    @staticmethod
    def forward(q, k, v, o, lse, do, window, prefix_len):
        return swa_attention_bwd(q, k, v, o, lse, do, window, prefix_len)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the flash-attention backward has no backward")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, window, prefix_len):
        n = info.batch_size
        args = [_fold(x, d, n) for x, d in zip((q, k, v, o, lse, do), in_dims[:6])]
        dq, dk, dv = _SwaAttentionBwd.apply(*args, window, prefix_len)
        return (_unfold(dq, n), _unfold(dk, n), _unfold(dv, n)), (0, 0, 0)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int = 0, prefix_len: int = 0) -> torch.Tensor:
    """Causal (window 0) or sliding-window GQA attention, [B, Sq, H, hd],
    with every key below ``prefix_len`` visible too (the prefix-LM mask;
    ``prefix_len`` >= Sk at window 0: unmasked, e.g. cross-attention)."""
    o, _ = _SwaAttention.apply(q, k, v, int(window), int(prefix_len))
    return o


def occupancy(pass_: str, dtype: torch.dtype, hd: int) -> Tuple[int, int]:
    """(resident blocks an SM, dynamic shared memory in bytes) of a pass's
    kernel on the card ("fwd", "dq" or "dkv"; the wgmma kernels at hd <=
    ``WG_HEAD_DIM``, B5's at ``HALF_HEAD_DIM`` and B4's at hd 256, B5's
    8-warp kernels at hd 256): the occupancy calculator, no launch."""
    smem = ctypes.c_int(0)
    blocks = _library().swa_attention_occupancy(("fwd", "dq", "dkv").index(pass_),
                                                _DTYPES[dtype], hd, ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError(f"swa_attention's occupancy query failed with CUDA error {-blocks}")
    return blocks, smem.value


def _check_decode(q, k, v, cache_pos, q_pos) -> bool:
    """Validate decode attention's inputs; True for the kernel, False for the
    plain version."""
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"q must be [B, 1, H, hd] and k, v [B, C, K, hd], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K or C == 0:
        raise ValueError(
            f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: need "
            f"[{B}, C >= 1, K, {hd}] with H={H} divisible by K"
        )
    if cache_pos.shape != (C,) or q_pos.shape != (1,):
        raise ValueError(f"cache_pos must be [{C}] and q_pos [1], got "
                         f"{tuple(cache_pos.shape)}, {tuple(q_pos.shape)}")
    if q.requires_grad:
        raise ValueError("decode attention has no backward: q must not require grad")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tensor on {q.device}: decode attention runs on cuda (kernel) "
                         "or cpu (plain version)")
    if any(t.device != q.device for t in (k, v, cache_pos, q_pos)):
        raise ValueError(f"tensors on {q.device}, {k.device}, {v.device}, "
                         f"{cache_pos.device} and {q_pos.device}")
    if q.device.type == "cpu":
        return False
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if H // K > DECODE_MAX_GROUP:
        raise ValueError(f"{H // K} query heads a kv head: the kernel takes at most "
                         f"{DECODE_MAX_GROUP}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes f32 or bf16, "
            "the same for q, k and v"
        )
    return True


def decode_splits(B: int, K: int, C: int, num_sms: int, blocks_per_sm: int) -> int:
    """S, the splits of B4d's cache a (b, kv head): a function of the shapes
    and of the card's SM count and resident blocks an SM, so it reads
    nothing from the card.  The B·K·S blocks fill the SMs once, at most
    ``DECODE_MAX_BLOCKS_PER_SM`` an SM: a second, partial wave runs on a
    nearly idle card, and more, shorter blocks ran slower
    (chip_ablate_decode.py).  Each split holds at least
    ``DECODE_MIN_SPLIT_TILES`` tiles of ``DECODE_TILE`` slots, so a cache of
    fewer than 8 tiles is not split."""
    tiles = -(-C // DECODE_TILE)
    per_sm = min(blocks_per_sm, DECODE_MAX_BLOCKS_PER_SM)
    return max(1, min(num_sms * per_sm // max(B * K, 1), tiles // DECODE_MIN_SPLIT_TILES))


@functools.lru_cache(maxsize=None)
def _splits_on(B: int, C: int, H: int, K: int, hd: int, dtype: int, index: int) -> int:
    blocks = _decode_library().swa_decode_blocks_per_sm(dtype, hd, H // K)
    if blocks <= 0:
        raise RuntimeError(f"swa_decode's occupancy query failed with CUDA error {-blocks}")
    return decode_splits(B, K, C, torch.cuda.get_device_properties(index).multi_processor_count,
                         blocks)


def decode_launch_splits(q: torch.Tensor, k: torch.Tensor) -> int:
    """The S that ``swa_decode`` launches for q and k on the card, once a
    shape: ``decode_splits`` with the device's SM count and the occupancy
    calculator's resident blocks of the split kernel (no launch)."""
    B, _, H, hd = q.shape
    return _splits_on(B, k.shape[1], H, k.shape[2], hd, _DTYPES[q.dtype], q.device.index)


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache_pos: torch.Tensor,
               q_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """B4d: decode attention of q [B, 1, H, hd] at position ``q_pos`` ([1])
    against the cache k, v [B, C, K, hd] holding positions ``cache_pos``
    ([C], -1 unfilled); o [B, 1, H, hd] in q's dtype.  A slot is visible
    when 0 <= p <= q_pos and, for ``window`` > 0, p > q_pos - window; a row
    with no visible slot is NaN."""
    if meta.is_meta(q):
        B, _, H, hd = q.shape
        meta.record("swa_decode", B=B, C=k.shape[1], H=H, K=k.shape[2], hd=hd,
                    window=max(int(window), 0), elt=q.element_size())
        return torch.empty_like(q)
    if not _check_decode(q, k, v, cache_pos, q_pos):
        return swa_decode_ref(q, k, v, cache_pos, q_pos, window)
    B, _, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cache_pos = cache_pos.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    S = decode_launch_splits(q, k)
    o = torch.empty_like(q)
    ws = (torch.empty(B * H * S * (hd + 2), dtype=torch.float32, device=q.device)
          if S > 1 else None)
    lib = _decode_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.swa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_pos.data_ptr(), q_pos.data_ptr(),
            o.data_ptr(), None if ws is None else ws.data_ptr(), _DTYPES[q.dtype], B, C, H, K,
            hd, max(int(window), 0), 1.0 / math.sqrt(hd), S, stream,
        )
    _raise_on(status, "swa_decode")
    decode_launches["swa_decode"] += 1
    return o
