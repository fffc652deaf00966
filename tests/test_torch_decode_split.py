"""B4d's split-KV arithmetic, emulated on the CPU and held to the JAX
package's decode attention.

The card's decode attention (``csrc/swa_decode.cu``) splits a cache of C
slots into 32-slot tiles, and split s of each (batch row, kv head) takes
tiles s, s + S, s + 2S, ... (``split_tiles`` here, a copy of the
kernel's partition: the card tests in ``test_torch_cuda.py`` are what
hold the kernel's own), S from ``decode_splits``. Each split runs an
online softmax tile by tile in log2 units (log2(e)/sqrt(hd) folded into
q, p = 2^(s - m)), skipping a tile whose slots are all invisible, and
leaves partials (m, l, acc): m = -inf, l = 0 and acc = 0 when none of
its tiles holds a visible slot. With one split the kernel writes acc /
l; with more, a second pass merges the partials in split order, M = max
m_s, o = sum 2^(m_s - M) acc_s / sum 2^(m_s - M) l_s, giving an empty
split weight 0 (no (-inf) - (-inf)); a row whose every split is empty is
NaN. This file runs that partition and arithmetic in float32 numpy on
numpy inputs from a seed and holds it to JAX's ``_sdpa(q, ck, cv,
_mask_bias(q_pos, cache_pos, True, window, 0, k_valid))``
(``src/repro/models/layers.py:93``, :120) at rtol = atol = 2e-5, the
attention kernels' tolerance: empty splits at the start, in the middle
and at the end, a wrapped ring, a window that one split holds, C a
multiple of neither the tile nor S, G in {1, 3, 6, 16} at hd 64 and 128,
and an all-masked row. It also holds ``decode_splits`` to its contract:
S >= 1, every tile in exactly one split, and the long cache's grid
filling at least the 132 SMs of an H100.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import layers as JL
from repro_torch.kernels.swa_attention import decode_splits
from repro_torch.kernels.swa_attention.ops import DECODE_TILE

ATTN_TOL = 2e-5  # the attention kernels' tolerance, rtol = atol
H100_SMS = 132
LOG2E = np.float32(math.log2(math.e))


def split_tiles(C, S):
    """The tiles of each of the S splits of a C-slot cache, in the order a
    split reads them: split s takes tiles s, s + S, s + 2S, ..."""
    tiles = -(-C // DECODE_TILE)
    return [list(range(s, tiles, S)) for s in range(S)]


def _visible(pos, q_pos, window):
    ok = (pos >= 0) & (pos <= q_pos)
    if window > 0:
        ok &= pos > q_pos - window
    return ok


def split_partials(q, k, v, cache_pos, q_pos, window, tiles):
    """One split's (m, l, acc) [B, K, G], [B, K, G], [B, K, G, hd] over its
    ``tiles``, tile by tile as the kernel runs them."""
    B, _, H, hd = q.shape
    C, K = k.shape[1], k.shape[2]
    G = H // K
    scale = np.float32(np.float32(1.0 / math.sqrt(hd)) * LOG2E)
    qs = (scale * q[:, 0]).reshape(B, K, G, hd)
    m = np.full((B, K, G), -np.inf, np.float32)
    l = np.zeros((B, K, G), np.float32)
    acc = np.zeros((B, K, G, hd), np.float32)
    for t in tiles:
        c = np.arange(t * DECODE_TILE, (t + 1) * DECODE_TILE)
        pos = np.where(c < C, cache_pos[np.minimum(c, C - 1)], -1)
        ok = _visible(pos, q_pos, window)
        if not ok.any():
            continue  # the kernel loads and computes nothing of this tile
        cc = c[c < C]
        kt, vt = k[:, cc], v[:, cc]  # [B, T, K, hd]
        s = np.einsum("bkgh,btkh->bkgt", qs, kt).astype(np.float32)
        s = np.where(ok[: len(cc)], s, -np.inf)
        m_new = np.maximum(m, s.max(-1))  # finite: the tile has a visible slot
        p = np.where(ok[: len(cc)], np.exp2(s - m_new[..., None]), np.float32(0))
        corr = np.exp2(m - m_new)  # 0 while m was -inf
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + np.einsum("bkgt,btkh->bkgh", p, vt).astype(np.float32)
        m = m_new.astype(np.float32)
    return m, l, acc


def merge(parts):
    """o [B, K, G, hd] from the splits' partials, in split order."""
    ms = np.stack([p[0] for p in parts])  # [S, B, K, G]
    M = ms.max(0)
    L = np.zeros_like(M)
    o = np.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = np.where(m == -np.inf, np.float32(0),
                     np.exp2(m - np.where(M == -np.inf, np.float32(0), M)))
        L = L + l * w
        o = o + acc * w[..., None]
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where((M == -np.inf)[..., None], np.nan, o / L[..., None])


def emulate(q, k, v, cache_pos, q_pos, window, S):
    """o [B, 1, H, hd] as B4d computes it with S splits."""
    B, _, H, hd = q.shape
    C = k.shape[1]
    parts = [split_partials(q, k, v, cache_pos, q_pos, window, tiles)
             for tiles in split_tiles(C, S)]
    if S == 1:
        m, l, acc = parts[0]
        with np.errstate(invalid="ignore", divide="ignore"):
            o = np.where((l > 0)[..., None], acc / l[..., None], np.nan)
    else:
        o = merge(parts)
    return o.reshape(B, 1, H, hd), parts


def jax_decode(q, k, v, cache_pos, q_pos, window):
    B, C = k.shape[:2]
    k_valid = jnp.broadcast_to(jnp.asarray(cache_pos >= 0)[None, :], (B, C))
    bias = JL._mask_bias(jnp.asarray(np.array([q_pos], np.int32)), jnp.asarray(cache_pos),
                         True, window, 0, k_valid)
    return np.asarray(JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias))


def _inputs(B, C, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, K, hd)).astype(np.float32)
    return q, k, v


def _slots(kind, C, q_pos):
    """cache_pos of C slots read at q_pos, as the card tests make them."""
    if kind == "partly filled":
        return np.where(np.arange(C) <= q_pos, np.arange(C), -1).astype(np.int32)
    if kind == "wrapped":  # a ring after q_pos + 1 tokens: slot p % C holds p
        return np.roll(np.arange(q_pos + 1 - C, q_pos + 1), (q_pos + 1) % C).astype(np.int32)
    return (np.arange(C) + q_pos + 1).astype(np.int32)  # all masked


def _empty_splits(C, S, empty, q_pos, seed):
    """A cache whose splits in ``empty`` hold no filled slot, every other
    tile filled with distinct positions <= q_pos in a shuffled order."""
    tiles = split_tiles(C, S)
    pos = np.full(C, -1, np.int32)
    filled = [c for s, ts in enumerate(tiles) if s not in empty for t in ts
              for c in range(t * DECODE_TILE, min((t + 1) * DECODE_TILE, C))]
    rng = np.random.default_rng(seed)
    pos[filled] = rng.permutation(q_pos + 1)[: len(filled)]
    return pos


def _check(o, ref):
    np.testing.assert_allclose(o, ref, rtol=ATTN_TOL, atol=ATTN_TOL)


# --------------------------------------------------------------------------- #
# the partition
# --------------------------------------------------------------------------- #

SPLIT_SHAPES = [(8, 128, 3), (8, 8192, 2), (8, 1024, 2), (3, 1300, 2), (3, 8192, 2),
                (2, 16, 2), (1, 8260, 2), (64, 8192, 8), (8, 8192, 8), (1, 33, 1)]


@pytest.mark.parametrize("B,C,K", SPLIT_SHAPES, ids=[str(s) for s in SPLIT_SHAPES])
@pytest.mark.parametrize("blocks_per_sm", [1, 3, 6])
def test_decode_splits_cover_every_tile_once(B, C, K, blocks_per_sm):
    S = decode_splits(B, K, C, H100_SMS, blocks_per_sm)
    tiles = -(-C // DECODE_TILE)
    assert 1 <= S <= tiles
    parts = split_tiles(C, S)
    assert len(parts) == S and all(parts)  # every split holds a tile
    assert sorted(t for ts in parts for t in ts) == list(range(tiles))
    assert S == 1 or all(len(ts) >= 4 for ts in parts)  # DECODE_MIN_SPLIT_TILES
    # the grid fills the SMs at most once, at most 4 blocks an SM
    assert S == 1 or B * K * S <= H100_SMS * min(blocks_per_sm, 4)


def test_decode_splits_fill_the_card_at_the_long_cache_and_not_at_the_serve_cells():
    # qwen2-1.5b's heads over 8192 slots at batch 8: 16 (b, kv head) pairs,
    # 3 blocks an SM for f32 hd 128 (the occupancy calculator on the H100)
    S = decode_splits(8, 2, 8192, H100_SMS, 3)
    assert S == 24 and 8 * 2 * S >= H100_SMS
    assert decode_splits(8, 2, 8192, H100_SMS, 6) == 33  # bf16: capped at 4 an SM
    for B, C, K in ((8, 128, 3), (8, 128, 2), (8, 128, 8)):  # the cache-128 serve cells
        assert decode_splits(B, K, C, H100_SMS, 6) == 1


# --------------------------------------------------------------------------- #
# the arithmetic against JAX
# --------------------------------------------------------------------------- #

# (G, hd, C, q_pos, kind, window, S)
CASES = [
    (1, 64, 1300, 700, "partly filled", 0, 10),     # C a multiple of neither 32 nor S
    (3, 64, 1300, 3000, "wrapped", 0, 7),           # a wrapped ring
    (6, 128, 1300, 3000, "wrapped", 200, 7),        # a window over a few tiles
    (16, 128, 1000, 999, "partly filled", 20, 8),   # a window that one split holds
    (6, 128, 8192, 8191, "partly filled", 0, 24),   # the long cache's partition
    (6, 128, 8192, 1023, "partly filled", 0, 24),   # filled to 1023
    (16, 64, 300, 150, "partly filled", 0, 3),
    (3, 128, 100, 70, "partly filled", 16, 1),      # one split: acc / l
    (1, 128, 640, 639, "partly filled", 0, 20),     # one tile a split
    (6, 64, 777, 5000, "wrapped", 33, 5),
]


@pytest.mark.parametrize("G,hd,C,q_pos,kind,window,S", CASES,
                         ids=[f"G{c[0]}-hd{c[1]}-C{c[2]}-{c[4].replace(' ', '-')}-w{c[5]}-S{c[6]}"
                              for c in CASES])
def test_split_arithmetic_matches_jax(G, hd, C, q_pos, kind, window, S):
    B, K = 2, 2
    q, k, v = _inputs(B, C, G * K, K, hd, seed=G * 1000 + hd + C)
    pos = _slots(kind, C, q_pos)
    o, _ = emulate(q, k, v, pos, q_pos, window, S)
    _check(o, jax_decode(q, k, v, pos, q_pos, window))


@pytest.mark.parametrize("where", ["start", "middle", "end"])
@pytest.mark.parametrize("G,hd", [(1, 64), (6, 128)])
def test_empty_splits_have_empty_partials_and_weigh_nothing(where, G, hd):
    B, K, C, S, q_pos = 2, 2, 1000, 6, 4000
    empty = {"start": {0}, "middle": {2, 3}, "end": {S - 1}}[where]
    q, k, v = _inputs(B, C, G * K, K, hd, seed=len(where) + G)
    pos = _empty_splits(C, S, empty, q_pos, seed=G)
    o, parts = emulate(q, k, v, pos, q_pos, 0, S)
    for s, (m, l, acc) in enumerate(parts):
        if s in empty:
            assert np.all(m == -np.inf) and np.all(l == 0) and np.all(acc == 0)
        else:
            assert np.all(np.isfinite(m)) and np.all(l >= 1)
    assert np.all(np.isfinite(o))
    _check(o, jax_decode(q, k, v, pos, q_pos, 0))


@pytest.mark.parametrize("S", [1, 4])
def test_an_all_masked_row_is_nan_as_in_jax(S):
    B, K, G, hd, C, q_pos = 1, 2, 3, 64, 300, 40
    q, k, v = _inputs(B, C, G * K, K, hd, seed=S)
    pos = _slots("all masked", C, q_pos)
    o, parts = emulate(q, k, v, pos, q_pos, 0, S)
    ref = jax_decode(q, k, v, pos, q_pos, 0)
    assert np.isnan(ref).all() and np.isnan(o).all()
    assert all(np.all(m == -np.inf) for m, _, _ in parts)


@pytest.mark.parametrize("S", [1, 2, 5, 13])
def test_the_split_count_does_not_change_the_result_beyond_the_tolerance(S):
    B, K, G, hd, C, q_pos = 2, 2, 6, 128, 420, 419
    q, k, v = _inputs(B, C, G * K, K, hd, seed=7)
    pos = _slots("partly filled", C, q_pos)
    o, _ = emulate(q, k, v, pos, q_pos, 0, S)
    _check(o, jax_decode(q, k, v, pos, q_pos, 0))
