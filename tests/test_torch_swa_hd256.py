"""B5 at head dim 256 on the CPU: the split count of the 8-warp dk/dv pass,
its partition of the work emulated in PyTorch against ``jax.grad``, and its
record on ``meta`` tensors.

The kernels (``csrc/swa_attention.cu``: ``swa_bwd_dkv_wide_kernel`` and
``swa_bwd_dkv_merge_kernel``) run only on the card.  What surrounds them is
held here:

* ``dkv_splits``: at least 1, at most G, 1 below head dim 256, enough
  blocks to fill the card's SMs where G allows, and the count whose
  blocks finish first by ``dkv_makespan`` (the busiest SM's iterations),
  at paligemma-3b's, whisper-large-v3's and smollm-135m's shapes and at
  edge shapes;
* the partition: each kv tile of 32 keys walks its (query head, 16-row q
  tile) iterations, cut into ``splits`` equal ranges; every visible (query
  head, row, key) falls in one split's range, and dk and dv summed split by
  split in the merge's order (each split's share from the plain version's p
  and ds, ``ref._p_ds``) equal ``jax.grad`` of JAX's attention at the f32
  tolerance, ATTN_TOL = 2e-5 of max|ref| as ``tests/test_torch_vlm.py``
  holds the backward: under a window (JAX's ``swa_attention_ref``) and
  under the prefix-LM mask (JAX's ``_sdpa`` under ``_mask_bias``, prefix 16);
* the dry-run: one ``swa_attention_bwd_dkv`` call recorded per wrapper call,
  its split count, and the workspace's bytes (written by the splits, read
  by the merge) in ``kernel_work`` and in the tally's peak.
"""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention.ref import swa_attention_ref as jax_swa_ref
from repro.models import layers as JL
from repro_torch.kernels import meta
from repro_torch.kernels.swa_attention import ops, ref
from repro_torch.launch import dryrun_lib as D

ATTN_TOL = 2e-5
H100_SMS = 132
BK, BQ = ops.DKV_WIDE_KEYS, ops.DKV_WIDE_ROWS


# (B, Sq, Sk, K, G, hd, window, prefix): paligemma-3b's Engine-B tiers, its
# REDUCED cell, whisper-large-v3's encoder, cross- and decoder
# self-attention, smollm-135m's main path, and edges: batch 1, one key,
# G = 1, many batches, Sq < Sk causal, a window, Sq > Sk
SHAPES = [(4, 512, 512, 1, 8, 256, 0, 256), (8, 64, 64, 1, 4, 32, 0, 4),
          (1, 512, 512, 1, 8, 256, 0, 256), (4, 1500, 1500, 20, 1, 64, 0, 1500),
          (4, 448, 1500, 20, 1, 64, 0, 1500), (4, 448, 448, 20, 1, 64, 0, 0),
          (8, 1024, 1024, 3, 3, 64, 0, 0), (1, 1, 1, 1, 8, 256, 0, 0),
          (1, 300, 300, 1, 1, 256, 0, 0), (64, 4096, 4096, 8, 2, 256, 0, 0),
          (2, 130, 130, 2, 6, 256, 0, 70), (1, 100, 300, 1, 4, 256, 0, 0),
          (1, 300, 300, 1, 4, 256, 48, 0), (1, 300, 130, 1, 6, 256, 0, 0)]


@pytest.mark.parametrize("num_sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_dkv_splits_fill_the_card_within_g(shape, num_sms):
    B, Sq, Sk, K, G, hd, W, P = shape
    n = ops.dkv_splits(B, Sq, Sk, K, G, hd, W, P, num_sms)
    assert 1 <= n <= G
    if hd <= ops.WIDE_HEAD_DIM:
        assert n == 1
        return
    its = ops.dkv_tile_iterations(Sq, Sk, G, W, P)
    tiles = B * K * len(its)
    if G * tiles >= num_sms:
        assert n * tiles >= num_sms  # the blocks fill the SMs
    else:
        assert n == G
    # no count that fills the SMs finishes sooner by the model
    cost = {m: ops.dkv_makespan(its, B * K, m, num_sms) + m * B * K * Sk / ops.DKV_MERGE_ROWS
            for m in range(1, G + 1) if m * tiles >= min(num_sms, G * tiles)
            and m * tiles <= max(4 * num_sms, n * tiles)}
    assert cost[n] == min(cost.values())


def test_dkv_makespan_counts_the_busiest_sm():
    """Two SMs, blocks of 3, 2, 2 and 1 iterations in that order: the
    greedy schedule puts 3 on one SM and 2 + 2 on the other, then 1 on the
    first: 4."""
    assert ops.dkv_makespan([3, 2, 2, 1], 1, 1, 2) == 4
    assert ops.dkv_makespan([6], 1, 2, 2) == 3  # one tile in two splits of 3
    assert ops.dkv_makespan([5], 1, 2, 2) == 3  # 2 and 3 iterations


def test_dkv_splits_at_paligemma_and_batch_1():
    """The counts the card runs on an H100's 132 SMs: 3 splits of G = 8 at
    [4, 512, 8, 1, 256] prefix 256 (192 blocks; 5 would leave 28 of the
    heaviest blocks to a second wave), every head apart at batch 1."""
    assert ops.dkv_splits(4, 512, 512, 1, 8, 256, 0, 256, H100_SMS) == 3
    assert ops.dkv_splits(1, 512, 512, 1, 8, 256, 0, 256, H100_SMS) == 8
    assert ops.dkv_splits(4, 1500, 1500, 20, 1, 64, 0, 1500, H100_SMS) == 1


def split_selection(Sq, Sk, G, window, prefix, splits):
    """[splits, G, Sq, Sk] bool: which split's block adds the pair (query
    head g of the kv head, row, key), as swa_bwd_dkv_wide_kernel walks them:
    kv tile j takes q tiles i_lo..i_hi, iteration it = g·n_i + (i - i_lo),
    and split z the iterations [z·n_it // S, (z + 1)·n_it // S)."""
    window, prefix = ops.effective_window(window, Sq), ops.effective_prefix(prefix, Sk)
    sel = torch.zeros(splits, G, Sq, Sk, dtype=torch.bool)
    nq = -(-Sq // BQ)
    for j in range(-(-Sk // BK)):
        k0 = j * BK
        i_lo = 0 if k0 < prefix else k0 // BQ
        i_hi = nq - 1
        if window > 0:
            i_hi = min(i_hi, (k0 + BK - 1 + window - 1) // BQ)
        n_i = max(i_hi - i_lo + 1, 0)
        n_it = G * n_i
        for z in range(splits):
            for it in range(z * n_it // splits, (z + 1) * n_it // splits):
                g, i = it // n_i, i_lo + it % n_i
                sel[z, g, i * BQ:(i + 1) * BQ, k0:k0 + BK] = True
    return sel


def emulated_dkv(q, k, v, do, window, prefix, splits):
    """dk, dv as the split kernel and the merge sum them: each split's
    share of the plain version's ds^T·(scale q) and p^T·do, added in split
    order; and the partition's count of splits for each (head, row, key)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    o, lse = ref.swa_attention_ref(q, k, v, window, prefix)
    _, delta = ref.swa_attention_bwd_dq_ref(q, k, v, o, lse, do, window, prefix)
    qg, dog, p, ds = ref._p_ds(q, k, v, lse, delta, do, window, prefix)
    sel = split_selection(Sq, k.shape[1], H // K, window, prefix, splits)
    dk = dv = None
    for z in range(splits):
        m = sel[z][None, None].to(p.dtype)
        dk_z = torch.einsum("bkgqs,bqkgh->bskh", ds * m, qg)
        dv_z = torch.einsum("bkgqs,bqkgh->bskh", p * m, dog)
        dk, dv = (dk_z, dv_z) if z == 0 else (dk + dk_z, dv + dv_z)
    return dk, dv, sel.sum(0)


def _norm_close(got, want, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= ATTN_TOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("splits", [ops.dkv_splits(2, 64, 64, 1, 8, 256, 0, 16, H100_SMS), 3, 5])
@pytest.mark.parametrize("mask", ["window 24", "prefix 16"])
def test_partition_summed_in_split_order_matches_jax_grad(mask, splits):
    """[2, 64, 8, 1, 256]: every visible pair in exactly one split (G = 8
    over 8 splits, and over 3 and 5, which G is no multiple of), and dk, dv
    from the splits against jax.grad."""
    B, S, H, K, hd = 2, 64, 8, 1, 256
    window, prefix = (24, 0) if mask == "window 24" else (0, 16)
    rng = np.random.default_rng(splits + window)
    q, do = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, S, K, hd)).astype(np.float32) for _ in range(2))
    dk, dv, count = emulated_dkv(*(torch.from_numpy(x) for x in (q, k, v, do)), window, prefix,
                                 splits)
    pos = torch.arange(S)
    seen = ref.visible(pos, pos, True, ops.effective_window(window, S), prefix)
    assert bool((count[:, seen] == 1).all()) and int(count.max()) == 1

    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    if prefix:
        jpos = jnp.arange(S)

        def attn(a, b, c):
            return JL._sdpa(a, b, c, JL._mask_bias(jpos, jpos, True, window, prefix))
    else:
        def attn(a, b, c):
            return jax_swa_ref(a, b, c, window)
    _, jdk, jdv = jax.grad(lambda a, b, c: jnp.sum(attn(a, b, c) * jdo),
                           argnums=(0, 1, 2))(jq, jk, jv)
    _norm_close(dk.numpy(), jdk, f"dk {mask} splits {splits}")
    _norm_close(dv.numpy(), jdv, f"dv {mask} splits {splits}")


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("hd", [64, 256])
def test_meta_dkv_records_one_call_and_its_workspace(hd):
    """On ``meta`` tensors at paligemma-3b's Engine-B shape (and at hd 64,
    which takes no split): one recorded call a wrapper call with its split
    count; ``kernel_work`` adds the workspace's bytes (written, then read),
    and the tally's peak holds dk, dv and the workspace together."""
    B, S, H, K, P = 4, 512, 8, 1, 256
    q, do = _meta(B, S, H, hd), _meta(B, S, H, hd)
    k, v = _meta(B, S, K, hd), _meta(B, S, K, hd)
    lse, delta = _meta(B, H, S), _meta(B, H, S)
    splits = ops.dkv_splits(B, S, S, K, H // K, hd, 0, P, ops.DRYRUN_NUM_SMS)
    assert splits == (3 if hd == 256 else 1)
    seen = []
    with meta.recording(lambda name, shape: seen.append((name, shape))):
        ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P)
        ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P)
    assert [name for name, _ in seen] == ["swa_attention_bwd_dkv"] * 2
    assert all(shape["splits"] == splits for _, shape in seen)
    assert not any(ops.launches.values())

    ws_bytes = 4 * splits * 2 * B * S * K * hd if splits > 1 else 0
    pairs = D.attention_pairs(S, S, 0, P)
    _, plain_bytes = D.pairs_work(B, S, S, H, K, hd, pairs)["swa_attention_bwd_dkv"]
    assert D.kernel_work("swa_attention_bwd_dkv", seen[0][1])["bytes"] == plain_bytes + 2 * ws_bytes

    _, got = D.count_step(lambda: ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P))
    assert got["kernels"]["swa_attention_bwd_dkv"]["calls"] == 1
    assert got["temp_bytes"] == 2 * B * S * K * hd * 4 + ws_bytes
    assert math.isclose(got["kernels"]["swa_attention_bwd_dkv"]["bytes"], plain_bytes + 2 * ws_bytes)


# B, Sq, Sk, H, K, hd, prefix: whisper-large-v3's encoder, cross- and decoder
# self-attention and smollm-135m's path, then hd 32 (REDUCED qwen2.5)
WG_META = [(4, 1500, 1500, 20, 20, 64, 1500), (4, 448, 1500, 20, 20, 64, 1500),
           (4, 448, 448, 20, 20, 64, 0), (8, 1024, 1024, 9, 3, 64, 0), (8, 256, 256, 8, 2, 32, 0)]


@pytest.mark.parametrize("shape", WG_META, ids=[str(s) for s in WG_META])
def test_meta_wgmma_dkv_records_no_split_and_no_workspace(shape):
    """At head dim <= 64 the dk/dv pass runs on wgmma in one launch with no
    workspace: on ``meta`` its record has one split, ``kernel_work`` adds no
    workspace bytes, and the tally's temporaries are dk and dv alone."""
    B, Sq, Sk, H, K, hd, P = shape
    assert hd <= ops.WG_HEAD_DIM
    q, do = _meta(B, Sq, H, hd), _meta(B, Sq, H, hd)
    k, v = _meta(B, Sk, K, hd), _meta(B, Sk, K, hd)
    lse, delta = _meta(B, H, Sq), _meta(B, H, Sq)
    assert ops.dkv_splits(B, Sq, Sk, K, H // K, hd, 0, P, ops.DRYRUN_NUM_SMS) == 1
    seen = []
    with meta.recording(lambda name, shape: seen.append((name, shape))):
        ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P)
    assert [(name, rec["splits"]) for name, rec in seen] == [("swa_attention_bwd_dkv", 1)]
    pairs = D.attention_pairs(Sq, Sk, 0, P)
    _, plain_bytes = D.pairs_work(B, Sq, Sk, H, K, hd, pairs)["swa_attention_bwd_dkv"]
    assert D.kernel_work("swa_attention_bwd_dkv", seen[0][1])["bytes"] == plain_bytes
    _, got = D.count_step(lambda: ops.swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P))
    assert got["temp_bytes"] == 2 * B * Sk * K * hd * 4
    assert not any(ops.launches.values())
