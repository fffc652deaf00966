"""Plain PyTorch versions of the flash-attention kernels — port of
``repro.kernels.swa_attention.ref``.

q [B, Sq, H, hd]; k, v [B, Sk, K, hd] with H = G·K (query head h reads kv
head h // G); query and key positions both count from 0 (Sq = Sk:
self-attention).  A query at position p attends keys in (p − window, p]
(causal, window inclusive of self); window = 0 means full causal attention.
A ``prefix_len`` P > 0 is the VLM's prefix-LM mask: keys below P are seen
by every query too, within the window (``visible``: the JAX package's
``_mask_bias`` rule, ``src/repro/models/layers.py:93``).  P >= Sk at
window 0 sees every key: the audio encoder (Sq = Sk) and the decoder's
cross-attention (Sq != Sk), which the JAX package runs as ``_sdpa`` under a
zero bias.

``swa_attention_ref`` is the JAX oracle with the per-row logsumexp added;
``swa_attention_bwd_ref`` is the flash backward formula that the kernel's
backward computes.  ``swa_decode_ref`` is decode attention (B4d's plain
version): one query position against a KV cache, the JAX package's
``_sdpa`` under ``_mask_bias`` (``src/repro/models/layers.py:93``, :120),
which ``mask_bias`` and ``sdpa`` mirror.  The wrappers in ``ops.py`` run
these for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def visible(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int,
            prefix_len: int = 0) -> torch.Tensor:
    """[Sq, Sk] bool, the JAX package's ``_mask_bias`` rule in its order:
    causal keys (with every key below ``prefix_len`` for a prefix), then
    the window, then no negative (unfilled) key position."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = kp <= qp
        if prefix_len > 0:
            ok = ok | (kp < prefix_len)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok & (kp >= 0)


def _scores(q, k, window, prefix_len=0):
    """(scaled q grouped [B, Sq, K, G, hd], masked scores [B, K, G, Sq, Sk], mask)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = (q.float() / math.sqrt(hd)).reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    ok = visible(torch.arange(Sq, device=q.device), torch.arange(k.shape[1], device=q.device),
                 True, window, prefix_len)  # [Sq, Sk]: key s visible from query q
    return qg, scores.masked_fill(~ok, -math.inf), ok


def swa_attention_ref(q, k, v, window: int = 0,
                      prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Sq, H, hd] in q's dtype, lse [B, H, Sq] f32 of the scaled scores)."""
    B, S, H, hd = q.shape
    _, scores, _ = _scores(q, k, window, prefix_len)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    lse = torch.logsumexp(scores, dim=-1)  # [B, K, G, Sq]
    return out.reshape(B, S, H, hd).to(q.dtype), lse.reshape(B, H, S)


def _p_ds(q, k, v, lse, delta, do, window, prefix_len):
    """(scaled q and do grouped [B, Sq, K, G, hd], p and ds [B, K, G, Sq, Sk])
    from the forward's lse and delta [B, H, Sq]."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg, scores, ok = _scores(q, k, window, prefix_len)
    p = torch.where(ok, torch.exp(scores - lse.reshape(B, K, G, S, 1)), 0.0)
    dog = do.float().reshape(B, S, K, G, hd)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, v.float())
    return qg, dog, p, p * (dp - delta.reshape(B, K, G, S, 1))


def swa_attention_bwd_dq_ref(q, k, v, o, lse, do, window: int = 0, prefix_len: int = 0):
    """The q-parallel pass: (dq in q's dtype, delta [B, H, Sq] f32), with
    delta = rowsum(o·do) and dq = scale·ds·k."""
    B, S, H, hd = q.shape
    delta = (o.float() * do.float()).sum(-1).permute(0, 2, 1)  # [B, H, S]
    _, _, _, ds = _p_ds(q, k, v, lse, delta, do, window, prefix_len)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) / math.sqrt(hd)
    return dq.reshape(B, S, H, hd).to(q.dtype), delta.contiguous()


def swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, window: int = 0, prefix_len: int = 0):
    """The kv-parallel pass: (dk, dv) in k's dtype, each summed over the G
    query heads of its kv head: dk = dsᵀ·(scale·q), dv = pᵀ·do."""
    qg, dog, p, ds = _p_ds(q, k, v, lse, delta, do, window, prefix_len)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def swa_attention_bwd_ref(q, k, v, o, lse, do, window: int = 0, prefix_len: int = 0):
    """(dq, dk, dv) of ``swa_attention_ref``'s output, from its o and lse:
    the dq pass (which also yields delta), then the dk/dv pass."""
    dq, delta = swa_attention_bwd_dq_ref(q, k, v, o, lse, do, window, prefix_len)
    dk, dv = swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, window, prefix_len)
    return dq, dk, dv


def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int,
              prefix_len: int = 0, k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask [Sq, Sk] (or [B, Sq, Sk] with ``k_valid`` [B, Sk]): 0
    where a key is visible, -inf where it is not; negative key positions are
    unfilled cache slots."""
    ok = visible(q_pos, k_pos, causal, window, prefix_len)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    bias = torch.where(ok, zero, -math.inf)
    if k_valid is not None:
        bias = bias[None] + torch.where(k_valid, zero, -math.inf)[:, None, :]
    return bias


def sdpa(q, k, v, bias):
    """q [B, Sq, H, hd]; k, v [B, Sk, K, hd]; bias [Sq, Sk] or [B, Sq, Sk]:
    the scores in f32, the softmax weights in v's dtype, as JAX's ``_sdpa``."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() / math.sqrt(hd)
    b = bias[None, None, None] if bias.ndim == 2 else bias[:, None, None]
    w = torch.softmax(scores + b, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def swa_decode_ref(q, k, v, cache_pos, q_pos, window: int = 0) -> torch.Tensor:
    """Decode attention: q [B, 1, H, hd] at position ``q_pos`` ([1] int)
    against the cache k, v [B, C, K, hd] whose slot c holds position
    ``cache_pos[c]`` (-1: unfilled).  A row with no visible slot is NaN,
    as the reference's softmax gives."""
    B, C = k.shape[:2]
    k_valid = (cache_pos >= 0)[None, :].expand(B, C)
    bias = mask_bias(q_pos.long(), cache_pos.long(), True, window, 0, k_valid)
    return sdpa(q, k, v, bias)
