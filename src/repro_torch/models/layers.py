"""Neural-net primitives — port of ``repro.models.layers``.

Pure functions over parameter dicts (no module framework: the HSFL engine
slices, stacks and aggregates raw parameter trees).  Initializers draw from
an explicit ``torch.Generator``.  Shapes follow the JAX package's
[batch, seq, ...] row-major conventions.

Self-attention runs through the flash-attention kernels
(``kernels.swa_attention``) at every sequence length and at the spec's
window; the JAX package's ``_sdpa`` / ``_blockwise_sdpa`` split computes the
same function and has no counterpart here.  The QKV, output, MLP, router,
expert and Mamba projections stay ``torch.matmul`` / ``torch.einsum``, as
the JAX package leaves them to XLA (the weight products without batch
dimensions through ``dot``, which the ``"dots"`` remat policy saves); so
do the MoE dispatch (``moe``: top-k routing with capacity, an index
scatter into per-group expert buffers and a gather or scatter-add
combine) and Mamba2's chunked SSD scan (``ssd_scan``), which the JAX
package runs in ``jnp`` too.

Decoding (serving) keeps a KV cache per attention layer (``init_attn_cache``)
and a conv and SSM state per Mamba block (``init_mamba_cache``).  One token
a step goes through ``attention(..., positions=, cache=)``, whose decode
attention runs on B4d (``kernels.swa_attention.swa_decode``), and through
``mamba_block(..., cache=)``, one step of the SSD recurrence in torch ops
as the JAX package runs it in ``jnp``.  The attention cache is written in
place (see ``attention``); under a sliding window it is a ring of
``window`` slots that wraps, where the JAX package's decode stops writing
once the ring is full (ROADMAP §C).

The VLM's prefix-LM mask (``attention(prefix_len=)``) runs on the same
kernels, and so does the audio model's attention: the encoder's
bidirectional self-attention (``causal=False``, unroped) as a prefix that
covers every key, and the decoder's cross-attention (``kv_override``) to
the encoder's output, with Sq != Sk, as the same unmasked case.  A decode
step's cross-attention (``positions`` given: one query) runs on B4d with
every encoder slot at position 0, so every slot is visible.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..kernels.swa_attention import swa_attention, swa_decode
from .spec import ModelSpec

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(tuple(shape), generator=gen) * s).to(dtype)


# the active "dots" remat segment's tape (``models.remat``), else None
_DOT_TAPE: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def dot_tape(tape: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """Route every ``dot`` through ``tape`` inside the block."""
    global _DOT_TAPE
    prev, _DOT_TAPE = _DOT_TAPE, tape
    try:
        yield
    finally:
        _DOT_TAPE = prev


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, a weight product without batch dimensions: the products
    that the ``"dots"`` remat policy saves (JAX's
    ``dots_with_no_batch_dims_saveable``)."""
    return x @ w if _DOT_TAPE is None else _DOT_TAPE(x, w)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, concatenated halves. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., :, None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean token cross-entropy. logits [..., V], labels [...] int; ``mask``
    weights each token (the LM loss masks labels < 0)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# --------------------------------------------------------------------------- #
# attention (GQA + rope + optional qk-norm / bias / sliding window)
# --------------------------------------------------------------------------- #


def init_attention(gen: torch.Generator, spec: ModelSpec, cross: bool = False) -> Params:
    """q, k, v, o projections and the pre-norm; the q/k/v biases and the
    q/k norms where the spec has them, but not on a cross-attention block
    (``cross``), as in JAX."""
    d, hd = spec.d_model, spec.hd
    h, k = spec.num_heads, spec.num_kv_heads
    p: Params = {
        "wq": _dense_init(gen, (d, h * hd), spec.pdtype),
        "wk": _dense_init(gen, (d, k * hd), spec.pdtype),
        "wv": _dense_init(gen, (d, k * hd), spec.pdtype),
        "wo": _dense_init(gen, (h * hd, d), spec.pdtype),
        "norm": torch.zeros((d,), dtype=spec.pdtype),
    }
    if spec.qkv_bias and not cross:
        p["bq"] = torch.zeros((h * hd,), dtype=spec.pdtype)
        p["bk"] = torch.zeros((k * hd,), dtype=spec.pdtype)
        p["bv"] = torch.zeros((k * hd,), dtype=spec.pdtype)
    if spec.qk_norm and not cross:
        p["q_norm"] = torch.zeros((hd,), dtype=spec.pdtype)
        p["k_norm"] = torch.zeros((hd,), dtype=spec.pdtype)
    return p


def attention(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    spec: ModelSpec,
    *,
    positions: Optional[torch.Tensor] = None,  # [S] int (decode: [1])
    causal: bool = True,
    prefix_len: int = 0,
    cache: Optional[Params] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA attention sub-layer (pre-norm + residual by the caller).

    Training and prefill (``cache=None``): rope positions are 0..S-1 and the
    mask is causal over them, optionally within ``spec.window``, with every
    key below ``prefix_len`` visible too (the VLM's prefix-LM mask, within
    the window), on the flash-attention kernels; ``positions`` must be None
    (0..S-1).  ``causal=False`` lets every query see every key (the audio
    encoder; the window still applies), ``use_rope=False`` skips the rotary
    embedding.

    Cross-attention (``kv_override=(k, v)``, [B, Sk, K, hd], precomputed):
    only q is projected (and q-normed where the block has ``q_norm``), and
    it attends every key of k with no mask, the JAX package's ``_sdpa`` under
    a zero bias, on the flash-attention kernels (Sq = S against Sk).  With
    ``positions`` (a decode step, S = 1) it runs on B4d, every slot at
    position 0.  ``cache`` is returned as it came: JAX's cross branch never
    writes one.

    Decode (``cache=`` from ``init_attn_cache``, S = 1): the token is roped
    at ``positions`` (default [0], as in JAX), its k and v go into slot
    ``index`` of the cache (``index % C`` under a window whose ring holds
    the whole window, C = window), and the query attends every filled slot
    that the causal and window mask lets through, on B4d; a prefix raises
    (the JAX package's decode passes none).  A cache without
    a window (or shorter than its window) that is full raises
    ``ValueError``.  The cache's k, v and positions are written **in
    place**; the returned cache holds those tensors and ``index + 1``, and
    the cache passed in must not be used again.
    """
    B, S, d = x.shape
    h, k_heads, hd = spec.num_heads, spec.num_kv_heads, spec.hd
    if kv_override is not None:
        return _cross_attention(params, x, spec, positions, kv_override), cache
    if cache is None:
        if positions is not None:
            raise ValueError("positions other than 0..S-1 need a cache: the training path's "
                             "kernels take the positions 0..S-1 (pass positions=None)")
        positions = torch.arange(S, device=x.device)
    else:
        if S != 1:
            raise ValueError(f"the decode path takes one token a step, got S={S}")
        if positions is None:
            positions = torch.zeros((1,), dtype=torch.int32, device=x.device)

    q = dot(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(B, S, h, hd)
    kx = dot(x, params["wk"])
    vx = dot(x, params["wv"])
    if "bk" in params:
        kx = kx + params["bk"]
        vx = vx + params["bv"]
    kx = kx.reshape(B, S, k_heads, hd)
    vx = vx.reshape(B, S, k_heads, hd)

    if spec.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
        kx = rms_norm(kx, params["k_norm"], spec.norm_eps)
    if use_rope:
        q = rope(q, positions, spec.rope_theta)
        kx = rope(kx, positions, spec.rope_theta)

    if cache is None:
        # bidirectional: a prefix that covers every key
        out = swa_attention(q, kx, vx, spec.window, prefix_len if causal else S)
        return dot(out.reshape(B, S, h * hd), params["wo"]), None

    if prefix_len > 0 or not causal:
        raise ValueError("decode attention (B4d) is causal and takes no prefix: the VLM "
                         "decodes its text as a dense model, as the JAX package's "
                         "decode_step does")
    ck, cv, cpos = cache["k"], cache["v"], cache["positions"]
    idx = int(cache["index"])  # host bookkeeping: reads no device value
    slot = _cache_slot(idx, ck.shape[1], spec.window)
    ck[:, slot] = kx[:, 0].to(ck.dtype)
    cv[:, slot] = vx[:, 0].to(cv.dtype)
    cpos[slot] = idx
    new_cache = {"k": ck, "v": cv, "positions": cpos, "index": cache["index"] + 1}
    out = swa_decode(q, ck, cv, cpos, positions, spec.window)
    return dot(out.reshape(B, S, h * hd), params["wo"]), new_cache


def _cross_attention(params: Params, x: torch.Tensor, spec: ModelSpec,
                     positions: Optional[torch.Tensor], kv) -> torch.Tensor:
    """``attention``'s ``kv_override`` branch: q [B, S, H, hd] against every
    key of k, v [B, Sk, K, hd]."""
    B, S, _ = x.shape
    h, hd = spec.num_heads, spec.hd
    k, v = kv
    q = dot(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(B, S, h, hd)
    if spec.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
    if positions is None:
        out = swa_attention(q, k, v, 0, k.shape[1])
    else:
        if S != 1:
            raise ValueError(f"the decode path takes one token a step, got S={S}")
        # every slot at position 0 <= the query's: all visible, no window
        slots = torch.zeros((k.shape[1],), dtype=torch.int32, device=k.device)
        out = swa_decode(q, k, v, slots, positions, 0)
    return dot(out.reshape(B, S, h * hd), params["wo"])


def _cache_slot(idx: int, C: int, window: int) -> int:
    """The cache slot of absolute position ``idx`` in a cache of C slots.

    A windowed cache whose C slots hold the whole window (C = window) is a
    ring: position idx goes to slot idx % C, over the slot that fell out of
    the window.  (The JAX package wraps only when ``window < C``, which its
    ``init_attn_cache`` never makes, so past C its writes are dropped and
    from position 2·window − 1 every slot is masked: NaN.)  Any other cache
    holds positions 0..C-1 and raises past them."""
    if window and C >= window:
        return idx % C
    if idx >= C:
        raise ValueError(
            f"position {idx} does not fit the KV cache of length {C}"
            + (f" (shorter than the window {window})" if window else "")
            + ": make the cache longer (cache_len)")
    return idx


def init_attn_cache(spec: ModelSpec, batch: int, cache_len: int,
                    device: Optional[DeviceLike] = None) -> Params:
    """One attention layer's KV cache: k, v [batch, C, K, hd] in the compute
    dtype and ``positions`` [C] int32 (-1: unfilled) on ``device`` (default:
    the first CUDA device), and ``index`` (int32, the next position to
    write) on the host, so that placing a token reads nothing from the
    card.  C = min(cache_len, window) under a window, else cache_len."""
    device = resolve_device(device)
    C = min(cache_len, spec.window) if spec.window else cache_len
    shape = (batch, C, spec.num_kv_heads, spec.hd)
    return {
        "k": torch.zeros(shape, dtype=spec.cdtype, device=device),
        "v": torch.zeros(shape, dtype=spec.cdtype, device=device),
        "positions": torch.full((C,), -1, dtype=torch.int32, device=device),
        "index": torch.zeros((), dtype=torch.int32),
    }


# --------------------------------------------------------------------------- #
# MLP (SwiGLU, or GELU)
# --------------------------------------------------------------------------- #


def init_mlp(gen: torch.Generator, spec: ModelSpec, d_ff: Optional[int] = None,
             gelu: bool = False) -> Params:
    d = spec.d_model
    ff = d_ff or spec.d_ff
    p = {
        "w1": _dense_init(gen, (d, ff), spec.pdtype),
        "w2": _dense_init(gen, (ff, d), spec.pdtype),
        "norm": torch.zeros((d,), dtype=spec.pdtype),
    }
    if not gelu:
        p["w3"] = _dense_init(gen, (d, ff), spec.pdtype)
    return p


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "w3" in params:
        return dot(F.silu(dot(x, params["w1"])) * dot(x, params["w3"]), params["w2"])
    # jax.nn.gelu's default is the tanh approximation
    return dot(F.gelu(dot(x, params["w1"]), approximate="tanh"), params["w2"])




# --------------------------------------------------------------------------- #
# MoE (top-k routing with capacity)
# --------------------------------------------------------------------------- #


def init_moe(gen: torch.Generator, spec: ModelSpec) -> Params:
    d, ff = spec.d_model, spec.d_ff
    E = spec.moe.num_experts
    return {
        "router": _dense_init(gen, (d, E), spec.pdtype, scale=0.02),
        "w1": _dense_init(gen, (E, d, ff), spec.pdtype),
        "w3": _dense_init(gen, (E, d, ff), spec.pdtype),
        "w2": _dense_init(gen, (E, ff, d), spec.pdtype),
        "norm": torch.zeros((d,), dtype=spec.pdtype),
    }


def moe_route(params: Params, xg: torch.Tensor, spec: ModelSpec):
    """Router of ``moe`` on grouped tokens ``xg`` [G, Tg, d]: (the softmax
    probabilities [G, Tg, E], the top-k gate values renormalised over the k
    [G, Tg, K], the expert ids [G, Tg, K], descending by gate)."""
    logits = dot(xg, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, spec.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_ids


def moe(params: Params, x: torch.Tensor, spec: ModelSpec,
        groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-based top-k MoE with capacity; returns (output, the Switch
    load-balancing aux loss).

    The tokens are reshaped [G, T/G] (``groups``, when it divides T) with a
    per-group capacity ``cap``.  Each (token, k) takes the rank of its
    expert's one-hot within the group's (token, k) order; ranks at or past
    ``cap`` go to the spill slot ``cap`` of a ``cap + 1`` buffer, which the
    experts never read.  The dispatch writes every kept (token, k) into its
    own slot, so a plain ``index_put`` reproduces the JAX scatter (the spill
    slot's duplicate writes are dropped with it).  With one group the
    combine gathers each (token, k) slot back; with several it scatter-adds
    the gate-weighted expert rows into a [Tg + 1, d] buffer per group,
    whose last row takes the empty slots (Engine B's per-entity dispatch).
    On the card that scatter-add is atomic, so its sums are not
    bit-repeatable.  The JAX ``constraint=`` hook pins GSPMD shardings and
    has no counterpart here.
    """
    ms = spec.moe
    B, S, d = x.shape
    T = B * S
    E, K = ms.num_experts, ms.top_k
    G = groups if T % groups == 0 else 1
    Tg = T // G
    xg = x.reshape(G, Tg, d)
    probs, gate_vals, expert_ids = moe_route(params, xg, spec)

    cap = int(max(1, math.ceil(Tg * K / E * ms.capacity_factor)))
    experts = torch.arange(E, device=x.device)
    oh_flat = (expert_ids[..., None] == experts).long().reshape(G, Tg * K, E)
    pos = torch.cumsum(oh_flat, dim=1) - oh_flat  # rank within expert (per group)
    pos = torch.sum(pos * oh_flat, dim=-1).reshape(G, Tg, K)
    slot = torch.where(pos < cap, pos, torch.full_like(pos, cap))  # overflow -> spill

    eid = expert_ids.reshape(G, Tg * K)
    sid = slot.reshape(G, Tg * K)
    gid = torch.arange(G, device=x.device)[:, None].expand(G, Tg * K)
    xrep = torch.repeat_interleave(xg, K, dim=1)  # [G, Tg*K, d]
    buf = torch.zeros((G, E, cap + 1, d), dtype=x.dtype, device=x.device)
    ein = buf.index_put((gid, eid, sid), xrep)[:, :, :cap]  # [G, E, cap, d]

    h = torch.einsum("gecd,edf->gecf", ein, params["w1"])
    g = torch.einsum("gecd,edf->gecf", ein, params["w3"])
    h = F.silu(h) * g
    eout = torch.einsum("gecf,efd->gecd", h, params["w2"])  # [G, E, cap, d]

    if G > 1:
        # combine by scatter-add in expert space: each slot's gate-weighted
        # row lands on its token; empty slots carry token id Tg (the drop row)
        gbuf = torch.zeros((G, E, cap + 1), dtype=torch.float32, device=x.device)
        gbuf = gbuf.index_put((gid, eid, sid), gate_vals.reshape(G, Tg * K))
        tok = torch.arange(Tg, device=x.device).repeat_interleave(K)
        tbuf = torch.full((G, E, cap + 1), Tg, dtype=torch.long, device=x.device)
        tbuf = tbuf.index_put((gid, eid, sid), tok.expand(G, Tg * K))
        weighted = eout * gbuf[:, :, :cap, None].to(eout.dtype)
        out = torch.zeros((G, Tg + 1, d), dtype=x.dtype, device=x.device)
        gslot = torch.arange(G, device=x.device)[:, None].expand(G, E * cap)
        out = out.index_put((gslot, tbuf[:, :, :cap].reshape(G, E * cap)),
                            weighted.reshape(G, E * cap, d), accumulate=True)
        out = out[:, :Tg]
    else:
        # combine: gather each (token, k) slot back; the spill slot reads 0
        eout_p = F.pad(eout, (0, 0, 0, 1))
        got = eout_p[gid, eid, sid].reshape(G, Tg, K, d)
        out = torch.sum(got * gate_vals[..., None].to(got.dtype), dim=2)

    # Switch-style load balancing, per dispatch group, then averaged
    me = torch.mean(probs, dim=1)  # [G, E]
    ce = torch.mean((expert_ids[..., 0, None] == experts).float(), dim=1)
    aux = E * torch.mean(torch.sum(me * ce, dim=-1))
    return out.reshape(B, S, d), aux


# --------------------------------------------------------------------------- #
# Mamba2 (SSD — state space duality, arXiv:2405.21060)
# --------------------------------------------------------------------------- #


def init_mamba(gen: torch.Generator, spec: ModelSpec) -> Params:
    ss = spec.ssm
    d = spec.d_model
    di = ss.expand * d
    nh = di // ss.head_dim
    n = ss.state_dim
    in_dim = 2 * di + 2 * n + nh  # z, x, B, C, dt
    return {
        "in_proj": _dense_init(gen, (d, in_dim), spec.pdtype),
        "conv_w": _dense_init(gen, (ss.conv_width, di), spec.pdtype, scale=0.5),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32)).to(spec.pdtype),
        "D": torch.ones((nh,), dtype=spec.pdtype),
        "dt_bias": torch.zeros((nh,), dtype=spec.pdtype),
        "gate_norm": torch.zeros((di,), dtype=spec.pdtype),
        "out_proj": _dense_init(gen, (di, d), spec.pdtype),
        "norm": torch.zeros((d,), dtype=spec.pdtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> lower-triangular cumulative segment sums [..., T, T]
    (−inf above the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    tril = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(tril, diff, torch.full_like(diff, -math.inf))


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P] (already dt-discretized input)
    A: torch.Tensor,  # [B, S, H]    (dt * A, negative)
    Bm: torch.Tensor,  # [B, S, N]
    Cm: torch.Tensor,  # [B, S, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (dual form). Returns (y [B,S,H,P], final_state [B,H,P,N]).

    The JAX package's three- and four-operand einsums are contracted pairwise
    here, so no intermediate grows past the [B, H, nc, l, l] decay matrix
    (``torch.einsum`` contracts left to right without ``opt_einsum``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    # the operands' common dtype, as jnp.einsum promotes them
    ct = torch.promote_types(torch.promote_types(x.dtype, A.dtype),
                             torch.promote_types(Bm.dtype, Cm.dtype))
    x, A, Bm, Cm = (t.to(ct) for t in (x, A, Bm, Cm))
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        A = F.pad(A, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = x.shape[1]
    nc = Sp // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    Ac = A.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)  # [B,H,nc,l]
    Bc = Bm.reshape(B, nc, chunk, N)
    Cc = Cm.reshape(B, nc, chunk, N)

    A_cumsum = torch.cumsum(Ac, dim=-1)  # [B,H,nc,l]
    L = torch.exp(_segsum(Ac))  # [B,H,nc,l,l]
    # 1. intra-chunk (diagonal block) outputs
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, xc)
    # 2. chunk-final states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)  # [B,H,nc,l]
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]  # [B,nc,l,H,P]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xd)
    # 3. inter-chunk recurrence
    if init_state is None:
        init_state = torch.zeros((B, H, P, N), dtype=states.dtype, device=states.device)
    states = torch.cat([init_state[:, None].to(states.dtype), states], dim=1)
    chunk_decay = A_cumsum[..., -1]  # [B,H,nc]
    decay_chunk = torch.exp(_segsum(F.pad(chunk_decay, (1, 0))))  # [B,H,nc+1,nc+1]
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states_in = new_states[:, :-1]  # state entering each chunk
    final_state = new_states[:, -1]
    # 4. state -> output contribution
    state_decay_out = torch.exp(A_cumsum)  # [B,H,nc,l]
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cc, states_in)
    Y_off = Y_off * state_decay_out.permute(0, 2, 3, 1)[..., None]
    Y = (Y_diag + Y_off).reshape(B, Sp, H, P)
    return Y[:, :S], final_state


def mamba_block(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    spec: ModelSpec,
    cache: Optional[Params] = None,  # {"conv": [B, W-1, di], "state": [B, H, P, N]}
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Mamba2 block (pre-norm and residual by the caller): in-projection,
    the causal depthwise convolution, the SSD scan, the gated RMS norm and
    the out-projection.  With ``cache`` (decode, S = 1) the convolution runs
    over the cached last W − 1 inputs and the scan is one step of the
    recurrence on the f32 state; the new cache is returned (new tensors:
    the one passed in is not written)."""
    ss = spec.ssm
    d = spec.d_model
    di = ss.expand * d
    nh = di // ss.head_dim
    n = ss.state_dim
    B, S, _ = x.shape

    zxbcdt = dot(x, params["in_proj"])
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    # dt and A in f32 at least (f64 stays f64); jax.nn.softplus is logaddexp(x, 0)
    f32 = torch.promote_types(x.dtype, torch.float32)
    dt = dt.to(f32) + params["dt_bias"].to(f32)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # [B,S,H]
    A = -torch.exp(params["A_log"].to(f32))  # [H]

    W = ss.conv_width
    new_cache = None
    if cache is None:
        # causal depthwise conv over xs
        xpad = F.pad(xs, (0, 0, W - 1, 0))
        xconv = sum(xpad[:, i : i + S] * params["conv_w"][i] for i in range(W))
        xconv = F.silu(xconv)
        xh = xconv.reshape(B, S, nh, ss.head_dim)
        x_dt = xh * dt[..., None].to(xh.dtype)
        y, _ = ssd_scan(x_dt, dt * A, Bm, Cm, ss.chunk)
        y = y + xh * params["D"].to(xh.dtype)[None, None, :, None]
    else:
        if S != 1:
            raise ValueError(f"the decode path takes one token a step, got S={S}")
        xcat = torch.cat([cache["conv"], xs], dim=1)  # [B, W, di]
        xconv = sum(xcat[:, i : i + 1] * params["conv_w"][i] for i in range(W))
        xconv = F.silu(xconv)
        xh = xconv.reshape(B, 1, nh, ss.head_dim)
        dA = torch.exp(dt[:, 0] * A)  # [B,H]
        inp = (xh[:, 0] * dt[:, 0, :, None]).to(f32)  # [B,H,P]
        st = cache["state"] * dA[..., None, None] \
            + inp[..., None] * Bm[:, 0, None, None, :].to(f32)
        y0 = torch.einsum("bhpn,bn->bhp", st, Cm[:, 0].to(f32))
        y = (y0[:, None] + xh * params["D"][None, None, :, None]).to(xs.dtype)
        new_cache = {"conv": xcat[:, 1:], "state": st}

    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), params["gate_norm"], spec.norm_eps)
    return dot(y, params["out_proj"]), new_cache


def init_mamba_cache(spec: ModelSpec, batch: int,
                     device: Optional[DeviceLike] = None) -> Params:
    """One Mamba block's decode cache on ``device`` (default: the first CUDA
    device): the last W − 1 conv inputs [batch, W−1, di] in the compute dtype
    and the SSM state [batch, H, P, N] in f32."""
    device = resolve_device(device)
    ss = spec.ssm
    di = ss.expand * spec.d_model
    nh = di // ss.head_dim
    return {
        "conv": torch.zeros((batch, ss.conv_width - 1, di), dtype=spec.cdtype, device=device),
        "state": torch.zeros((batch, nh, ss.head_dim, ss.state_dim), dtype=torch.float32,
                             device=device),
    }
