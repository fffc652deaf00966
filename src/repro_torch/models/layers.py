"""Neural-net primitives — port of ``repro.models.layers``, the dense subset.

Pure functions over parameter dicts (no module framework: the HSFL engine
slices, stacks and aggregates raw parameter trees).  Initializers draw from
an explicit ``torch.Generator``.  Shapes follow the JAX package's
[batch, seq, ...] row-major conventions.

Self-attention runs through the flash-attention kernels
(``kernels.swa_attention``) at every sequence length and at the spec's
window; the JAX package's ``_sdpa`` / ``_blockwise_sdpa`` split computes the
same function and has no counterpart here.  The QKV, output and MLP
products stay ``torch.matmul``, as the JAX package leaves them to XLA.

Not ported yet (ROADMAP A14): the KV cache and decode path (serving), the
cross-attention ``kv_override`` (audio), ``prefix_len > 0`` (the VLM's
prefix-LM mask), bidirectional attention, ``moe`` and ``mamba_block``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.swa_attention import swa_attention
from .spec import ModelSpec

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(tuple(shape), generator=gen) * s).to(dtype)


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
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
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
    if cross:
        raise NotImplementedError("cross-attention (audio) is ported with ROADMAP A14")
    d, hd = spec.d_model, spec.hd
    h, k = spec.num_heads, spec.num_kv_heads
    p: Params = {
        "wq": _dense_init(gen, (d, h * hd), spec.pdtype),
        "wk": _dense_init(gen, (d, k * hd), spec.pdtype),
        "wv": _dense_init(gen, (d, k * hd), spec.pdtype),
        "wo": _dense_init(gen, (h * hd, d), spec.pdtype),
        "norm": torch.zeros((d,), dtype=spec.pdtype),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=spec.pdtype)
        p["bk"] = torch.zeros((k * hd,), dtype=spec.pdtype)
        p["bv"] = torch.zeros((k * hd,), dtype=spec.pdtype)
    if spec.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=spec.pdtype)
        p["k_norm"] = torch.zeros((hd,), dtype=spec.pdtype)
    return p


def attention(
    params: Params,
    x: torch.Tensor,  # [B, S, d]
    spec: ModelSpec,
    *,
    causal: bool = True,
    prefix_len: int = 0,
    cache: Optional[Params] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Causal GQA self-attention sub-layer (pre-norm + residual by the caller).

    Rope positions are 0..S-1 and the mask is causal over them, optionally
    within ``spec.window``.
    """
    if cache is not None:
        raise NotImplementedError("the KV cache and decode path come with serving (ROADMAP A14)")
    if kv_override is not None:
        raise NotImplementedError("cross-attention (audio) is ported with ROADMAP A14")
    if prefix_len > 0:
        raise NotImplementedError("the prefix-LM mask (VLM) is ported with ROADMAP A14")
    if not causal:
        raise NotImplementedError("bidirectional attention (audio encoder) is ported with ROADMAP A14")
    B, S, d = x.shape
    h, k_heads, hd = spec.num_heads, spec.num_kv_heads, spec.hd
    positions = torch.arange(S, device=x.device)

    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(B, S, h, hd)
    kx = x @ params["wk"]
    vx = x @ params["wv"]
    if "bk" in params:
        kx = kx + params["bk"]
        vx = vx + params["bv"]
    kx = kx.reshape(B, S, k_heads, hd)
    vx = vx.reshape(B, S, k_heads, hd)

    if spec.qk_norm and "q_norm" in params:
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
        kx = rms_norm(kx, params["k_norm"], spec.norm_eps)
    q = rope(q, positions, spec.rope_theta)
    kx = rope(kx, positions, spec.rope_theta)

    out = swa_attention(q, kx, vx, spec.window)
    return out.reshape(B, S, h * hd) @ params["wo"], None


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
        return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ params["w1"], approximate="tanh") @ params["w2"]


def moe(*args, **kwargs):
    """Top-k MoE with capacity — ported with ROADMAP A14 (the MoE family)."""
    raise NotImplementedError("moe is ported with ROADMAP A14 (the MoE family)")


def mamba_block(*args, **kwargs):
    """Mamba2 SSD block — ported with ROADMAP A14 (the SSM and hybrid families)."""
    raise NotImplementedError("mamba_block is ported with ROADMAP A14 (SSM and hybrid)")
