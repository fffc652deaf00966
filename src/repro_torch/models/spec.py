"""Architecture specifications for the splittable model zoo — port of
``repro.models.spec``, field for field; ``pdtype`` / ``cdtype`` are torch
dtypes.  The analytic counts are plain Python and equal the JAX package's.

Every model is a *frontend* + an ordered list of *units* + a *head*.
HSFL cut layers index unit boundaries: cut vector ``c = (c_1, .., c_{M-1})``
with ``0 <= c_1 <= ... <= c_{M-1} <= n_units`` assigns units
``[c_{m-1}, c_m)`` to tier ``m`` (``c_0 = 0``, ``c_M = n_units``); the
frontend always lives with tier 1 and the head with tier M.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class MoeSpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SsmSpec:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | vgg
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    moe: Optional[MoeSpec] = None
    ssm: Optional[SsmSpec] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # hybrid (jamba): one attention layer per `attn_period` layers, MoE FFN
    # every `moe_period`-th layer (others dense MLP).
    attn_period: int = 0
    moe_period: int = 0
    # encoder-decoder (whisper): num_layers counts DECODER layers.
    encoder_layers: int = 0
    encoder_len: int = 1500
    # vlm (paligemma): number of image-prefix tokens (stub embeddings).
    prefix_len: int = 0
    # sliding window (0 = full attention). The long_500k shape forces a
    # window via `spec.with_window(...)` for quadratic-attention archs.
    window: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # rematerialize unit activations in the backward pass (activation
    # checkpointing at unit granularity — the policy C5 prices).
    remat: bool = False
    # remat policy: "full" recomputes everything inside a unit;
    # "dots" (jax dots_with_no_batch_dims_saveable) saves matmul outputs,
    # skipping the re-forward matmuls AND their TP collectives at the cost
    # of more saved-activation memory (perf lever, EXPERIMENTS.md sect. Perf).
    remat_policy: str = "full"
    # source citation (public pool assignment)
    source: str = ""

    # ------------------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def n_units(self) -> int:
        """Number of HSFL-cuttable units."""
        if self.family == "hybrid":
            return self.num_layers // self.attn_period  # super-blocks
        if self.family == "audio":
            return self.encoder_layers + self.num_layers
        return self.num_layers

    @property
    def layers_per_unit(self) -> int:
        return self.attn_period if self.family == "hybrid" else 1

    def with_window(self, window: int) -> "ModelSpec":
        return dataclasses.replace(self, window=window)

    def with_dtypes(self, param: str, compute: str) -> "ModelSpec":
        return dataclasses.replace(self, param_dtype=param, compute_dtype=compute)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    # ---------------- analytic size/FLOP accounting ------------------- #
    def unit_param_count(self, unit: int) -> int:
        """Parameters in one unit (used by the HSFL latency/memory model)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        h, k = self.num_heads, self.num_kv_heads

        def attn_params() -> int:
            p = d * h * hd + 2 * d * k * hd + h * hd * d
            if self.qkv_bias:
                p += h * hd + 2 * k * hd
            if self.qk_norm:
                p += 2 * hd
            return p + d  # + norm

        def mlp_params(width: int) -> int:
            return 3 * d * width + d  # swiglu + norm

        def moe_params(ms: MoeSpec) -> int:
            return d * ms.num_experts + ms.num_experts * 3 * d * ff + d

        def mamba_params(ss: SsmSpec) -> int:
            di = ss.expand * d
            nh = di // ss.head_dim
            in_p = d * (2 * di + 2 * ss.state_dim + nh)
            return in_p + di * ss.conv_width + 3 * nh + di + di * d + d

        if self.family in ("dense", "vlm"):
            return attn_params() + mlp_params(ff)
        if self.family == "moe":
            return attn_params() + moe_params(self.moe)
        if self.family == "ssm":
            return mamba_params(self.ssm)
        if self.family == "hybrid":
            per = self.attn_period
            n_moe = per // self.moe_period
            n_mlp = per - n_moe
            return (
                attn_params()
                + (per - 1) * mamba_params(self.ssm)
                + n_moe * moe_params(self.moe)
                + n_mlp * mlp_params(ff)
            )
        if self.family == "audio":
            # encoder unit == decoder unit + cross-attention block
            enc = attn_params() + mlp_params(ff)
            dec = 2 * attn_params() + mlp_params(ff)
            return dec if unit >= self.encoder_layers else enc
        raise ValueError(self.family)

    def frontend_param_count(self) -> int:
        return self.padded_vocab * self.d_model

    def head_param_count(self) -> int:
        p = self.d_model
        if not self.tie_embeddings:
            p += self.padded_vocab * self.d_model
        return p

    def total_param_count(self) -> int:
        return (
            self.frontend_param_count()
            + sum(self.unit_param_count(u) for u in range(self.n_units))
            + self.head_param_count()
        )

    def active_param_count(self) -> int:
        """Parameters active per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.total_param_count()
        ms = self.moe
        d, ff = self.d_model, self.d_ff
        inactive_per_moe = (ms.num_experts - ms.top_k) * 3 * d * ff
        if self.family == "moe":
            n_moe_layers = self.num_layers
        elif self.family == "hybrid":
            n_moe_layers = self.num_layers // self.moe_period
        else:
            n_moe_layers = 0
        return self.total_param_count() - n_moe_layers * inactive_per_moe

    def unit_flops_fwd(self, unit: int, batch: int, seq: int) -> float:
        """Forward FLOPs of one unit on [batch, seq] tokens (matmul-dominant)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        h, k = self.num_heads, self.num_kv_heads
        T = batch * seq
        ctx = min(seq, self.window) if self.window else seq

        def attn_flops(s_kv: int) -> float:
            proj = 2.0 * T * (d * h * hd + 2 * d * k * hd + h * hd * d)
            scores = 2.0 * batch * seq * s_kv * h * hd * 2
            return proj + scores

        def mlp_flops(width: int) -> float:
            return 2.0 * T * 3 * d * width

        def moe_flops(ms: MoeSpec) -> float:
            return 2.0 * T * d * ms.num_experts + ms.top_k * mlp_flops(ff)

        def mamba_flops(ss: SsmSpec) -> float:
            di = ss.expand * d
            nh = di // ss.head_dim
            proj = 2.0 * T * d * (2 * di + 2 * ss.state_dim + nh) + 2.0 * T * di * d
            q = ss.chunk
            nchunks = max(seq // q, 1)
            intra = 2.0 * batch * nchunks * q * q * (ss.state_dim + ss.head_dim) * nh
            inter = 4.0 * batch * nchunks * q * nh * ss.head_dim * ss.state_dim
            return proj + intra + inter

        if self.family in ("dense", "vlm"):
            return attn_flops(ctx) + mlp_flops(ff)
        if self.family == "moe":
            return attn_flops(ctx) + moe_flops(self.moe)
        if self.family == "ssm":
            return mamba_flops(self.ssm)
        if self.family == "hybrid":
            per = self.attn_period
            n_moe = per // self.moe_period
            return (
                attn_flops(ctx)
                + (per - 1) * mamba_flops(self.ssm)
                + n_moe * moe_flops(self.moe)
                + (per - n_moe) * mlp_flops(ff)
            )
        if self.family == "audio":
            if unit < self.encoder_layers:
                Te = batch * self.encoder_len
                return (
                    2.0 * Te * 4 * d * h * hd
                    + 2.0 * batch * self.encoder_len**2 * h * hd * 2
                    + 2.0 * Te * 3 * d * ff
                )
            cross = 2.0 * T * 4 * d * h * hd + 2.0 * batch * seq * self.encoder_len * h * hd * 2
            return attn_flops(ctx) + cross + mlp_flops(ff)
        raise ValueError(self.family)

    def unit_act_bytes(self, batch: int, seq: int, bytes_per: int = 2) -> int:
        """Bytes of the activation tensor crossing a cut boundary."""
        return batch * seq * self.d_model * bytes_per
