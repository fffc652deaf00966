"""SplittableModel: the frontend / units / head protocol over the model zoo
— port of ``repro.models.model`` for the dense, MoE, SSM, hybrid, VLM and
audio families.

The HSFL engine relies only on:
  * ``init_params(gen, device)`` -> {"frontend": .., "units": <stacked [U, ...]>, "head": ..}
  * ``loss_fn(params, batch)`` / ``forward(params, batch)``
  * unit parameters stacked on axis 0, so a cut range is a slice.

The tree is the JAX package's, leaf for leaf (``units/attn/wq`` is
[U, d, H·hd]; a hybrid unit's Mamba, MoE and MLP sub-layers are stacked
once more inside it, ``units/mamba/in_proj`` [U, attn_period − 1, d, ·]),
so parameters and checkpoints pass between the packages unchanged.  A
Python loop over the units takes the place of ``lax.scan``.

``moe_groups`` is the MoE dispatch's group count: 1 for one client's
tokens, set per tier by Engine B to the clients an entity pools (each
client's tokens then compete for expert capacity only among themselves).
The MoE families add ``0.01 · aux`` (the Switch load-balancing loss summed
over the layers) to the token loss.

The VLM (paligemma) runs dense units over the image-prefix embeddings
projected by ``frontend["proj"]`` and the text's token embeddings, both
scaled by √d; every attention layer sees the prefix bidirectionally
(``prefix_len``, the prefix-LM mask on the flash-attention kernels), and
the loss is on the text positions (``loss_fn`` computes no logits for the
prefix, which the JAX package computes and drops).  Its batch carries ``patch_embeds``
[B, P, d] beside the P-less tokens and labels (``configs.shapes``).

Decoding (``init_caches``, ``decode_step``) keeps one cache per unit,
stacked on axis 0 as the units are (a hybrid super-block's one attention
cache and ``attn_period − 1`` Mamba caches), and writes it in place.  The
VLM decodes as the JAX package's does: its units as dense ones over the
text's token embeddings alone (no prefix, no √d scale).

The audio model (whisper, encoder-decoder) keeps two unit stacks,
``units = {"enc": [Ue, ...], "dec": [Ud, ...]}``, cut as one layout enc ++
dec.  Its frontend projects the (stubbed) frames and adds ``enc_pos`` into
the carry's ``enc`` [B, encoder_len, d] beside the tokens' ``h``; an
encoder unit runs unroped bidirectional self-attention and a GELU MLP on
``enc``, a decoder unit causal self-attention, cross-attention to ``enc``
(its k and v projected without biases) and a GELU MLP on ``h``.  Decoding
runs the decoder units against cross caches ``xk``/``xv`` that, as in the
JAX package, start at zero and are never filled from an encoder.

Under ``spec.remat`` each unit's body runs in ``remat.remat`` under
``spec.remat_policy``, as JAX wraps ``body``, ``enc_body`` and
``dec_body`` in ``jax.checkpoint``: the backward recomputes the unit from
its input carry.  ``"outs"`` splits a dense, VLM or MoE unit into its
attention and FFN sublayers, two segments, so their outputs' sums are
saved (JAX names ``attn_out`` and ``ffn_out`` there only); the other
units run whole.  Decoding is not rematerialised.  The GSPMD hooks of the
JAX class (``carry_constraint``, ``moe_constraint``) pin XLA shardings and
have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves, tree_map
from . import layers as L
from .remat import POLICIES, remat
from .spec import ModelSpec

Params = Dict[str, Any]


def _unstack(units: Any, lo: int, hi: int) -> List[Any]:
    """Per-unit trees of the stacked units [lo, hi) (nested dicts).  One
    ``unbind`` per leaf, so the backward stacks each leaf's gradient once
    instead of scattering every unit's into a full-size zero tensor."""
    if isinstance(units, dict):
        per_key = {k: _unstack(v, lo, hi) for k, v in units.items()}
        return [{k: per_key[k][u] for k in units} for u in range(hi - lo)]
    return list(units[lo:hi].unbind(0))


def enc_dec_range(lo: int, hi: int, ne: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The audio model's layout enc ++ dec: the unit range [lo, hi) over ``ne``
    encoder units, as ((e_lo, e_hi), (d_lo, d_hi)) in each stack's own
    indices, either possibly empty."""
    return (min(lo, ne), min(hi, ne)), (max(lo, ne) - ne, max(hi, ne) - ne)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _stack(trees: List[Params]) -> Params:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


class SplittableModel:
    def __init__(self, spec: ModelSpec):
        if spec.family not in FAMILIES:
            raise ValueError(f"{spec.name}: unknown family {spec.family!r}; "
                             f"SplittableModel runs the {', '.join(FAMILIES)} families")
        if spec.remat and spec.remat_policy not in POLICIES:
            raise ValueError(f"{spec.name}: remat policy {spec.remat_policy!r}, "
                             f"one of {POLICIES}")
        self.spec = spec
        # the MoE dispatch's group count (Engine B sets it per tier)
        self.moe_groups = 1

    # ------------------------------------------------------------------ #
    # init
    # ------------------------------------------------------------------ #
    def _init_unit(self, gen: torch.Generator, kind: str) -> Params:
        spec = self.spec
        if kind in ("dense", "vlm"):
            return {"attn": L.init_attention(gen, spec), "mlp": L.init_mlp(gen, spec)}
        if kind == "moe":
            return {"attn": L.init_attention(gen, spec), "moe": L.init_moe(gen, spec)}
        if kind == "ssm":
            return {"mamba": L.init_mamba(gen, spec)}
        if kind == "enc":
            return {"attn": L.init_attention(gen, spec), "mlp": L.init_mlp(gen, spec, gelu=True)}
        if kind == "dec":
            return {"attn": L.init_attention(gen, spec),
                    "xattn": L.init_attention(gen, spec, cross=True),
                    "mlp": L.init_mlp(gen, spec, gelu=True)}
        per = spec.attn_period  # hybrid: one attention, per − 1 Mamba sub-layers
        n_moe = per // spec.moe_period
        return {
            "attn": L.init_attention(gen, spec),
            "mamba": _stack([L.init_mamba(gen, spec) for _ in range(per - 1)]),
            "moe": _stack([L.init_moe(gen, spec) for _ in range(n_moe)]),
            "mlp": _stack([L.init_mlp(gen, spec) for _ in range(per - n_moe)]),
        }

    def init_params(
        self, generator: torch.Generator, device: Optional[DeviceLike] = None
    ) -> Params:
        """Weights drawn on the CPU from ``generator`` (so a seed gives the
        same model on every device), moved to ``device`` (default: the first
        CUDA device, raising when there is none)."""
        spec = self.spec
        device = resolve_device(device)
        V, d = spec.padded_vocab, spec.d_model
        frontend: Params = {
            "embed": (torch.randn((V, d), generator=generator) * 0.02).to(spec.pdtype)
        }
        if spec.family in ("vlm", "audio"):
            frontend["proj"] = L._dense_init(generator, (d, d), spec.pdtype)
        if spec.family == "audio":
            frontend["enc_pos"] = (torch.randn((spec.encoder_len, d), generator=generator)
                                   * 0.02).to(spec.pdtype)
            stacked = {
                "enc": _stack([self._init_unit(generator, "enc")
                               for _ in range(spec.encoder_layers)]),
                "dec": _stack([self._init_unit(generator, "dec")
                               for _ in range(spec.num_layers)]),
            }
        else:
            stacked = _stack([self._init_unit(generator, spec.family)
                              for _ in range(spec.n_units)])
        head: Params = {"norm": torch.zeros((d,), dtype=spec.pdtype)}
        if not spec.tie_embeddings:
            head["unembed"] = L._dense_init(generator, (d, V), spec.pdtype, scale=0.02)
        params = {"frontend": frontend, "units": stacked, "head": head}
        return tree_map(lambda x: x.to(device), params)

    # ------------------------------------------------------------------ #
    # unit application (training)
    # ------------------------------------------------------------------ #
    def _attention(self, p: Params, h: torch.Tensor, prefix_len: int = 0) -> torch.Tensor:
        a, _ = L.attention(p, L.rms_norm(h, p["norm"], self.spec.norm_eps), self.spec,
                           prefix_len=prefix_len)
        return a

    def _moe(self, p: Params, h: torch.Tensor,
             groups: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return L.moe(p, L.rms_norm(h, p["norm"], self.spec.norm_eps), self.spec,
                     groups=self.moe_groups if groups is None else groups)

    def _mamba(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        o, _ = L.mamba_block(p, L.rms_norm(h, p["norm"], self.spec.norm_eps), self.spec)
        return o

    def _mlp(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        return L.mlp(p, L.rms_norm(h, p["norm"], self.spec.norm_eps))

    def _attn_sublayer(self, p: Params, h: torch.Tensor, prefix_len: int) -> torch.Tensor:
        """The attention half of a dense, VLM or MoE unit (JAX's ``attn_out``
        added to the residual)."""
        return h + self._attention(p, h, prefix_len)

    def _ffn_sublayer(self, up: Params, h: torch.Tensor, aux: torch.Tensor,
                      groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The FFN half of a dense, VLM or MoE unit (JAX's ``ffn_out`` added
        to the residual): (h, aux plus the MoE layer's)."""
        if self.spec.family == "moe":
            o, al = self._moe(up["moe"], h, groups)
            return h + o, aux + al
        return h + self._mlp(up["mlp"], h), aux

    def _apply_one_unit(self, up: Params, carry: Params, prefix_len: int,
                        groups: int) -> Params:
        spec = self.spec
        fam = spec.family
        h, aux = carry["h"], carry["aux"]
        if fam in ("dense", "vlm", "moe"):
            h = self._attn_sublayer(up["attn"], h, prefix_len)
            h, aux = self._ffn_sublayer(up, h, aux, groups)
        elif fam == "ssm":
            h = h + self._mamba(up["mamba"], h)
        else:  # hybrid: attention, then Mamba; MoE on every moe_period-th sub-layer
            per = spec.attn_period
            n_moe = per // spec.moe_period
            mambas = _unstack(up["mamba"], 0, per - 1)
            moes = _unstack(up["moe"], 0, n_moe)
            mlps = _unstack(up["mlp"], 0, per - n_moe)
            for j in range(per):
                if j == 0:
                    h = h + self._attention(up["attn"], h, prefix_len)
                else:
                    h = h + self._mamba(mambas.pop(0), h)
                if j % spec.moe_period == 1:
                    o, al = self._moe(moes.pop(0), h, groups)
                    aux = aux + al
                else:
                    o = self._mlp(mlps.pop(0), h)
                h = h + o
        out = dict(carry)
        out["h"] = h
        out["aux"] = aux
        return out

    def _unit(self, up: Params, carry: Params, prefix_len: int, groups: int) -> Params:
        """One unit of ``apply_units``, rematerialised under ``spec.remat``
        (the MoE group count bound now: the replay runs in the backward)."""
        spec = self.spec
        if not spec.remat:
            return self._apply_one_unit(up, carry, prefix_len, groups)
        if spec.remat_policy == "outs" and spec.family in ("dense", "vlm", "moe"):
            out = dict(carry)
            out["h"] = remat(lambda p, h: self._attn_sublayer(p, h, prefix_len),
                             up["attn"], carry["h"])
            ffn = {k: v for k, v in up.items() if k != "attn"}
            out["h"], out["aux"] = remat(
                lambda p, h, a: self._ffn_sublayer(p, h, a, groups), ffn, out["h"], out["aux"])
            return out
        return remat(lambda p, c: self._apply_one_unit(p, c, prefix_len, groups), up, carry,
                     policy=spec.remat_policy)

    def _apply_enc_unit(self, up: Params, henc: torch.Tensor) -> torch.Tensor:
        """An encoder unit: unroped bidirectional self-attention, GELU MLP."""
        p = up["attn"]
        a, _ = L.attention(p, L.rms_norm(henc, p["norm"], self.spec.norm_eps), self.spec,
                           causal=False, use_rope=False)
        henc = henc + a
        return henc + self._mlp(up["mlp"], henc)

    def _apply_dec_unit(self, up: Params, carry: Params) -> Params:
        """A decoder unit: causal self-attention, cross-attention to the
        encoder's output ``carry["enc"]`` (k and v projected without
        biases), GELU MLP."""
        spec = self.spec
        h = carry["h"]
        h = h + self._attention(up["attn"], h)
        enc, px = carry["enc"], up["xattn"]
        kv_shape = (enc.shape[0], enc.shape[1], spec.num_kv_heads, spec.hd)
        kx = L.dot(enc, px["wk"]).reshape(kv_shape)
        vx = L.dot(enc, px["wv"]).reshape(kv_shape)
        x, _ = L.attention(px, L.rms_norm(h, px["norm"], spec.norm_eps), spec,
                           kv_override=(kx, vx), use_rope=False)
        h = h + x
        out = dict(carry)
        out["h"] = h + self._mlp(up["mlp"], h)
        return out

    def apply_units(self, units: Params, carry: Params, lo: int, hi: int,
                    prefix_len: int = 0) -> Params:
        """Run units [lo, hi) on the carry; unit params are stacked on axis 0.
        ``prefix_len`` > 0: every attention layer sees the first
        ``prefix_len`` positions bidirectionally (the VLM).

        The audio model's ``{"enc", "dec"}`` stacks are one layout enc ++
        dec: [lo, hi) runs the encoder units it covers on ``carry["enc"]``,
        then the decoder units on the carry.  The boundary is the number of
        encoder units that ``units`` holds, so a tier's slice (Engine B
        applies its units [0, hi − lo)) runs exactly its own units.  The
        JAX package splits at ``spec.encoder_layers`` for a slice too, and
        its Engine B so skips the decoder units of every tier that holds
        no more than ``encoder_layers`` units (ROADMAP §C)."""
        if lo >= hi:
            return carry
        spec = self.spec
        if spec.family == "audio":
            def body(fn, up, c):
                return (remat(fn, up, c, policy=spec.remat_policy) if spec.remat
                        else fn(up, c))

            ne = tree_leaves(units["enc"])[0].shape[0]  # the encoder units held
            (e_lo, e_hi), (d_lo, d_hi) = enc_dec_range(lo, hi, ne)
            carry = dict(carry)
            for up in _unstack(units["enc"], e_lo, e_hi):
                carry["enc"] = body(self._apply_enc_unit, up, carry["enc"])
            for up in _unstack(units["dec"], d_lo, d_hi):
                carry = body(self._apply_dec_unit, up, carry)
            return carry
        groups = self.moe_groups
        for up in _unstack(units, lo, hi):
            carry = self._unit(up, carry, prefix_len, groups)
        return carry


    # ------------------------------------------------------------------ #
    # frontend / head
    # ------------------------------------------------------------------ #
    def frontend_apply(self, frontend: Params, batch: Params) -> Params:
        spec = self.spec
        h = frontend["embed"][batch["tokens"].long()].to(spec.cdtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if spec.family == "vlm":
            # the image prefix, projected, then the text; both scaled by √d
            pe = batch["patch_embeds"].to(spec.cdtype) @ frontend["proj"]
            h = (torch.cat([pe, h], dim=1) * math.sqrt(spec.d_model)).to(spec.cdtype)
        if spec.family == "audio":
            # the frames (a stub of the conv/mel frontend), projected, plus
            # the encoder's positions
            henc = (batch["frames"].to(spec.cdtype) @ frontend["proj"]
                    + frontend["enc_pos"][None].to(spec.cdtype))
            return {"h": h, "enc": henc, "aux": aux}
        return {"h": h, "aux": aux}

    def head_apply(self, params: Params, carry: Params) -> torch.Tensor:
        spec = self.spec
        h = L.rms_norm(carry["h"], params["head"]["norm"], spec.norm_eps)
        if spec.tie_embeddings:
            logits = h @ params["frontend"]["embed"].T.to(h.dtype)
        else:
            logits = h @ params["head"]["unembed"]
        if spec.padded_vocab != spec.vocab_size:
            pad = spec.padded_vocab - spec.vocab_size
            neg = torch.full(logits.shape[:-1] + (pad,), -1e30, dtype=logits.dtype,
                             device=logits.device)
            logits = torch.cat([logits[..., : spec.vocab_size], neg], dim=-1)
        return logits

    # ------------------------------------------------------------------ #
    # end-to-end loss / forward
    # ------------------------------------------------------------------ #
    @property
    def prefix_len(self) -> int:
        """The prefix-LM mask's prefix: the VLM's image tokens, else 0."""
        return self.spec.prefix_len if self.spec.family == "vlm" else 0

    def forward(self, params: Params, batch: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        carry = self.frontend_apply(params["frontend"], batch)
        carry = self.apply_units(params["units"], carry, 0, self.spec.n_units,
                                 prefix_len=self.prefix_len)
        return self.head_apply(params, carry), carry["aux"]

    def loss_fn(self, params: Params, batch: Params) -> torch.Tensor:
        carry = self.frontend_apply(params["frontend"], batch)
        carry = self.apply_units(params["units"], carry, 0, self.spec.n_units,
                                 prefix_len=self.prefix_len)
        # the VLM's loss is on the text positions only: the prefix's logits,
        # which the JAX package computes and drops, are not computed
        carry["h"] = carry["h"][:, self.prefix_len:]
        logits, aux = self.head_apply(params, carry), carry["aux"]
        labels = batch["labels"]
        mask = (labels >= 0).float()
        loss = L.cross_entropy(logits, torch.clamp(labels, min=0), mask)
        if self.spec.moe is not None:
            loss = loss + 0.01 * aux
        return loss

    # ------------------------------------------------------------------ #
    # decode (serve_step)
    # ------------------------------------------------------------------ #
    def init_caches(self, batch: int, cache_len: int,
                    device: Optional[DeviceLike] = None) -> Params:
        """Every unit's decode cache, stacked on axis 0 (the JAX tree, leaf
        for leaf): ``{"attn": ...}`` (dense, moe), ``{"mamba": ...}`` (ssm),
        both for a hybrid super-block, its Mamba caches stacked once more
        [U, attn_period − 1, ...]; the audio model's decoder units
        ``{"attn", "xk", "xv"}``, the cross caches zero [B, encoder_len, K,
        hd] in the compute dtype.  On ``device`` (default: the first CUDA
        device), but each ``index`` on the host (``L.init_attn_cache``)."""
        spec = self.spec
        device = resolve_device(device)

        def stacked(tree: Params, n: int) -> Params:
            return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous(), tree)

        unit: Params = {}
        if spec.family in ("dense", "vlm", "moe", "hybrid", "audio"):
            unit["attn"] = L.init_attn_cache(spec, batch, cache_len, device)
        if spec.family == "audio":
            for name in ("xk", "xv"):
                unit[name] = torch.zeros((batch, spec.encoder_len, spec.num_kv_heads, spec.hd),
                                         dtype=spec.cdtype, device=device)
            return stacked(unit, spec.num_layers)
        if spec.family == "ssm":
            unit["mamba"] = L.init_mamba_cache(spec, batch, device)
        if spec.family == "hybrid":
            unit["mamba"] = stacked(L.init_mamba_cache(spec, batch, device),
                                    spec.attn_period - 1)
        return stacked(unit, spec.n_units)

    def _decode_unit(self, up: Params, cache: Params, carry: Params,
                     pos: torch.Tensor) -> Tuple[Params, Params]:
        """One unit of ``decode_step``: (carry, the unit's new caches)."""
        spec = self.spec
        eps = spec.norm_eps
        fam = spec.family
        h = carry["h"]

        def attn(p, c, h):
            return L.attention(p, L.rms_norm(h, p["norm"], eps), spec, positions=pos, cache=c)

        def mamba(p, c, h):
            return L.mamba_block(p, L.rms_norm(h, p["norm"], eps), spec, cache=c)

        if fam in ("dense", "vlm", "moe"):
            a, nc = attn(up["attn"], cache["attn"], h)
            h = h + a
            h = h + (self._moe(up["moe"], h)[0] if fam == "moe" else self._mlp(up["mlp"], h))
            new = {"attn": nc}
        elif fam == "ssm":
            o, nc = mamba(up["mamba"], cache["mamba"], h)
            h = h + o
            new = {"mamba": nc}
        elif fam == "audio":
            a, nc = attn(up["attn"], cache["attn"], h)
            h = h + a
            px = up["xattn"]
            x, _ = L.attention(px, L.rms_norm(h, px["norm"], eps), spec, positions=pos,
                               kv_override=(cache["xk"], cache["xv"]), use_rope=False)
            h = h + x
            h = h + self._mlp(up["mlp"], h)
            new = {"attn": nc, "xk": cache["xk"], "xv": cache["xv"]}
        else:  # hybrid: attention, then Mamba; MoE on every moe_period-th sub-layer
            per = spec.attn_period
            n_moe = per // spec.moe_period
            mambas = _unstack(up["mamba"], 0, per - 1)
            mcaches = [tree_map(lambda x: x[i], cache["mamba"]) for i in range(per - 1)]
            moes = _unstack(up["moe"], 0, n_moe)
            mlps = _unstack(up["mlp"], 0, per - n_moe)
            new_m = []
            for j in range(per):
                if j == 0:
                    a, nca = attn(up["attn"], cache["attn"], h)
                    h = h + a
                else:
                    o, ncm = mamba(mambas.pop(0), mcaches.pop(0), h)
                    h = h + o
                    new_m.append(ncm)
                if j % spec.moe_period == 1:
                    h = h + self._moe(moes.pop(0), h)[0]
                else:
                    h = h + self._mlp(mlps.pop(0), h)
            new = {"attn": nca, "mamba": _stack(new_m)}
        out = dict(carry)
        out["h"] = h
        return out, new

    def decode_step(self, params: Params, tokens: torch.Tensor, caches: Params,
                    pos_index) -> Tuple[torch.Tensor, Params]:
        """One decode step: tokens [B, 1] int at position ``pos_index`` (a
        host int; a 0-dim tensor is read once) -> (logits [B, padded_vocab],
        the caches).  The caches are written **in place** and returned: the
        ones passed in hold the new state, and a test that needs the old
        one copies it first."""
        spec = self.spec
        h = params["frontend"]["embed"][tokens.long()].to(spec.cdtype)  # [B, 1, d]
        carry = {"h": h, "aux": torch.zeros((), dtype=torch.float32, device=h.device)}
        pos = torch.full((1,), int(pos_index), dtype=torch.int32, device=h.device)
        if spec.family == "audio":  # the decoder units
            units = _unstack(params["units"]["dec"], 0, spec.num_layers)
        else:
            units = _unstack(params["units"], 0, spec.n_units)
        for u, up in enumerate(units):
            view = tree_map(lambda x: x[u], caches)
            carry, new = self._decode_unit(up, view, carry, pos)
            _write_back(view, new)
        logits = self.head_apply(params, carry)
        return logits[:, 0], caches


def _write_back(view: Params, new: Params) -> None:
    """Copy a unit's new cache leaves into its views of the stacked caches
    (a leaf already written in place is the view's own tensor)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(view[k], v)
        elif v is not view[k]:
            view[k].copy_(v)
