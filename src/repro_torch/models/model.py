"""SplittableModel: the frontend / units / head protocol over the model zoo
— port of ``repro.models.model`` for the dense family.

The HSFL engine relies only on:
  * ``init_params(gen, device)`` -> {"frontend": .., "units": <stacked [U, ...]>, "head": ..}
  * ``loss_fn(params, batch)`` / ``forward(params, batch)``
  * unit parameters stacked on axis 0, so a cut range is a slice.

The tree is the JAX package's, leaf for leaf (``units/attn/wq`` is
[U, d, H·hd]), so parameters and checkpoints pass between the packages
unchanged.  A Python loop over the units takes the place of ``lax.scan``.

Not ported yet (ROADMAP A14): the MoE, SSM, hybrid, VLM and audio
families, decoding with its caches, and ``spec.remat``
(``torch.utils.checkpoint`` does not compose with ``torch.func``).  The
sharding hooks of the JAX class (``carry_constraint``, ``moe_constraint``)
belong to the sharded engine and are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .._tree import tree_map
from . import layers as L
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


class SplittableModel:
    def __init__(self, spec: ModelSpec):
        if spec.family != "dense":
            raise NotImplementedError(
                f"{spec.name}: the {spec.family} family is ported with ROADMAP A14; "
                "the port runs the dense family"
            )
        if spec.remat:
            raise NotImplementedError(
                "spec.remat: unit rematerialisation is ported with ROADMAP A14 "
                "(torch.utils.checkpoint does not compose with torch.func)"
            )
        self.spec = spec

    # ------------------------------------------------------------------ #
    # init
    # ------------------------------------------------------------------ #
    def _init_unit(self, gen: torch.Generator) -> Params:
        spec = self.spec
        return {"attn": L.init_attention(gen, spec), "mlp": L.init_mlp(gen, spec)}

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
        units = [self._init_unit(generator) for _ in range(spec.n_units)]
        stacked = tree_map(lambda *xs: torch.stack(xs), units[0], *units[1:])
        head: Params = {"norm": torch.zeros((d,), dtype=spec.pdtype)}
        if not spec.tie_embeddings:
            head["unembed"] = L._dense_init(generator, (d, V), spec.pdtype, scale=0.02)
        params = {"frontend": frontend, "units": stacked, "head": head}
        return tree_map(lambda x: x.to(device), params)

    # ------------------------------------------------------------------ #
    # unit application (training)
    # ------------------------------------------------------------------ #
    def _apply_one_unit(self, up: Params, carry: Params) -> Params:
        spec = self.spec
        eps = spec.norm_eps
        h = carry["h"]
        a, _ = L.attention(up["attn"], L.rms_norm(h, up["attn"]["norm"], eps), spec)
        h = h + a
        o = L.mlp(up["mlp"], L.rms_norm(h, up["mlp"]["norm"], eps))
        out = dict(carry)
        out["h"] = h + o
        return out

    def apply_units(self, units: Params, carry: Params, lo: int, hi: int,
                    prefix_len: int = 0) -> Params:
        """Run units [lo, hi) on the carry; unit params are stacked on axis 0."""
        if prefix_len > 0:
            raise NotImplementedError("the prefix-LM mask (VLM) is ported with ROADMAP A14")
        if lo >= hi:
            return carry
        for up in _unstack(units, lo, hi):
            carry = self._apply_one_unit(up, carry)
        return carry

    # ------------------------------------------------------------------ #
    # frontend / head
    # ------------------------------------------------------------------ #
    def frontend_apply(self, frontend: Params, batch: Params) -> Params:
        spec = self.spec
        h = frontend["embed"][batch["tokens"].long()].to(spec.cdtype)
        return {"h": h, "aux": torch.zeros((), dtype=torch.float32, device=h.device)}

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
    def forward(self, params: Params, batch: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        carry = self.frontend_apply(params["frontend"], batch)
        carry = self.apply_units(params["units"], carry, 0, self.spec.n_units)
        return self.head_apply(params, carry), carry["aux"]

    def loss_fn(self, params: Params, batch: Params) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        return L.cross_entropy(logits, torch.clamp(labels, min=0), mask)
