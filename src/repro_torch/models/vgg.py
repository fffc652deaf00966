"""VGG-16 (the paper's experimental model, Sec. VII) — port of
``repro.models.vgg``.

Units are the 13 conv layers + 3 FC layers = 16 cut-indexable units, kept as
a python list.  The parameter tree is the JAX package's own,
``{"frontend": {}, "units": [{"w", "b"}…], "head": {}}``, with conv weights
in HWIO and activations in NHWC at every public function, so parameters and
checkpoints pass between the two packages unchanged.  Only the
``F.conv2d`` / ``F.max_pool2d`` calls see NCHW / OIHW.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from .layers import cross_entropy

Params = Dict[str, Any]


@dataclass(frozen=True)
class VggSpec:
    name: str
    conv_channels: Tuple[int, ...]
    pool_after: Tuple[int, ...]  # conv indices followed by a 2x2 max-pool
    fc_dims: Tuple[int, ...]
    image_size: int
    in_channels: int
    num_classes: int
    family: str = "vgg"
    param_dtype: str = "float32"

    @property
    def n_units(self) -> int:
        return len(self.conv_channels) + len(self.fc_dims)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def _feature_hw(self) -> int:
        hw = self.image_size
        for _ in self.pool_after:
            hw //= 2
        return hw

    def unit_io(self, unit: int) -> Tuple[int, int, int]:
        """(in_dim, out_dim, spatial_hw_after) for analytic cost accounting."""
        ncv = len(self.conv_channels)
        if unit < ncv:
            cin = self.in_channels if unit == 0 else self.conv_channels[unit - 1]
            pools = sum(1 for p in self.pool_after if p <= unit)
            hw_out = self.image_size // (2**pools)
            return cin, self.conv_channels[unit], hw_out
        fi = unit - ncv
        fhw = self._feature_hw()
        in_dim = (
            self.conv_channels[-1] * fhw * fhw if fi == 0 else self.fc_dims[fi - 1]
        )
        return in_dim, self.fc_dims[fi], 1

    # analytic per-unit accounting for the HSFL latency model ------------- #
    def unit_param_count(self, unit: int) -> int:
        ncv = len(self.conv_channels)
        cin, cout, _ = self.unit_io(unit)
        if unit < ncv:
            return 9 * cin * cout + cout
        return cin * cout + cout

    def unit_flops_fwd(self, unit: int, batch: int, seq: int = 1) -> float:
        ncv = len(self.conv_channels)
        cin, cout, hw = self.unit_io(unit)
        if unit < ncv:
            pools_before = sum(1 for p in self.pool_after if p < unit)
            hw_in = self.image_size // (2**pools_before)
            return 2.0 * batch * hw_in * hw_in * 9 * cin * cout
        return 2.0 * batch * cin * cout

    def unit_act_bytes(self, batch: int, seq: int = 1, bytes_per: int = 4) -> int:
        # conservative: activation at unit boundaries varies; use max conv map
        return batch * self.image_size * self.image_size * self.conv_channels[0] * bytes_per

    def unit_act_bytes_at(self, unit: int, batch: int, bytes_per: int = 4) -> int:
        ncv = len(self.conv_channels)
        if unit < ncv:
            _, cout, hw = self.unit_io(unit)
            return batch * hw * hw * cout * bytes_per
        _, dout, _ = self.unit_io(unit)
        return batch * dout * bytes_per

    def frontend_param_count(self) -> int:
        return 0

    def head_param_count(self) -> int:
        return 0

    def total_param_count(self) -> int:
        return sum(self.unit_param_count(u) for u in range(self.n_units))

    def active_param_count(self) -> int:
        return self.total_param_count()


class VggModel:
    def __init__(self, spec: VggSpec):
        self.spec = spec

    def init_params(
        self, generator: torch.Generator, device: Optional[DeviceLike] = None
    ) -> Params:
        """He-normal weights drawn on the CPU from ``generator`` (so a seed
        gives the same model on every device), zero biases, moved to
        ``device`` (default: the first CUDA device, raising when there is
        none)."""
        spec = self.spec
        device = resolve_device(device)
        units: List[Params] = []
        ncv = len(spec.conv_channels)
        for u in range(spec.n_units):
            cin, cout, _ = spec.unit_io(u)
            if u < ncv:
                shape, fan_in = (3, 3, cin, cout), 9 * cin
            else:
                shape, fan_in = (cin, cout), cin
            w = torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)
            units.append({
                "w": w.to(device=device, dtype=spec.pdtype),
                "b": torch.zeros((cout,), dtype=spec.pdtype, device=device),
            })
        return {"frontend": {}, "units": units, "head": {}}

    def apply_units(self, units, carry: Params, lo: int, hi: int, **_) -> Params:
        """Units [lo, hi) on ``carry["h"]`` (NHWC images or [b, d] features)."""
        spec = self.spec
        ncv = len(spec.conv_channels)
        h = carry["h"]
        if h.ndim == 4:
            h = h.permute(0, 3, 1, 2)  # NHWC -> NCHW for F.conv2d
        for u in range(lo, hi):
            p = units[u]
            if u < ncv:
                # "SAME" 3x3 stride 1 == padding 1; HWIO -> OIHW
                h = F.conv2d(h, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)
                h = F.relu(h)
                if u in spec.pool_after:
                    h = F.max_pool2d(h, 2)
            else:
                if u == ncv:
                    # flatten in NHWC order: the first FC weight's rows are
                    # laid out (h, w, c), as in the JAX package
                    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
                h = h @ p["w"] + p["b"]
                if u < spec.n_units - 1:
                    h = F.relu(h)
        if h.ndim == 4:
            h = h.permute(0, 2, 3, 1)  # back to NHWC
        out = dict(carry)
        out["h"] = h
        return out

    def frontend_apply(self, frontend, batch) -> Params:
        images = batch["images"]
        return {"h": images, "aux": torch.zeros((), device=images.device)}

    def head_apply(self, params, carry) -> torch.Tensor:
        return carry["h"]

    def forward(self, params, batch):
        carry = self.frontend_apply(params["frontend"], batch)
        carry = self.apply_units(params["units"], carry, 0, self.spec.n_units)
        return self.head_apply(params, carry), carry["aux"]

    def loss_fn(self, params, batch) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        return cross_entropy(logits, batch["labels"])

    def accuracy(self, params, batch) -> torch.Tensor:
        logits, _ = self.forward(params, batch)
        return torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())


def build_model(spec):
    """Factory accepting either a ``ModelSpec`` or a ``VggSpec``."""
    if isinstance(spec, VggSpec):
        return VggModel(spec)
    from .model import SplittableModel
    from .spec import ModelSpec

    if not isinstance(spec, ModelSpec):
        raise TypeError(f"{type(spec).__module__}.{type(spec).__name__}: "
                        "build_model takes the port's ModelSpec or VggSpec")
    return SplittableModel(spec)
