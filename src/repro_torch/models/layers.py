"""Neural-net primitives (port of ``repro.models.layers``; this slice carries
only what the VGG path needs)."""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean token cross-entropy. logits [..., V], labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
