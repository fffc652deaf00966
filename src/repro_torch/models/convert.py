"""Carry parameter trees across packages as numpy arrays.

The JAX package and the port draw different random numbers from one seed,
so every parity test initialises the model once, in the JAX package, turns
the tree into numpy arrays and hands it to the port through
``params_from_numpy``.  Trees are nested dicts, lists and tuples; the
structure (including empty ``frontend`` / ``head`` dicts) is kept as it is,
so Engine B's state — a list of per-tier trees — crosses as one tree.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: Optional[DeviceLike] = None) -> Any:
    """numpy (or array-like) leaves -> torch tensors on ``device`` (default:
    the first CUDA device, raising when there is none)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """torch tensor (or array-like) leaves -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
