"""Kernel calls on ``meta`` tensors: shape propagation for the dry-run
(``launch.dryrun_lib``).

A kernel wrapper given ``meta`` tensors launches nothing and counts no
launch: it returns empty ``meta`` outputs of the kernel's shapes and tells
every active recorder the call's name and shape, from which the dry-run
reckons the kernel's work.  This is not a fallback: a ``meta`` tensor has
no values to compute on.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List

import torch

_RECORDERS: List[Callable[[str, Dict[str, Any]], None]] = []


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def record(name: str, **shape: Any) -> None:
    """Tell the active recorders of one kernel call on ``meta`` tensors."""
    for fn in _RECORDERS:
        fn(name, shape)


@contextlib.contextmanager
def recording(fn: Callable[[str, Dict[str, Any]], None]):
    """Call ``fn(name, shape)`` for every kernel call on ``meta`` tensors
    inside the block."""
    _RECORDERS.append(fn)
    try:
        yield fn
    finally:
        _RECORDERS.remove(fn)
