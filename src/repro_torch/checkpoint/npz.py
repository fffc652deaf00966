"""Flat-npz checkpointing of parameter trees + HSFL schedule metadata — port
of ``repro.checkpoint.npz``.

Layout (the JAX package's, so a checkpoint written by either package loads
in the other): one ``.npz`` holding every leaf under its '/'-joined key path
(``units/0/w``) plus a JSON entry ``__meta__`` (step, tier plan, arbitrary
user dict).  Empty containers (VGG's ``frontend`` / ``head``) hold no leaf
and write no key.  A whole training state (a dataclass such as
``core.engine.TrainState``) is written as the JAX package writes its pytree
node: its fields under ``0``, ``1``, ``2`` (params, optimizer state, step).
Restores exactly: structure is rebuilt from the key paths against a
template tree, so dtype/shape mismatches fail loudly.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.convert import params_to_numpy


def _walk(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs; None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for i, f in enumerate(dataclasses.fields(tree)):
            yield from _walk(getattr(tree, f.name), prefix + (str(i),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: params_to_numpy(v) for k, v in _walk(tree)}


def save_checkpoint(
    path: str,
    tree: Any,
    step: int = 0,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    payload = _flatten(tree)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"step": int(step), **(meta or {})}).encode(), dtype=np.uint8
    )
    # a bare filename has dirname '' — normalize to '.' so makedirs,
    # mkstemp and the directory fsync all address the CWD
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    # atomic + durable write: tmp in the SAME directory (os.replace must
    # not cross filesystems), fsync the file so the rename never installs
    # a partially-flushed payload, then fsync the directory so the rename
    # itself survives a crash — a reader of ``path`` sees either the old
    # complete checkpoint or the new complete one, never a torn file
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def check_schedule_meta(
    meta: Dict[str, Any],
    expect_cuts: Optional[Any] = None,
    expect_intervals: Optional[Any] = None,
) -> None:
    """Fail loudly when a checkpoint's saved HSFL schedule metadata does not
    match the schedule the caller is resuming under.

    Resuming a tier-partitioned state under a different cut vector
    silently mis-assigns units to tiers even when every leaf shape lines
    up (Engine A states are client-stacked full models, so no shape check
    catches it).
    """
    for name, expect in (("cuts", expect_cuts), ("intervals", expect_intervals)):
        if expect is None:
            continue
        saved = meta.get(name)
        if saved is None:
            raise ValueError(
                f"checkpoint has no {name!r} metadata to verify against "
                f"expected {tuple(int(v) for v in expect)}; re-save with "
                f"meta={{{name!r}: ...}} or load without the expectation"
            )
        saved_t = tuple(int(v) for v in saved)
        expect_t = tuple(int(v) for v in expect)
        if saved_t != expect_t:
            raise ValueError(
                f"checkpoint was saved under {name}={saved_t} but resume "
                f"requests {name}={expect_t}; migrate the tier assignment "
                f"explicitly or resume at the saved schedule"
            )


def load_checkpoint(
    path: str,
    template: Any,
    expect_cuts: Optional[Any] = None,
    expect_intervals: Optional[Any] = None,
) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``template``; returns (tree, step, meta).

    Leaves come back as tensors with each template leaf's dtype and device.
    ``expect_cuts`` / ``expect_intervals`` assert the saved schedule
    metadata matches the resume schedule (``check_schedule_meta``).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        check_schedule_meta(meta, expect_cuts, expect_intervals)
        saved_cuts = meta.get("cuts")

        def restore(tree, prefix):
            if isinstance(tree, dict):
                return {k: restore(v, prefix + (str(k),)) for k, v in tree.items()}
            if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
                return type(tree)(*(restore(getattr(tree, f.name), prefix + (str(i),))
                                    for i, f in enumerate(dataclasses.fields(tree))))
            if isinstance(tree, (list, tuple)):
                return type(tree)(
                    restore(v, prefix + (str(i),)) for i, v in enumerate(tree)
                )
            if tree is None:
                return None
            key = "/".join(prefix)
            if key not in z:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = z[key]
            if isinstance(tree, int):  # a host-side counter (TrainState.step)
                return int(arr)
            if arr.shape != tuple(tree.shape):
                hint = (
                    f" (checkpoint metadata says cuts={tuple(saved_cuts)}; a "
                    f"template built for a different cut vector mis-shapes "
                    f"tier-stacked leaves — pass expect_cuts= to catch this "
                    f"up front)"
                    if saved_cuts is not None
                    else ""
                )
                raise ValueError(
                    f"{key}: shape {arr.shape} != template {tuple(tree.shape)}{hint}"
                )
            return torch.from_numpy(arr).to(device=tree.device, dtype=tree.dtype)

        tree = restore(template, ())
    step = int(meta.pop("step", 0))
    return tree, step, meta
