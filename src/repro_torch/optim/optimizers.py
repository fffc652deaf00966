"""Minimal optimizer library — port of ``repro.optim.optimizers``.

Optimizers are (init, update) pairs over parameter trees, functional like
the JAX originals: ``update`` returns new tensors and leaves its inputs as
they are.  The HSFL memory constraint C5 prices optimizer state, so each
optimizer reports bytes-per-parameter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from .._tree import tree_leaves, tree_map

Params = Any
OptState = Any


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], OptState]
    update: Callable[[Params, Params, OptState], Tuple[Params, OptState]]
    state_bytes_per_param: float  # for constraint C5


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(params, grads, state):
        new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new, state

    return Optimizer("sgd", init, update, 0.0)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(params, grads, state):
        new_m = tree_map(lambda m, g: beta * m + g.to(m.dtype), state, grads)
        new_p = tree_map(lambda p, m: p - lr * m.to(p.dtype), params, new_m)
        return new_p, new_m

    return Optimizer("momentum", init, update, 4.0)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return {
            "m": z,
            "v": tree_map(torch.zeros_like, z),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(params, grads, state):
        t = state["t"] + 1
        m = tree_map(
            lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads
        )
        v = tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
            state["v"], grads,
        )
        tf = t.float()
        c1 = 1.0 - torch.pow(b1, tf)
        c2 = 1.0 - torch.pow(b2, tf)
        new_p = tree_map(
            lambda p, m_, v_: p
            - (lr * (m_ / c1) / (torch.sqrt(v_ / c2) + eps)).to(p.dtype),
            params, m, v,
        )
        return new_p, {"m": m, "v": v, "t": t}

    return Optimizer("adam", init, update, 8.0)


def opt_state_bytes_per_param(name: str) -> float:
    return {"sgd": 0.0, "momentum": 4.0, "adam": 8.0}[name]
