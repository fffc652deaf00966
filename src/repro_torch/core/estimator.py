"""Estimation of the convergence-bound constants (β, σ_l², G_l², ϑ) — port
of ``repro.core.estimator``.

Follows the approach of Wang et al. [28] (as cited in Sec. VI): the constants
are estimated from a short probe run of the actual training system —

* G_l²  : running mean of per-unit squared gradient norms (per client),
* σ_l²  : running mean of the per-unit across-client variance of the
          stochastic gradients (unbiased per Assumption 2's structure),
* β     : max ratio ‖∇̄f(w_t) − ∇̄f(w_{t-1})‖ / ‖w_t − w_{t-1}‖ over probe
          steps (a smoothness lower-envelope estimate),
* ϑ     : f(w_0) − f̂* with f̂* the best loss seen (refined as training runs).

All quantities are computed on the client-stacked Engine-A layout, so the
estimator can run inside the production training loop at negligible cost.
The norms are f32 sums on the tensors' device; the running accumulators
are NumPy float64, as in the JAX package.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from .._device import DeviceLike
from .._tree import tree_leaves, tree_map
from .convergence import HyperSpec

Params = Dict[str, Any]


def _sq_sum(x: torch.Tensor, first: int) -> torch.Tensor:
    """f32 sum of squares of ``x`` over every axis from ``first`` on."""
    return torch.sum(torch.square(x.float()), dim=tuple(range(first, x.ndim)))


def _unit_sq_norms(tree: Params, n_units: int) -> torch.Tensor:
    """Per-unit squared norms of a (client-stacked) tree: returns [N, U].

    ``frontend`` folds into unit 0 and ``head`` into unit U−1, mirroring the
    paper's convention that cut layers never separate the embedding from the
    first block nor the head from the last.  Units are a list (VGG) or
    stacked on the axis after the client axis (the dense transformers); the
    audio model's ``{"enc", "dec"}`` stacks come with ROADMAP A14.
    """
    units = tree["units"]
    if isinstance(units, (list, tuple)):
        per = [sum(_sq_sum(x, 1) for x in tree_leaves(u)) for u in units]
        sq = torch.stack(per, dim=1)  # [N, U]
    elif isinstance(units, dict) and set(units) == {"enc", "dec"}:
        raise NotImplementedError("the audio model's unit stacks come with ROADMAP A14")
    else:
        tot = None
        for x in tree_leaves(units):
            s = _sq_sum(x, 2)
            tot = s if tot is None else tot + s
        sq = tot
    assert sq.shape[1] == n_units, (sq.shape, n_units)

    def extra_sq(part) -> Optional[torch.Tensor]:  # [N]
        if part is None or not tree_leaves(part):
            return None
        return sum(_sq_sum(x, 1) for x in tree_leaves(part))

    sq = sq.clone()
    front, head = extra_sq(tree.get("frontend")), extra_sq(tree.get("head"))
    if front is not None:
        sq[:, 0] += front
    if head is not None:
        sq[:, -1] += head
    return sq


def _unit_sq_norms_mean_tree(tree: Params, n_units: int) -> torch.Tensor:
    """[U] squared norms of a non-stacked tree (client axis already reduced)."""
    stacked = tree_map(lambda x: x[None], tree)
    return _unit_sq_norms(stacked, n_units)[0]


def _global_sq_norm(tree) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclass
class HyperEstimator:
    """Accumulates probe-run statistics into a HyperSpec.

    ``window=None`` (the default) keeps running sums over the whole probe —
    the offline estimation mode.  ``window=W`` keeps only the last W
    observations in ring buffers, the online mode an adaptive controller
    consumes: the emitted ``HyperSpec`` tracks the *current* regime instead
    of a lifetime average, and stale rounds age out as the window wraps.
    """

    n_units: int
    num_clients: int
    gamma: float
    window: Optional[int] = None

    def __post_init__(self):
        if self.window is not None and self.window < 2:
            raise ValueError(
                f"window must be >= 2 (beta needs consecutive observations), "
                f"got {self.window}"
            )
        self._g2_sum = np.zeros(self.n_units)
        self._var_sum = np.zeros(self.n_units)
        self._steps = 0
        self._beta = 0.0
        self._prev_mean_grad: Optional[Params] = None
        self._prev_params: Optional[Params] = None
        self._f0: Optional[float] = None
        self._fmin = float("inf")
        if self.window is not None:
            self._g2_hist = deque(maxlen=self.window)    # [U] per round
            self._var_hist = deque(maxlen=self.window)   # [U] per round
            self._beta_hist = deque(maxlen=self.window)  # ratio or None
            self._loss_hist = deque(maxlen=self.window)  # float

    # ------------------------------------------------------------------ #
    def observe(self, params: Params, grads: Params, loss: float) -> None:
        """Feed one probe round: client-stacked params/grads + mean loss."""
        sq = _host(_unit_sq_norms(grads, self.n_units))  # [N, U] f32
        g2_round = sq.mean(axis=0)
        self._g2_sum += g2_round
        mean_grad = tree_map(lambda g: torch.mean(g.float(), dim=0, keepdim=True), grads)
        # Var_n[g] per unit = E_n ||g_n||² − ||ḡ||² (per-unit decomposition)
        mean_sq = _host(_unit_sq_norms(mean_grad, self.n_units))[0]
        var_round = np.maximum(g2_round - mean_sq, 0.0)
        self._var_sum += var_round
        ratio: Optional[float] = None
        if self._prev_mean_grad is not None:
            dg = tree_map(lambda a, b: a - b, mean_grad, self._prev_mean_grad)
            dw = tree_map(lambda a, b: a - b, params, self._prev_params)
            num = float(torch.sqrt(_global_sq_norm(dg)))
            den = float(torch.sqrt(_global_sq_norm(dw)))
            if den > 1e-12:
                ratio = num / den
                self._beta = max(self._beta, ratio)
        self._prev_mean_grad = mean_grad
        # the engine's updates are functional, so holding the tensors keeps
        # this round's values
        self._prev_params = tree_map(lambda x: x, params)
        loss = float(loss)
        if self._f0 is None:
            self._f0 = loss
        self._fmin = min(self._fmin, loss)
        self._steps += 1
        if self.window is not None:
            self._g2_hist.append(g2_round)
            self._var_hist.append(var_round)
            self._beta_hist.append(ratio)
            self._loss_hist.append(loss)

    # ------------------------------------------------------------------ #
    def hyperspec(self, fstar_margin: float = 0.5) -> HyperSpec:
        if self._steps == 0:
            raise ValueError("no probe rounds observed")
        if self.window is not None:
            G2 = np.mean(np.stack(tuple(self._g2_hist)), axis=0)
            sigma2 = np.mean(np.stack(tuple(self._var_hist)), axis=0)
            ratios = [b for b in self._beta_hist if b is not None]
            beta = max(max(ratios, default=0.0), 1e-3)
            f0 = self._loss_hist[0]
            theta0 = max(f0 - min(self._loss_hist), fstar_margin * f0, 1e-3)
            return HyperSpec(
                gamma=self.gamma,
                beta=beta,
                theta0=float(theta0),
                num_clients=self.num_clients,
                sigma2=sigma2,
                G2=G2,
            )
        G2 = self._g2_sum / self._steps
        sigma2 = self._var_sum / self._steps
        theta0 = max(self._f0 - self._fmin, fstar_margin * self._f0, 1e-3)
        beta = max(self._beta, 1e-3)
        return HyperSpec(
            gamma=self.gamma,
            beta=beta,
            theta0=float(theta0),
            num_clients=self.num_clients,
            sigma2=sigma2,
            G2=G2,
        )


def estimate_from_probe(
    model,
    plan,
    opt,
    batches: Iterable[Params],
    generator: torch.Generator,
    gamma: float,
    device: Optional[DeviceLike] = None,
) -> HyperSpec:
    """Convenience: run Engine A for the probe batches and estimate.

    The initial state is ``init_state_a``'s from ``generator`` on ``device``
    (default: the first CUDA device, raising when there is none); batch
    leaves (NumPy arrays or tensors) are moved there."""
    from .engine import build_train_step_a, init_state_a

    state = init_state_a(model, plan, opt, generator, device)
    dev = tree_leaves(state.params)[0].device
    est = HyperEstimator(plan.n_units, plan.num_clients, gamma)
    grad_fn = vmap(grad_and_value(model.loss_fn))
    step = build_train_step_a(model, plan, opt)
    for batch in batches:
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        grads, losses = grad_fn(state.params, batch)
        est.observe(state.params, grads, float(torch.mean(losses)))
        state, _ = step(state, batch)
    return est.hyperspec()
