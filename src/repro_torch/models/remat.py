"""Unit rematerialisation — the port's counterpart of ``jax.checkpoint``
around a unit's body (``SplittableModel.apply_units`` under
``spec.remat``).

``remat(fn, *args, policy=)`` returns ``fn(*args)`` and keeps for the
backward only the tensors of ``args`` (a unit's parameters and its input
carry), plus what the policy saves; the backward runs ``fn`` again on them
through ``torch.func.vjp`` and returns its cotangents.  It is one
``torch.autograd.Function`` in the functorch style (``setup_context``,
``generate_vmap_rule``), so it composes with Engine A's
``vmap(grad_and_value)``, the sharded engine's and Engine B's
``torch.autograd.grad`` around ``vmap``s.  ``torch.utils.checkpoint``
does not: its saved-tensor hooks raise under ``torch.func.grad``.

The policies are JAX's (``repro.models.model.SplittableModel._remat``):

* ``"full"`` saves the inputs only; the backward recomputes the whole body.
* ``"dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) also saves the
  output of every weight product without batch dimensions, the products
  that ``layers.dot`` computes.  The forward records them in order; the
  replay's ``layers.dot`` returns each recorded output through a Function
  that differentiates as ``x @ w``, so the replay does not redo them.
* ``"outs"`` (JAX's ``save_only_these_names("attn_out", "ffn_out")``) is
  the caller's: ``apply_units`` splits a dense, VLM or MoE unit into two
  ``"full"`` segments, the attention sublayer and then the FFN sublayer,
  so the sublayer outputs' sums are saved between them; the other
  families have no such names, and there ``"outs"`` is ``"full"``, as in
  JAX.

The numbers never depend on the policy: the body runs the same operations
on the same inputs, so the forward is bit for bit the body's, and so is
the backward wherever the body's own arithmetic repeats (the CPU; on the
card the MoE combine's atomic scatter-add need not).  A body that reads
state beyond its arguments must bind it before the call, since the replay
runs in the backward.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import layers as L

POLICIES = ("full", "outs", "dots")


class _Segment:
    """A body over flat tensor inputs: ``fn`` with its arguments' tree
    spec and their non-tensor leaves, a non-tensor input of ``_Remat``."""

    def __init__(self, fn: Callable, leaves: Sequence[Any], spec, policy: str):
        self.fn = fn
        self.spec = spec
        self.leaves = list(leaves)
        self.slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        self.policy = policy
        self.out_spec = None
        self.n_out = 0

    def run(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        leaves = list(self.leaves)
        for i, t in zip(self.slots, tensors):
            leaves[i] = t
        out = self.fn(*tree_unflatten(leaves, self.spec))
        flat, self.out_spec = tree_flatten(out)
        if not all(isinstance(t, torch.Tensor) for t in flat):
            raise TypeError("a rematerialised body returns a tree of tensors")
        self.n_out = len(flat)
        return flat


class _Record:
    """``layers.dot`` in a ``"dots"`` segment's forward: each product's
    output is kept, in call order."""

    def __init__(self):
        self.saved: List[torch.Tensor] = []

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = x @ w
        self.saved.append(y)
        return y


class _Replay:
    """``layers.dot`` in a ``"dots"`` segment's replay: the recorded
    outputs in call order, each differentiable as ``x @ w``."""

    def __init__(self, saved: Sequence[torch.Tensor]):
        self.saved = list(saved)
        self.next = 0

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = self.saved[self.next]
        self.next += 1
        return _SavedDot.apply(x, w, y)


class _SavedDot(torch.autograd.Function):
    """y (recorded as ``x @ w``), differentiated as ``x @ w``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        gx = g2.mm(w.t()).reshape(x.shape)
        gw = x2.t().mm(g2)
        return gx, gw, None


class _Remat(torch.autograd.Function):
    """outputs = body(inputs), saving the inputs (and under ``"dots"`` the
    recorded products, returned as extra outputs without gradient) and
    recomputing the body in the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(seg: _Segment, *tensors):
        tape = _Record() if seg.policy == "dots" else None
        with L.dot_tape(tape) if tape else contextlib.nullcontext():
            out = seg.run(tensors)
        # an input passed through (a dense unit's aux) leaves as a view:
        # autograd saves no input that is returned as it is
        ins = {id(t) for t in tensors}
        out = [t.view_as(t) if id(t) in ins else t for t in out]
        return (*out, *(tape.saved if tape else ()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        seg, *tensors = inputs
        ctx.seg = seg
        ctx.n_in = len(tensors)
        dots = output[seg.n_out:]
        ctx.save_for_backward(*tensors, *dots)
        ctx.mark_non_differentiable(*dots)

    @staticmethod
    def backward(ctx, *grads):
        seg = ctx.seg
        saved = ctx.saved_tensors
        tensors, dots = saved[:ctx.n_in], saved[ctx.n_in:]

        def replay(*xs):
            if seg.policy != "dots":
                return tuple(seg.run(xs))
            with L.dot_tape(_Replay(dots)):
                return tuple(seg.run(xs))

        # the replay's own graph only: under torch.func.grad the backward
        # runs with create_graph, which would keep every unit's replay alive
        _, vjp = torch.func.vjp(replay, *(t.detach() for t in tensors))
        return (None, *vjp(tuple(g.detach() for g in grads[:seg.n_out])))


def remat(fn: Callable, *args: Any, policy: str = "full") -> Any:
    """``fn(*args)``, rematerialised in the backward under ``policy``
    (``"outs"`` is ``"full"`` here: see the module docstring).  ``args``
    and the result are trees of tensors (nested dicts, lists, tuples);
    non-tensor leaves of ``args`` are passed through as they are."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r}: one of {POLICIES}")
    leaves, spec = tree_flatten(args)
    seg = _Segment(fn, leaves, spec, policy)
    tensors = [leaves[i] for i in seg.slots]
    out = _Remat.apply(seg, *tensors)
    return tree_unflatten(list(out[:seg.n_out]), seg.out_spec)

