"""Fault injection: compose a ``FaultSpec`` with a ``SystemTrace`` — port of
``repro.faults.inject``.

``faulty_trace`` wraps a scenario trace so every ``round_state(r)`` carries
the round's realized faults *as ordinary RoundState fields* — crashed
clients drop out of ``available``, realized link retries scale the link
multipliers, a cell outage zeroes its fed-exchange contribution.  Because
both the discrete-event oracle (``sim.events``) and the vectorized fleet
path (``sim.fleet``) consume only ``round_state``, their fault-adjusted
round times stay bit-identical — the same contract the scenario library
already maintains, inherited for free.

``apply_corruption`` is the data-plane half: it transforms the corrupt
clients' rows of a client-stacked parameter pytree (the uploads the guard
in ``tiers.synchronize`` must catch).  Corruption never changes timing —
the bytes arrive on schedule, they are just wrong.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._tree import tree_map
from ..sim.scenarios import RoundState, SystemTrace
from .spec import FaultSpec, RoundFaults, expand_faults


def faulty_round_state(
    spec: FaultSpec, state: RoundState, rf: RoundFaults
) -> RoundState:
    """One round's fault-adjusted fleet state.

    * crash: the client's upload never lands, so the server's round
      barrier excludes it — exactly ``available=False`` (the crash stage
      only determines how much work was wasted; nobody waits on it).
    * link retries: a traversal needing a attempts takes a× the time —
      every per-client link multiplier divides by the realized attempt
      count (the trace analogue of the expected-attempts pricing in
      ``core.latency``).
    * outage: a dead cell's fed exchange contributes nothing to the
      tier's aggregation barrier — its rate multiplier becomes +inf, so
      its λ/rate term is exactly 0.0 under IEEE division.
    """
    available = state.available
    if spec.crash_rate > 0.0:
        available = available & ~rf.crashed
        if not available.any():
            raise ValueError(
                "every client crashed this round — an all-faulty round has "
                "no defined latency or aggregate; lower crash_rate (or the "
                "scenario's churn) so at least one upload can land"
            )
    link_up = state.link_up_mult
    link_down = state.link_down_mult
    fed_up = state.fed_up_mult
    fed_down = state.fed_down_mult
    if spec.link_fail_rate > 0.0:
        inv = 1.0 / rf.attempts
        link_up = tuple(m * inv for m in link_up)
        link_down = tuple(m * inv for m in link_down)
        fed_up = tuple(
            m * inv if len(m) == len(inv) else m for m in fed_up
        )
        fed_down = tuple(
            m * inv if len(m) == len(inv) else m for m in fed_down
        )
    if rf.cell_out:
        mt = spec.outage_tier
        dead = np.asarray(spec.outage_cells, dtype=np.int64)
        up = fed_up[mt].copy()
        down = fed_down[mt].copy()
        up[dead] = np.inf
        down[dead] = np.inf
        fed_up = fed_up[:mt] + (up,) + fed_up[mt + 1 :]
        fed_down = fed_down[:mt] + (down,) + fed_down[mt + 1 :]
    return RoundState(
        available=available,
        compute_mult=state.compute_mult,
        link_up_mult=link_up,
        link_down_mult=link_down,
        fed_up_mult=fed_up,
        fed_down_mult=fed_down,
    )


def faulty_trace(trace: SystemTrace, spec: Optional[FaultSpec]) -> SystemTrace:
    """The trace with the spec's faults layered on every round.

    A null spec (zero rates, no outage) returns the *input trace object*
    unchanged — the zero-fault bit-exactness contract.  The wrapped trace
    keeps the base trace's name (suffixed), profile/system/compression and
    seed; fault draws come from the spec's own seeded streams, so the
    underlying scenario's randomness is untouched.
    """
    if spec is None or spec.is_null:
        return trace
    spec.validate_for(trace.system.M, trace.system.entities)
    N = trace.system.num_clients

    def gen(r: int) -> RoundState:
        return faulty_round_state(
            spec, trace.round_state(r), expand_faults(spec, r, N)
        )

    return SystemTrace(
        f"{trace.name}+faults",
        trace.profile,
        trace.system,
        trace.rounds,
        trace.seed,
        gen,
        trace.compression,
    )


# --------------------------------------------------------------------------- #
# data-plane corruption (what the guard must catch)
# --------------------------------------------------------------------------- #


def apply_corruption(params, corrupt: np.ndarray, spec: FaultSpec):
    """Corrupt the marked clients' rows of a client-stacked tree.

    Only leaves with a leading client axis (shape[0] == len(corrupt)) are
    touched; scalar bookkeeping leaves pass through.  Returns a new tree
    (applied between the local update and the guarded sync by the fault-
    aware training loop; never inside the step).  Every mode is the JAX
    package's bit for bit: ``nan``, ``inf`` and ``scale`` select with
    ``torch.where``, ``bitflip`` XORs the int32 view of an f32 leaf.
    """
    if not corrupt.any():
        return params
    n = len(corrupt)
    masks = {}

    def hit(x):
        if x.ndim == 0 or x.shape[0] != n:
            return x
        if x.device not in masks:  # one copy of the [N] mask per device
            masks[x.device] = torch.as_tensor(corrupt, dtype=torch.bool, device=x.device)
        m = masks[x.device].reshape((n,) + (1,) * (x.ndim - 1))
        if spec.corrupt_mode == "nan":
            return torch.where(m, torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)
        if spec.corrupt_mode == "inf":
            return torch.where(m, torch.full((), float("inf"), dtype=x.dtype, device=x.device), x)
        if spec.corrupt_mode == "scale":
            return torch.where(m, x * spec.corrupt_scale, x)
        # bitflip: XOR an exponent bit of the float32 representation —
        # values blow up (or collapse) by ~2^64, the classic DRAM flip
        if x.dtype != torch.float32:
            return x
        flipped = (x.contiguous().view(torch.int32) ^ 0x40000000).view(torch.float32)
        return torch.where(m, flipped, x)

    return tree_map(hit, params)
