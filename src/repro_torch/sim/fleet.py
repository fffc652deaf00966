"""Vectorized fleet fast path: whole-round advancement for N clients at once
— port of ``repro.sim.fleet``.

Where ``events.py`` schedules one event per client per stage, this path
treats the round as pure array arithmetic: per-client compute rates, link
bandwidths, and availability live in ``[N]`` float64 arrays, a round is a
fixed chain of elementwise divide/accumulate ops, and the round latency is
one masked reduction.  A 10⁶-client round is ~10 array ops.

Bit-exactness contract: the fast path consumes the *same* per-stage
duration arrays as the event core (``events.round_stage_durations``) and
accumulates them in the same canonical order, so for any trace and cut
vector ``simulate_rounds`` and ``events.simulate`` agree to the last bit.

Backends (``backend=``):

* ``numpy`` — the reference;
* ``torch`` — the same chain in float64 tensors on the first CUDA device
  (raising without one), ``torch:<device>`` on the one named
  (``torch:cpu`` in the CPU tests).  Every op is an IEEE float64 add,
  divide, compare, min or max, each correctly rounded on the card as on
  the host, so the results equal NumPy's with ``==``;
* ``jax`` — the JAX package's name for its device backend, which
  ``ExperimentSpec`` files carry (``ScenarioCfg.backend``): read as
  ``torch`` (``core.batched.spec_backend``), so one spec file drives
  either package;
* ``auto`` — ``torch`` for the ``[K, N]`` lattice pricing when a card is
  visible and the lattice reaches the measured crossover
  (``AUTO_TORCH_MIN_ELEMS`` lattice rows × clients), else ``numpy``; a
  round's ``[N]`` chain (``round_latency``, ``simulate_rounds``) and
  ``quantiles`` always take ``numpy``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batched import chain_sums_torch, spec_backend, torch_device
from .events import fires, round_agg_phases, round_stage_durations
from .scenarios import SystemTrace

BACKENDS = ("numpy", "torch")

# auto picks torch only where the chain is large enough to pay for the
# host->device copies of the stage arrays, which are drawn on the host.
# chip_smoke.py's [sim] phase times both backends on straggler-tail (VGG-16,
# the paper's three tiers) on an NVIDIA H100 80GB HBM3 at 700 W: the [91, N]
# lattice pricing won from 91 000 rows x clients; a round's [N] chain
# (simulate_rounds) lost on the card up to 10^5 clients and was within ~10%
# of NumPy either way at 10^6, the largest size timed, so auto keeps it on
# NumPy (PERF.md §5).
AUTO_TORCH_MIN_ELEMS = 91_000


@dataclass(frozen=True)
class FleetRound:
    split: float                 # max over participants
    per_client: np.ndarray       # [N] finish times (NaN when absent)
    agg: np.ndarray              # [M-1] priced tier-sync latency
    n_participants: int


@dataclass(frozen=True)
class FleetResult:
    split: np.ndarray            # [R]
    agg: np.ndarray              # [M-1, R] priced every round
    fired: np.ndarray            # [M-1, R] sync schedule
    total: np.ndarray            # [R]
    participants: np.ndarray     # [R]

    def straggler_quantiles(self, qs=(0.5, 0.95, 0.99)) -> np.ndarray:
        """Quantiles of per-round *round* latency (the straggler-shaped tail)."""
        return quantiles(self.total, qs)


def _resolve_backend(backend: str, lattice_elems: Optional[int] = None) -> str:
    """``numpy``, ``torch`` or ``torch:<device>`` for a backend name (module
    docstring); ``auto`` is ``torch`` only for a lattice of at least
    ``AUTO_TORCH_MIN_ELEMS`` rows × clients with a card visible.  A torch
    device that is not there raises."""
    backend = spec_backend(backend)
    if backend == "auto":
        if (lattice_elems is None or lattice_elems < AUTO_TORCH_MIN_ELEMS
                or not torch.cuda.is_available()):
            return "numpy"
        return "torch"
    name, _, device = backend.partition(":")
    if name not in BACKENDS or (name == "numpy" and device):
        raise ValueError(
            f"unknown fleet backend {backend!r}; use numpy|torch|torch:<device>|"
            "jax (= torch)|auto"
        )
    torch_device(backend)  # a torch device that is not there raises here
    return backend


def _on(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def quantiles(x: np.ndarray, qs: Sequence[float], backend: str = "auto") -> np.ndarray:
    """Quantile reduction (linear interpolation, as ``np.quantile``)."""
    device = torch_device(_resolve_backend(backend))
    if device is not None:
        return torch.quantile(
            _on(np.asarray(x, dtype=np.float64), device),
            torch.as_tensor(list(qs), dtype=torch.float64, device=device),
        ).cpu().numpy()
    return np.quantile(np.asarray(x), list(qs))


def round_latency(
    trace: SystemTrace, r: int, cuts: Sequence[int], backend: str = "auto"
) -> FleetRound:
    """Advance one whole round for all N clients at once."""
    device = torch_device(_resolve_backend(backend))
    state = trace.round_state(r)
    avail = state.available
    n_part = int(np.count_nonzero(avail))
    _, durs = round_stage_durations(trace, r, cuts)
    M = trace.system.M

    if device is not None:
        t = torch.zeros(trace.system.num_clients, dtype=torch.float64, device=device)
        for d in durs:
            t = t + _on(d, device)
        av = _on(avail, device)
        split = float(torch.max(torch.where(av, t, -torch.inf))) if n_part else 0.0
        per_client = torch.where(av, t, torch.nan).cpu().numpy()
    else:
        t = np.zeros(trace.system.num_clients)
        for d in durs:
            t = t + d
        split = float(np.max(t[avail])) if n_part else 0.0
        per_client = np.where(avail, t, np.nan)

    agg = np.zeros(M - 1)
    for m in range(M - 1):
        phases = round_agg_phases(trace, r, cuts, m)
        if phases is None:
            continue
        up, down = phases
        if device is not None:
            agg[m] = float(torch.max(_on(up, device))) + float(torch.max(_on(down, device)))
        else:
            agg[m] = float(np.max(up)) + float(np.max(down))
    return FleetRound(split, per_client, agg, n_part)


def simulate_lattice_rounds(
    trace: SystemTrace,
    lattice: np.ndarray,
    rounds: Optional[int] = None,
    backend: str = "auto",
    deadline: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-lattice counterpart of ``simulate_rounds`` for the batched
    solver core: per-round split ``[K, R]`` and per-tier agg ``[K, M-1, R]``
    for every cut row at once (no interval gating — quantile pricing
    consumes raw per-round latencies, exactly like ``TraceLatency``).

    Bit-exactness: consumes the same ``[K, S]`` stage-work tensor the
    nominal batched path uses (``core.batched.split_work_tensor``), prices
    it against the same ``base_rate × round_mult`` products as
    ``events.round_stage_durations``, and accumulates in canonical chain
    order — so row k equals ``simulate_rounds(trace, lattice[k])`` to the
    last bit.

    ``deadline`` switches on the partial-participation view (DESIGN.md
    §12): a round's split is capped at the *effective* barrier
    ``d_eff = max(deadline, fastest available finish)`` — the server never
    waits past it, but cannot close a round before at least one upload
    lands — and client-hosted tier syncs run over that round's
    participants: available clients whose chain finished by d_eff, a
    per-lattice-row set since finish times depend on the cut.
    """
    from ..core.batched import model_bits_lattice, split_work_tensor, stage_meta

    be = _resolve_backend(backend, lattice.shape[0] * trace.system.num_clients)
    R = trace.rounds if rounds is None else min(rounds, trace.rounds)
    system, profile = trace.system, trace.profile
    M = system.M
    K = lattice.shape[0]
    works = split_work_tensor(profile, lattice, trace.compression)   # [K, S]
    lam = model_bits_lattice(profile, lattice, trace.compression)    # [K, M-1]
    meta = stage_meta(M)

    split = np.zeros((K, R))
    agg = np.zeros((K, M - 1, R))
    for r in range(R):
        state = trace.round_state(r)
        split[:, r], agg[:, :, r] = price_lattice_round(
            system, works, lam, meta, state, deadline=deadline, backend=be
        )
    return split, agg


def price_lattice_round(
    system,
    works: np.ndarray,
    lam: np.ndarray,
    meta,
    state,
    deadline: Optional[float] = None,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Price one round's ``RoundState`` against a whole cut lattice:
    returns (split ``[K]``, agg ``[K, M-1]``).

    The single per-round pricing kernel behind ``simulate_lattice_rounds``.
    ``works``/``lam``/``meta`` are the precomputed ``core.batched`` tensors
    for the lattice.
    """
    M, N, K = system.M, system.num_clients, works.shape[0]
    device = torch_device(_resolve_backend(backend, K * N))
    split_col = np.zeros(K)
    agg_col = np.zeros((K, M - 1))
    rates = []
    for kind, idx in meta:
        if kind in ("compute_fwd", "compute_bwd"):
            rates.append(system.compute[idx] * state.compute_mult[idx])
        elif kind == "uplink":
            rates.append(system.act_up[idx] * state.link_up_mult[idx])
        else:
            rates.append(system.act_down[idx] * state.link_down_mult[idx])
    avail = state.available
    part = None  # [K, N] per-row participants (deadline pricing only)
    if not avail.any():
        pass  # a round with zero participants has split 0 (events.py)
    elif device is not None:
        t = chain_sums_torch(works, rates, device)
        av = _on(avail, device)
        top = torch.where(av, t, -torch.inf).amax(dim=1)
        if deadline is not None:
            d_eff = torch.clamp(torch.where(av, t, torch.inf).amin(dim=1), min=deadline)
            part = (av[None, :] & (t <= d_eff[:, None])).cpu().numpy()
            top = torch.minimum(d_eff, top)
        split_col[:] = top.cpu().numpy()
    else:
        t = np.zeros((K, N))
        for s, rt in enumerate(rates):
            t = t + works[:, s][:, None] / rt[None, :]
        top = t[:, avail].max(axis=1)
        if deadline is not None:
            d_eff = np.maximum(deadline, t[:, avail].min(axis=1))
            part = avail[None, :] & (t <= d_eff[:, None])
            top = np.minimum(d_eff, top)
        split_col[:] = top
    for m in range(M - 1):
        if system.entities[m] <= 1:
            continue
        up_rate = system.model_up[m] * state.fed_up_mult[m]
        down_rate = system.model_down[m] * state.fed_down_mult[m]
        up = lam[:, m][:, None] / up_rate[None, :]
        down = lam[:, m][:, None] / down_rate[None, :]
        if up.shape[1] == N:  # clients host tier m: absent ones don't sync
            if part is not None:
                any_part = part.any(axis=1)
                up_m = np.where(part, up, -np.inf).max(axis=1)
                down_m = np.where(part, down, -np.inf).max(axis=1)
                agg_col[:, m] = np.where(any_part, up_m + down_m, 0.0)
                continue
            up, down = up[:, avail], down[:, avail]
            if up.shape[1] == 0:
                continue
        agg_col[:, m] = up.max(axis=1) + down.max(axis=1)
    return split_col, agg_col


def simulate_rounds(
    trace: SystemTrace,
    cuts: Sequence[int],
    intervals: Optional[Sequence[int]] = None,
    rounds: Optional[int] = None,
    backend: str = "auto",
) -> FleetResult:
    """Vectorized counterpart of ``events.simulate`` (same result layout)."""
    R = trace.rounds if rounds is None else min(rounds, trace.rounds)
    M = trace.system.M
    iv = [1] * (M - 1) if intervals is None else list(intervals[: M - 1])

    split = np.zeros(R)
    agg = np.zeros((M - 1, R))
    fired = np.zeros((M - 1, R), dtype=bool)
    total = np.zeros(R)
    participants = np.zeros(R, dtype=int)
    for r in range(R):
        res = round_latency(trace, r, cuts, backend=backend)
        split[r] = res.split
        agg[:, r] = res.agg
        participants[r] = res.n_participants
        tot = res.split
        for m in range(M - 1):
            if fires(r, iv[m]):
                fired[m, r] = True
                tot = tot + res.agg[m]
        total[r] = tot
    return FleetResult(split, agg, fired, total, participants)
