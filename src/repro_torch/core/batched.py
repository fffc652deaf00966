"""Batched evaluation core: the whole MS/MA/BCD cut lattice at once — port
of ``repro.core.batched``.

The scalar objective walk in ``core.problem`` prices one cut vector at a
time — ``split_T`` re-runs the canonical stage chain of
``latency.split_stages`` per candidate, so a Dinkelbach iteration over
the U=64/M=3 lattice is ~2,016 Python chain walks and U=128/M=4 explodes
to ~3·10⁵.  This module prices the *entire* C2–C5 lattice as array
arithmetic, the same way ``sim/fleet.py`` vectorized the discrete-event
oracle:

* the feasible lattice is one ``[K, M-1]`` int array
  (:func:`cut_lattice`, exact row order of
  ``HsflProblem.iter_cut_vectors``);
* every tier quantity is a gather into the leading-zero prefix-sum
  tables the scalar path reads (``LayerProfile.prefix``, the G² cumsum
  of ``convergence.tier_G2_sums``) — identical subtraction, identical
  bits;
* the canonical stage chain becomes a ``[K, S]`` work tensor
  (:func:`split_work_tensor`) accumulated against per-stage ``[N]``
  rates *in chain order*, so per-candidate ``split_T``/``agg_T`` and
  therefore N(I, μ), D(I, μ), Θ'(I, μ) match the scalar oracle
  bit-for-bit — the ``events.py``/``fleet.py`` contract, ported to the
  solvers (enforced in ``tests/test_batched.py``).

Backends: ``numpy`` is the reference implementation; ``torch`` runs the
same chain in float64 tensors on a device — the first CUDA device, or the
one named as ``torch:<device>`` (``torch:cpu`` in the CPU tests).  The
chain is IEEE division, addition and max, each correctly rounded in
float64 on the card as on the host, so the tables are bit-identical to
NumPy's.  ``auto`` picks torch only when a card is visible and the
lattice is big enough to amortize the host↔device copies.  The scalar
walk stays available as ``backend="scalar"`` in the solvers and is the
test oracle.  See DESIGN.md §11.
"""
from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..compress.base import CompressionSpec, act_ratio, model_ratio
from .latency import BITS, LayerProfile, SystemSpec

if TYPE_CHECKING:  # pragma: no cover - type hints only
    from .problem import HsflProblem

BACKENDS = ("numpy", "torch")

# auto picks torch only when the [K, N] chain is big enough to amortize the
# host↔device copies and per-stage launches.  chip_smoke.py times both
# backends' tables at the paper's three tiers (VGG-16's 91 lattice rows) on
# an H100: NumPy won at 18 200 rows x clients, the card from 182 000 on
# (PERF.md §6).
AUTO_TORCH_MIN_ELEMS = 182_000


def resolve_backend(backend: str, work_elems: Optional[int] = None) -> str:
    """Map ``auto`` to a concrete backend (``scalar`` is handled upstream
    by the solvers, before the batched core is involved).

    ``torch`` runs on the first CUDA device and raises without one;
    ``torch:<device>`` names the device.  ``auto`` is ``torch`` only when
    a card is visible and the lattice is large."""
    if backend == "auto":
        if not torch.cuda.is_available():
            return "numpy"
        if work_elems is not None and work_elems < AUTO_TORCH_MIN_ELEMS:
            return "numpy"
        return "torch"
    name, _, device = backend.partition(":")
    if name not in BACKENDS or (name == "numpy" and device):
        raise ValueError(
            f"unknown batched backend {backend!r}; use numpy|torch|"
            'torch:<device>|auto (backend="scalar" is the solvers\' '
            "non-batched oracle walk and never reaches the batched core)"
        )
    if name == "torch":
        resolve_device(device or None)
    return backend


def spec_backend(name: str) -> str:
    """The port's backend for a name an ``ExperimentSpec`` carries:
    ``"jax"``, the JAX package's device backend, is ``torch`` (the card);
    every other name is returned as it is."""
    return "torch" if name == "jax" else name


def torch_device(backend: str) -> Optional[torch.device]:
    """The device of a resolved ``torch`` backend; None for ``numpy``."""
    name, _, device = backend.partition(":")
    return resolve_device(device or None) if name == "torch" else None


def chain_sums_torch(
    works: np.ndarray, rates: Sequence[np.ndarray], device: torch.device
) -> torch.Tensor:
    """``[K, N]`` float64 chain sums Σ_s work/rate on ``device``, in stage
    order — the NumPy loop of ``accumulate_chain`` op for op."""
    w = torch.as_tensor(works, dtype=torch.float64, device=device)
    r = torch.as_tensor(np.stack(rates, axis=0), dtype=torch.float64, device=device)
    t = torch.zeros((w.shape[0], r.shape[1]), dtype=torch.float64, device=device)
    for s in range(r.shape[0]):
        t = t + w[:, s][:, None] / r[s][None, :]
    return t


# --------------------------------------------------------------------------- #
# lattice materialization (C2–C4)
# --------------------------------------------------------------------------- #


def cut_lattice(n_units: int, M: int, min_tier_units: int = 1) -> np.ndarray:
    """All C2–C4-valid cut vectors as one ``[K, M-1]`` int64 array.

    Row order is exactly ``HsflProblem.iter_cut_vectors`` (lexicographic
    ``itertools.combinations``), so scalar loops and batched argmins
    break ties identically.
    """
    t = min_tier_units
    rng = range(t, n_units - t * (M - 1) + 1)
    rows = [
        c
        for c in itertools.combinations(rng, M - 1)
        if all(c[i + 1] - c[i] >= t for i in range(len(c) - 1))
    ]
    if not rows:
        return np.zeros((0, M - 1), dtype=np.int64)
    return np.asarray(rows, dtype=np.int64)


def lattice_bounds(lattice: np.ndarray, n_units: int) -> np.ndarray:
    """``[K, M+1]`` tier boundaries: 0 | cuts | U for every row."""
    K = lattice.shape[0]
    return np.concatenate(
        [
            np.zeros((K, 1), dtype=np.int64),
            lattice,
            np.full((K, 1), n_units, dtype=np.int64),
        ],
        axis=1,
    )


def stage_meta(M: int) -> Tuple[Tuple[str, int], ...]:
    """(kind, index) of every leg of the canonical chain — cut-independent,
    mirroring ``latency.split_stages`` (fwd up the hierarchy, bwd back)."""
    meta: List[Tuple[str, int]] = []
    for m in range(M):
        meta.append(("compute_fwd", m))
        if m < M - 1:
            meta.append(("uplink", m))
    for m in range(M - 1, -1, -1):
        meta.append(("compute_bwd", m))
        if m > 0:
            meta.append(("downlink", m - 1))
    return tuple(meta)


# --------------------------------------------------------------------------- #
# per-candidate work tensors (Eqs. 11–16 gathered from the prefix tables)
# --------------------------------------------------------------------------- #


def boundary_bits_lattice(
    profile: LayerProfile,
    lattice: np.ndarray,
    m: int,
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> np.ndarray:
    """``[K]`` boundary-m activation/gradient bits (Eq. 12/14), matching
    ``split_stages``'s ``boundary_bits`` multiply order — including the
    trailing retry-attempt factor (DESIGN.md §16), applied last so scalar
    and batched stay bit-equal."""
    cut = lattice[:, m]
    act = np.where(cut > 0, profile.act_bytes[np.maximum(cut - 1, 0)], 0.0)
    bits = profile.batch * act * BITS * act_ratio(compression, m)
    return bits if retry_mult is None else bits * retry_mult


def split_work_tensor(
    profile: LayerProfile,
    lattice: np.ndarray,
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> np.ndarray:
    """``[K, S]`` stage works in canonical chain order for every row —
    the batched counterpart of ``latency.split_stages`` work values."""
    M = lattice.shape[1] + 1
    bnds = lattice_bounds(lattice, profile.n_units)
    px = profile.prefix
    fwd = px.flops_fwd[bnds[:, 1:]] - px.flops_fwd[bnds[:, :-1]]  # [K, M]
    bwd = px.flops_bwd[bnds[:, 1:]] - px.flops_bwd[bnds[:, :-1]]
    cols: List[np.ndarray] = []
    for kind, idx in stage_meta(M):
        if kind == "compute_fwd":
            cols.append(fwd[:, idx])
        elif kind == "compute_bwd":
            cols.append(bwd[:, idx])
        else:  # uplink / downlink share the boundary payload
            cols.append(
                boundary_bits_lattice(
                    profile, lattice, idx, compression, retry_mult
                )
            )
    return np.stack(cols, axis=1)


def model_bits_lattice(
    profile: LayerProfile,
    lattice: np.ndarray,
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> np.ndarray:
    """``[K, M-1]`` fed-server model bits λ_m (Eq. 15/16 payload), matching
    ``aggregation_phases``'s ``tier_param_bytes · 8 · ratio`` order with
    the retry factor applied last (DESIGN.md §16)."""
    M = lattice.shape[1] + 1
    bnds = lattice_bounds(lattice, profile.n_units)
    cs = profile.prefix.param_bytes
    out = np.empty((lattice.shape[0], M - 1))
    for m in range(M - 1):
        lam = cs[bnds[:, m + 1]] - cs[bnds[:, m]]
        if m == 0:
            lam = lam + profile.frontend_param_bytes
        lam = lam * BITS * model_ratio(compression, m)
        if retry_mult is not None:
            lam = lam * retry_mult
        out[:, m] = lam
    return out


def tier_d_lattice(G2: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """``[K, M]`` per-tier Σ G_l² — same cumsum-diff as ``tier_G2_sums``."""
    cs = np.concatenate(([0.0], np.cumsum(np.asarray(G2, dtype=np.float64))))
    bnds = lattice_bounds(lattice, len(G2))
    return cs[bnds[:, 1:]] - cs[bnds[:, :-1]]


def memory_mask(
    profile: LayerProfile, system: SystemSpec, lattice: np.ndarray
) -> np.ndarray:
    """``[K]`` bool — constraint C5 for every row, same expression shape as
    the scalar ``latency.memory_ok``."""
    N = system.num_clients
    bnds = lattice_bounds(lattice, profile.n_units)
    px = profile.prefix
    ok = np.ones(lattice.shape[0], dtype=bool)
    for m in range(system.M):
        lo, hi = bnds[:, m], bnds[:, m + 1]
        hosted = N // system.entities[m]
        per_model = (
            (px.act_bytes[hi] - px.act_bytes[lo])
            + (px.grad_act_bytes[hi] - px.grad_act_bytes[lo])
        ) * profile.batch + (
            (px.param_bytes[hi] - px.param_bytes[lo])
            + (px.opt_bytes[hi] - px.opt_bytes[lo])
        )
        if m == 0:
            per_model = per_model + profile.frontend_param_bytes
        if m == system.M - 1:
            per_model = per_model + profile.head_param_bytes
        ok &= hosted * per_model < float(np.min(system.memory[m]))
    return ok


# --------------------------------------------------------------------------- #
# nominal latency tables (Eqs. 17/18 for every row)
# --------------------------------------------------------------------------- #


def nominal_stage_rates(system: SystemSpec, M: int) -> List[np.ndarray]:
    """Per-stage nominal ``[N]`` service rates, chain order (``stage_rate``)."""
    rates: List[np.ndarray] = []
    for kind, idx in stage_meta(M):
        if kind in ("compute_fwd", "compute_bwd"):
            rates.append(system.compute[idx])
        elif kind == "uplink":
            rates.append(system.act_up[idx])
        else:
            rates.append(system.act_down[idx])
    return rates


def accumulate_chain(
    works: np.ndarray, rates: Sequence[np.ndarray], backend: str = "numpy"
) -> np.ndarray:
    """``[K]`` max-over-clients of the chain sum Σ_s work/rate, accumulated
    in stage order (the bit-exactness-critical reduction)."""
    device = torch_device(backend)
    if device is not None:
        return chain_sums_torch(works, rates, device).amax(dim=1).cpu().numpy()
    t = np.zeros((works.shape[0], rates[0].shape[0]))
    for s, r in enumerate(rates):
        t = t + works[:, s][:, None] / r[None, :]
    return t.max(axis=1)


def nominal_split_table(
    profile: LayerProfile,
    system: SystemSpec,
    lattice: np.ndarray,
    compression: Optional[CompressionSpec] = None,
    backend: str = "numpy",
    retry_mult: Optional[float] = None,
) -> np.ndarray:
    """``[K]`` T_S(μ) for every lattice row (Eq. 17)."""
    works = split_work_tensor(profile, lattice, compression, retry_mult)
    rates = nominal_stage_rates(system, lattice.shape[1] + 1)
    return accumulate_chain(works, rates, backend)


def nominal_agg_table(
    profile: LayerProfile,
    system: SystemSpec,
    lattice: np.ndarray,
    compression: Optional[CompressionSpec] = None,
    backend: str = "numpy",
    retry_mult: Optional[float] = None,
) -> np.ndarray:
    """``[K, M-1]`` T_{m,A}(μ) for every lattice row (Eq. 18)."""
    M = lattice.shape[1] + 1
    lam = model_bits_lattice(profile, lattice, compression, retry_mult)
    agg = np.zeros((lattice.shape[0], M - 1))
    device = torch_device(backend)
    for m in range(M - 1):
        if system.entities[m] <= 1:
            continue  # Eq. (15)/(16) indicator
        up, down = system.model_up[m], system.model_down[m]
        if device is not None:
            lt = torch.as_tensor(lam[:, m], dtype=torch.float64, device=device)
            ut = torch.as_tensor(up, dtype=torch.float64, device=device)
            dt = torch.as_tensor(down, dtype=torch.float64, device=device)
            agg[:, m] = (
                (lt[:, None] / ut[None, :]).amax(dim=1)
                + (lt[:, None] / dt[None, :]).amax(dim=1)
            ).cpu().numpy()
        else:
            agg[:, m] = (lam[:, m][:, None] / up[None, :]).max(axis=1) + (
                lam[:, m][:, None] / down[None, :]
            ).max(axis=1)
    return agg


# --------------------------------------------------------------------------- #
# the evaluator
# --------------------------------------------------------------------------- #


class BatchedEvaluator:
    """Whole-lattice Θ'/N/D evaluation for one ``HsflProblem``.

    Latency tables (``split`` [K], ``agg`` [K, M-1]) and the convergence
    gathers (``d`` [K, M-1], ``mem_ok`` [K]) are computed ONCE per
    problem; evaluating the objective for any interval vector is then
    O(K·M) elementwise arithmetic — one Dinkelbach step is a single
    argmin over a [K] array.  Obtain via ``problem.evaluator(backend)``
    (memoized per problem instance, so BCD's repeated MS solves share
    one table build; ``with_compression`` returns a new problem and
    therefore re-prices).

    Latency pricing mirrors ``HsflProblem``: nominal Eq. 17/18 tables
    when no ``latency_model`` is attached; a model exposing
    ``split_T_batch``/``agg_T_batch`` (``sim.robust.TraceLatency``)
    prices the lattice through the trace; any other ``LatencyModel``
    falls back to per-row protocol calls (correct, not fast).
    """

    def __init__(self, problem: "HsflProblem", backend: str = "auto"):
        self.problem = problem
        lattice = problem.cut_lattice()
        M = problem.M
        self.backend = resolve_backend(
            backend, work_elems=lattice.shape[0] * problem.system.num_clients
        )
        self.lattice = lattice
        self.mem_ok = memory_mask(problem.profile, problem.system, lattice)
        lm = problem.latency_model
        pp = problem.participation
        rm = problem.retry_mult
        if lm is None:
            self.split = nominal_split_table(
                problem.profile, problem.system, lattice,
                problem.compression, self.backend, rm,
            )
            if pp is not None and pp.deadline is not None:
                # nominal deadline barrier — same min as the scalar split_T
                self.split = np.minimum(self.split, pp.deadline)
            self.agg = nominal_agg_table(
                problem.profile, problem.system, lattice,
                problem.compression, self.backend, rm,
            )
        elif hasattr(lm, "split_T_batch") and hasattr(lm, "agg_T_batch"):
            self.split = np.asarray(lm.split_T_batch(lattice), dtype=np.float64)
            self.agg = np.asarray(lm.agg_T_batch(lattice), dtype=np.float64)
        else:  # generic LatencyModel: scalar protocol per row
            rows = [tuple(int(x) for x in r) for r in lattice]
            self.split = np.array([lm.split_T(r) for r in rows])
            self.agg = np.array(
                [[lm.agg_T(r, m) for m in range(M - 1)] for r in rows]
            )
        self.d = tier_d_lattice(problem.hyper.G2, lattice)[:, : M - 1]
        if pp is not None:
            # per-tier 1/q_m drift inflation — the same elementwise divide
            # the scalar problem.tier_d applies, so D stays bit-equal
            self.d = self.d / problem.q[: M - 1][None, :]
        self.c, self.kappa = problem.constants()
        self.scale = 2.0 * problem.hyper.theta0 / problem.hyper.gamma
        # privacy budget as a denominator floor (0.0 unconstrained, so the
        # feasibility compare below is bit-identical to D > 0) and energy
        # prices over the lattice (DESIGN.md §15; masks only, never Θ')
        self.d_min = problem.d_min()
        en = problem.energy
        self.energy_budget = None if en is None else en.budget_j_per_round
        if en is not None:
            from ..energy import agg_energy_lattice, split_energy_lattice

            self.e_split = split_energy_lattice(
                problem.profile, problem.system, en, lattice,
                problem.compression,
            )
            self.e_agg = agg_energy_lattice(
                problem.profile, problem.system, en, lattice,
                problem.compression,
            )
        else:
            self.e_split = None
            self.e_agg = None

    @property
    def K(self) -> int:
        return self.lattice.shape[0]

    def cuts_at(self, i: int) -> Tuple[int, ...]:
        return tuple(int(x) for x in self.lattice[i])

    def numerator(self, intervals: Sequence[int]) -> np.ndarray:
        """[K] N(I, μ) — ``split + Σ_m agg_m / I_m`` in tier order (the
        ``add.reduce`` order of the scalar ``problem.numerator``)."""
        M = self.problem.M
        acc = self.agg[:, 0] / float(intervals[0])
        for m in range(1, M - 1):
            acc = acc + self.agg[:, m] / float(intervals[m])
        return self.split + acc

    def denominator(self, intervals: Sequence[int]) -> np.ndarray:
        """[K] D(I, μ) = c − κ·Σ_{I_m>1} I_m² d_m (Eq. 22/24)."""
        s = np.zeros(self.K)
        for m in range(self.problem.M - 1):
            I = int(intervals[m])
            if I > 1:
                s = s + (I**2) * self.d[:, m]
        return self.c - self.kappa * s

    def round_energy(self, intervals: Sequence[int]) -> Optional[np.ndarray]:
        """[K] E(I, μ) — ``e_split + Σ_m e_agg_m / I_m`` in tier order (the
        accumulation shape of ``numerator``); None without an EnergySpec."""
        if self.e_split is None:
            return None
        M = self.problem.M
        acc = self.e_agg[:, 0] / float(intervals[0])
        for m in range(1, M - 1):
            acc = acc + self.e_agg[:, m] / float(intervals[m])
        return self.e_split + acc

    def theta(self, intervals: Sequence[int]) -> np.ndarray:
        """[K] exact Θ'(I, μ); +inf where C5 fails, D ≤ d_min, or the
        round energy overruns the budget."""
        from .problem import INFEASIBLE

        D = self.denominator(intervals)
        N_ = self.numerator(intervals)
        th = np.full(self.K, INFEASIBLE)
        ok = self.mem_ok & (D > self.d_min)
        if self.energy_budget is not None:
            ok = ok & (self.round_energy(intervals) <= self.energy_budget)
        th[ok] = self.scale * N_[ok] / D[ok]
        return th
