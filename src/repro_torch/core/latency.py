"""HSFL training-latency model — Eqs. (11)–(19) of the paper — port of
``repro.core.latency``.

Two parameterizations of the same code:
  * the paper's WAN numbers (Sec. VII) for reproducing Figs. 2, 4–9;
  * TPU ICI/DCN constants for the pod mapping (see DESIGN.md §2).

``LayerProfile`` carries per-unit compute/communication quantities derived
from a ModelSpec/VggSpec; ``SystemSpec`` carries the multi-tier resource
topology. Everything downstream (solvers, benchmarks) consumes only these.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..compress.base import CompressionSpec, act_ratio, model_ratio
from ..models.spec import ModelSpec
from ..models.vgg import VggSpec

BITS = 8.0


def prefix_table(arr: np.ndarray) -> np.ndarray:
    """Leading-zero float64 prefix sums: ``table[hi] - table[lo]`` is the
    canonical tier sum of ``arr[lo:hi]``.

    Every tier quantity in this repo — scalar chain, batched lattice core
    (``core.batched``), memory constraint — reads the SAME tables with the
    same subtraction, which is what makes the batched evaluation bit-exact
    against the scalar walk (``np.sum`` over a slice pairwise-accumulates
    and would differ in the last bit).
    """
    return np.concatenate(([0.0], np.cumsum(np.asarray(arr, dtype=np.float64))))


@dataclass(frozen=True)
class ProfilePrefix:
    """Prefix-sum tables ([U+1] each) of every per-unit profile column."""
    flops_fwd: np.ndarray
    flops_bwd: np.ndarray
    act_bytes: np.ndarray
    grad_act_bytes: np.ndarray
    param_bytes: np.ndarray
    opt_bytes: np.ndarray


@dataclass(frozen=True)
class LayerProfile:
    """Per-unit workload profile (unit = HSFL cut granularity)."""
    n_units: int
    flops_fwd: np.ndarray        # [U] forward FLOPs per mini-batch b
    flops_bwd: np.ndarray        # [U] backward FLOPs per mini-batch b
    act_bytes: np.ndarray        # [U] activation bytes *per sample* at the
                                 #     boundary after unit u (ψ_l)
    grad_act_bytes: np.ndarray   # [U] activation-gradient bytes per sample (χ_l)
    param_bytes: np.ndarray      # [U] parameter bytes of unit u (δ contribution)
    opt_bytes: np.ndarray        # [U] optimizer-state bytes of unit u (ϑ̃_l)
    frontend_param_bytes: float
    head_param_bytes: float
    batch: int

    def __post_init__(self):
        # Degenerate-input guard (DESIGN.md §16): a zero-work or
        # non-finite profile silently turns latencies and Θ' into 0/inf/
        # NaN deep inside the solvers; fail loudly at construction.
        if self.n_units <= 0:
            raise ValueError(f"n_units must be > 0: {self.n_units}")
        if self.batch <= 0:
            raise ValueError(f"batch must be > 0: {self.batch}")
        per_unit = (
            "flops_fwd", "flops_bwd", "act_bytes", "grad_act_bytes",
            "param_bytes", "opt_bytes",
        )
        for name in per_unit:
            a = np.asarray(getattr(self, name), dtype=float)
            if a.shape != (self.n_units,):
                raise ValueError(
                    f"LayerProfile.{name} must have shape ({self.n_units},): "
                    f"{a.shape}"
                )
            if not np.all(np.isfinite(a)) or np.any(a < 0.0):
                raise ValueError(
                    f"LayerProfile.{name} must be finite and non-negative"
                )
        for name in ("flops_fwd", "flops_bwd", "param_bytes"):
            if float(np.asarray(getattr(self, name), dtype=float).sum()) <= 0.0:
                raise ValueError(
                    f"LayerProfile.{name} sums to zero — a model with no "
                    "work/parameters has no defined split latency"
                )

    @property
    def prefix(self) -> ProfilePrefix:
        """Memoized prefix-sum tables (computed once per profile; the
        instance ``__dict__`` write bypasses the frozen-dataclass guard)."""
        tables = self.__dict__.get("_prefix")
        if tables is None:
            tables = ProfilePrefix(
                flops_fwd=prefix_table(self.flops_fwd),
                flops_bwd=prefix_table(self.flops_bwd),
                act_bytes=prefix_table(self.act_bytes),
                grad_act_bytes=prefix_table(self.grad_act_bytes),
                param_bytes=prefix_table(self.param_bytes),
                opt_bytes=prefix_table(self.opt_bytes),
            )
            self.__dict__["_prefix"] = tables
        return tables

    def tier_flops(self, cuts: Sequence[int], m: int, bwd: bool = False) -> float:
        lo, hi = self._bounds(cuts, m)
        cs = self.prefix.flops_bwd if bwd else self.prefix.flops_fwd
        return float(cs[hi] - cs[lo])

    def tier_param_bytes(self, cuts: Sequence[int], m: int) -> float:
        lo, hi = self._bounds(cuts, m)
        M = len(cuts) + 1
        extra = 0.0
        if m == 0:
            extra += self.frontend_param_bytes
        if m == M - 1:
            extra += self.head_param_bytes
        cs = self.prefix.param_bytes
        return float(cs[hi] - cs[lo]) + extra

    def _bounds(self, cuts: Sequence[int], m: int) -> Tuple[int, int]:
        b = [0, *cuts, self.n_units]
        return b[m], b[m + 1]


def build_profile(
    spec,
    batch: int,
    seq: int = 1,
    bytes_per_param: float = 4.0,
    bytes_per_act: float = 4.0,
    optimizer: str = "sgd",
    bwd_fwd_ratio: float = 2.0,
) -> LayerProfile:
    """Derive a LayerProfile from a ModelSpec or VggSpec."""
    from ..optim import opt_state_bytes_per_param

    U = spec.n_units
    flops = np.array([spec.unit_flops_fwd(u, batch, seq) for u in range(U)])
    params = np.array([spec.unit_param_count(u) for u in range(U)], dtype=float)
    if isinstance(spec, VggSpec):
        act = np.array(
            [spec.unit_act_bytes_at(u, 1, int(bytes_per_act)) for u in range(U)],
            dtype=float,
        )
    else:
        act = np.full(U, float(spec.unit_act_bytes(1, seq, int(bytes_per_act))))
    opt_per = opt_state_bytes_per_param(optimizer)
    return LayerProfile(
        n_units=U,
        flops_fwd=flops,
        flops_bwd=bwd_fwd_ratio * flops,
        act_bytes=act,
        grad_act_bytes=act.copy(),
        param_bytes=params * bytes_per_param,
        opt_bytes=params * opt_per,
        frontend_param_bytes=spec.frontend_param_count() * bytes_per_param,
        head_param_bytes=spec.head_param_count() * bytes_per_param,
        batch=batch,
    )


@dataclass(frozen=True)
class SystemSpec:
    """Multi-tier resource topology (client→…→cloud) + fed-server links."""
    M: int
    num_clients: int
    entities: Tuple[int, ...]            # J_m
    compute: Tuple[np.ndarray, ...]      # per tier: FLOPS per hosted sub-model [N]
    act_up: Tuple[np.ndarray, ...]       # [M-1][N] bit/s client-sub-model uplink
    act_down: Tuple[np.ndarray, ...]     # [M-1][N] bit/s
    model_up: Tuple[np.ndarray, ...]     # [M-1][J_m] bit/s to fed server
    model_down: Tuple[np.ndarray, ...]   # [M-1][J_m] bit/s from fed server
    memory: Tuple[np.ndarray, ...]       # [M][J_m] bytes (C5)

    def __post_init__(self):
        # Degenerate-input guard (DESIGN.md §16): a zero/negative service
        # rate would silently turn every latency downstream into inf/NaN;
        # fail loudly at construction instead.
        for name in ("compute", "act_up", "act_down", "model_up", "model_down"):
            for i, arr in enumerate(getattr(self, name)):
                a = np.asarray(arr, dtype=float)
                if a.size == 0 or not np.all(np.isfinite(a)) or np.any(a <= 0.0):
                    raise ValueError(
                        f"SystemSpec.{name}[{i}] must be non-empty, finite "
                        f"and strictly positive (got min="
                        f"{a.min() if a.size else 'empty'})"
                    )

    @classmethod
    def paper_three_tier(
        cls,
        num_clients: int = 20,
        num_edges: int = 5,
        seed: int = 0,
        compute_scale: float = 1.0,
        comm_scale: float = 1.0,
        memory_bytes: float = 16e9,
    ) -> "SystemSpec":
        """Sec. VII experimental setup (client–edge–cloud)."""
        rng = np.random.default_rng(seed)
        N, J2 = num_clients, num_edges
        per_edge = N // J2
        dev = rng.uniform(0.4e12, 0.6e12, N) * compute_scale
        edge = np.full(N, 5e12 / per_edge) * compute_scale  # evenly split
        cloud = np.full(N, 50e12 / N) * compute_scale
        up_dev = rng.uniform(75e6, 80e6, N) * comm_scale
        down_dev = np.full(N, 370e6) * comm_scale
        edge_cloud = rng.uniform(370e6, 400e6, N) * comm_scale
        edge_fed = rng.uniform(370e6, 400e6, J2) * comm_scale
        dev_fed = rng.uniform(75e6, 80e6, N) * comm_scale
        return cls(
            M=3,
            num_clients=N,
            entities=(N, J2, 1),
            compute=(dev, edge, cloud),
            act_up=(up_dev, edge_cloud),
            act_down=(down_dev, edge_cloud),
            model_up=(dev_fed, edge_fed),
            model_down=(np.full(N, 370e6) * comm_scale, edge_fed),
            memory=(
                np.full(N, 8e9),
                np.full(J2, memory_bytes),
                np.array([64e9]),
            ),
        )

    @classmethod
    def tpu_pod_mapping(
        cls,
        num_clients: int = 16,
        num_edges: int = 4,
        chip_flops: float = 197e12,
        ici_bps: float = 50e9 * 8,
        dcn_bps: float = 25e9 * 8,
        hbm_bytes: float = 16e9,
    ) -> "SystemSpec":
        """HSFL hierarchy priced with TPU v5e constants (DESIGN.md §2):
        tier links = ICI, fed-server (cross-pod) links = DCN."""
        N, J2 = num_clients, num_edges
        return cls(
            M=3,
            num_clients=N,
            entities=(N, J2, 1),
            compute=(
                np.full(N, chip_flops),
                np.full(N, chip_flops),
                np.full(N, chip_flops),
            ),
            act_up=(np.full(N, ici_bps), np.full(N, ici_bps)),
            act_down=(np.full(N, ici_bps), np.full(N, ici_bps)),
            model_up=(np.full(N, dcn_bps), np.full(J2, dcn_bps)),
            model_down=(np.full(N, dcn_bps), np.full(J2, dcn_bps)),
            memory=(
                np.full(N, hbm_bytes),
                np.full(J2, hbm_bytes),
                np.array([hbm_bytes * 16]),
            ),
        )


# --------------------------------------------------------------------------- #
# Eq. (11)–(19)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class Stage:
    """One sequential leg of a client's per-round pipeline.

    ``kind``  ∈ {compute_fwd, uplink, compute_bwd, downlink};
    ``index`` is the tier for compute stages, the link (cut boundary) for
    communication stages; ``work`` is FLOPs for compute, bits for links.

    The tuple returned by :func:`split_stages` is the *canonical chain
    order* — fwd up the hierarchy, bwd back down.  Every consumer
    (``split_latency``, the fleet simulator's vectorized path, and the
    discrete-event oracle) accumulates latency in exactly this order so
    their floating-point results agree bit-for-bit.
    """
    kind: str
    index: int
    work: float


def split_stages(
    profile: LayerProfile,
    cuts: Sequence[int],
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> Tuple[Stage, ...]:
    """Canonical per-client stage chain for cut vector μ (Eqs. 11–14).

    ``compression`` scales boundary-m's activation/gradient bits by
    ``act_ratio[m]`` (DESIGN.md §9); None prices the full-precision wire.
    ``retry_mult`` prices transient link failures (DESIGN.md §16): every
    link payload carries the expected attempt count
    ``faults.retry_attempts(p, k)`` as extra traversals.  None (the
    zero-fault gate) leaves every bit count untouched.
    """
    M = len(cuts) + 1
    b = profile.batch
    bnds = [0, *cuts, profile.n_units]

    def boundary_bits(m: int) -> float:
        cut = bnds[m + 1]
        act = 0.0 if cut == 0 else float(profile.act_bytes[cut - 1])
        bits = b * act * BITS * act_ratio(compression, m)
        return bits if retry_mult is None else bits * retry_mult

    stages: List[Stage] = []
    for m in range(M):  # forward sweep: Eq. (11) interleaved with Eq. (12)
        stages.append(Stage("compute_fwd", m, profile.tier_flops(cuts, m, bwd=False)))
        if m < M - 1:
            stages.append(Stage("uplink", m, boundary_bits(m)))
    for m in range(M - 1, -1, -1):  # backward sweep: Eq. (13) + Eq. (14)
        stages.append(Stage("compute_bwd", m, profile.tier_flops(cuts, m, bwd=True)))
        if m > 0:
            stages.append(Stage("downlink", m - 1, boundary_bits(m - 1)))
    return tuple(stages)


def stage_rate(system: SystemSpec, stage: Stage) -> np.ndarray:
    """Nominal per-client service rate [N] for one stage (FLOPS or bit/s)."""
    if stage.kind in ("compute_fwd", "compute_bwd"):
        return system.compute[stage.index]
    if stage.kind == "uplink":
        return system.act_up[stage.index]
    return system.act_down[stage.index]


def per_client_split_latency(
    profile: LayerProfile,
    system: SystemSpec,
    cuts: Sequence[int],
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> np.ndarray:
    """Per-client round latency [N], accumulated in canonical chain order.

    The fleet simulator (``repro.sim``) prices the same ``work / rate``
    stages with trace-perturbed rates and MUST keep this accumulation
    order — the homogeneous golden test in ``tests/test_sim.py`` pins the
    two paths to exact floating-point equality.
    """
    stages = split_stages(profile, cuts, compression, retry_mult)
    t = np.zeros(system.num_clients)
    for s in stages:
        t = t + s.work / stage_rate(system, s)
    return t


def split_latency(
    profile: LayerProfile,
    system: SystemSpec,
    cuts: Sequence[int],
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> float:
    """T_S(μ): per-round split-training latency, Eq. (17)."""
    return float(
        np.max(
            per_client_split_latency(
                profile, system, cuts, compression, retry_mult
            )
        )
    )


def aggregation_phases(
    profile: LayerProfile,
    system: SystemSpec,
    cuts: Sequence[int],
    m: int,
    up_rate: Optional[np.ndarray] = None,
    down_rate: Optional[np.ndarray] = None,
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-entity (upload, download) times [J_m] of a tier-m sync, Eq. (18).

    ``compression`` scales the model bits λ_m by ``model_ratio[m]`` — the
    wire the quantized aggregation kernel actually carries (DESIGN.md §9).
    ``retry_mult`` scales the same bits by the expected link attempt count
    (DESIGN.md §16); None leaves them untouched.
    """
    lam = profile.tier_param_bytes(cuts, m) * BITS * model_ratio(compression, m)
    if retry_mult is not None:
        lam = lam * retry_mult
    up = lam / (system.model_up[m] if up_rate is None else up_rate)
    down = lam / (system.model_down[m] if down_rate is None else down_rate)
    return up, down


def aggregation_latency(
    profile: LayerProfile,
    system: SystemSpec,
    cuts: Sequence[int],
    m: int,
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> float:
    """T_{m,A}(μ): fed-server aggregation latency of tier m, Eq. (18)."""
    if system.entities[m] <= 1:
        return 0.0  # Eq. (15)/(16) indicator
    up, down = aggregation_phases(
        profile, system, cuts, m, compression=compression,
        retry_mult=retry_mult,
    )
    return float(np.max(up)) + float(np.max(down))


def total_latency(
    profile: LayerProfile,
    system: SystemSpec,
    cuts: Sequence[int],
    intervals: Sequence[int],
    R: float,
    compression: Optional[CompressionSpec] = None,
    retry_mult: Optional[float] = None,
) -> float:
    """T(I, μ), Eq. (19)."""
    ts = split_latency(profile, system, cuts, compression, retry_mult)
    tot = R * ts
    for m in range(system.M - 1):
        tot += np.floor(R / intervals[m]) * aggregation_latency(
            profile, system, cuts, m, compression, retry_mult
        )
    return float(tot)


def memory_ok(profile: LayerProfile, system: SystemSpec, cuts: Sequence[int]) -> bool:
    """Constraint C5: per-entity memory for hosted sub-models.

    Reads the profile's prefix tables with the same expression shape as
    the batched lattice check (``core.batched.memory_mask``) so the two
    agree on every knife-edge cut.
    """
    N = system.num_clients
    bnds = [0, *cuts, profile.n_units]
    px = profile.prefix
    for m in range(system.M):
        lo, hi = bnds[m], bnds[m + 1]
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
        cap = float(np.min(system.memory[m]))
        if hosted * per_model >= cap:
            return False
    return True
