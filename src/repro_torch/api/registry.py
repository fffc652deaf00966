"""String-keyed registries the spec layer resolves against (DESIGN.md §10)
— port of ``repro.api.registry``.

Four maps, one per spec axis:

* ``MODEL_IDS``  — architecture ids (delegates to ``repro.configs``);
* ``SYSTEMS``    — system presets: name → ``SystemCfg`` → ``SystemSpec``
  (paper-three-tier, tpu-pod, the two two-tier SFL baselines of Fig. 7,
  the M=4 four-tier-wan hierarchy, plus anything added via
  ``register_system``);
* ``SCENARIOS``  — fleet-sim regimes (delegates to ``repro.sim``);
* ``CODECS``     — wire codecs: name → ``Compressor`` constructor
  (delegates to ``repro.compress.SCHEMES``; extend via ``register_codec``).

Registries keep specs *data*: a new scenario/system/codec becomes reachable
from serialized specs by registering a builder, with no new wiring code at
any call site.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..compress import SCHEMES
from ..configs import ARCH_IDS, get_reduced, get_spec
from ..core.latency import SystemSpec
from .spec import ModelCfg, SystemCfg

# --------------------------------------------------------------------------- #
# models
# --------------------------------------------------------------------------- #

MODEL_IDS: List[str] = sorted([*ARCH_IDS, "vgg16-cifar10"])


def resolve_model(cfg: ModelCfg):
    """``ModelCfg`` → the concrete ModelSpec / VggSpec it names."""
    spec = get_reduced(cfg.arch) if cfg.variant == "reduced" else get_spec(cfg.arch)
    if cfg.num_layers is not None:
        import dataclasses

        spec = dataclasses.replace(spec, num_layers=cfg.num_layers)
    return spec


# --------------------------------------------------------------------------- #
# systems
# --------------------------------------------------------------------------- #

SystemBuilder = Callable[[SystemCfg], SystemSpec]
SYSTEMS: Dict[str, SystemBuilder] = {}


def register_system(name: str) -> Callable[[SystemBuilder], SystemBuilder]:
    """Register a system preset under ``name`` (decorator)."""

    def deco(fn: SystemBuilder) -> SystemBuilder:
        SYSTEMS[name] = fn
        return fn

    return deco


def resolve_system(cfg: SystemCfg) -> SystemSpec:
    try:
        builder = SYSTEMS[cfg.preset]
    except KeyError:
        raise KeyError(
            f"unknown system preset {cfg.preset!r}; available: {sorted(SYSTEMS)}"
        ) from None
    return builder(cfg)


@register_system("paper-three-tier")
def _paper_three_tier(cfg: SystemCfg) -> SystemSpec:
    """Sec. VII client–edge–cloud WAN system."""
    return SystemSpec.paper_three_tier(
        num_clients=cfg.num_clients,
        num_edges=cfg.num_edges,
        seed=cfg.seed,
        compute_scale=cfg.compute_scale,
        comm_scale=cfg.comm_scale,
        **cfg.extras,
    )


@register_system("tpu-pod")
def _tpu_pod(cfg: SystemCfg) -> SystemSpec:
    """HSFL hierarchy priced with TPU v5e ICI/DCN constants (DESIGN.md §2).

    Deterministic preset (``seed`` unused); ``compute_scale`` scales chip
    FLOPS and ``comm_scale`` scales the ICI/DCN links so Fig.-6-style
    resource sweeps work here too.
    """
    extras = dict(cfg.extras)
    chip_flops = extras.pop("chip_flops", 197e12) * cfg.compute_scale
    ici_bps = extras.pop("ici_bps", 50e9 * 8) * cfg.comm_scale
    dcn_bps = extras.pop("dcn_bps", 25e9 * 8) * cfg.comm_scale
    return SystemSpec.tpu_pod_mapping(
        num_clients=cfg.num_clients,
        num_edges=cfg.num_edges,
        chip_flops=chip_flops,
        ici_bps=ici_bps,
        dcn_bps=dcn_bps,
        **extras,
    )


def _two_tier(cfg: SystemCfg, kind: str) -> SystemSpec:
    """Client-edge (J2 near servers) or client-cloud (one far server) SFL —
    the Fig. 7 baselines (formerly hand-wired in benchmarks/fig67)."""
    # fail loudly rather than run a system the provenance doesn't describe
    if cfg.extras:
        raise ValueError(
            f"two-tier-{kind} takes no extras; got {sorted(cfg.extras)}"
        )
    if kind == "client-cloud" and cfg.num_edges != 1:
        raise ValueError(
            "two-tier-client-cloud has exactly one server; set num_edges=1 "
            f"(got {cfg.num_edges})"
        )
    if not 1 <= cfg.num_edges <= cfg.num_clients:
        raise ValueError(
            f"two-tier-{kind} needs 1 <= num_edges <= num_clients; got "
            f"num_edges={cfg.num_edges}, num_clients={cfg.num_clients}"
        )
    rng = np.random.default_rng(cfg.seed)
    N = cfg.num_clients
    dev = rng.uniform(0.4e12, 0.6e12, N) * cfg.compute_scale
    if kind == "client-edge":
        J2, f2 = cfg.num_edges, 5e12
        up = rng.uniform(75e6, 80e6, N) * cfg.comm_scale
        down = np.full(N, 370e6) * cfg.comm_scale
    else:  # client-cloud: more compute, slower WAN link (15 Mbps, Fig. 2)
        J2, f2 = 1, 50e12
        up = np.full(N, 15e6) * cfg.comm_scale
        down = np.full(N, 15e6) * cfg.comm_scale
    per = N // J2
    return SystemSpec(
        M=2,
        num_clients=N,
        entities=(N, J2),
        compute=(dev, np.full(N, f2 / per) * cfg.compute_scale),
        act_up=(up,),
        act_down=(down,),
        model_up=(rng.uniform(75e6, 80e6, N) * cfg.comm_scale,),
        model_down=(np.full(N, 370e6) * cfg.comm_scale,),
        memory=(np.full(N, 8e9), np.full(J2, 64e9)),
    )


@register_system("lognormal-fleet")
def _lognormal_fleet(cfg: SystemCfg) -> SystemSpec:
    """Sec. VII system with a *statically* heterogeneous device tier.

    The paper-three-tier arrays with per-device lognormal multipliers
    drawn once — ``exp(N(0, compute_sigma))`` on tier-0 compute and
    ``exp(N(0, link_sigma))`` on the tier-0 links.  Each device's fed
    uplink/downlink shares its access-link draw (one radio), so slow-link
    devices are slow on both the activation and the model wire — the
    regime where per-class cut assignment pays (DESIGN.md §14).  Unlike
    the ``lognormal-heterogeneous`` *scenario* (fresh draws per round),
    this is a fixed system, so nominal pricing — and hence the per-class
    solver — applies.  ``extras``: ``compute_sigma`` (0.5), ``link_sigma``
    (0.6).
    """
    import dataclasses

    extras = dict(cfg.extras)
    compute_sigma = float(extras.pop("compute_sigma", 0.5))
    link_sigma = float(extras.pop("link_sigma", 0.6))
    base = SystemSpec.paper_three_tier(
        num_clients=cfg.num_clients,
        num_edges=cfg.num_edges,
        seed=cfg.seed,
        compute_scale=cfg.compute_scale,
        comm_scale=cfg.comm_scale,
        **extras,
    )
    rng = np.random.default_rng(cfg.seed + 777)
    N = cfg.num_clients
    dev = np.exp(rng.normal(0.0, compute_sigma, N))
    up = np.exp(rng.normal(0.0, link_sigma, N))
    down = np.exp(rng.normal(0.0, link_sigma, N))
    return dataclasses.replace(
        base,
        compute=(base.compute[0] * dev,) + base.compute[1:],
        act_up=(base.act_up[0] * up,) + base.act_up[1:],
        act_down=(base.act_down[0] * down,) + base.act_down[1:],
        model_up=(base.model_up[0] * up,) + base.model_up[1:],
        model_down=(base.model_down[0] * down,) + base.model_down[1:],
    )


@register_system("four-tier-wan")
def _four_tier_wan(cfg: SystemCfg) -> SystemSpec:
    """Client–edge–regional–cloud WAN hierarchy (M=4): the Sec. VII
    numbers extended one tier up (a regional aggregation layer between
    edge and cloud), for M-sweeps of the solver core and deeper-hierarchy
    scenarios.  ``extras['num_regional']`` sets J₃ (default J₂//2)."""
    rng = np.random.default_rng(cfg.seed)
    N, J2 = cfg.num_clients, cfg.num_edges
    extras = dict(cfg.extras)
    J3 = int(extras.pop("num_regional", max(1, J2 // 2)))
    if extras:
        raise ValueError(f"four-tier-wan unknown extras: {sorted(extras)}")
    if not 1 <= J3 <= J2 <= N:
        raise ValueError(
            f"four-tier-wan needs 1 <= num_regional <= num_edges <= "
            f"num_clients; got {J3}/{J2}/{N}"
        )
    dev = rng.uniform(0.4e12, 0.6e12, N) * cfg.compute_scale
    edge = np.full(N, 5e12 / max(1, N // J2)) * cfg.compute_scale
    regional = np.full(N, 20e12 / max(1, N // J3)) * cfg.compute_scale
    cloud = np.full(N, 50e12 / N) * cfg.compute_scale
    up_dev = rng.uniform(75e6, 80e6, N) * cfg.comm_scale
    down_dev = np.full(N, 370e6) * cfg.comm_scale
    edge_reg = rng.uniform(370e6, 400e6, N) * cfg.comm_scale
    reg_cloud = rng.uniform(800e6, 1000e6, N) * cfg.comm_scale
    return SystemSpec(
        M=4,
        num_clients=N,
        entities=(N, J2, J3, 1),
        compute=(dev, edge, regional, cloud),
        act_up=(up_dev, edge_reg, reg_cloud),
        act_down=(down_dev, edge_reg, reg_cloud),
        model_up=(
            rng.uniform(75e6, 80e6, N) * cfg.comm_scale,
            rng.uniform(370e6, 400e6, J2) * cfg.comm_scale,
            rng.uniform(800e6, 1000e6, J3) * cfg.comm_scale,
        ),
        model_down=(
            np.full(N, 370e6) * cfg.comm_scale,
            np.full(J2, 370e6) * cfg.comm_scale,
            np.full(J3, 1000e6) * cfg.comm_scale,
        ),
        memory=(
            np.full(N, 8e9),
            np.full(J2, 16e9),
            np.full(J3, 64e9),
            np.array([256e9]),
        ),
    )


@register_system("two-tier-client-edge")
def _two_tier_client_edge(cfg: SystemCfg) -> SystemSpec:
    return _two_tier(cfg, "client-edge")


@register_system("two-tier-client-cloud")
def _two_tier_client_cloud(cfg: SystemCfg) -> SystemSpec:
    return _two_tier(cfg, "client-cloud")


# --------------------------------------------------------------------------- #
# scenarios (delegated) and codecs
# --------------------------------------------------------------------------- #


def scenario_names() -> List[str]:
    from ..sim.scenarios import SCENARIOS

    return sorted(SCENARIOS)


CODECS: Dict[str, Callable] = dict(SCHEMES)


def register_codec(name: str, ctor: Callable) -> None:
    """Register a ``Compressor`` constructor under ``name``."""
    CODECS[name] = ctor


def resolve_codec(name: str, params: Dict) -> object:
    try:
        ctor = CODECS[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; available: {sorted(CODECS)}"
        ) from None
    return ctor(**params)
