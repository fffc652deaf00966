"""Sharded Engine A: the client axis over ``torch.distributed`` ranks —
port of ``repro.core.sharded`` (DESIGN.md §17).

The single-process engine stacks every parameter leaf per client on axis
0 and realizes the HSFL hierarchy as ``tiers.synchronize``'s group means.
This module splits that client axis over the client axes of a
``DeviceMesh`` (``data``, or ``pod × data`` multi-pod — the
``launch.sharding`` layout): each rank holds ``n_local = N / D`` client
rows of every leaf as plain local tensors, runs Engine A's per-client
update on them, and lowers each aggregation level to whichever of two
strategies keeps the single-process semantics:

* **device-local** — when every group lives wholly on one rank
  (``groups % D == 0``), the level IS the single-process arithmetic on the
  local shard with ``groups / D`` groups: ``tiers._tier_levels`` /
  ``_masked_tier_levels`` on B1, B2 and B1m, bit-identical to the
  unsharded engine.  A tier whose entity and fed levels are both
  device-local keeps them fused in one B1 launch per leaf, so a world of
  one rank is the unsharded engine bit for bit.
* **spanning** — when a group spans ranks (the fed level, one group,
  always does for D > 1), each rank sums weight × row per group in f32
  together with the per-group weights, one ``all_reduce`` adds them over
  the client ranks, and each row takes its group's mean — a group with no
  weight keeps its rows.  A one-group level stays on the kernels: B1
  (``do_entity=0, do_global=1``) already computes Σ w·y, so its row 0 is
  the rank's partial sum, with w = 1/N (N the global client count) or the
  participation/guard mask, over the int8 wire on B2.  A level with G > 1
  groups is the JAX einsum, a ``torch.matmul`` of the ``[G, n_local]``
  weight matrix and the ``[n_local, P]`` shard.  The result equals the
  single-process one up to f32 summation order.

The §16 guard survives sharding exactly: per-client finite checks and
norm² are local arithmetic, and the fleet median is taken over an
``all_gather`` of the per-client norm vectors — the same multiset of
values the single-process median sorts.  The round loss is the
single-process formula over an ``all_gather`` of the per-client losses
and weights.

There is no ``shard_map``: the step is ``engine.build_train_step_a``'s
arithmetic on local shards, with collectives where JAX has ``psum`` or
``all_gather``.  Ranks on the mesh's ``model`` axis hold equal copies;
every collective runs over the client sub-mesh's group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from .._tree import tree_leaves, tree_map
from ..kernels.tiered_aggregate import aggregate_tree
from ..kernels.tiered_aggregate.ops import tiered_aggregate, tiered_aggregate_q8
from ..optim import Optimizer
from .engine import TrainState, _masked_select, masked_mean_loss, replicate_for_clients
from .tiers import (
    GuardSpec,
    TierPlan,
    _compressed,
    _entity_groups,
    _fed_do,
    _fused_q8,
    _masked_tier_levels,
    _median,
    _per_client,
    _stacked,
    _tier_levels,
    combine_tiers,
    tier_subtrees,
)

Params = Dict[str, Any]


def _axis_tuple(client_axes) -> Tuple[str, ...]:
    if isinstance(client_axes, str):
        return (client_axes,)
    return tuple(client_axes)


def _axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def num_client_shards(mesh, client_axes) -> int:
    n = 1
    for a in _axis_tuple(client_axes):
        n *= _axis_size(mesh, a)
    return n


def _shard_index(mesh, axis_names: Tuple[str, ...]) -> int:
    """This rank's row-major index over the client axes."""
    idx = 0
    for ax in axis_names:
        idx = idx * _axis_size(mesh, ax) + mesh.get_local_rank(ax)
    return idx


def _client_base(mesh, axis_names: Tuple[str, ...], n_local: int) -> int:
    """Global client id of this shard's row 0.

    Clients lay out row-major over the client axes, so the shard index is
    the mixed-radix expansion of this rank's mesh coordinates in the given
    order."""
    return _shard_index(mesh, axis_names) * n_local


@dataclass(frozen=True)
class ClientShards:
    """This rank's place among the client shards of a mesh: the process
    group of the client sub-mesh it belongs to (ranks on the ``model`` axis
    run in separate, equal groups), the shard count D and its index.

    ``recorder`` (a list; the dry-run's virtual mesh, ``launch.dryrun_lib``)
    replaces the group: each collective appends ``{"op", "result_bytes",
    "group"}`` and returns what one rank's call would, communicating
    nothing."""

    group: Any
    num_shards: int
    index: int
    recorder: Optional[list] = None


_SHARDS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, ClientShards]] = {}


def client_shards(mesh, client_axes=("data",)) -> ClientShards:
    """The ``ClientShards`` of ``mesh`` over ``client_axes``, made once per
    mesh (a multi-axis client group is a collective call on every rank)."""
    import torch.distributed as dist

    ca = _axis_tuple(client_axes)
    recorder = getattr(mesh, "recorder", None)
    if recorder is not None:  # a virtual mesh: no ranks behind it
        return ClientShards(None, num_client_shards(mesh, ca), _shard_index(mesh, ca), recorder)
    key = (id(mesh), ca)
    hit = _SHARDS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    if len(ca) == 1:
        group = mesh.get_group(ca[0])
    else:
        names = list(mesh.mesh_dim_names)
        rest = [n for n in names if n not in ca]
        ranks = mesh.mesh.permute(*[names.index(n) for n in rest + list(ca)])
        ranks = ranks.reshape(-1, num_client_shards(mesh, ca)).tolist()
        group, _ = dist.new_subgroups_by_enumeration(ranks)
    shards = ClientShards(group, num_client_shards(mesh, ca), _shard_index(mesh, ca))
    _SHARDS[key] = (mesh, shards)
    return shards


def _through_host(x: torch.Tensor, sh: ClientShards) -> bool:
    """gloo moves a card's tensors through the host: the collective is
    staged on a host copy (ranks sharing one card, ``launch.mesh``)."""
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(sh.group) == "gloo"


def _record(sh: ClientShards, op: str, result: torch.Tensor) -> None:
    sh.recorder.append({"op": op, "result_bytes": result.numel() * result.element_size(),
                        "group": sh.num_shards})


def _all_reduce(buf: torch.Tensor, sh: ClientShards) -> torch.Tensor:
    """Sum ``buf`` over the client shards, in place."""
    import torch.distributed as dist

    if sh.recorder is not None:
        _record(sh, "all-reduce", buf)
        return buf
    if _through_host(buf, sh):
        host = buf.cpu()
        dist.all_reduce(host, group=sh.group)
        return buf.copy_(host)
    dist.all_reduce(buf, group=sh.group)
    return buf


def _all_gather(x: torch.Tensor, sh: ClientShards) -> torch.Tensor:
    """Concatenate every shard's ``x`` on axis 0, in client order."""
    import torch.distributed as dist

    if sh.recorder is not None:
        out = torch.cat([x] * sh.num_shards, dim=0)  # the gathered shape
        _record(sh, "all-gather", out)
        return out

    src = x.cpu() if _through_host(x, sh) else x.contiguous()
    out = [torch.empty_like(src) for _ in range(sh.num_shards)]
    dist.all_gather(out, src, group=sh.group)
    return torch.cat(out, dim=0).to(x.device)


def local_rows(tree: Any, mesh, client_axes, num_clients: int) -> Any:
    """This rank's client rows of every leaf with a leading axis of
    ``num_clients`` (tensors or NumPy arrays); other leaves pass through.
    Every rank draws the round's global batch from the seed and keeps its
    rows, so the sharded and unsharded runs see the same numbers."""
    D = num_client_shards(mesh, client_axes)
    n_local = num_clients // D
    base = _client_base(mesh, _axis_tuple(client_axes), n_local)

    def f(x):
        shape = getattr(x, "shape", ())
        if D > 1 and len(shape) > 0 and shape[0] == num_clients:
            return x[base:base + n_local]
        return x

    return tree_map(f, tree)


def gather_clients(tree: Any, mesh, client_axes, n_local: int) -> Any:
    """Every client-stacked leaf of a local shard tree (leading axis
    ``n_local``) all-gathered to the full ``[N, ...]`` leaf on every rank;
    other leaves pass through."""
    sh = client_shards(mesh, client_axes)

    def f(x):
        if _stacked(x, n_local):
            return _all_gather(x, sh)
        return x

    return tree_map(f, tree)


# --------------------------------------------------------------------------- #
# the levels
# --------------------------------------------------------------------------- #


def _kernel_group_mean(tree: Params, n_global: int, sh: ClientShards,
                       w: Optional[torch.Tensor], keep: Optional[Params] = None,
                       wire=None) -> Params:
    """A one-group level across shards on the aggregation kernels.

    Per leaf, B1 with ``do_entity=0, do_global=1`` (B2 over the int8 wire)
    writes Σ w·y to every local row; row 0 is the rank's f32 partial sum,
    with w = 1/N (N global) or the mask ``w``, whose sum rides along as the
    count.  One ``all_reduce`` of every leaf's row (and the count) sums the
    partials over the client shards; under a mask each row takes tot /
    count, or its ``keep`` row where the count is 0."""
    leaves = [x for x in tree_leaves(tree) if x.numel()]
    if not leaves:
        return tree
    n_local = leaves[0].shape[0]
    device = leaves[0].device
    weights = (torch.full((n_local,), 1.0 / n_global, dtype=torch.float32, device=device)
               if w is None else w)
    codec = wire
    if codec is not None and not _fused_q8(codec):
        tree = tree_map(lambda x: _per_client(codec, x), tree)
        codec = None

    def partial(x):
        flat = x.reshape(n_local, -1).float().contiguous()
        if codec is not None:
            out = tiered_aggregate_q8(flat, weights, False, True, 1, codec.tile)
        else:
            out = tiered_aggregate(flat, weights, False, True, 1)
        return out[0]

    rows = [partial(x) for x in tree_leaves(tree) if x.numel()]
    if w is not None:
        rows.append(torch.sum(w).reshape(1))
    buf = _all_reduce(torch.cat(rows), sh)
    sums = iter(torch.split(buf, [r.numel() for r in rows]))
    count = buf[-1] if w is not None else None

    def f(x, k):
        if not x.numel():
            return x
        tot = next(sums)
        if count is None:
            return tot.to(x.dtype).expand(n_local, -1).reshape(x.shape).contiguous()
        mean = (tot / torch.clamp(count, min=1.0)).to(x.dtype)
        mean = mean.expand(n_local, -1).reshape(x.shape)
        return torch.where(count > 0.0, mean, k)

    return tree_map(f, tree, tree if keep is None else keep)


def _matmul_group_mean(
    tree: Params,
    groups: int,
    n_global: int,
    sh: ClientShards,
    w: Optional[torch.Tensor],
    keep: Optional[Params] = None,
) -> Params:
    """Cross-shard group mean with G > 1 groups, one matmul per leaf.

    ``tree`` leaves are local shards [n_local, ...]; some group of the
    ``n_global``-client fleet spans shards.  Each rank contracts the
    ``[G, n_local]`` weight matrix (group one-hot × weights) with its
    ``[n_local, P]`` shard in f32; one ``all_reduce`` sums the partial
    products and the per-group weights; each row gathers its own group's
    mean, or keeps its ``keep`` row where the group has no weight."""
    leaves = [x for x in tree_leaves(tree) if x.numel()]
    if not leaves:
        return tree
    n_local = leaves[0].shape[0]
    device = leaves[0].device
    base = sh.index * n_local
    gs = n_global // groups
    gid = (base + torch.arange(n_local, device=device)) // gs          # [n_local]
    onehot = (gid[:, None] == torch.arange(groups, device=device)[None, :]).float()
    wl = torch.ones((n_local,), dtype=torch.float32, device=device) if w is None else w
    ww = onehot * wl[:, None]                                           # [n_local, G]
    wt = ww.t().contiguous()                                            # [G, n_local]
    rows = [torch.matmul(wt, x.reshape(n_local, -1).float()).reshape(-1) for x in leaves]
    rows.append(torch.sum(ww, dim=0))
    buf = _all_reduce(torch.cat(rows), sh)
    sums = iter(torch.split(buf, [r.numel() for r in rows]))
    cnt = buf[-groups:]
    alive = cnt[gid] > 0.0                                              # [n_local]

    def f(x, k):
        if not x.numel():
            return x
        tot = next(sums).reshape(groups, -1)
        mean = tot / torch.clamp(cnt, min=1.0)[:, None]
        mine = mean[gid].to(x.dtype).reshape(x.shape)
        return torch.where(alive.reshape((n_local,) + (1,) * (x.ndim - 1)), mine, k)

    return tree_map(f, tree, tree if keep is None else keep)


def _spanning_level(tree, groups: int, n_global: int, sh: ClientShards, mask,
                    keep=None, wire=None):
    if groups == 1:
        return _kernel_group_mean(tree, n_global, sh, mask, keep, wire)
    return _matmul_group_mean(tree, groups, n_global, sh, mask, keep)


def sharded_guard_health(
    tree: Params,
    n_local: int,
    guard: GuardSpec,
    mesh,
    client_axes=("data",),
    *,
    sanitize: bool = True,
):
    """``tiers.guard_health`` on a client shard: local finite/norm²
    arithmetic, the fleet-median blow-up reference over an ``all_gather``
    of the ``[n_local]`` norm² vectors (the same multiset, so the same
    median).  Returns (health [n_local], sanitized tree or None)."""
    sh = client_shards(mesh, client_axes)
    stacked = [x for x in tree_leaves(tree) if _stacked(x, n_local) and x.numel()]
    device = stacked[0].device if stacked else torch.device("cpu")
    finite = torch.ones((n_local,), dtype=torch.bool, device=device)
    raw2 = torch.zeros((n_local,), dtype=torch.float32, device=device)
    for x in stacked:
        f = x.reshape(n_local, -1)
        lo, hi = torch.aminmax(f, dim=1)
        finite &= torch.isfinite(lo) & torch.isfinite(hi)
        raw2 = raw2 + torch.linalg.vector_norm(f, dim=1, dtype=torch.float32) ** 2
    norm2 = torch.where(finite, raw2, torch.zeros((), dtype=torch.float32, device=device))
    med = _median(_all_gather(norm2, sh))
    blowup = norm2 > guard.norm_factor * torch.clamp(med, min=1e-30)
    health = (finite & ~blowup).float()

    def clean(x):
        if not _stacked(x, n_local):
            return x
        ok = finite.reshape((n_local,) + (1,) * (x.ndim - 1))
        return torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=x.device))

    return health, (tree_map(clean, tree) if sanitize else None)


def _tier_sync(part, plan: TierPlan, m: int, do_global: bool, sh: ClientShards,
               mask, wire, weights):
    """Tier m's levels on a shard: device-local ones on the unsharded
    kernels' arithmetic, spanning ones through ``_spanning_level``."""
    D = sh.num_shards
    N = plan.num_clients
    groups = _entity_groups(plan, m)

    def local(tree, g, do_fed, w):
        if mask is not None:
            return _masked_tier_levels(tree, mask, g, do_fed, w)
        dense = lambda t, *flags, **kw: aggregate_tree(t, weights, *flags, **kw)
        return _tier_levels(tree, dense, g, do_fed, w)

    if groups % D == 0 and (not do_global or D == 1):
        return local(part, groups // D, do_global, wire)
    if groups:
        if groups % D == 0:
            part = local(part, groups // D, False, None)
        else:
            part = _spanning_level(part, groups, N, sh, mask)
    if do_global:
        part = _spanning_level(part, 1, N, sh, mask, keep=part, wire=wire)
    return part


def sharded_synchronize(
    params: Params,
    plan: TierPlan,
    step: int,
    *,
    mesh,
    client_axes=("data",),
    fed_round=None,
    compressor=None,
    mask=None,
    guard: Optional[GuardSpec] = None,
) -> Params:
    """``tiers.synchronize`` on this rank's client shard.

    Semantics (fed-wire compression placement, mask weighting,
    zero-participant keep-last, guard quarantine, ``fed_round``
    specialization) mirror ``synchronize`` level for level; only each
    level's strategy changes (module docstring).  ``mask`` is this shard's
    ``[n_local]`` rows.  Device-local levels are bit-identical; spanning
    levels differ by f32 summation order only."""
    ca = _axis_tuple(client_axes)
    sh = client_shards(mesh, ca)
    N = plan.num_clients
    n_local = N // sh.num_shards
    if guard is not None:
        health, params = sharded_guard_health(params, n_local, guard, mesh, ca)
        mask = health if mask is None else mask.to(health.device, torch.float32) * health
    device = tree_leaves(params)[0].device
    if mask is not None:
        mask = mask.to(device=device, dtype=torch.float32).contiguous()
    if fed_round is not None and not isinstance(fed_round, (tuple, list)):
        fed_round = (bool(fed_round),) * plan.M
    weights = torch.full((n_local,), 1.0 / N, dtype=torch.float32, device=device)
    out_parts = []
    for m, part in enumerate(tier_subtrees(params, plan)):
        wire = compressor if _compressed(plan, m, compressor) else None
        out_parts.append(_tier_sync(part, plan, m, _fed_do(plan, m, step, fed_round),
                                    sh, mask, wire, weights))
    return combine_tiers(out_parts, params)


def sharded_fed_level(src: Params, plan: TierPlan, *, mesh, client_axes=("data",),
                      compressor=None, mask=None) -> Params:
    """One tier's fed level spanning the client shards, on this rank's
    shard ``src`` (the deferred apply of ``async_agg.fed_level_apply``);
    ``compressor`` is the tier's wire or None, ``mask`` the shard's rows."""
    if mask is not None:
        mask = mask.to(device=tree_leaves(src)[0].device, dtype=torch.float32).contiguous()
    return _spanning_level(src, 1, plan.num_clients, client_shards(mesh, client_axes),
                           mask, keep=src, wire=compressor)


# --------------------------------------------------------------------------- #
# the sharded Engine-A step
# --------------------------------------------------------------------------- #


def sharded_state_specs(state: TrainState, num_clients: int, client_axes):
    """``PartitionSpec`` tree for a ``TrainState``: client axis 0 over the
    client axes, scalar bookkeeping replicated (``launch.sharding``'s
    training-step layout)."""
    from ..launch.sharding import train_pspecs

    return train_pspecs(state, _axis_tuple(client_axes), num_clients)


def init_sharded_state_a(
    model, plan: TierPlan, opt: Optimizer, generator: torch.Generator, mesh,
    client_axes=("data",), device=None,
) -> TrainState:
    """This rank's shard of ``init_state_a``: every rank draws the same
    init from ``generator`` (Engine A's replicas are identical) and keeps
    its ``n_local`` client rows, on ``device`` (default: the mesh's device
    for this rank)."""
    from ..launch.mesh import mesh_device

    D = num_client_shards(mesh, client_axes)
    if plan.num_clients % D != 0:
        raise ValueError(
            f"num_clients={plan.num_clients} must divide over the "
            f"{D} client shards of mesh axes {_axis_tuple(client_axes)!r}"
        )
    p0 = model.init_params(generator, device if device is not None else mesh_device(mesh))
    params = replicate_for_clients(p0, plan.num_clients // D)
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def build_sharded_train_step_a(
    model,
    plan: TierPlan,
    opt: Optimizer,
    mesh,
    *,
    client_axes=("data",),
    sync_opt_state: bool = False,
    fed_round=None,
    compressor=None,
    with_mask: bool = False,
    guard: Optional[GuardSpec] = None,
    with_sync_weights: bool = False,
) -> Callable[..., Tuple]:
    """``engine.build_train_step_a`` on client shards.

    Same contract as the single-process builder for the features that
    survive sharding (fed_round / compressor / with_mask / guard /
    sync_opt_state / with_sync_weights); ``privacy`` and ``class_members``
    are *not* accepted — ``api.build`` refuses those spec combinations at
    build time (DESIGN.md §17 capability matrix).

    The step takes and returns this rank's shard of a ``TrainState``
    (``init_sharded_state_a``).  The batch and mask may be the global
    ``[N, ...]`` ones, of which it keeps this rank's rows, or the rank's
    own rows.  The loss is the global round loss, equal on every rank;
    under ``with_sync_weights`` the weights returned are the shard's
    ``[n_local]``.
    """
    ca = _axis_tuple(client_axes)
    D = num_client_shards(mesh, ca)
    N = plan.num_clients
    if N % D != 0:
        raise ValueError(
            f"num_clients={N} must divide over the {D} client shards of "
            f"mesh axes {ca!r}"
        )
    n_local = N // D
    sh = client_shards(mesh, ca)
    per_client = vmap(grad_and_value(model.loss_fn))

    def _sync(tree, step, compress=None, mask=None):
        return sharded_synchronize(
            tree, plan, step, mesh=mesh, client_axes=ca, fed_round=fed_round,
            compressor=compress, mask=mask, guard=guard,
        )

    def _round_loss(losses, w):
        """The unsharded formula over the gathered [N] losses and weights."""
        cols = [losses.float()] + ([] if w is None else [w])
        allv = _all_gather(torch.stack(cols, dim=1), sh)
        all_l = allv[:, 0].contiguous()
        if w is None:
            return torch.mean(all_l), None
        all_w = allv[:, 1].contiguous()
        return masked_mean_loss(all_l, all_w), (all_l, all_w)

    def _step(state: TrainState, batch: Params, mask):
        batch = local_rows(batch, mesh, ca, N)
        grads, losses = per_client(state.params, batch)
        new_params, new_opt = opt.update(state.params, grads, state.opt_state)
        if mask is not None:
            mask = local_rows(mask, mesh, ca, N).to(device=losses.device,
                                                    dtype=torch.float32)
        if guard is not None:
            health, _ = sharded_guard_health(new_params, n_local, guard, mesh, ca,
                                             sanitize=False)
            lfin = torch.isfinite(losses)
            health = health * lfin.float()
            w = health if mask is None else mask * health
            new_params = _masked_select(new_params, state.params, w)
            new_opt = _masked_select(new_opt, state.opt_state, w)
            lsafe = torch.where(lfin, losses, torch.zeros((), dtype=losses.dtype,
                                                          device=losses.device))
            loss, (all_l, all_w) = _round_loss(lsafe, w)
            if mask is None:
                # an all-healthy unmasked round reports the exact plain mean
                loss = torch.where(torch.all(all_w >= 1.0), torch.mean(all_l), loss)
            sync_mask = w
        elif mask is None:
            loss, _ = _round_loss(losses, None)
            sync_mask = None
        else:
            w = mask
            new_params = _masked_select(new_params, state.params, w)
            new_opt = _masked_select(new_opt, state.opt_state, w)
            loss, _ = _round_loss(losses, w)
            sync_mask = w
        new_params = _sync(new_params, state.step, compress=compressor, mask=sync_mask)
        if sync_opt_state and tree_leaves(new_opt):
            if opt.name == "momentum":
                new_opt = _sync(new_opt, state.step, mask=sync_mask)
            elif opt.name == "adam":
                new_opt = dict(new_opt)
                new_opt["m"] = _sync(new_opt["m"], state.step, mask=sync_mask)
                new_opt["v"] = _sync(new_opt["v"], state.step, mask=sync_mask)
        new_state = TrainState(new_params, new_opt, state.step + 1)
        if with_sync_weights:
            ww = (torch.ones((n_local,), dtype=torch.float32, device=losses.device)
                  if sync_mask is None else sync_mask)
            return new_state, loss, ww
        return new_state, loss

    if with_mask:
        def step(state, batch, mask=None):
            if mask is None:
                mask = torch.ones((N,), dtype=torch.float32)
            return _step(state, batch, torch.as_tensor(mask))
        return step
    return lambda state, batch: _step(state, batch, None)
