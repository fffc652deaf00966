"""Layout rules for every architecture family and execution path — port of
``repro.launch.sharding``.

Layout contract (DESIGN.md §5):

* Training (Engine A): every parameter leaf is client-stacked on axis 0 —
  sharded over the client mesh axes (``data``, or ``pod+data`` multi-pod).
  Trailing *weight* dimensions get Megatron-style TP over ``model``:
  up-projections shard their output dim, down-projections their input dim,
  embedding/unembedding shard the vocab, MoE experts shard the expert axis
  (expert parallelism), Mamba projections shard the channel dim.
* Serving: one aggregated model copy — same TP rules, no client axis;
  decode batch shards over the client axes; the ``long_500k`` single-request
  shape shards the KV cache on the *sequence* dim over ``data`` and SSM
  state on heads over ``model``.

Every rule is divisibility-guarded: a dim that does not divide its mesh
axis stays replicated.

A spec is a ``PartitionSpec``: one entry per tensor dim, each a mesh axis
name, a tuple of names, or ``None`` (replicated).  The rules read only the
``shape`` of each leaf, so they take tensors, meta tensors or any shape
record, in the port's trees (nested dicts, lists and tuples).
``to_placements`` turns a tree of specs into ``torch.distributed.tensor``
placements on a ``DeviceMesh``; the sharded engine (``core.sharded``)
holds its client shards as plain local tensors laid out by
``train_pspecs``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

# name -> (axis position from the END of the leaf) to shard over `model`.
_TP_RULES: Dict[str, Optional[int]] = {
    # attention
    "wq": -1, "wk": -1, "wv": -1, "wo": -2,
    "bq": -1, "bk": -1, "bv": -1,
    "q_norm": None, "k_norm": None,
    # mlp
    "w1": -1, "w3": -1, "w2": -2,
    # embeddings
    "embed": -2, "unembed": -1, "proj": -1, "enc_pos": None,
    # moe (expert axis first; see _pspec_for_leaf)
    "router": None,
    # mamba
    "in_proj": -1, "out_proj": -2, "conv_w": -1, "gate_norm": -1,
    "A_log": None, "D": None, "dt_bias": None,
    # norms / vgg
    "norm": None, "w": None, "b": None,
}

_MOE_KEYS = {"w1", "w2", "w3"}


class PartitionSpec:
    """Per-dim mesh axes of one leaf: a name, a tuple of names, or None.

    A leaf of the spec trees, not a container, so the port's tree helpers
    and ``to_placements`` stop at it."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


def _map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` over a tree of dicts / lists / tuples, the names
    being the dict keys and sequence indices down to the leaf (the JAX
    ``_path_names`` of a key path)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)
        )
    return fn(path, tree)


def _map_leaves(fn: Callable, tree: Any) -> Any:
    """``fn(leaf)`` over a tree whose leaves may be specs (never descended)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _pspec_for_leaf(
    names: Tuple[str, ...],
    shape: Tuple[int, ...],
    tp: int,
    tp_axis: str,
    client_axes: Optional[Tuple[str, ...]],
) -> PartitionSpec:
    rank = len(shape)
    entries: list = [None] * rank
    if client_axes:
        entries[0] = client_axes if len(client_axes) > 1 else client_axes[0]
    leaf = names[-1] if names else ""
    in_moe = "moe" in names
    pos = _TP_RULES.get(leaf, None)
    if in_moe and leaf in _MOE_KEYS:
        # expert parallelism when E divides, else fall back to ff sharding
        e_pos = -3
        if shape[e_pos] % tp == 0:
            pos = e_pos
        else:
            pos = -1 if leaf in ("w1", "w3") else -2
    if pos is not None:
        idx = rank + pos
        clientish = 1 if client_axes else 0
        if idx >= clientish and shape[idx] % tp == 0 and shape[idx] >= tp:
            entries[idx] = tp_axis
    return PartitionSpec(*entries)


def param_pspecs(
    params: Any,
    *,
    tp: int = 16,
    tp_axis: str = "model",
    client_axes: Optional[Tuple[str, ...]] = None,
) -> Any:
    """Tree of ``PartitionSpec`` matching ``params`` (shapes or tensors)."""
    return _map_with_path(
        lambda names, leaf: _pspec_for_leaf(names, _shape(leaf), tp, tp_axis, client_axes),
        params,
    )


def train_pspecs(
    tree: Any,
    client_axes: Tuple[str, ...],
    num_clients: Optional[int] = None,
) -> Any:
    """Client-axis-only specs for the sharded *training* step
    (``core.sharded``): shard axis 0 of every client-stacked leaf over the
    client mesh axes, replicate everything else (scalar bookkeeping like
    adam's step counter, the host-side round counter).

    Deliberately distinct from ``param_pspecs``: Megatron TP over ``model``
    is a *serving* feature here — the training step keeps weights
    replicated across ``model`` and shards only the client axis.
    (``param_pspecs(tp=1, ...)`` would NOT express that: every weight dim
    divides 1, so every ``_TP_RULES`` entry would shard over ``model``.)

    ``num_clients`` restricts the client-stacked test to leaves whose
    leading dim matches (safe over mixed trees like a ``TrainState``);
    ``None`` treats every non-scalar leaf as client-stacked.  A
    ``TrainState`` maps to a ``TrainState`` of specs.
    """
    from ..core.engine import TrainState

    ca = client_axes if len(client_axes) > 1 else client_axes[0]

    def f(leaf):
        shape = _shape(leaf)
        stacked = len(shape) > 0 and (num_clients is None or shape[0] == num_clients)
        if stacked:
            return PartitionSpec(ca, *([None] * (len(shape) - 1)))
        return PartitionSpec()

    if isinstance(tree, TrainState):
        return TrainState(
            params=_map_leaves(f, tree.params),
            opt_state=_map_leaves(f, tree.opt_state),
            step=f(tree.step),
        )
    return _map_leaves(f, tree)


def batch_pspecs(batch: Any, client_axes: Tuple[str, ...]) -> Any:
    """Client-stacked batch leaves [N, b, ...]: shard the client axis."""
    ca = client_axes if len(client_axes) > 1 else client_axes[0]
    return _map_leaves(
        lambda leaf: PartitionSpec(ca, *([None] * (len(_shape(leaf)) - 1))), batch
    )


def opt_pspecs(opt_state: Any, pps: Any, opt_name: str) -> Any:
    """Optimizer-state specs follow the parameter specs leaf for leaf."""
    if opt_name == "sgd":
        return ()
    if opt_name == "momentum":
        return pps
    if opt_name == "adam":
        return {"m": pps, "v": pps, "t": PartitionSpec()}
    raise ValueError(opt_name)


def state_pspecs(spec_params: Any, opt_name: str, *, tp: int, client_axes):
    from ..core.engine import TrainState

    pps = param_pspecs(spec_params, tp=tp, client_axes=client_axes)
    return TrainState(
        params=pps, opt_state=opt_pspecs(None, pps, opt_name), step=PartitionSpec()
    )


# --------------------------------------------------------------------------- #
# serving (data for the decode path, ROADMAP A14)
# --------------------------------------------------------------------------- #

# cache leaf name -> (batch_pos, long_pos, long_axis), positions from the END
_CACHE_RULES = {
    "k": (-4, -3, "data"),
    "v": (-4, -3, "data"),
    "xk": (-4, -3, "data"),
    "xv": (-4, -3, "data"),
    "conv": (-3, -1, "model"),
    "state": (-4, -3, "model"),
    "positions": (None, None, None),
    "index": (None, None, None),
}


def _production_clients(client_axes: Tuple[str, ...]) -> int:
    return math.prod({"data": 16, "pod": 2}.get(a, 1) for a in client_axes)


def cache_pspecs(
    caches: Any,
    *,
    batch: int,
    client_axes: Tuple[str, ...],
    tp: int = 16,
    long_context: bool = False,
    seq_shard: bool = False,
) -> Any:
    """Decode caches: shard batch when it divides; long_500k shards the
    sequence (attention) / heads (SSM) instead.

    ``seq_shard=True`` additionally shards the attention-cache *sequence*
    dim over ``model``, so each model rank stores 1/tp of the cache."""
    n_client = _production_clients(client_axes)
    ca = client_axes if len(client_axes) > 1 else client_axes[0]

    def f(names, leaf):
        leafname = names[-1] if names else ""
        rule = _CACHE_RULES.get(leafname)
        shape = _shape(leaf)
        rank = len(shape)
        entries: list = [None] * rank
        if rule is None:
            return PartitionSpec(*entries)
        b_pos, l_pos, l_axis = rule
        if not long_context:
            if b_pos is not None and shape[rank + b_pos] % n_client == 0 \
               and shape[rank + b_pos] >= n_client:
                entries[rank + b_pos] = ca
            if seq_shard and l_pos is not None and leafname in ("k", "v") \
               and shape[rank + l_pos] % tp == 0 \
               and shape[rank + l_pos] >= tp:
                entries[rank + l_pos] = "model"
        else:
            if l_pos is not None:
                size = {"data": 16, "model": tp}[l_axis]
                if shape[rank + l_pos] % size == 0 and shape[rank + l_pos] >= size:
                    entries[rank + l_pos] = l_axis
        return PartitionSpec(*entries)

    return _map_with_path(f, caches)


def token_pspec(batch: int, client_axes: Tuple[str, ...]) -> PartitionSpec:
    n_client = _production_clients(client_axes)
    ca = client_axes if len(client_axes) > 1 else client_axes[0]
    if batch % n_client == 0 and batch >= n_client:
        return PartitionSpec(ca, None)
    return PartitionSpec(None, None)


def to_placements(mesh, pspecs: Any) -> Any:
    """Each spec of ``pspecs`` as the ``torch.distributed.tensor``
    placements on ``mesh`` (a ``DeviceMesh`` with named dims): one
    placement per mesh dim, ``Shard(d)`` when tensor dim d names that mesh
    dim (alone or in a tuple), else ``Replicate()`` — the port's
    ``to_shardings``.  A spec naming an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())

    def f(ps):
        if not isinstance(ps, PartitionSpec):
            raise TypeError(f"expected a PartitionSpec leaf, got {type(ps).__name__}")
        where: Dict[str, int] = {}
        for d, entry in enumerate(ps):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is None:
                    continue
                if ax not in names:
                    raise ValueError(f"{ps!r} names mesh axis {ax!r}; the mesh has {names}")
                where[ax] = d
        return tuple(Shard(where[n]) if n in where else Replicate() for n in names)

    return _map_leaves(f, pspecs)
