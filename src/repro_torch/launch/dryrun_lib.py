"""Dry-run engine — port of ``repro.launch.dryrun_lib``: one rank's view of
each (arch × shape × mesh) case, run on ``meta`` tensors, and the roofline
inputs reckoned from it.

The JAX package lowers and compiles each case on 256 or 512 forced host
devices and reads XLA's cost and memory analyses and the HLO's
collectives.  The port has neither GSPMD nor forced devices.  It takes a
virtual mesh (``VirtualMesh``: the axis names and sizes of
``launch.mesh.POD_SHAPE`` / ``MULTIPOD_SHAPE``, no ranks behind them),
builds the case's state and inputs on the ``meta`` device at one rank's
shapes — the global shapes cut by ``launch.sharding``'s specs over the
client axes — and runs the port's real step on them:

* train: the sharded Engine A step (``core.sharded``) on the rank's
  ``n_local`` clients;
* prefill: ``SplittableModel.forward`` on the rank's batch rows;
* decode: ``decode_step`` on the rank's batch rows of the caches, one
  token at the end of a full cache.

Per case, for one rank:

* ``flops``: the matmul-like products that
  ``torch.utils.flop_counter.FlopCounterMode`` counts, plus each kernel
  call's model FLOPs (``kernel_work``: attention by its visible pairs,
  forward 4·hd a pair and backward 8·hd, the products that the math
  needs; the kernels' own operations, which recompute s, are
  ``kernel_ops``).  Elementwise work is not counted;
* ``bytes_accessed``: every aten op's input and output bytes, unfused
  (views move none), plus each kernel call's reckoned bytes;
* ``arg_bytes`` / ``out_bytes``: the step's inputs and outputs on this rank
  from the layout specs on the virtual mesh; ``temp_bytes``: the peak of
  the ``meta`` storage bytes made during the step and alive at once
  (outputs included: the port donates nothing), tracked by a
  ``TorchDispatchMode``; ``alias_bytes``: the caches that decoding writes
  in place;
* ``collectives``: what the sharded engine issues, recorded by its two
  funnels on the virtual mesh (``ClientShards.recorder``), in JAX's record
  form, read by ``collective_traffic_bytes`` unchanged.  The port has no
  tensor parallelism (ranks on ``model`` hold copies), so no ``model``-axis
  collective appears, and serving issues none.

A kernel wrapper on ``meta`` tensors launches nothing (``kernels.meta``).
The record has every key of JAX's but ``compile_s`` and ``hlo_bytes``,
which name XLA artefacts.  ``unrolled`` is True: the port's unit loop is a
Python loop, and every unit is counted.
"""
from __future__ import annotations

import json
import math
import os
import re
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .._tree import tree_leaves, tree_map
from ..configs import get_spec
from ..configs.shapes import LONG_CONTEXT_WINDOW, SHAPES, InputShape, input_specs, sds
from ..core.engine import TrainState, build_train_step_a, replicate_for_clients
from ..core.sharded import build_sharded_train_step_a
from ..core.tiers import default_plan
from ..kernels import meta as kernel_meta
from ..models.model import SplittableModel
from ..optim import adam, momentum, sgd
from . import sharding as sh
from .mesh import MULTIPOD_SHAPE, POD_SHAPE

# families whose full attention is quadratic -> long_500k runs the
# sliding-window variant (window = 8192); ssm/hybrid run natively.
QUADRATIC_FAMILIES = {"dense", "moe", "vlm", "audio"}

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "f32": 4, "bf16": 2, "f16": 2, "f64": 8, "s32": 4, "u32": 4,
    "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8, "s16": 2, "u16": 2,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")

# the JAX package's models.layers.BLOCKWISE_THRESHOLD: Sq*Sk above its
# square takes JAX's blockwise attention, whose inner scans XLA counts once.
# The port's attention is the flash kernels at every length.
BLOCKWISE_THRESHOLD = 4096


def _shape_bytes(type_str: str) -> int:
    """Sum bytes of every typed buffer in an HLO result type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> List[Dict[str, Any]]:
    """Extract every collective op with its per-device result bytes."""
    out: List[Dict[str, Any]] = []
    for line in hlo_text.splitlines():
        ls = line.strip()
        m = re.match(r"%?[\w.\-]+ = (.*?) (" + "|".join(COLLECTIVE_OPS) + r")[.\d]*\(", ls)
        if not m:
            # also catch "ROOT %x = ..."
            m = re.match(
                r"ROOT %?[\w.\-]+ = (.*?) (" + "|".join(COLLECTIVE_OPS) + r")[.\d]*\(",
                ls,
            )
        if not m:
            continue
        type_str, op = m.group(1), m.group(2)
        rb = _shape_bytes(type_str)
        g = None
        gm = _GROUPS_RE.search(ls)
        if gm:
            g = int(gm.group(2))  # [groups, participants]
        else:
            gl = _GROUPS_LIST_RE.search(ls)
            if gl:
                g = len(gl.group(1).split(","))
        out.append({"op": op, "result_bytes": rb, "group": g})
    return out


def collective_traffic_bytes(colls: List[Dict[str, Any]]) -> float:
    """Per-device ICI traffic model (ring algorithms):
    all-gather: receive ≈ result; all-reduce: 2×result (RS+AG phases);
    reduce-scatter: receive ≈ result×(g−1); all-to-all: result;
    collective-permute: result."""
    total = 0.0
    for c in colls:
        b, g = c["result_bytes"], c["group"] or 2
        if c["op"] == "all-reduce":
            total += 2.0 * b * (g - 1) / g
        elif c["op"] == "all-gather":
            total += b * (g - 1) / g
        elif c["op"] == "reduce-scatter":
            total += b * (g - 1)
        else:
            total += b
    return total


def blockwise_attn_corr_flops(spec, shape, num_devices: int) -> float:
    """JAX's analytic per-device FLOPs inside its *blockwise-attention*
    inner scans (``layers._blockwise_sdpa``), which XLA's cost_analysis
    counts once: score flops QK^T + PV = 4·B·Sq·Sk_eff·(H·hd), causal
    Sk_eff ≈ Sk/2, for the shapes with Sq*Sk > BLOCKWISE_THRESHOLD^2;
    ×4 for a remat train step (fwd + refwd + 2x bwd); per device =
    total/num_devices.  The port's counts need no such correction (every
    attention call is reckoned, ``kernel_work``); the record keeps JAX's
    number beside them."""
    if shape.kind not in ("train", "prefill"):
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    d_attn = spec.num_heads * spec.hd

    def one(Sq: int, Sk: int, n_layers: int, causal: bool = True) -> float:
        if Sq * Sk <= BLOCKWISE_THRESHOLD**2:
            return 0.0
        eff = Sk / 2.0 if causal else float(Sk)
        return 4.0 * B * Sq * eff * d_attn * n_layers

    if spec.family == "ssm":
        total = 0.0
    elif spec.family == "audio":
        # enc self-attn (1500^2) is below threshold; dec self + cross are not
        total = one(S, S, spec.num_layers, causal=True)
        total += one(S, spec.encoder_len, spec.num_layers, causal=False)
    elif spec.family == "hybrid":
        total = one(S, S, spec.n_units)  # one attn layer per super-block
    else:
        total = one(S, S, spec.num_layers)
    mult = 4.0 if shape.kind == "train" else 1.0  # remat: fwd + refwd + 2x bwd
    return mult * total / num_devices


# --------------------------------------------------------------------------- #
# the kernels' work
# --------------------------------------------------------------------------- #


def attention_pairs(Sq: int, Sk: int, window: int, prefix: int = 0) -> int:
    """(query, key) pairs a head that the flash-attention kernels' mask lets
    through, with the kernels' effective window and prefix (0 <= prefix <=
    Sk; 0 window: none): query p sees keys max(0, p − W + 1) ..
    min(max(p, prefix − 1), Sk − 1)."""
    p = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(np.maximum(p, prefix - 1), Sk - 1)
    lo = np.maximum(0, p - window + 1) if window > 0 else np.zeros_like(p)
    return int(np.maximum(hi - lo + 1, 0).sum())


def visible_pairs(S: int, window: int, prefix: int = 0) -> int:
    """Self-attention's (query, key) pairs a head under the causal,
    windowed or prefix mask (``attention_pairs`` at Sq = Sk = S; a window of
    at least S is none, a prefix beyond S every key)."""
    w = 0 if window <= 0 or window >= S else window
    return attention_pairs(S, S, w, min(max(prefix, 0), S))


def pairs_work(B, Sq, Sk, H, K, hd, pairs: int, elt: int = 4):
    """{kernel: (operations, bytes)} of B4 and the two B5 passes with Sq
    query rows against Sk key rows and ``pairs`` visible (query, key)
    pairs a head: each input read once, each output written once (``elt``
    bytes an element, lse and delta f32), multiply-adds counted as 2."""
    pairs = pairs * B * H
    qb, kb, rows = elt * B * Sq * H * hd, elt * B * Sk * K * hd, 4 * B * H * Sq
    return {
        # s = q·k, o += p·v
        "swa_attention_fwd": (4 * hd * pairs, 2 * qb + 2 * kb + rows),
        # s, dp = do·v, dq += ds·k; delta = rowsum(o·do)
        "swa_attention_bwd_dq": (6 * hd * pairs + 2 * B * Sq * H * hd, 4 * qb + 2 * kb + 2 * rows),
        # s, dp, dv += p·do, dk += ds·q
        "swa_attention_bwd_dkv": (8 * hd * pairs, 2 * qb + 4 * kb + 2 * rows),
    }


def attention_work(B, S, H, K, hd, window, prefix: int = 0):
    """``pairs_work`` of self-attention over the pairs its mask lets through."""
    return pairs_work(B, S, S, H, K, hd, visible_pairs(S, window, prefix))


def decode_work(B, C, H, K, hd, visible: int, read_slots: int, elt: int = 4):
    """(operations, bytes) of decode attention: s = q.k and o += p.v over the
    visible slots (2 flops a multiply-add); q read and o written once in
    the input dtype (``elt`` bytes), k and v of the ``read_slots`` (the
    slots of the tiles that hold a visible slot: B4d skips the others), and
    cache_pos and q_pos once."""
    ops = 4 * hd * B * H * visible
    nbytes = elt * (2 * B * H * hd + 2 * B * K * hd * read_slots) + 4 * (C + 1)
    return ops, nbytes


def aggregate_work(name: str, N: int, P: int, de: bool, dg: bool, elt: int = 4,
                   tile: int = 0):
    """(operations, bytes) of one aggregation call on [N, P]: the entity
    means (an add an element) and the weighted global sum (a multiply-add),
    the int8 load's dequantizing multiply; x (or q and its scales) and
    B1m's ``keep`` read once, the output written once."""
    ops = N * P * (int(de) + 2 * int(dg))
    if tile:  # the int8 wire: q [N, P] int8, a scale a tile, f32 out
        ops += N * P
        nbytes = N * P + 4 * N * (P // tile) + 4 * N * P + 4 * N
    else:
        nbytes = 2 * N * P * elt + 4 * N
    if name.startswith("masked"):
        nbytes += N * P * (elt if not tile else 4)
    return ops, nbytes


def kernel_work(name: str, shape: Dict[str, Any]) -> Dict[str, float]:
    """One kernel call on ``meta`` (``kernels.meta.record``'s name and
    shape): {"flops": the model FLOPs, "ops": the kernel's operations,
    "bytes": its bytes}.  Attention's model FLOPs are the products the math
    needs, forward 4·hd a visible pair, dq and dk/dv 4·hd each; the
    kernels recompute s (and dk/dv dp), which ``ops`` counts.  The dk/dv
    pass's ``splits`` > 1 (head dim 256) adds its workspace's bytes: each
    split's f32 dk and dv written, then read by the merge.  A decode step
    is reckoned at a full cache (every slot visible)."""
    if name.startswith("swa_attention"):
        pairs = attention_pairs(shape["Sq"], shape["Sk"], shape["window"], shape["prefix"])
        ops, nbytes = pairs_work(shape["B"], shape["Sq"], shape["Sk"], shape["H"], shape["K"],
                                 shape["hd"], pairs, shape["elt"])[name]
        splits = shape.get("splits", 1)
        if splits > 1:
            nbytes += 2 * 4 * splits * 2 * shape["B"] * shape["Sk"] * shape["K"] * shape["hd"]
        flops = 4 * shape["hd"] * pairs * shape["B"] * shape["H"]
        return {"flops": float(flops), "ops": float(ops), "bytes": float(nbytes)}
    if name == "swa_decode":
        C = shape["C"]
        ops, nbytes = decode_work(shape["B"], C, shape["H"], shape["K"], shape["hd"], C, C,
                                  shape["elt"])
        return {"flops": float(ops), "ops": float(ops), "bytes": float(nbytes)}
    ops, nbytes = aggregate_work(name, shape["N"], shape["P"], shape["de"], shape["dg"],
                                 shape.get("elt", 4), shape.get("tile", 0))
    return {"flops": float(ops), "ops": float(ops), "bytes": float(nbytes)}


# --------------------------------------------------------------------------- #
# the virtual mesh and one rank's shapes
# --------------------------------------------------------------------------- #


class VirtualMesh:
    """A mesh's axis names and sizes with no ranks behind it: rank 0's view
    (index 0 on every axis).  The sharded engine takes it as a mesh
    (``size``, ``mesh_dim_names``, ``get_local_rank``), and its collectives
    append to ``recorder`` instead of communicating."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        self.axis_names = tuple(axis_names)
        self.mesh_dim_names = self.axis_names
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.recorder: List[Dict[str, Any]] = []

    def size(self, mesh_dim: Optional[int] = None) -> int:
        if mesh_dim is None:
            return math.prod(self.shape.values())
        return self.shape[self.axis_names[mesh_dim]]

    def get_local_rank(self, mesh_dim) -> int:
        return 0


def make_virtual_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """The production mesh's axes: (data=16, model=16), or (pod=2, data=16,
    model=16) multi-pod."""
    if multi_pod:
        return VirtualMesh(MULTIPOD_SHAPE, ("pod", "data", "model"))
    return VirtualMesh(POD_SHAPE, ("data", "model"))


def _rank_shape(shape, pspec, mesh: VirtualMesh, axes) -> Tuple[int, ...]:
    """``shape`` on one rank: each dim divided by the sizes of the axes of
    ``axes`` that its spec entry names (the port shards over the client
    axes only: ranks on ``model`` hold copies)."""
    out = list(shape)
    for d, entry in enumerate(pspec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax in axes:
                out[d] //= mesh.shape[ax]
    return tuple(out)


def _rank_tree(tree, pspecs, mesh, axes):
    """``meta`` tensors of one rank's shapes of a tree and its specs; a leaf
    on the host (a cache's position counter) stays as it is."""
    if isinstance(tree, dict):
        return {k: _rank_tree(v, pspecs[k], mesh, axes) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rank_tree(v, p, mesh, axes) for v, p in zip(tree, pspecs))
    if not kernel_meta.is_meta(tree):
        return tree
    return sds(_rank_shape(tree.shape, pspecs, mesh, axes), tree.dtype)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _meta_like(tree):
    return tree_map(lambda x: sds(x.shape, x.dtype) if isinstance(x, torch.Tensor) else x, tree)


# --------------------------------------------------------------------------- #
# counting one step
# --------------------------------------------------------------------------- #


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally(TorchDispatchMode):
    """Every aten op's input and output bytes (views move none), and the
    live and peak bytes of the storages made inside the block: a storage is
    live while a tensor on it is (autograd keeps the tensors it saves, and
    their Python objects with them)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._owners: Dict[int, int] = {}

    def _free(self, key: int, n: int) -> None:
        self._owners[key] -= 1
        if not self._owners[key]:
            del self._owners[key]
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        outside = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in outside and key not in self._owners:
                continue  # written in place into a storage made before the block
            if key not in self._owners:
                self._owners[key] = 0
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
            self._owners[key] += 1
            weakref.finalize(t, self._free, key, st.nbytes())
        return out


def count_step(fn, *args) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` on ``meta`` tensors under the counters: (its
    result, {"flops", "aten_flops", "kernel_flops", "kernel_ops",
    "bytes_accessed", "temp_bytes", "kernels", "step_s"})."""
    calls: List[Tuple[str, Dict[str, Any]]] = []
    flops = FlopCounterMode(display=False)
    tally = _Tally()
    t = time.time()
    with kernel_meta.recording(lambda name, shape: calls.append((name, shape))), flops, tally:
        out = fn(*args)
        peak = tally.peak
    kernels: Dict[str, Dict[str, float]] = {}
    for name, shape in calls:
        w = kernel_work(name, shape)
        k = kernels.setdefault(name, {"calls": 0, "flops": 0.0, "ops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        for key in ("flops", "ops", "bytes"):
            k[key] += w[key]
    aten = float(flops.get_total_flops())
    kflops = sum(k["flops"] for k in kernels.values())
    return out, {
        "flops": aten + kflops, "aten_flops": aten, "kernel_flops": kflops,
        "kernel_ops": sum(k["ops"] for k in kernels.values()),
        "bytes_accessed": float(tally.bytes) + sum(k["bytes"] for k in kernels.values()),
        "temp_bytes": int(peak), "kernels": kernels, "step_s": round(time.time() - t, 2),
    }


def meta_params(model) -> Dict[str, Any]:
    """``model``'s parameters on ``meta``: shapes and dtypes, no storage."""
    with torch.device("meta"):
        return model.init_params(torch.Generator(), "meta")


def count_train_step(model, plan, opt, batch, *, mesh: Optional[VirtualMesh] = None,
                     client_axes: Tuple[str, ...] = ("data",), fed_round=None,
                     state: Optional[TrainState] = None) -> Dict[str, Any]:
    """The counts of one Engine A step (``count_step``) of ``model`` on
    ``plan``: the unsharded step on all ``plan.num_clients`` clients, or on
    a virtual ``mesh`` the sharded step on rank 0's clients (the leading
    axis of ``batch``), its collectives recorded.  ``batch`` may hold real
    tensors (only their shapes are read); ``state`` (on ``meta``) defaults to
    the replicated init.  Adds ``arg_bytes`` (state and batch) and
    ``out_bytes`` (the new state and the loss)."""
    batch = _meta_like(batch)
    n = tree_leaves(batch)[0].shape[0]
    if state is None:
        params = replicate_for_clients(meta_params(model), n)
        state = TrainState(params=params, opt_state=opt.init(params), step=0)
    if mesh is None:
        step = build_train_step_a(model, plan, opt, fed_round=fed_round)
    else:
        mesh.recorder.clear()
        step = build_sharded_train_step_a(model, plan, opt, mesh, client_axes=client_axes,
                                          fed_round=fed_round)
    (new, loss), counts = count_step(step, state, batch)
    counts["arg_bytes"] = tree_bytes((state.params, state.opt_state)) + tree_bytes(batch)
    counts["out_bytes"] = tree_bytes((new.params, new.opt_state)) + _nbytes(loss)
    counts["collectives"] = list(mesh.recorder) if mesh is not None else []
    return counts


# --------------------------------------------------------------------------- #
# case construction
# --------------------------------------------------------------------------- #


@dataclass
class DryrunCase:
    arch: str
    shape: str
    multi_pod: bool
    opt_name: str = "sgd"
    remat: bool = True
    dtype: Optional[str] = None       # e.g. "bfloat16" override
    seq_shard: bool = False           # sequence-parallel residual constraint
    tag: str = "baseline"
    # JAX: unroll the unit scans so XLA's cost_analysis counts every unit
    # (None = unroll iff single-pod).  The port's unit loop is a Python
    # loop: every unit is counted either way.
    unroll: Optional[bool] = None
    # round specialization (train shapes): "dynamic" = the step reads the
    # round counter, "local" / "sync" = the specialized round steps
    # (``fed_round`` False / True; see tiers.synchronize).
    round_kind: str = "dynamic"
    # decode shapes: shard the attention-cache sequence dim over `model`
    # (a GSPMD constraint: no counterpart in the port).
    cache_seq_shard: bool = False
    # decode shapes: donate the cache buffers (the port writes its caches
    # in place always).
    donate_cache: bool = False
    # train shapes: remat policy ("full" | "dots" | "outs"); see
    # ModelSpec.remat_policy.
    remat_policy: str = "full"
    # moe archs: the expert-parallel sharding constraint (a GSPMD
    # constraint: no counterpart in the port).
    moe_shard: bool = False
    # train/prefill: JAX's blockwise (flash-style) attention for training;
    # the port's attention runs the flash kernels always.
    flash_train: bool = False

    @property
    def resolved_unroll(self) -> bool:
        return (not self.multi_pod) if self.unroll is None else self.unroll


def _spec_for(case: DryrunCase):
    spec = get_spec(case.arch)
    shape = SHAPES[case.shape]
    if shape.name == "long_500k" and spec.family in QUADRATIC_FAMILIES:
        spec = spec.with_window(LONG_CONTEXT_WINDOW)
    if case.dtype:
        spec = spec.with_dtypes(case.dtype, case.dtype)
    if case.remat and shape.kind == "train":
        import dataclasses

        spec = dataclasses.replace(spec, remat=True,
                                   remat_policy=case.remat_policy)
    return spec, shape


# the GSPMD constraints of the JAX dry-run, which pin XLA shardings
GSPMD_FLAGS = {
    "seq_shard": "--seq-shard (a sequence-parallel sharding constraint on the residual stream)",
    "cache_seq_shard": "--cache-seq-shard (a sharding constraint on the KV cache's sequence dim)",
    "moe_shard": "--moe-shard (an expert-parallel sharding constraint on the MoE dispatch)",
}


def _refuse_gspmd(case: DryrunCase) -> None:
    for field, what in GSPMD_FLAGS.items():
        if getattr(case, field):
            raise NotImplementedError(
                f"{what} installs a GSPMD constraint of the JAX package's XLA "
                "partitioner; the port has no GSPMD and no tensor parallelism "
                "(ranks on `model` hold copies, core/sharded.py), so it has no "
                "counterpart here")


def _notes(case: DryrunCase) -> List[str]:
    out = []
    if case.flash_train:
        out.append("flash_train: the port's attention runs the flash kernels at every length")
    if case.donate_cache:
        out.append("donate_cache: the port's decode writes its caches in place always")
    return out


def lower_case(case: DryrunCase, mesh: Optional[VirtualMesh] = None):
    """Build one case on ``meta`` at rank 0's shapes.  Returns (run, meta
    dict): ``run()`` runs the case's step under the counters and returns
    its counts (``count_step``)."""
    _refuse_gspmd(case)
    if mesh is None:
        mesh = make_virtual_mesh(multi_pod=case.multi_pod)
    ca = tuple(a for a in mesh.axis_names if a != "model")
    n_client = math.prod(mesh.shape[a] for a in ca)

    spec, shape = _spec_for(case)
    model = SplittableModel(spec)
    meta: Dict[str, Any] = {
        "arch": case.arch, "shape": case.shape,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "axes": list(mesh.axis_names), "kind": shape.kind, "tag": case.tag,
        "window": spec.window, "dtype": str(spec.param_dtype),
        "num_devices": mesh.size(),
        "model_axis": ("ranks on `model` hold copies: the port has no tensor "
                       "parallelism, so no model-axis collective"),
    }
    notes = _notes(case)
    if notes:
        meta["notes"] = notes
    params = meta_params(model)

    if shape.kind == "train":
        # JAX steps SGD whatever --opt names (and its lowering then fails
        # on the moments' specs); here the named optimizer's state is held
        opt = {"sgd": sgd, "momentum": momentum, "adam": adam}[case.opt_name](5e-4)
        plan = default_plan(
            spec.n_units, n_client,
            num_pods=mesh.shape.get("pod", 1),
            pod_interval=16 if case.multi_pod else 0,
        )
        b_per = shape.global_batch // n_client
        per_client = input_specs(spec, InputShape(shape.name, shape.seq_len, b_per, "train"))
        batch_g = {k: sds((n_client,) + tuple(s.shape), s.dtype) for k, s in per_client.items()}
        params_g = replicate_for_clients(params, n_client)
        state_g = TrainState(params_g, opt.init(params_g), 0)
        sps = sh.train_pspecs(state_g, ca, n_client)
        bps = sh.batch_pspecs(batch_g, ca)
        state = TrainState(_rank_tree(state_g.params, sps.params, mesh, ca),
                           _rank_tree(state_g.opt_state, sps.opt_state, mesh, ca), 0)
        batch = _rank_tree(batch_g, bps, mesh, ca)
        fed_round = {"dynamic": None, "local": False, "sync": True}[case.round_kind]
        meta["round_kind"] = case.round_kind
        meta["plan"] = {
            "cuts": plan.cuts, "intervals": plan.intervals,
            "entities": plan.entities, "num_clients": n_client,
        }
        meta["global_batch"] = shape.global_batch
        meta["seq_len"] = shape.seq_len

        def run():
            return count_train_step(model, plan, opt, batch, mesh=mesh, client_axes=ca,
                                    fed_round=fed_round, state=state)

        return run, meta

    # serving paths: a single aggregated model copy a rank
    meta["global_batch"] = shape.global_batch
    meta["seq_len"] = shape.seq_len

    if shape.kind == "prefill":
        batch_g = input_specs(spec, shape)
        b_ax = ca if shape.global_batch % n_client == 0 else ()
        bps = {k: sh.P(*([(b_ax if len(b_ax) > 1 else b_ax[0]) if b_ax else None]
                         + [None] * (v.ndim - 1))) for k, v in batch_g.items()}
        batch = _rank_tree(batch_g, bps, mesh, ca)

        def run():
            out, counts = count_step(lambda p, b: model.forward(p, b)[0], params, batch)
            counts["arg_bytes"] = tree_bytes(params) + tree_bytes(batch)
            counts["out_bytes"] = _nbytes(out)
            counts["collectives"] = []
            return counts

        return run, meta

    # decode: one token at the end of a seq_len cache
    B = shape.global_batch
    caches_g = model.init_caches(B, shape.seq_len, device="meta")  # positions on the host
    cps = sh.cache_pspecs(caches_g, batch=B, client_axes=ca,
                          tp=mesh.shape.get("model", 1))
    caches = _rank_tree(caches_g, cps, mesh, ca)
    tokens = sds(_rank_shape((B, 1), sh.token_pspec(B, ca), mesh, ca), torch.int32)

    def run():
        (logits, new), counts = count_step(
            lambda p, t, c: model.decode_step(p, t, c, 0), params, tokens, caches)
        counts["arg_bytes"] = tree_bytes(params) + tree_bytes(caches) + _nbytes(tokens)
        counts["out_bytes"] = _nbytes(logits) + tree_bytes(new)
        counts["alias_bytes"] = tree_bytes(caches)
        counts["collectives"] = []
        return counts

    return run, meta


def run_case(case: DryrunCase, mesh: Optional[VirtualMesh] = None,
             compile_: bool = True) -> Dict[str, Any]:
    """Build one case and, unless ``compile_`` is False (``--lower-only``),
    run its step on ``meta`` under the counters: JAX's record, one rank's."""
    t0 = time.time()
    run, meta = lower_case(case, mesh)
    meta["lower_s"] = round(time.time() - t0, 2)
    if not compile_:
        return meta
    counts = run()
    meta["step_s"] = counts["step_s"]
    meta["flops"] = counts["flops"]
    meta["bytes_accessed"] = counts["bytes_accessed"]
    meta["aten_flops"] = counts["aten_flops"]
    meta["kernel_flops"] = counts["kernel_flops"]
    meta["kernel_ops"] = counts["kernel_ops"]
    meta["kernels"] = counts["kernels"]
    spec, shape = _spec_for(case)
    meta["unrolled"] = True
    meta["attn_corr_flops"] = blockwise_attn_corr_flops(
        spec, shape, meta["num_devices"]
    )
    meta["arg_bytes"] = int(counts["arg_bytes"])
    meta["out_bytes"] = int(counts["out_bytes"])
    meta["temp_bytes"] = int(counts["temp_bytes"])
    meta["alias_bytes"] = int(counts.get("alias_bytes", 0))
    colls = counts["collectives"]
    meta["collectives"] = _summarize_collectives(colls)
    meta["collective_bytes"] = collective_traffic_bytes(colls)
    return meta


def _summarize_collectives(colls: List[Dict[str, Any]]) -> Dict[str, Any]:
    summary: Dict[str, Any] = {}
    for c in colls:
        s = summary.setdefault(c["op"], {"count": 0, "result_bytes": 0})
        s["count"] += 1
        s["result_bytes"] += c["result_bytes"]
    return summary


def save_result(meta: Dict[str, Any], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{meta['arch']}_{meta['shape']}_{meta['mesh']}_{meta['tag']}.json"
    name = name.replace("/", "-")
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return path
