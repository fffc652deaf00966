"""Meshes and ranks — port of ``repro.launch.mesh``.

Production meshes (the JAX package's TPU v5e target):

Single pod:  (data=16, model=16)          = 256 ranks
Multi-pod:   (pod=2, data=16, model=16)   = 512 ranks

The HSFL mapping (DESIGN.md §2): one index of the client axis — ``data``,
or (``pod``, ``data``) in multi-pod — hosts one shard of the clients'
parameter replicas; ``model`` replicates the training step (the serving
path's tensor parallelism); the ``pod`` axis is an additional HSFL
hierarchy level.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over an initialized
world of exactly its size: one rank per mesh position.  The backend is
NCCL on the card and gloo on the CPU; an explicit ``backend="gloo"`` lets
several ranks share one card, its collectives then staged through the
host.  Nothing switches backend or device on its own: a world of the
wrong size, backend or device count raises and says what to do.

``run_on_ranks`` starts the ranks: it uses an initialized default group
(``torchrun``), initializes a one-rank group in process, or spawns the
ranks with ``torch.multiprocessing``; every group it makes meets on a
``FileStore`` in a temporary directory, so no network address is used.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device

POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)

# a collective that waits longer than this raises instead of hanging a run
COLLECTIVE_TIMEOUT = timedelta(seconds=600)


def client_axes(multi_pod: bool = False):
    """Mesh axes the client-stacked parameter axis is sharded over."""
    return ("pod", "data") if multi_pod else ("data",)


def num_clients(multi_pod: bool = False) -> int:
    """One HSFL client per (pod, data) index."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    return math.prod(shape) // shape[-1]


def default_backend(device: DeviceLike) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _make_mesh(shape: Sequence[int], names: Sequence[str], device, backend, what: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    layout = "x".join(str(s) for s in shape)
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialized torch.distributed world of {need} ranks "
            f"({layout} over {names}) and none is initialized: start the ranks "
            f"with repro_torch.launch.mesh.run_on_ranks(fn, {need}, device=...) "
            f"or torchrun --nproc-per-node {need}, or call "
            "torch.distributed.init_process_group first"
        )
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(
            f"{what} needs {need} ranks ({layout} over {names}) but the "
            f"torch.distributed world has {have}: one rank runs one mesh "
            f"position, so start exactly {need} ranks (run_on_ranks(fn, {need}, "
            f"...) or torchrun --nproc-per-node {need})"
        )
    actual = dist.get_backend()
    if actual != backend:
        raise RuntimeError(
            f"{what} on {device.type} wants backend {backend!r} but the world was "
            f"initialized with {actual!r}: initialize it with {backend!r} or pass "
            f"backend={actual!r}"
        )
    if device.type == "cuda" and backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", have))
        if local > torch.cuda.device_count():
            raise RuntimeError(
                f"{what}: {local} NCCL ranks on this host but "
                f"{torch.cuda.device_count()} CUDA devices; NCCL refuses two ranks "
                "on one device — start one rank per card, or pass "
                "backend='gloo' to share a card through the host"
            )
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: Optional[DeviceLike] = None,
                         backend: Optional[str] = None):
    """The production mesh over an initialized world of 256 (or, multi-pod,
    512) ranks; any other world raises."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device, backend, "make_production_mesh")


def make_debug_mesh(data: int = 2, model: int = 2, pods: int = 0, *,
                    device: Optional[DeviceLike] = None, backend: Optional[str] = None):
    """A small mesh with dims ``("data", "model")``, or ``("pod", "data",
    "model")`` when ``pods`` > 0, over an initialized world of exactly
    data·model·max(pods, 1) ranks (``run_on_ranks`` starts them).

    A world of another size, an initialized backend other than ``backend``
    (default NCCL on CUDA, gloo on the CPU), or more NCCL ranks on a host
    than it has cards raises with what to do, rather than building a
    different mesh."""
    if pods:
        return _make_mesh((pods, data, model), ("pod", "data", "model"), device,
                          backend, "make_debug_mesh")
    return _make_mesh((data, model), ("data", "model"), device, backend,
                      "make_debug_mesh")


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# --------------------------------------------------------------------------- #
# starting the ranks
# --------------------------------------------------------------------------- #


def _rank_main(rank: int, world: int, root: str, device_type: str, backend: str,
               fn: Callable, args: tuple, threads: int = 0) -> Any:
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    local = rank
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if backend == "nccl" and rank >= count:
            raise RuntimeError(
                f"rank {rank}: NCCL needs one card per rank and this host has {count}"
            )
        local = rank % count
        torch.cuda.set_device(local)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local),
                      LOCAL_WORLD_SIZE=str(world))
    store = dist.FileStore(os.path.join(root, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        out = fn(*args)
        if rank == 0 and world > 1:  # the parent process reads it
            with open(os.path.join(root, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        return out
    finally:
        dist.destroy_process_group()


def run_on_ranks(fn: Callable, world: int, *, device: Optional[DeviceLike] = None,
                 backend: Optional[str] = None, args: tuple = (),
                 store_dir: Optional[str] = None) -> Any:
    """Run ``fn(*args)`` on every rank of a ``world``-rank group and return
    rank 0's result.

    * An initialized default group (``torchrun``) is used as it is; its size
      must be ``world``.
    * Otherwise ``world`` = 1 initializes a one-rank group in this process,
      and a larger world spawns ``world`` processes (``fn`` must then be a
      module-level function and its result picklable).  Either group meets
      on a ``FileStore`` in a fresh directory under ``store_dir`` (default
      the system's temporary directory), which is removed afterwards.

    ``backend`` defaults to NCCL on CUDA and gloo on the CPU; rank r runs on
    ``cuda:r`` under NCCL (more ranks than cards raises) and on
    ``cuda:(r mod cards)`` under an explicit gloo.  A failure on any rank
    raises here; nothing is retried on another backend or device.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"run_on_ranks({world}) inside an initialized world of "
                f"{dist.get_world_size()} ranks"
            )
        return fn(*args)
    device = resolve_device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda" and backend == "nccl" and world > torch.cuda.device_count():
        raise RuntimeError(
            f"run_on_ranks: {world} NCCL ranks but {torch.cuda.device_count()} CUDA "
            "devices; NCCL refuses two ranks on one device — pass backend='gloo' "
            "to share a card through the host"
        )
    if store_dir is not None:
        os.makedirs(store_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="repro-ranks-", dir=store_dir)
    try:
        if world == 1:
            saved = {k: os.environ.get(k) for k in
                     ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
            try:
                return _rank_main(0, 1, root, device.type, backend, fn, args)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        import torch.multiprocessing as mp

        # the spawned ranks share this process's intra-op threads, as
        # torchrun's one thread per rank shares a host's cores
        threads = max(1, torch.get_num_threads() // world)
        mp.start_processes(_rank_main,
                           args=(world, root, device.type, backend, fn, args, threads),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(root, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
