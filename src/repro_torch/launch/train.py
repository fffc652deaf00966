"""End-to-end HSFL training entry point — port of ``repro.launch.train``.

Synthetic data → client partition → federated loader → Engine A split
training with the multi-timescale aggregation schedule, whose sync levels
run through the fused aggregation kernels → bound-constant estimation →
BCD (Algorithm 2) re-optimization of (I, μ) → checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16-cifar10 \
        --rounds 100 --non-iid --auto-optimize

``--arch vgg16-cifar10`` is the paper's own setting; a transformer id of
the dense (``smollm-135m``, ``qwen2-1.5b``, ``qwen2.5-14b``,
``qwen3-32b``), MoE (``granite-moe-1b-a400m``, ``phi3.5-moe-42b-a6.6b``),
SSM (``mamba2-1.3b``) or hybrid (``jamba-1.5-large-398b``) family trains
its REDUCED variant on a synthetic LM stream of 64-token sequences, as the
JAX CLI does, with every attention on the flash-attention kernels.  The
VLM id (``paligemma-3b``) and the audio id (``whisper-large-v3``) exit as
the JAX CLI does: the stream carries no image-prefix embeddings and no
audio frames.

``--auto-optimize`` runs ``--probe-rounds`` probe rounds from the initial
state, estimates the Theorem-1 constants from them (``core.estimator``),
prices the model on the paper's three-tier system, sets ε to
``--eps-scale`` × the I=1 bound floor, and lets ``solve_bcd`` pick the cuts
and intervals the run then trains with, from the initial state again.

``--staleness S`` (one value for every deferrable tier, or one per tier)
trains on the bounded-staleness schedule of ``core.async_agg``: a due
tier's fed level is snapshotted and folded back S rounds later, and the
in-flight ones are drained after the last round; 0 is the synchronous
dispatch.

``--shard-data D`` (and ``--shard-pods P``) trains the sharded engine
(``core.sharded``): the client axis splits over D (× P) ranks of
``torch.distributed``, NCCL on the card and gloo on the CPU, which
``launch.mesh.run_on_ranks`` starts (or takes from ``torchrun``) on a
``FileStore`` — no network address.  Every rank draws the global batch and
keeps its client rows; rank 0 prints, and writes the checkpoint of the
gathered state, the file the unsharded run writes.

Runs on the first CUDA device (rank r of a sharded run on ``cuda:r``);
``--device cpu`` asks for the CPU (the kernels then take their plain
PyTorch versions).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="vgg16-cifar10")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--edges", type=int, default=5)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--optimizer", choices=["sgd", "momentum", "adam"], default="sgd")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--cuts", type=int, nargs="*", default=None)
    ap.add_argument("--intervals", type=int, nargs="*", default=None)
    ap.add_argument("--auto-optimize", action="store_true",
                    help="estimate bound constants from a probe run and let "
                         "BCD (Algorithm 2) pick (I, mu)")
    ap.add_argument("--probe-rounds", type=int, default=8)
    ap.add_argument("--eps-scale", type=float, default=4.0,
                    help="target eps as a multiple of the I=1 bound floor")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--staleness", type=int, nargs="*", default=None,
                    metavar="S",
                    help="bounded-staleness async aggregation: one value "
                         "(applies to every deferrable tier) or one per "
                         "tier; 0 is the synchronous schedule "
                         "(core.async_agg)")
    ap.add_argument("--shard-data", type=int, default=0, metavar="D",
                    help="shard the client-stacked axis over D ranks "
                         "(core.sharded; NCCL on the card, gloo on the CPU)")
    ap.add_argument("--shard-pods", type=int, default=0, metavar="P",
                    help="additionally shard clients over P pods "
                         "(client axes become (pod, data))")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu on request)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, spec=None, seq: Optional[int] = None):
    """(device, spec, model, plan, opt, loader) for parsed ``args``.

    For an LM arch, ``spec`` (default: the arch's REDUCED config) and
    ``seq`` (default 64) size the model and the stream, so a full-width run
    is built from the same pieces."""
    from ..configs import get_reduced
    from ..core.tiers import default_plan
    from ..data import (
        image_loader, lm_loader, make_cifar10_like, make_lm_stream, partition_iid,
        partition_sort_and_shard,
    )
    from ..models.vgg import build_model
    from ..optim import adam, momentum, sgd

    device = resolve_device(args.device)
    opt = {"sgd": sgd, "momentum": momentum, "adam": adam}[args.optimizer](args.lr)
    vgg = args.arch == "vgg16-cifar10"
    if vgg:
        from ..configs.vgg16_cifar10 import SPEC as spec

        ds = make_cifar10_like(4096, seed=args.seed)
        labels = ds.labels
    else:
        spec = spec or get_reduced(args.arch)
        ds = make_lm_stream(2048, seq or 64, spec.vocab_size, seed=args.seed)
        labels = ds.tokens[:, 0] % 10
        if spec.family in ("vlm", "audio"):
            raise SystemExit(
                f"{args.arch}: frontend is a stub; use examples/train_hsfl_e2e.py "
                "with dense/moe/ssm/hybrid archs or vgg16-cifar10"
            )
    parts = (
        partition_sort_and_shard(labels, args.clients, 2, args.seed)
        if args.non_iid
        else partition_iid(len(labels), args.clients, args.seed)
    )
    loader = (image_loader if vgg else lm_loader)(ds, parts, args.batch, args.seed)
    model = build_model(spec)
    plan = default_plan(
        spec.n_units, args.clients,
        cuts=tuple(args.cuts) if args.cuts else None,
        intervals=tuple(args.intervals) + (1,) if args.intervals else None,
        entities=(args.clients, args.edges, 1),
    )
    return device, spec, model, plan, opt, loader


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def next_batch(loader, device, mesh=None, client_axes=("data",), num_clients=0):
    """The round's batch on ``device``; with a ``mesh``, this rank's client
    rows of the global batch every rank draws."""
    batch = loader.next_round()
    if mesh is not None:
        from ..core.sharded import local_rows

        batch = local_rows(batch, mesh, client_axes, num_clients)
    return to_device(batch, device)


def say(*a, **kw) -> None:
    """print, on rank 0 of a sharded run only."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*a, **kw)


def make_dispatch(model, plan, opt, compressor=None, class_members=None,
                  guard=None) -> Callable:
    """Specialized per-round-type steps (see ``tiers.synchronize``): round r
    runs the step whose fed-server levels are exactly the tiers due at
    r + 1, as the JAX package's dispatch does.  ``class_members`` (from
    ``tiers.class_tier_members``) makes every step a per-class (ragged) one,
    as ``build_train_step_a(class_members=...)``; ``guard`` (a
    ``tiers.GuardSpec``) arms the step's fault quarantine.  ``dispatch(state,
    batch, r, mask)`` with an [N] participation mask runs the masked step
    (``build_train_step_a(with_mask=True)``)."""
    from ..core import build_train_step_a

    cache = {}

    def dispatch(state, batch, r, mask=None):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        key = (fed, mask is not None)
        if key not in cache:
            cache[key] = build_train_step_a(
                model, plan, opt, fed_round=fed, compressor=compressor,
                class_members=class_members, with_mask=mask is not None,
                guard=guard,
            )
        if mask is None:
            return cache[key](state, batch)
        return cache[key](state, batch, mask)

    return dispatch


def auto_optimize(args, spec, model, plan, opt, loader, state, device, mesh=None,
                  client_axes=("data",)):
    """Probe, estimate, solve (Algorithm 1 + 2): ``--probe-rounds`` Engine-A
    rounds from ``state`` feed the bound-constant estimator; ``solve_bcd``
    then picks (μ, I) on the paper's three-tier system at ε =
    ``--eps-scale`` × the I=1 floor.  Returns the re-planned ``TierPlan``;
    ``state`` is left as it was, so training starts from the initial state.
    With a ``mesh`` the probe runs the sharded step on this rank's shard and
    the estimator gathers over the client shards, so every rank solves the
    same problem and picks the same plan."""
    from torch.func import grad_and_value, vmap

    from ..core import HsflProblem, SystemSpec, build_profile, build_train_step_a, solve_bcd
    from ..core.convergence import theorem1_bound
    from ..core.estimator import HyperEstimator
    from ..core.tiers import default_plan

    say(f"[probe] estimating bound constants over {args.probe_rounds} rounds")
    est = HyperEstimator(plan.n_units, args.clients, args.lr)
    grad_fn = vmap(grad_and_value(model.loss_fn))
    if mesh is None:
        step = build_train_step_a(model, plan, opt)
    else:
        from ..core.sharded import build_sharded_train_step_a

        step = build_sharded_train_step_a(model, plan, opt, mesh, client_axes=client_axes)
    pstate = state
    for _ in range(args.probe_rounds):
        batch = next_batch(loader, device, mesh, client_axes, args.clients)
        grads, losses = grad_fn(pstate.params, batch)
        if mesh is not None:
            from ..core.sharded import gather_clients

            losses = gather_clients(losses, mesh, client_axes, losses.shape[0])
        est.observe(pstate.params, grads, float(torch.mean(losses)), mesh=mesh,
                    client_axes=client_axes)
        pstate, _ = step(pstate, batch)
    hp = est.hyperspec()
    prof = build_profile(spec, args.batch, seq=64 if args.arch != "vgg16-cifar10" else 1)
    system = SystemSpec.paper_three_tier(args.clients, args.edges, seed=args.seed)
    floor = theorem1_bound(hp, 10**9, [1] * plan.M, plan.cuts)
    prob = HsflProblem(prof, system, hp, eps=args.eps_scale * floor)
    res = solve_bcd(prob)
    say(f"[bcd] cuts={res.cuts} intervals={res.intervals} "
          f"theta={res.theta:.4g} R={res.rounds:.0f} T={res.total_latency:.1f}s")
    return default_plan(
        spec.n_units, args.clients, cuts=res.cuts,
        intervals=res.intervals, entities=(args.clients, args.edges, 1),
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.shard_data:
        from .mesh import run_on_ranks

        world = args.shard_data * max(args.shard_pods, 1)
        return run_on_ranks(train, world, device=args.device, args=(args,))
    return train(args)


def train(args: argparse.Namespace) -> int:
    """The run of parsed ``args``, on one process or, with ``--shard-data``,
    on each rank of an initialized world."""
    # f32 convolutions and matmuls run in full f32, not TF32, so the card
    # computes what the JAX reference computes; relaxing this is a
    # performance decision for a later change.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from ..core import init_state_a

    device, spec, model, plan, opt, loader = setup(args)
    mesh, client_axes = None, ("data",)
    generator = torch.Generator().manual_seed(args.seed)
    if args.shard_data:
        from ..core.sharded import init_sharded_state_a
        from .mesh import client_axes as mesh_client_axes, make_debug_mesh, mesh_device

        mesh = make_debug_mesh(data=args.shard_data, model=1, pods=args.shard_pods,
                               device=args.device)
        client_axes = mesh_client_axes(bool(args.shard_pods))
        device = mesh_device(mesh)
        state = init_sharded_state_a(model, plan, opt, generator, mesh, client_axes)
    else:
        state = init_state_a(model, plan, opt, generator, device)
    if args.auto_optimize:
        plan = auto_optimize(args, spec, model, plan, opt, loader, state, device, mesh,
                             client_axes)
    staleness = 0
    if args.staleness:
        staleness = (
            args.staleness[0] if len(args.staleness) == 1 else tuple(args.staleness)
        )
    mode = []
    if mesh is not None:
        import torch.distributed as dist

        mode.append(f"sharded over {client_axes} ({dist.get_world_size()} ranks, "
                    f"{dist.get_backend()})")
    if staleness:
        mode.append(f"async staleness={staleness}")
    say(f"[train] arch={spec.name} units={spec.n_units} plan cuts={plan.cuts} "
        f"I={plan.intervals} N={args.clients} J2={args.edges} device={device}"
        + (f"  [{', '.join(mode)}]" if mode else ""))
    trainer = None
    if mesh is not None or staleness:
        # the async trainer with all-zero staleness is the synchronous
        # dispatch; it also hosts the sharded steps
        from ..core.async_agg import make_async_trainer

        trainer = make_async_trainer(model, plan, opt, staleness=staleness, mesh=mesh,
                                     client_axes=client_axes)
        dispatch = trainer.run_round
    else:
        dispatch = make_dispatch(model, plan, opt)
    t0 = t_log = time.time()
    r_log = 0
    for r in range(args.rounds):
        batch = next_batch(loader, device, mesh, client_axes, args.clients)
        state, loss = dispatch(state, batch, r)
        if (r + 1) % args.log_every == 0 or r == 0:
            loss = float(loss)  # waits for the round to finish on the device
            now = time.time()
            say(f"round {r+1:5d}  loss {loss:.4f}  "
                f"({(now - t_log) * 1e3 / (r + 1 - r_log):.1f} ms/round since "
                f"last log, {(now - t0) / (r + 1):.2f}s/round)")
            t_log, r_log = now, r + 1
    if trainer is not None:
        state = trainer.drain(state)  # fold the in-flight async syncs in

    if args.checkpoint:
        from ..checkpoint import save_checkpoint

        params = state.params
        if mesh is not None:
            # rank 0 writes the gathered state: the unsharded run's file
            import torch.distributed as dist

            from ..core.sharded import gather_clients, num_client_shards

            params = gather_clients(params, mesh, client_axes,
                                    args.clients // num_client_shards(mesh, client_axes))
            if dist.get_rank() != 0:
                return 0
        save_checkpoint(
            args.checkpoint, params, step=state.step,
            meta={"cuts": list(plan.cuts), "intervals": list(plan.intervals)},
        )
        print(f"saved checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
