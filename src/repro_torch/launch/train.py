"""End-to-end HSFL training entry point — port of ``repro.launch.train``.

Synthetic data → client partition → federated loader → Engine A split
training with the multi-timescale aggregation schedule, whose sync levels
run through the fused aggregation kernels → checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.train --arch vgg16-cifar10 \
        --rounds 100 --non-iid

``--arch vgg16-cifar10`` is the paper's own setting; a dense transformer id
(``smollm-135m``, ``qwen2-1.5b``, ``qwen2.5-14b``, ``qwen3-32b``) trains its
REDUCED variant on a synthetic LM stream of 64-token sequences, as the JAX
CLI does, with every attention on the flash-attention kernels.  The other
arch ids of the zoo raise ``NotImplementedError`` (ROADMAP A14).

Runs on the first CUDA device; ``--device cpu`` asks for the CPU (the
kernels then take their plain PyTorch versions).  Bound-constant estimation
with the BCD re-solve (``--auto-optimize``), the sharded engine
(``--shard-*``) and async aggregation (``--staleness``) are not ported yet
(ROADMAP A8, A13, A11).
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
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
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


def make_dispatch(model, plan, opt, compressor=None, class_members=None) -> Callable:
    """Specialized per-round-type steps (see ``tiers.synchronize``): round r
    runs the step whose fed-server levels are exactly the tiers due at
    r + 1, as the JAX package's dispatch does.  ``class_members`` (from
    ``tiers.class_tier_members``) makes every step a per-class (ragged) one,
    as ``build_train_step_a(class_members=...)``."""
    from ..core import build_train_step_a

    cache = {}

    def dispatch(state, batch, r):
        fed = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
        if fed not in cache:
            cache[fed] = build_train_step_a(
                model, plan, opt, fed_round=fed, compressor=compressor,
                class_members=class_members,
            )
        return cache[fed](state, batch)

    return dispatch


def main(argv=None) -> int:
    args = parse_args(argv)
    # f32 convolutions and matmuls run in full f32, not TF32, so the card
    # computes what the JAX reference computes; relaxing this is a
    # performance decision for a later change.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from ..core import init_state_a

    device, spec, model, plan, opt, loader = setup(args)
    state = init_state_a(
        model, plan, opt, torch.Generator().manual_seed(args.seed), device
    )
    print(f"[train] arch={spec.name} units={spec.n_units} plan cuts={plan.cuts} "
          f"I={plan.intervals} N={args.clients} J2={args.edges} device={device}")
    dispatch = make_dispatch(model, plan, opt)
    t0 = t_log = time.time()
    r_log = 0
    for r in range(args.rounds):
        batch = to_device(loader.next_round(), device)
        state, loss = dispatch(state, batch, r)
        if (r + 1) % args.log_every == 0 or r == 0:
            loss = float(loss)  # waits for the round to finish on the device
            now = time.time()
            print(f"round {r+1:5d}  loss {loss:.4f}  "
                  f"({(now - t_log) * 1e3 / (r + 1 - r_log):.1f} ms/round since "
                  f"last log, {(now - t0) / (r + 1):.2f}s/round)")
            t_log, r_log = now, r + 1

    if args.checkpoint:
        from ..checkpoint import save_checkpoint

        save_checkpoint(
            args.checkpoint, state.params, step=state.step,
            meta={"cuts": list(plan.cuts), "intervals": list(plan.intervals)},
        )
        print(f"saved checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
