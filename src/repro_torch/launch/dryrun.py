"""Multi-pod dry-run CLI — port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh pod [--tag baseline] [--round local] \\
        [--remat-policy dots] [--dtype bfloat16] [--out experiments/dryrun]

Runs one rank's view of the requested (architecture × input-shape × mesh)
case on ``meta`` tensors over a virtual mesh (``dryrun_lib``), prints the
record and writes the JSON that the roofline reads, with JAX's flags,
choices and defaults.  No device is touched and no XLA flag is set: the
virtual mesh needs no devices.  ``--flash-train`` and ``--donate-cache``
describe what the port always does (its attention runs the flash kernels,
its caches are written in place); they are accepted and the record notes
them.  ``--seq-shard``, ``--cache-seq-shard`` and ``--moe-shard`` install
GSPMD sharding constraints in the JAX package and raise here.
"""
import argparse
import json
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--opt", default="sgd")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--round", choices=["dynamic", "local", "sync"],
                    default="dynamic", dest="round_kind",
                    help="train-step round specialization (perf)")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="decode: shard the KV-cache sequence dim over model")
    ap.add_argument("--donate-cache", action="store_true",
                    help="decode: donate cache buffers (in-place update)")
    ap.add_argument("--remat-policy", choices=["full", "dots", "outs"], default="full",
                    help="train: remat policy (dots saves matmul outputs)")
    ap.add_argument("--moe-shard", action="store_true",
                    help="moe: expert-parallel dispatch sharding constraint")
    ap.add_argument("--flash-train", action="store_true",
                    help="train: blockwise (flash-style) attention path")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--lower-only", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from repro_torch.launch.dryrun_lib import DryrunCase, run_case, save_result

    case = DryrunCase(
        arch=args.arch,
        shape=args.shape,
        multi_pod=args.mesh == "multipod",
        opt_name=args.opt,
        remat=not args.no_remat,
        dtype=args.dtype,
        seq_shard=args.seq_shard,
        round_kind=args.round_kind,
        cache_seq_shard=args.cache_seq_shard,
        donate_cache=args.donate_cache,
        remat_policy=args.remat_policy,
        moe_shard=args.moe_shard,
        flash_train=args.flash_train,
        tag=args.tag,
    )
    meta = run_case(case, compile_=not args.lower_only)
    print(json.dumps(meta, indent=1, default=str))
    if not args.lower_only:
        path = save_result(meta, args.out)
        print(f"saved -> {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
