#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card, its power limit, torch and CUDA versions (no card: exit 1);
2. build every CUDA kernel of the package with nvcc, in parallel;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's leaf shapes and at ragged edge shapes;
4. the port on the card against the port on the CPU: VGG REDUCED, N=4,
   3 rounds, f32 convolutions (TF32 off);
5. the main path at full width: VGG-16 / CIFAR-10, N=20 clients, J2=5
   edges, batch 16, the paper's cuts (3, 8) and intervals (8, 4, 1), 8
   rounds through ``repro_torch.launch.train.main`` and 8 more with the
   int8 fed wire; launch counts must equal what the plan implies, and every
   client replica must equal client 0 after round 8;
6. kernel, plain-version and bound times at the largest leaf [20, 2359296],
   and one full-width sync;
7. one JSON line describing every kernel, then the card, then
   ``{"ok": true, ...}`` as the last line.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # CUDA cores, outside the tensor cores

F32_RTOL, F32_ATOL = 1e-5, 1e-6  # f32 sums taken in another order
Q8_TILE = 256
REPLACES = {
    "tiered_aggregate": "src/repro/kernels/tiered_aggregate/tiered_aggregate.py:35",
    "tiered_aggregate_q8": "src/repro/kernels/tiered_aggregate/tiered_aggregate.py:88",
}
SOURCE = "src/repro_torch/kernels/tiered_aggregate/csrc/tiered_aggregate.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def bf16_ulp(ref):
    """One bf16 unit in the last place of each value of ``ref``."""
    import torch

    _, exp = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)


def max_err(out, ref, dtype, what: str) -> float:
    """Largest |out - ref|, after checking the dtype's tolerance.

    bf16: both sides round an f32 sum, and the two f32 sums differ by up to
    the f32 tolerance (order of summation), so they may land one bf16 ulp
    apart, plus that f32 difference where a sum cancels to near zero.
    """
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    f32_tol = F32_ATOL + F32_RTOL * ref.abs()
    bad = err > (f32_tol + bf16_ulp(ref) if dtype == torch.bfloat16 else f32_tol)
    if bool(bad.any()):
        i = int(torch.argmax(bad.float() * (1 + err)))
        raise AssertionError(
            f"{what}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} elements; worst flat index {i}: kernel "
            f"{float(out.flatten()[i])!r} plain {float(ref.flatten()[i])!r}"
        )
    return float(err.max())


def vgg_leaf_widths(spec):
    widths = []
    for u in range(spec.n_units):
        cin, cout, _ = spec.unit_io(u)
        widths += [spec.unit_param_count(u) - cout, cout]  # w, b
    return sorted(set(widths))


def check_kernels(spec):
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        quantized_tiered_aggregate, quantized_tiered_aggregate_ref,
        tiered_aggregate, tiered_aggregate_ref,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flags = [(de, dg) for de in (0, 1) for dg in (0, 1)]
    N = 20
    # (N, J, P, random weights?): edge shapes with a ragged tail, then the
    # main path's leaves at the mid tier (J=5) and the top tier (J=1)
    b1_cases = [(8, 4, 700, True), (20, 5, 2049, True), (4, 1, 100, True),
                (6, 6, 257, True)]
    b1_cases += [(N, J, P, False) for P in vgg_leaf_widths(spec) for J in (5, 1)]
    # the main path runs f32 only, so f32 errors are kept apart from bf16's
    errs = {"tiered_aggregate": 0.0, "tiered_aggregate_q8": 0.0}
    bf16_err = 0.0
    n_checks = 0
    for n, J, P, rand_w in b1_cases:
        w = (torch.softmax(torch.randn(n, generator=gen, device=dev), 0) if rand_w
             else torch.full((n,), 1.0 / n, device=dev))
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, P, generator=gen, device=dev).to(dtype)
            for de, dg in flags:
                out = tiered_aggregate(x, w, de, dg, J)
                torch.cuda.synchronize()
                ref = tiered_aggregate_ref(x, w, de, dg, J)
                assert out.dtype == dtype and out.shape == x.shape
                e = max_err(out, ref, dtype, f"B1 N={n} J={J} P={P} {dtype} "
                            f"do_entity={de} do_global={dg}")
                if dtype == torch.float32:
                    errs["tiered_aggregate"] = max(errs["tiered_aggregate"], e)
                else:
                    bf16_err = max(bf16_err, e)
                n_checks += 1
    for P in vgg_leaf_widths(spec):
        w = torch.full((N,), 1.0 / N, device=dev)
        x = torch.randn(N, P, generator=gen, device=dev) * 0.05
        q, scales = q8_quantize(x, Q8_TILE)
        for J in (5, 1):
            for de, dg in flags:
                out = quantized_tiered_aggregate(q, scales, w, de, dg, J, Q8_TILE)
                torch.cuda.synchronize()
                ref = quantized_tiered_aggregate_ref(q, scales, w, de, dg, J, Q8_TILE)
                assert out.dtype == torch.float32 and out.shape == q.shape
                e = max_err(out, ref, torch.float32, f"B2 N={N} J={J} P={P} "
                            f"do_entity={de} do_global={dg}")
                errs["tiered_aggregate_q8"] = max(errs["tiered_aggregate_q8"], e)
                n_checks += 1
    print(f"[kernels] {n_checks} checks against the plain versions passed "
          f"(f32 rtol {F32_RTOL} atol {F32_ATOL}, bf16 one ulp beyond that); max |err| "
          f"B1 f32 {errs['tiered_aggregate']:.3e} B1 bf16 {bf16_err:.3e} "
          f"B2 {errs['tiered_aggregate_q8']:.3e}")
    return errs, {"tiered_aggregate": bf16_err, "tiered_aggregate_q8": None}


def card_vs_cpu():
    """REDUCED VGG, 3 rounds, the same init and batches on both devices."""
    import numpy as np
    import torch

    from repro_torch.configs.vgg16_cifar10 import REDUCED
    from repro_torch.core import default_plan, init_state_a
    from repro_torch.launch.train import make_dispatch, to_device
    from repro_torch.models import VggModel
    from repro_torch.optim import sgd

    N, b = 4, 2
    model = VggModel(REDUCED)
    plan = default_plan(REDUCED.n_units, N, cuts=(1, 3), intervals=(2, 2, 1),
                        entities=(N, 2, 1))
    opt = sgd(0.05)
    rng = np.random.default_rng(0)
    hw = REDUCED.image_size
    batches = [{
        "images": rng.normal(size=(N, b, hw, hw, 3)).astype(np.float32),
        "labels": rng.integers(0, 10, (N, b)).astype(np.int32),
    } for _ in range(3)]
    losses = {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), device)
        dispatch = make_dispatch(model, plan, opt)
        losses[name] = []
        for r, batch in enumerate(batches):
            state, loss = dispatch(state, to_device(batch, device), r)
            losses[name].append(float(loss))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    print(f"[card vs cpu] REDUCED N=4 losses cuda {losses['cuda']} cpu "
          f"{losses['cpu']} (rtol 1e-4)")


def expected_launches(plan, rounds: int, compressed: bool):
    """(B1, B2) launches the sync mapping implies for VGG (2 leaves a unit)."""
    b1 = b2 = 0
    for r in range(rounds):
        for m in range(plan.M):
            lo, hi = plan.tier_bounds(m)
            leaves = 2 * (hi - lo)
            levels = plan.levels(m)
            entity = len(levels) == 2
            interval = levels[-1][1]
            fed = interval <= 1 or (r + 1) % interval == 0
            wire = compressed and m < plan.M - 1 and plan.entities[m] > 1
            if wire and fed:
                b1 += leaves * entity
                b2 += leaves
            elif entity or fed:
                b1 += leaves
    return b1, b2


def assert_replicas_equal(named_arrays, what: str) -> None:
    for key, arr in named_arrays:
        if not (arr == arr[0:1]).all():
            raise AssertionError(f"{what}: client replicas of {key} differ after round 8")


def main_path(rounds: int = 8):
    import numpy as np
    import torch

    from repro_torch.compress import Int8Stochastic
    from repro_torch.core import init_state_a
    from repro_torch.kernels.tiered_aggregate import launches, reset_launches
    from repro_torch.launch import train

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5",
            "--batch", "16", "--rounds", str(rounds), "--log-every", "1"]
    ckpt = ROOT / "build" / "chip_smoke" / "vgg16-cifar10.npz"
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv + ["--checkpoint", str(ckpt)])
    wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    assert rc == 0, rc
    plain = dict(launches)
    _, _, _, plan, _, _ = train.setup(train.parse_args(argv))
    want = expected_launches(plan, rounds, compressed=False)
    got = (plain["tiered_aggregate"], plain["tiered_aggregate_q8"])
    assert got == want, (got, want)
    if plan.cuts == (3, 8) and plan.intervals == (8, 4, 1) and rounds == 8:
        assert got == (214, 0), got
    losses = [float(v) for v in re.findall(r"loss (\S+)", buf.getvalue())]
    ms = [float(v) for v in re.findall(r"\((\S+) ms/round", buf.getvalue())]
    assert len(losses) == rounds and all(math.isfinite(v) for v in losses), losses
    with np.load(ckpt) as z:
        assert_replicas_equal(((k, z[k]) for k in z.files if k != "__meta__"),
                              "train.main")
    ckpt.unlink()
    print(f"[main path] uncompressed: {rounds} rounds in {wall:.2f} s "
          f"(checkpoint included), B1 {got[0]} B2 {got[1]} launches "
          f"(plan implies {want}), replicas equal")
    print(json.dumps({"run": "uncompressed", "loss": losses, "round_ms": ms}))

    # the same rounds with the int8 codec on the fed wire
    reset_launches()
    args = train.parse_args(argv)
    device, _, model, plan, opt, loader = train.setup(args)
    state = init_state_a(model, plan, opt, torch.Generator().manual_seed(args.seed),
                         device)
    dispatch = train.make_dispatch(model, plan, opt,
                                   compressor=Int8Stochastic(tile=Q8_TILE))
    losses, ms = [], []
    for r in range(rounds):
        t = time.perf_counter()
        batch = train.to_device(loader.next_round(), device)
        state, loss = dispatch(state, batch, r)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t) * 1e3)
    comp = (launches["tiered_aggregate"], launches["tiered_aggregate_q8"])
    want_c = expected_launches(plan, rounds, compressed=True)
    assert comp == want_c, (comp, want_c)
    if plan.cuts == (3, 8) and plan.intervals == (8, 4, 1) and rounds == 8:
        assert comp == (208, 26), comp
    assert all(math.isfinite(v) for v in losses), losses
    assert_replicas_equal(
        ((f"units/{u}/{k}", x) for u, unit in enumerate(state.params["units"])
         for k, x in unit.items()),
        "int8 wire",
    )
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main path] int8 fed wire: B1 {comp[0]} B2 {comp[1]} launches "
          f"(plan implies {want_c}), replicas equal; peak device memory "
          f"{peak:.2f} GiB")
    print(json.dumps({"run": "int8", "loss": losses, "round_ms": ms}))
    counts = {"tiered_aggregate": got[0] + comp[0],
              "tiered_aggregate_q8": got[1] + comp[1]}
    return counts, dict(model=model, plan=plan, opt=opt, state=state, batch=batch)


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def timings(card: str, run):
    import torch
    from torch.func import grad_and_value, vmap

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.core import synchronize
    from repro_torch.kernels.tiered_aggregate import (
        quantized_tiered_aggregate, quantized_tiered_aggregate_ref,
        reset_launches, tiered_aggregate, tiered_aggregate_ref,
    )

    dev = torch.device("cuda", 0)
    N, P = 20, 9 * 512 * 512
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.full((N,), 1.0 / N, device=dev)
    x = torch.randn(N, P, generator=gen, device=dev)
    q, scales = q8_quantize(x, Q8_TILE)
    out = {}

    b1_bytes = 2 * N * P * 4 + 4 * N
    b1_ops = 3 * N * P  # group sums, weighted global sum (multiply + add)
    k, p = in_turns(lambda: tiered_aggregate_ref(x, w, 1, 1, 5),
                    lambda: tiered_aggregate(x, w, 1, 1, 5))
    out["tiered_aggregate"] = dict(ms=k, plain_ms=p, bytes=b1_bytes, ops=b1_ops)

    b2_bytes = N * P + 4 * N * P // Q8_TILE + 4 * N * P + 4 * N
    b2_ops = 3 * N * P  # dequantizing multiply, weighted global sum
    k, p = in_turns(lambda: quantized_tiered_aggregate_ref(q, scales, w, 0, 1, 1, Q8_TILE),
                    lambda: quantized_tiered_aggregate(q, scales, w, 0, 1, 1, Q8_TILE))
    out["tiered_aggregate_q8"] = dict(ms=k, plain_ms=p, bytes=b2_bytes, ops=b2_ops)

    for name, r in out.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["ops"] / F32_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"[timing] {name} at [{N}, {P}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB at 3.35 TB/s, H100 SXM "
              f"data sheet) = {100 * r['bound_ms'] / r['ms']:.1f}% of the bound; "
              f"library call: none (no one PyTorch call computes the fused "
              f"two-level mean with its broadcast); card {card}")

    # where a full-width round's time goes: the per-client forward and
    # backward, the optimizer, and the sync of an ordinary round (entity
    # levels and the top tier) and of round 8 (every tier's fed level too)
    model, plan, opt, state, batch = (run[k] for k in ("model", "plan", "opt",
                                                        "state", "batch"))
    per_client = vmap(grad_and_value(model.loss_fn))
    grads, _ = per_client(state.params, batch)
    parts = {
        "per-client forward+backward": lambda: per_client(state.params, batch),
        "optimizer": lambda: opt.update(state.params, grads, state.opt_state),
    }
    for label, fed in (("sync, ordinary round", (False, False, True)),
                       ("sync, round 8", (True, True, True))):
        parts[label] = lambda fed=fed: synchronize(state.params, plan, 0, fed_round=fed)
    parts_ms = {label: cuda_ms(fn, iters=5) for label, fn in parts.items()}
    print(f"[timing] full-width round parts (ms): {json.dumps(parts_ms)}; card {card}")
    images = batch["images"].shape[0] * batch["images"].shape[1]
    flops = 3 * vgg_forward_flops(model.spec, images)
    rate = flops / (parts_ms["per-client forward+backward"] * 1e-3)
    print(f"[timing] per-client forward+backward: {flops / 1e9:.1f} GFLOP for "
          f"{images} images (analytic, backward = 2x forward) at "
          f"{rate / 1e12:.2f} TFLOP/s = {100 * rate / F32_FLOPS_PER_S:.1f}% of the "
          f"67 TFLOP/s f32 peak (TF32 off); card {card}")
    reset_launches()
    return out


def vgg_forward_flops(spec, images: int) -> float:
    """Multiply-adds x 2 of one forward pass over ``images`` images."""
    ncv = len(spec.conv_channels)
    total = 0.0
    for u in range(spec.n_units):
        cin, cout, _ = spec.unit_io(u)
        if u < ncv:
            hw = spec.image_size // 2 ** sum(1 for p in spec.pool_after if p < u)
            total += 2.0 * images * hw * hw * 9 * cin * cout
        else:
            total += 2.0 * images * cin * cout
    return total


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is visible; it drives the port on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # f32 convolutions and matmuls in full f32, as the JAX reference computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")

    from repro_torch.configs.vgg16_cifar10 import SPEC
    from repro_torch.kernels import build

    t = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel libraries in {time.perf_counter() - t:.1f} s: "
          + ", ".join(p.name for p in libs))

    errs, bf16_errs = check_kernels(SPEC)
    card_vs_cpu()
    path_launches, run = main_path()
    for name, n in path_launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    times = timings(card, run)

    # max_abs_err: the f32 checks, the dtype the main path launches;
    # max_abs_err_bf16: B1's bf16 instantiation (B2 has none)
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
        "launches": path_launches[name], "max_abs_err": errs[name],
        "max_abs_err_bf16": bf16_errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": None,
    } for name in ("tiered_aggregate", "tiered_aggregate_q8")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
