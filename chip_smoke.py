#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card, its power limit, torch and CUDA versions (no card: exit 1);
2. build every CUDA kernel of the package with nvcc, in parallel; print
   ptxas's registers and spills and cuobjdump's count of tensor-core (HMMA)
   instructions of the attention kernels (B4, B5), and fail if one has none;
3. hold each kernel against its plain PyTorch version on the card: the
   aggregation kernels (B1, B2) at the VGG main path's leaf shapes and at
   ragged edge shapes; the participation-masked B1m (f32, bf16, int8 load)
   at the same shapes under random masks, masks with silent entity groups,
   all-zero and all-ones masks, every flag pair, silent groups keeping
   ``keep`` bit for bit; the per-class kernels (B3 and its dense twin) at the
   JAX package's ragged shapes, the largest VGG leaf and a stacked
   [N, U·E] row, every flag pair and member pattern; the per-class solve
   (Algorithm 2 with two cut classes) on the card's float64 tables against
   NumPy; the flash-attention forward (B4) and its two
   backward passes (B5) at the JAX package's test cases, the full-width
   smollm-135m shape at windows 0/128/256/512, the CLI's S=64 and REDUCED
   qwen2.5's hd 32 / GQA 4:1, bf16 (the forward and both backward passes),
   and under ``vmap(grad_and_value)``;
4. the port on the card against the port on the CPU: VGG REDUCED (N=4, 3
   rounds, f32 convolutions, TF32 off), VGG REDUCED with per-class cuts
   (N=8, 6 rounds, plain and over the int8 wire) and smollm-135m REDUCED
   (N=4, S=256, 3 rounds, at window 0 and 128); the bound-constant probe
   (4 rounds) of REDUCED VGG and REDUCED smollm-135m, every HyperSpec
   field at rtol 1e-4;
5. the main paths, each with every launch count set to 0 just before it and
   read just after, and held to what the plan and the depth imply:
   VGG-16 / CIFAR-10 at full width (N=20 clients, J2=5 edges, batch 16, the
   paper's cuts (3, 8) and intervals (8, 4, 1), 8 rounds through
   ``repro_torch.launch.train.main`` and 8 more with the int8 fed wire);
   the training CLI on REDUCED smollm-135m (N=8, J2=4, batch 4, S=64, 8
   rounds); smollm-135m at full width (N=8, J2=4, batch 1, seq 1024, cuts
   (6, 15), intervals (8, 4, 1), SGD, 8 rounds).  Every client replica must
   equal client 0 after round 8.  Then per-class VGG-16 at full width: the
   solved class cuts and intervals, N=20, J2=5, batch 16, SGD, 12 rounds
   plain and 12 over the int8 fed wire, its sync on B3's twin and B3 only;
   after rounds 6 and 12 the clients that hold a unit in one tier agree.
   Then ``launch.train --auto-optimize`` at VGG-16 full width (8 probe
   rounds, BCD, 8 rounds; B1 as the two plans imply), and the declarative
   API at full width: ``run(paper_spec())`` solved on the card's tables and
   on NumPy (equal), and train mode for 8 rounds on ``paper_spec``,
   ``compressed_spec("int8")`` (B2), ``participation_spec()`` (B1m under
   the trace's deadline masks) and the participation spec over the int8
   wire (B1m's int8 load), each tier synced in round 8 equal across
   clients; the fleet simulator's ``simulate_rounds`` on NumPy and on the
   card at 20 to 10^6 clients and its lattice pricing at 20 to 10^5, equal
   with ``==``, timed for ``sim.fleet.AUTO_TORCH_MIN_ELEMS``;
6. kernel, plain-version, library and bound times: B1/B2, B1m, B3 and its twin
   at the largest VGG leaf [20, 2359296], B4/B5 at the full-width attention shape (window 0,
   the path's, and window 128; the plain version at window 0; B4's and B5's
   bound is 3xTF32 on the tensor cores, with the f32 CUDA-core one beside it); the parts
   of a full-width round of each model, the per-class one included;
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
TF32_FLOPS_PER_S = 495e12  # tensor cores; B4's and B5's 3xTF32 takes 3 of these per f32 operation

F32_RTOL, F32_ATOL = 1e-5, 1e-6  # f32 sums taken in another order
# B1m rounds bf16 once, JAX's level chain twice: three half-ulp roundings
BF16_MASKED_ULPS = 2
Q8_TILE = 256
REPLACES = {
    "tiered_aggregate": "src/repro/kernels/tiered_aggregate/tiered_aggregate.py:35",
    "tiered_aggregate_q8": "src/repro/kernels/tiered_aggregate/tiered_aggregate.py:88",
    "ragged_tiered_aggregate_q8": "src/repro/kernels/tiered_aggregate/tiered_aggregate.py:119",
    # B3's dense twin replaces no TPU kernel: the jnp _ragged_units_mean
    "ragged_tiered_aggregate": "src/repro/core/tiers.py:456",
}
AGG = ("tiered_aggregate", "tiered_aggregate_q8")
RAGGED = ("ragged_tiered_aggregate", "ragged_tiered_aggregate_q8")
# B1m replaces no TPU kernel: the jnp tiers._group_mean_masked, dense and
# over the int8 wire's decoded uploads
MASKED = ("masked_tiered_aggregate", "masked_tiered_aggregate_q8")
REPLACES.update(dict.fromkeys(MASKED, "src/repro/core/tiers.py:262"))
REPLACES.update({
    "swa_attention_fwd": "src/repro/kernels/swa_attention/swa_attention.py:96",
    "swa_attention_bwd_dq": "src/repro/kernels/swa_attention/swa_attention.py:198",
    "swa_attention_bwd_dkv": "src/repro/kernels/swa_attention/swa_attention.py:240",
})
SOURCES = {
    "tiered_aggregate": "src/repro_torch/kernels/tiered_aggregate/csrc/tiered_aggregate.cu",
    "swa_attention": "src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu",
}
ATTN = ("swa_attention_fwd", "swa_attention_bwd_dq", "swa_attention_bwd_dkv")
KERNEL_FN = {"swa_attention_fwd": "swa_fwd_kernel", "swa_attention_bwd_dq": "swa_bwd_dq_kernel",
             "swa_attention_bwd_dkv": "swa_bwd_dkv_kernel"}
ATTN_TOL = 2e-5  # tests/test_kernels_swa.py's: rtol = atol (forward); after max-normalising (backward)
# attention at the full-width smollm-135m path: B = N·batch = 8·1, S, H, K, hd
MAIN_ATTN = (8, 1024, 9, 3, 64)
# the full-width smollm-135m batch per client: 2 peaked at 73.6 GB of the
# card's 80 GB, above the 70 GB line at which the batch is cut to 1
LM_BATCH = 1


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


def _attention_kernel(mangled: str):
    """'swa_bwd_dq_kernel<64, f32>' for an attention kernel's mangled name
    (B4's swa_fwd_kernel, B5's swa_bwd_dq_kernel and swa_bwd_dkv_kernel),
    else None."""
    m = re.search(r"(swa_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)E(f|13__nv_bfloat16)", mangled)
    return m and f"{m.group(1)}<{m.group(2)}, {'f32' if m.group(3) == 'f' else 'bf16'}>"


def attention_build_report(source) -> dict:
    """ptxas's registers and spills and cuobjdump's count of tensor-core
    instructions (HMMA) for every attention kernel of the built library (3
    kernels x 5 head dims x 2 dtypes); fails if one has none."""
    import os

    from repro_torch.kernels import build

    report, key = {}, None
    for line in build.build_log(source).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = _attention_kernel(m.group(1))
        elif key and "Used" in line:
            report.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        elif key and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line).groups()
            report.setdefault(key, {}).update(spill_stores=int(stores), spill_loads=int(loads))
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            key = _attention_kernel(line)
            if key:
                report.setdefault(key, {})["hmma"] = 0
        elif key and re.search(r"\bHMMA\b", line):
            report[key]["hmma"] += 1
    if len(report) != 30 or any(r.get("hmma", 0) == 0 for r in report.values()):
        raise AssertionError(f"attention kernels without tensor-core instructions: {report}")
    for key in ("swa_fwd_kernel<64, f32>", "swa_bwd_dq_kernel<64, f32>",
                "swa_bwd_dkv_kernel<64, f32>"):
        r = report[key]
        print(f"[build] {key}: {r['registers']} registers, spill stores/loads "
              f"{r['spill_stores']}/{r['spill_loads']} bytes (ptxas -v), {r['hmma']} HMMA "
              f"instructions (cuobjdump -sass)")
    print("[build] every attention kernel (B4 and B5, hd 32-128, f32 and bf16) has HMMA "
          "instructions: "
          + ", ".join(f"{k} {r['hmma']}" for k, r in report.items()))
    return report


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


def tier_leaves(params, plan):
    """Leaves with elements in each tier's slice of a client-stacked tree:
    one B1 (or B2) launch each per level that runs."""
    from repro_torch._tree import tree_leaves
    from repro_torch.core import tier_subtrees

    return [sum(1 for x in tree_leaves(part) if x.numel())
            for part in tier_subtrees(params, plan)]


def expected_launches(plan, rounds: int, compressed: bool, leaves):
    """(B1, B2) launches the sync mapping implies, ``leaves[m]`` per tier."""
    b1 = b2 = 0
    for r in range(rounds):
        for m in range(plan.M):
            levels = plan.levels(m)
            entity = len(levels) == 2
            interval = levels[-1][1]
            fed = interval <= 1 or (r + 1) % interval == 0
            wire = compressed and m < plan.M - 1 and plan.entities[m] > 1
            if wire and fed:
                b1 += leaves[m] * entity
                b2 += leaves[m]
            elif entity or fed:
                b1 += leaves[m]
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
    from repro_torch.kernels.tiered_aggregate import launches
    from repro_torch.launch import train

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5",
            "--batch", "16", "--rounds", str(rounds), "--log-every", "1"]
    ckpt = ROOT / "build" / "chip_smoke" / "vgg16-cifar10.npz"
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv + ["--checkpoint", str(ckpt)])
    wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    assert rc == 0, rc
    plain = dict(launches)
    _, _, _, plan, _, _ = train.setup(train.parse_args(argv))
    # w and b of each unit; VGG has no frontend or head leaves
    leaves = [2 * (hi - lo) for lo, hi in map(plan.tier_bounds, range(plan.M))]
    want = expected_launches(plan, rounds, compressed=False, leaves=leaves)
    got = (plain["tiered_aggregate"], plain["tiered_aggregate_q8"])
    assert got == want, (got, want)
    assert not any(plain[k] for k in RAGGED), f"the dense path launched {plain}"
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
          f"(plan implies {want}), no twin or B3 launch, replicas equal")
    print(json.dumps({"run": "uncompressed", "loss": losses, "round_ms": ms}))

    # the same rounds with the int8 codec on the fed wire
    reset_all_launches()
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
    comp_all = dict(launches)
    comp = (comp_all["tiered_aggregate"], comp_all["tiered_aggregate_q8"])
    assert not any(comp_all[k] for k in RAGGED), f"the dense path launched {comp_all}"
    want_c = expected_launches(plan, rounds, compressed=True, leaves=leaves)
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
          f"(plan implies {want_c}), no twin or B3 launch, replicas equal; peak "
          f"device memory "
          f"{peak:.2f} GiB")
    print(json.dumps({"run": "int8", "loss": losses, "round_ms": ms}))
    assert not any(plain[k] + comp_all[k] for k in MASKED), "the dense path launched B1m"
    counts = {k: plain[k] + comp_all[k] for k in AGG + RAGGED + MASKED}
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


# --------------------------------------------------------------------------- #
# the per-class (mixed-cut) path: B3, its twin, the solve and the training
# --------------------------------------------------------------------------- #

# (N, J, P, U, tile): the JAX package's ragged-kernel shapes, the largest
# VGG leaf at the TPU kernel's tile, and a stacked row of smollm-135m's 30
# units of d = 576 with a [N, U] member
RAGGED_CASES = [(20, 5, 999, 1, 128), (6, 2, 257, 1, 128), (16, 4, 2048, 1, 256),
                (20, 5, 9 * 512 * 512, 1, 2048), (8, 4, 30 * 576, 30, 256)]
HETERO = 8.0  # the slow half's access links, tests/test_classes.py's make_problem


def ragged_members(N, J, U, gen, dev):
    """All ones, alternating, an entity group with no member, none, and for
    U > 1 a random [N, U] matrix."""
    import torch

    per = N // J
    ones = torch.ones(N, U, device=dev)
    empty = ones.clone()
    empty[:per] = 0.0
    out = {"ones": ones,
           "mixed": (torch.arange(N, device=dev) % 2).float()[:, None].expand(N, U).contiguous(),
           "empty-group": empty, "none": torch.zeros(N, U, device=dev)}
    if U > 1:
        out["random"] = (torch.rand(N, U, generator=gen, device=dev) > 0.5).float()
    return out


def check_ragged_pair(x, q, scales, w, m, de, dg, J, tile, what, errs):
    """One twin and one B3 launch on the same inputs, each held to its plain
    version; the twin must also leave every non-member's value as it was."""
    import torch

    from repro_torch.kernels.tiered_aggregate import (
        ragged_quantized_tiered_aggregate, ragged_quantized_tiered_aggregate_ref,
        ragged_tiered_aggregate, ragged_tiered_aggregate_ref,
    )

    N, P = x.shape
    U = m.shape[1]
    out = ragged_tiered_aggregate(x, w, m, de, dg, J)
    b3 = ragged_quantized_tiered_aggregate(q, scales, w, m, de, dg, J, tile, width=P)
    torch.cuda.synchronize()
    e = max_err(out, ragged_tiered_aggregate_ref(x, w, m, de, dg, J), torch.float32,
                f"twin {what}")
    errs["ragged_tiered_aggregate"] = max(errs["ragged_tiered_aggregate"], e)
    keep = (m == 0).repeat_interleave(P // U, dim=1)
    if not torch.equal(out[keep], x[keep]):
        raise AssertionError(f"twin {what}: a non-member's value changed")
    ref = ragged_quantized_tiered_aggregate_ref(q, scales, w, m, de, dg, J, tile, P)
    e = max_err(b3, ref, torch.float32, f"B3 tile={tile} {what}")
    errs["ragged_tiered_aggregate_q8"] = max(errs["ragged_tiered_aggregate_q8"], e)


def check_ragged_kernels(spec):
    """B3 and its twin against their plain versions on the same inputs: the
    edge shapes of RAGGED_CASES, then every VGG-16 leaf width at the shapes
    the per-class path gives them (N=20, J=5 and 1, fed weights 1, tile
    Q8_TILE, each class's members, all, none)."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        ragged_tiered_aggregate, ragged_tiered_aggregate_ref,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    flags = ((0, 0), (0, 1), (1, 0), (1, 1))
    errs = dict.fromkeys(RAGGED, 0.0)
    bf16_err, n_checks = 0.0, 0
    for N, J, P, U, tile in RAGGED_CASES:
        x = torch.randn(N, P, generator=gen, device=dev)
        w = torch.softmax(torch.randn(N, generator=gen, device=dev), 0)
        q, scales = q8_quantize(x, tile)
        xb = x.bfloat16() if P < 10**5 else None
        for pattern, m in ragged_members(N, J, U, gen, dev).items():
            for de, dg in flags:
                what = f"N={N} J={J} P={P} U={U} {pattern} do_entity={de} do_global={dg}"
                check_ragged_pair(x, q, scales, w, m, de, dg, J, tile, what, errs)
                n_checks += 2
                if xb is not None:
                    ob = ragged_tiered_aggregate(xb, w, m, de, dg, J)
                    torch.cuda.synchronize()
                    bf16_err = max(bf16_err, max_err(
                        ob, ragged_tiered_aggregate_ref(xb, w, m, de, dg, J),
                        torch.bfloat16, f"twin bf16 {what}"))
                    n_checks += 1
        del x, q, scales
    N = 20
    odd = (torch.arange(N, device=dev) % 2).float()[:, None]
    path_members = {"class 0 (odd rows)": odd, "class 1 (even rows)": 1.0 - odd,
                    "all": torch.ones(N, 1, device=dev), "none": torch.zeros(N, 1, device=dev)}
    ones = torch.ones(N, device=dev)
    for P in vgg_leaf_widths(spec):
        x = torch.randn(N, P, generator=gen, device=dev) * 0.05
        q, scales = q8_quantize(x, Q8_TILE)
        for J in (5, 1):
            for pattern, m in path_members.items():
                for de, dg in flags:
                    what = f"path N={N} J={J} P={P} {pattern} do_entity={de} do_global={dg}"
                    check_ragged_pair(x, q, scales, ones, m, de, dg, J, Q8_TILE, what, errs)
                    n_checks += 2
        del x, q, scales
    print(f"[kernels] {n_checks} checks of B3 and its twin against their plain versions "
          f"passed, every VGG-16 leaf width at the per-class path's shapes among them "
          f"(f32 rtol {F32_RTOL} atol {F32_ATOL}, bf16 one ulp beyond that; "
          f"non-members kept exactly by the twin); max |err| twin f32 "
          f"{errs['ragged_tiered_aggregate']:.3e} twin bf16 {bf16_err:.3e} "
          f"B3 {errs['ragged_tiered_aggregate_q8']:.3e}")
    return errs, {"ragged_tiered_aggregate": bf16_err, "ragged_tiered_aggregate_q8": None}


def hetero_problem(core, vgg):
    """``tests/test_classes.py::make_problem(seed=0, hetero=8.0)``: the
    paper's three tiers (N=20, J2=5), VGG-16 at batch 16, the odd half of
    the fleet's access links (activation and model wires) 8x slower."""
    import dataclasses

    import numpy as np

    N = 20
    system = core.SystemSpec.paper_three_tier(seed=0)
    slow = np.ones(N)
    slow[1::2] = 1.0 / HETERO

    def scaled(tiers):
        return (tiers[0] * slow,) + tuple(tiers[1:])

    system = dataclasses.replace(
        system, act_up=scaled(system.act_up), act_down=scaled(system.act_down),
        model_up=scaled(system.model_up), model_down=scaled(system.model_down))
    hp = core.synthetic_hyperspec(vgg.n_units, N, beta=3.0, seed=0)
    floor = core.theorem1_bound(hp, 10**9, [1, 1, 1], (3, 8))
    return core.HsflProblem(core.build_profile(vgg, batch=16), system, hp, eps=10.0 * floor)


def solve_classes(vgg):
    """Algorithm 2 single-cut, then two cut classes banded by fed uplink,
    with the torch backend on the card and with NumPy: the same optimum."""
    from repro_torch import core

    out = {}
    for backend in ("torch", "numpy"):
        p = hetero_problem(core, vgg)
        t = time.perf_counter()
        single = core.solve_bcd(p, backend=backend)
        spec = core.CutClassSpec.from_rates(p.system.model_up[0], 2, single.cuts)
        res = core.solve_bcd_classes(p, spec, backend=backend)
        ms = (time.perf_counter() - t) * 1e3
        if backend == "torch" and p.evaluator("torch").backend != "torch":
            raise AssertionError("the torch backend did not build its tables on the card")
        out[backend] = (single.cuts, single.intervals, single.theta, res.class_cuts,
                        tuple(res.intervals), res.theta, tuple(res.spec.class_of), ms)
    if out["torch"][:7] != out["numpy"][:7]:
        raise AssertionError(f"torch backend {out['torch']} != numpy {out['numpy']}")
    cuts, intervals, theta, class_cuts, class_iv, class_theta, class_of, ms = out["torch"]
    if len(set(class_cuts)) < 2 or not class_theta < theta:
        raise AssertionError(f"the classes did not split: {class_cuts}, {class_theta} "
                             f"against {theta}")
    print(f"[solve] make_problem(seed=0, hetero={HETERO}): single-cut BCD cuts {cuts} "
          f"intervals {intervals} theta {float(theta)!r}; two classes banded by fed "
          f"uplink: class cuts {class_cuts} intervals {class_iv} theta "
          f"{float(class_theta)!r}; "
          f"equal on the torch backend (card, float64) and NumPy ({ms:.1f} ms and "
          f"{out['numpy'][7]:.1f} ms)")
    return {"class_cuts": class_cuts, "intervals": class_iv, "class_of": class_of}


def solve_backend_timings(card: str, vgg):
    """The batched evaluator's tables on NumPy and on the card's float64
    torch backend, at the paper's three tiers grown from 20 to 10^5 clients:
    where the card starts to win, which ``batched.AUTO_TORCH_MIN_ELEMS``
    (lattice rows x clients) reads.  The tables must be equal."""
    import numpy as np

    from repro_torch import core
    from repro_torch.core.batched import AUTO_TORCH_MIN_ELEMS, BatchedEvaluator

    rows = []
    for N in (20, 200, 2000, 20000, 100000):
        system = core.SystemSpec.paper_three_tier(num_clients=N, num_edges=5, seed=0)
        hp = core.synthetic_hyperspec(vgg.n_units, N, beta=3.0, seed=0)
        floor = core.theorem1_bound(hp, 10**9, [1, 1, 1], (3, 8))
        p = core.HsflProblem(core.build_profile(vgg, batch=16), system, hp,
                             eps=10.0 * floor)
        ms, tables = {}, {}
        for backend in ("numpy", "torch", "torch", "numpy"):  # in turns
            BatchedEvaluator(p, backend)
            best = math.inf
            for _ in range(3):
                t = time.perf_counter()
                ev = BatchedEvaluator(p, backend)
                best = min(best, (time.perf_counter() - t) * 1e3)
            ms.setdefault(backend, []).append(best)
            tables[backend] = (ev.split, ev.agg)
        if not all(np.array_equal(a, b) for a, b in zip(tables["numpy"], tables["torch"])):
            raise AssertionError(f"N={N}: the torch backend's tables differ from NumPy's")
        rows.append((ev.lattice.shape[0] * N, N, min(ms["numpy"]), min(ms["torch"])))
    # the smallest size from which the card wins at every larger size
    wins = [rows[i][0] for i in range(len(rows)) if all(r[3] < r[2] for r in rows[i:])]
    print("[timing] batched evaluator tables, ms (NumPy; torch on the card), best of 3 "
          "after a warm-up, tables equal: "
          + "; ".join(f"N={N} ({elems} rows x clients) {a:.3f}; {b:.3f}"
                      for elems, N, a, b in rows)
          + f". The card wins from {min(wins) if wins else 'none of these'}; auto picks "
          f"it from {AUTO_TORCH_MIN_ELEMS}; card {card}")


def ragged_expected(host, plan, rounds: int, compressed: bool, leaves: int = 2):
    """(twin, B3) launches the ragged sync implies: per round and tier, one
    launch per leaf of every unit some client holds in that tier."""
    twin = b3 = 0
    for r in range(rounds):
        for m in range(plan.M):
            *entity, (_, interval) = plan.levels(m)
            fed = interval <= 1 or (r + 1) % interval == 0
            n = leaves * int(host[m].any(axis=0).sum())
            if compressed and fed and m < plan.M - 1 and plan.entities[m] > 1:
                twin += n * bool(entity)
                b3 += n
            elif entity or fed:
                twin += n
    return twin, b3


def assert_member_sets_agree(params, host, what: str) -> None:
    """Every client whose class holds unit u in tier m holds one value."""
    import numpy as np

    for u, unit in enumerate(params["units"]):
        for m, table in enumerate(host):
            rows = np.flatnonzero(table[:, u])
            for k, x in unit.items():
                if len(rows) and not bool((x[rows] == x[rows[:1]]).all()):
                    raise AssertionError(f"{what}: the tier-{m} holders of units/{u}/{k} "
                                         "differ")


def class_path(solved, rounds: int = 12):
    """Per-class VGG-16 at full width: the solved class cuts and intervals,
    12 rounds plain and 12 over the int8 fed wire."""
    import torch

    from repro_torch.compress import Int8Stochastic
    from repro_torch.core import class_tier_members, default_plan, init_state_a
    from repro_torch.launch import train

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5",
            "--batch", "16", "--rounds", str(rounds)]
    class_cuts, intervals = solved["class_cuts"], solved["intervals"]
    counts = dict.fromkeys(AGG + RAGGED, 0)
    for name, compressor in (("plain", None), ("int8", Int8Stochastic(tile=Q8_TILE))):
        args = train.parse_args(argv)
        device, spec, model, _, opt, loader = train.setup(args)
        plan = default_plan(spec.n_units, args.clients, cuts=class_cuts[0],
                            intervals=intervals, entities=(args.clients, args.edges, 1))
        members = class_tier_members(spec.n_units, class_cuts, solved["class_of"])
        state = init_state_a(model, plan, opt, torch.Generator().manual_seed(args.seed),
                             device)
        dispatch = train.make_dispatch(model, plan, opt, compressor=compressor,
                                       class_members=members)
        torch.cuda.synchronize()
        reset_all_launches()
        losses, ms = [], []
        for r in range(rounds):
            t = time.perf_counter()
            batch = train.to_device(loader.next_round(), device)
            state, loss = dispatch(state, batch, r)
            losses.append(float(loss))  # waits for the round
            ms.append((time.perf_counter() - t) * 1e3)
            if (r + 1) % 6 == 0:  # lcm of the intervals: every fed level ran
                assert_member_sets_agree(state.params, members.host,
                                         f"per-class {name}, round {r + 1}")
        got = all_launches()
        want = ragged_expected(members.host, plan, rounds, compressor is not None)
        if got["tiered_aggregate"] or got["tiered_aggregate_q8"]:
            raise AssertionError(f"per-class {name}: B1/B2 launched on the units {got}")
        if (got["ragged_tiered_aggregate"], got["ragged_tiered_aggregate_q8"]) != want:
            raise AssertionError(f"per-class {name}: launches {got}, the plan implies {want}")
        if (class_cuts == ((4, 5), (1, 2)) and intervals == (3, 2, 1) and rounds == 12
                and want != ((384, 56) if compressor else (416, 0))):
            raise AssertionError(f"per-class {name}: the plan implies {want}, not the "
                                 "count of the solved schedule")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"per-class {name}: losses {losses}")
        for k in RAGGED:
            counts[k] += got[k]
        print(f"[main path] per-class VGG-16 {name}: class cuts {class_cuts}, intervals "
              f"{intervals}, N=20, J2=5, batch 16, {rounds} rounds; twin "
              f"{got['ragged_tiered_aggregate']} B3 {got['ragged_tiered_aggregate_q8']} "
              f"launches as the plan implies, no B1/B2; finite losses; the holders of "
              f"every (unit, tier) agree after rounds 6 and 12")
        print(json.dumps({"run": f"per-class {name}", "loss": losses, "round_ms": ms}))
    return counts, dict(model=model, plan=plan, opt=opt, state=state, batch=batch,
                        members=members)


def class_card_vs_cpu(rounds: int = 6):
    """REDUCED VGG with per-class cuts, the same init and batches on the
    card and the CPU, plain and over the int8 fed wire."""
    import numpy as np
    import torch

    from repro_torch.compress import Int8Stochastic
    from repro_torch.configs.vgg16_cifar10 import REDUCED
    from repro_torch.core import class_tier_members, default_plan, init_state_a
    from repro_torch.launch.train import make_dispatch, to_device
    from repro_torch.models import VggModel
    from repro_torch.optim import sgd

    N, b = 8, 2
    class_cuts, class_of = ((3, 4), (1, 2)), [0, 1] * 4
    model = VggModel(REDUCED)
    plan = default_plan(REDUCED.n_units, N, cuts=class_cuts[0], intervals=(3, 2, 1),
                        entities=(N, 4, 1))
    rng = np.random.default_rng(0)
    hw = REDUCED.image_size
    batches = [{"images": rng.normal(size=(N, b, hw, hw, 3)).astype(np.float32),
                "labels": rng.integers(0, 10, (N, b)).astype(np.int32)}
               for _ in range(rounds)]
    opt = sgd(0.05)
    for name, compressor, rtol in (("plain", None, 1e-4),
                                   ("int8", Int8Stochastic(tile=128), 1e-3)):
        losses = {}
        for dev in ("cuda", "cpu"):
            device = torch.device(dev)
            members = class_tier_members(REDUCED.n_units, class_cuts, class_of, device)
            state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), device)
            dispatch = make_dispatch(model, plan, opt, compressor=compressor,
                                     class_members=members)
            losses[dev] = []
            for r, batch in enumerate(batches):
                state, loss = dispatch(state, to_device(batch, device), r)
                losses[dev].append(float(loss))
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=rtol)
        print(f"[card vs cpu] per-class REDUCED VGG {name} (N=8, class cuts {class_cuts}, "
              f"{rounds} rounds): losses cuda {losses['cuda']} cpu {losses['cpu']} "
              f"(rtol {rtol})")


def ragged_timings(card: str):
    """B3 and its twin at the largest VGG leaf, as the per-class path calls
    them: the twin with both levels (J=5), B3 the fed level (J=1, tile 256),
    both with the path's alternating member vector."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        ragged_quantized_tiered_aggregate, ragged_quantized_tiered_aggregate_ref,
        ragged_tiered_aggregate, ragged_tiered_aggregate_ref, reset_launches,
    )

    dev = torch.device("cuda", 0)
    N, P = 20, 9 * 512 * 512
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(N, P, generator=gen, device=dev)
    ones = torch.ones(N, device=dev)
    m = (torch.arange(N, device=dev) % 2).float()
    q, scales = q8_quantize(x, Q8_TILE)
    out = {}
    k, p = in_turns(lambda: ragged_tiered_aggregate_ref(x, ones, m, 1, 1, 5),
                    lambda: ragged_tiered_aggregate(x, ones, m, 1, 1, 5))
    # bytes: x read once, the output written once; operations: m·x
    # multiply-add in the entity sum and y·(w·m) multiply-add in the fed sum
    out["ragged_tiered_aggregate"] = dict(ms=k, plain_ms=p, bytes=2 * N * P * 4 + 8 * N,
                                          ops=4 * N * P)
    k, p = in_turns(
        lambda: ragged_quantized_tiered_aggregate_ref(q, scales, ones, m, 0, 1, 1, Q8_TILE),
        lambda: ragged_quantized_tiered_aggregate(q, scales, ones, m, 0, 1, 1, Q8_TILE))
    out["ragged_tiered_aggregate_q8"] = dict(
        ms=k, plain_ms=p, bytes=N * P + 4 * N * P // Q8_TILE + 4 * N * P + 8 * N,
        ops=3 * N * P)  # dequantizing multiply, y·(w·m) multiply-add
    for name, r in out.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["ops"] / F32_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"[timing] {name} at [{N}, {P}] (alternating members): kernel {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB at 3.35 TB/s, H100 SXM data "
              f"sheet) = {100 * r['bound_ms'] / r['ms']:.1f}% of the bound; library call: "
              f"none; card {card}")
    reset_launches()
    return out


def class_round_parts(card: str, run):
    """Where a full-width per-class round goes, beside the dense sync of
    the same plan (class 0's cuts for every client)."""
    from torch.func import grad_and_value, vmap

    from repro_torch.compress import Int8Stochastic
    from repro_torch.core import ragged_synchronize, synchronize
    from repro_torch.kernels.tiered_aggregate import reset_launches

    model, plan, opt, state, batch, members = (run[k] for k in (
        "model", "plan", "opt", "state", "batch", "members"))
    per_client = vmap(grad_and_value(model.loss_fn))
    parts = {"per-client forward+backward": lambda: per_client(state.params, batch)}
    grads, _ = per_client(state.params, batch)
    parts["optimizer"] = lambda: opt.update(state.params, grads, state.opt_state)
    ordinary, full = (False, False, True), (True, True, True)
    wire = Int8Stochastic(tile=Q8_TILE)
    for label, fed, comp in (("ordinary round", ordinary, None), ("round 6", full, None),
                             ("round 6, int8 wire", full, wire)):
        parts[f"ragged sync, {label}"] = lambda fed=fed, comp=comp: ragged_synchronize(
            state.params, plan, members, 0, fed_round=fed, compressor=comp)
        parts[f"dense sync, {label}"] = lambda fed=fed, comp=comp: synchronize(
            state.params, plan, 0, fed_round=fed, compressor=comp)
    parts_ms = {label: cuda_ms(fn, iters=5) for label, fn in parts.items()}
    reset_launches()
    print(f"[timing] per-class VGG-16 full-width round parts (ms): {json.dumps(parts_ms)}; "
          f"card {card}")
    return parts_ms


# --------------------------------------------------------------------------- #
# the dense transformer path: flash attention (B4, B5) and smollm-135m
# --------------------------------------------------------------------------- #


def attention_cases():
    """(B, S, H, K, hd, window) of every attention check."""
    cases = [(1, 256, 4, 2, 64, 128), (2, 384, 4, 4, 128, 256), (1, 512, 8, 2, 80, 0),
             (1, 300, 4, 1, 64, 128), (1, 256, 6, 3, 96, 128),
             (1, 640, 4, 2, 64, 512)]  # tests/test_kernels_swa.py's CASES
    cases += [MAIN_ATTN + (w,) for w in (0, 128, 256, 512)]
    cases += [(32, 64, 3, 3, 64, 0)]   # the CLI: REDUCED smollm, N=8 x batch 4, S=64
    cases += [(8, 256, 8, 2, 32, 0)]   # REDUCED qwen2.5: hd 32, GQA 4:1
    return cases


def normalised_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-9))


def check_attention():
    """B4 and each B5 pass against its plain version, on the same inputs."""
    import torch
    from torch.func import grad_and_value, vmap

    from repro_torch.kernels.swa_attention import (
        launches, reset_launches, swa_attention, swa_attention_bwd_dkv,
        swa_attention_bwd_dkv_ref, swa_attention_bwd_dq, swa_attention_bwd_dq_ref,
        swa_attention_fwd, swa_attention_ref,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    errs = dict.fromkeys(ATTN, 0.0)
    for B, S, H, K, hd, W in attention_cases():
        q, k, v, do = randn(B, S, H, hd), randn(B, S, K, hd), randn(B, S, K, hd), randn(B, S, H, hd)
        o, lse = swa_attention_fwd(q, k, v, W)
        dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W)
        dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)
        torch.cuda.synchronize()
        what = f"B={B} S={S} H={H} K={K} hd={hd} window={W}"
        ro, rlse = swa_attention_ref(q, k, v, W)
        torch.testing.assert_close(o, ro, rtol=ATTN_TOL, atol=ATTN_TOL, msg=f"B4 o {what}")
        torch.testing.assert_close(lse, rlse, rtol=ATTN_TOL, atol=ATTN_TOL, msg=f"B4 lse {what}")
        rdq, rdelta = swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W)
        rdk, rdv = swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W)
        for name, got, ref in (("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            e = normalised_err(got, ref)
            if e > ATTN_TOL:
                raise AssertionError(f"B5 {name} {what}: max error {e:.3e} of max|ref| "
                                     f"> {ATTN_TOL}")
        errs["swa_attention_fwd"] = max(errs["swa_attention_fwd"],
                                        float((o - ro).abs().max()), float((lse - rlse).abs().max()))
        errs["swa_attention_bwd_dq"] = max(errs["swa_attention_bwd_dq"],
                                           float((dq - rdq).abs().max()),
                                           float((delta - rdelta).abs().max()))
        errs["swa_attention_bwd_dkv"] = max(errs["swa_attention_bwd_dkv"],
                                            float((dk - rdk).abs().max()),
                                            float((dv - rdv).abs().max()))
        del q, k, v, do, o, lse, dq, delta, dk, dv, ro, rlse, rdq, rdelta, rdk, rdv
    n_cases = len(attention_cases())

    # bf16 inputs against the f32 plain version, the JAX test's tolerance
    B, S, H, K, hd, W = 1, 256, 4, 2, 64, 128
    q, k, v, do = (randn(*s, dtype=torch.bfloat16) for s in
                   ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
    o, lse = swa_attention_fwd(q, k, v, W)
    ro, _ = swa_attention_ref(q.float(), k.float(), v.float(), W)
    torch.testing.assert_close(o.float(), ro, rtol=0, atol=3e-2, msg="B4 bf16")
    bf16_errs = {"swa_attention_fwd": float((o.float() - ro).abs().max())}
    # the bf16 backward against the f32 plain version on the same bf16
    # inputs: one bf16 ulp beyond the f32 tolerance, as B1's bf16 check
    dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W)
    dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, o, do)]
    rdq, _ = swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W)
    rdk, rdv = swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W)
    for name, pairs in (("swa_attention_bwd_dq", ((dq, rdq),)),
                        ("swa_attention_bwd_dkv", ((dk, rdk), (dv, rdv)))):
        for got, ref in pairs:
            err = (got.float() - ref).abs()
            if bool((err > ATTN_TOL * ref.abs().max() + bf16_ulp(ref)).any()):
                raise AssertionError(f"{name} bf16: beyond one bf16 ulp of the f32 tolerance")
            bf16_errs[name] = max(bf16_errs.get(name, 0.0), float(err.max()))

    # Engine A's transform: one launch of each kernel for all N clients
    N, B, S, H, K, hd, W = 4, 2, 256, 9, 3, 64, 128
    q, k, v, dd = randn(N, B, S, H, hd), randn(N, B, S, K, hd), randn(N, B, S, K, hd), \
        randn(N, B, S, H, hd)

    def loss(q, k, v, dd):
        return (swa_attention(q, k, v, W) * dd).sum()

    def loss_plain(q, k, v, dd):
        return (swa_attention_ref(q, k, v, W)[0] * dd).sum()

    reset_launches()
    g, val = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(q, k, v, dd)
    torch.cuda.synchronize()
    once = dict(launches)
    if once != dict.fromkeys(ATTN, 1):
        raise AssertionError(f"vmap over {N} clients made {once} launches, not one each")
    g_ref, val_ref = vmap(grad_and_value(loss_plain, argnums=(0, 1, 2)))(q, k, v, dd)
    torch.testing.assert_close(val, val_ref, rtol=1e-5, atol=1e-3, msg="vmap loss")
    for name, a, b in zip(("dq", "dk", "dv"), g, g_ref):
        e = normalised_err(a, b)
        if e > ATTN_TOL:
            raise AssertionError(f"vmap(grad_and_value) {name}: {e:.3e} > {ATTN_TOL}")
    reset_launches()
    print(f"[attention] {n_cases} shapes x (B4, B5 dq, B5 dk/dv) against the plain versions "
          f"passed (forward rtol=atol {ATTN_TOL}; backward {ATTN_TOL} of max|ref|); bf16 "
          f"forward within 3e-2 of f32 (max |err| {bf16_errs['swa_attention_fwd']:.3e}), bf16 "
          f"backward within one bf16 ulp of the f32 tolerance (max |err| dq "
          f"{bf16_errs['swa_attention_bwd_dq']:.3e}, dk/dv "
          f"{bf16_errs['swa_attention_bwd_dkv']:.3e}); vmap(grad_and_value) "
          f"over N={N}: one launch of each kernel, grads match; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs, bf16_errs


def lm_batches(vocab, N, b, S, rounds, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        toks = rng.integers(0, vocab, (N, b, S + 1)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def lm_card_vs_cpu():
    """REDUCED smollm-135m, 3 rounds, the same init and batches on both
    devices, at window 0 and 128: both forward bodies through the model."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import default_plan, init_state_a
    from repro_torch.kernels.swa_attention import launches, reset_launches
    from repro_torch.launch.train import make_dispatch, to_device
    from repro_torch.models import SplittableModel
    from repro_torch.optim import sgd

    N, b, S, rounds = 4, 2, 256, 3
    for window in (0, 128):
        spec = get_reduced("smollm-135m").with_window(window)
        model = SplittableModel(spec)
        plan = default_plan(spec.n_units, N, cuts=(1, 2), intervals=(2, 2, 1),
                            entities=(N, 2, 1))
        opt = sgd(0.05)
        batches = lm_batches(spec.vocab_size, N, b, S, rounds)
        losses = {}
        for name in ("cuda", "cpu"):
            device = torch.device(name)
            reset_launches()
            state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), device)
            dispatch = make_dispatch(model, plan, opt)
            losses[name] = []
            for r, batch in enumerate(batches):
                state, loss = dispatch(state, to_device(batch, device), r)
                losses[name].append(float(loss))
            if name == "cuda":
                counts = dict(launches)
        want = dict.fromkeys(ATTN, spec.n_units * rounds)
        if counts != want:
            raise AssertionError(f"window {window}: launches {counts}, expected {want}")
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
        print(f"[card vs cpu] smollm-135m REDUCED window={window} N={N} S={S}: losses cuda "
              f"{losses['cuda']} cpu {losses['cpu']} (rtol 1e-4); launches {counts}")


def reset_all_launches():
    from repro_torch.kernels.swa_attention import reset_launches as reset_attn
    from repro_torch.kernels.tiered_aggregate import reset_launches as reset_agg

    reset_agg()
    reset_attn()


def all_launches():
    from repro_torch.kernels.swa_attention import launches as attn
    from repro_torch.kernels.tiered_aggregate import launches as agg

    return {**agg, **attn}


def lm_expected(plan, params, n_units, rounds):
    b1, b2 = expected_launches(plan, rounds, compressed=False,
                               leaves=tier_leaves(params, plan))
    return {"tiered_aggregate": b1, "tiered_aggregate_q8": b2, **dict.fromkeys(RAGGED, 0),
            **dict.fromkeys(MASKED, 0), **dict.fromkeys(ATTN, n_units * rounds)}


def lm_cli(rounds: int = 8):
    """``python -m repro_torch.launch.train --arch smollm-135m`` on the card:
    REDUCED at S=64, as the JAX CLI runs it."""
    import numpy as np
    import torch

    from repro_torch.core import replicate_for_clients
    from repro_torch.launch import train

    argv = ["--arch", "smollm-135m", "--clients", "8", "--edges", "4", "--batch", "4",
            "--rounds", str(rounds), "--log-every", "1"]
    ckpt = ROOT / "build" / "chip_smoke" / "smollm-135m-reduced.npz"
    reset_all_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv + ["--checkpoint", str(ckpt)])
    got = all_launches()
    print(buf.getvalue(), end="")
    assert rc == 0, rc
    losses = [float(v) for v in re.findall(r"loss (\S+)", buf.getvalue())]
    assert len(losses) == rounds and all(math.isfinite(v) for v in losses), losses
    _, spec, model, plan, _, _ = train.setup(train.parse_args(argv + ["--device", "cpu"]))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    want = lm_expected(plan, replicate_for_clients(params, plan.num_clients),
                       spec.n_units, rounds)
    if got != want:
        raise AssertionError(f"CLI launches {got}, the plan and depth imply {want}")
    with np.load(ckpt) as z:
        assert_replicas_equal(((k, z[k]) for k in z.files if k != "__meta__"), "CLI")
    ckpt.unlink()
    print(f"[cli] smollm-135m REDUCED, S=64: {rounds} rounds, finite losses, launches {got} "
          f"as the plan implies, replicas equal")
    return got


def lm_main_path(rounds: int = 8):
    """smollm-135m at full width through the CLI's own pieces."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_spec
    from repro_torch.core import init_state_a
    from repro_torch.launch import train

    argv = ["--arch", "smollm-135m", "--clients", "8", "--edges", "4",
            "--batch", str(LM_BATCH), "--rounds", str(rounds)]
    args = train.parse_args(argv)
    device, spec, model, plan, opt, loader = train.setup(
        args, spec=get_spec("smollm-135m"), seq=1024)
    assert plan.cuts == (6, 15) and plan.intervals == (8, 4, 1), plan
    state = init_state_a(model, plan, opt, torch.Generator().manual_seed(args.seed), device)
    want = lm_expected(plan, state.params, spec.n_units, rounds)
    dispatch = train.make_dispatch(model, plan, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, ms = [], []
    for r in range(rounds):
        t = time.perf_counter()
        batch = train.to_device(loader.next_round(), device)
        state, loss = dispatch(state, batch, r)
        losses.append(float(loss))  # waits for the round
        ms.append((time.perf_counter() - t) * 1e3)
    got = all_launches()
    peak = torch.cuda.max_memory_allocated()
    if got != want:
        raise AssertionError(f"smollm-135m launches {got}, the plan and depth imply {want}")
    assert all(math.isfinite(v) for v in losses), losses
    for i, x in enumerate(tree_leaves(state.params)):
        if not bool((x == x[0:1]).all()):
            raise AssertionError(f"smollm-135m: client replicas of leaf {i} differ after "
                                 f"round {rounds}")
    print(f"[main path] smollm-135m full width (N=8, J2=4, batch {LM_BATCH}, seq 1024, cuts "
          f"{plan.cuts}, intervals {plan.intervals}, {spec.total_param_count()} params): "
          f"launches {got} as the plan and depth imply; replicas equal; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    print(json.dumps({"run": "smollm-135m", "loss": losses, "round_ms": ms,
                      "peak_bytes": peak}))
    return got, dict(model=model, plan=plan, opt=opt, state=state, batch=batch, spec=spec)


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs the causal / windowed mask lets through, per head."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return sum(min(p + 1, window) for p in range(S))


def attention_work(B, S, H, K, hd, window):
    """{kernel: (operations, bytes)}: each input read once, each output
    written once, multiply-adds counted as 2, over the visible pairs."""
    pairs = visible_pairs(S, window) * B * H
    qb, kb, rows = 4 * B * S * H * hd, 4 * B * S * K * hd, 4 * B * H * S
    return {
        # s = q·k, o += p·v
        "swa_attention_fwd": (4 * hd * pairs, 2 * qb + 2 * kb + rows),
        # s, dp = do·v, dq += ds·k; delta = rowsum(o·do)
        "swa_attention_bwd_dq": (6 * hd * pairs + 2 * B * S * H * hd, 4 * qb + 2 * kb + 2 * rows),
        # s, dp, dv += p·do, dk += ds·q
        "swa_attention_bwd_dkv": (8 * hd * pairs, 2 * qb + 4 * kb + 2 * rows),
    }


def attention_timings(card: str):
    """B4 and both B5 passes at the full-width shape: kernel, plain, bound,
    and SDPA as the library yardstick (never called by the port)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.swa_attention import (
        reset_launches, swa_attention_bwd_dkv, swa_attention_bwd_dkv_ref,
        swa_attention_bwd_dq, swa_attention_bwd_dq_ref, swa_attention_fwd, swa_attention_ref,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S, H, K, hd = MAIN_ATTN
    q = torch.randn(B, S, H, hd, generator=gen, device=dev)
    k = torch.randn(B, S, K, hd, generator=gen, device=dev)
    v = torch.randn(B, S, K, hd, generator=gen, device=dev)
    do = torch.randn(B, S, H, hd, generator=gen, device=dev)
    out = {}
    for W in (0, 128):  # the full-width path's window, and one windowed case
        o, lse = swa_attention_fwd(q, k, v, W)
        _, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W)
        runs = {
            "swa_attention_fwd": (lambda: swa_attention_ref(q, k, v, W),
                                  lambda: swa_attention_fwd(q, k, v, W)),
            "swa_attention_bwd_dq": (lambda: swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W),
                                     lambda: swa_attention_bwd_dq(q, k, v, o, lse, do, W)),
            "swa_attention_bwd_dkv": (
                lambda: swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W),
                lambda: swa_attention_bwd_dkv(q, k, v, lse, delta, do, W)),
        }
        work = attention_work(B, S, H, K, hd, W)
        for name, (plain, kernel) in runs.items():
            if W == 0:
                km, pm = in_turns(plain, kernel)
            else:
                km, pm = cuda_ms(kernel), None
            ops, nbytes = work[name]
            by_ops = ops / F32_FLOPS_PER_S * 1e3
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            r = dict(ms=km, plain_ms=pm, bound_ms=max(by_ops, by_bytes),
                     bound_by="operations" if by_ops >= by_bytes else "bytes",
                     ops=ops, bytes=nbytes)
            # B4 and B5 run 3xTF32 on the tensor cores: the share is against that bound
            by_tc = 3 * ops / TF32_FLOPS_PER_S * 1e3
            r.update(bound_ms_f32_cuda_cores=r["bound_ms"], bound_ms=max(by_tc, by_bytes),
                     bound_by="operations" if by_tc >= by_bytes else "bytes")
            against = (f"3xTF32 on the tensor cores, 3 x {ops / 1e9:.2f} GFLOP at 495 "
                       f"TFLOP/s TF32; against 67 TFLOP/s f32 on the CUDA cores it would be "
                       f"{r['bound_ms_f32_cuda_cores']:.4f} ms = "
                       f"{100 * r['bound_ms_f32_cuda_cores'] / km:.1f}%")
            out[(name, W)] = r
            print(f"[timing] {name} at B={B} S={S} H={H} K={K} hd={hd} window={W}: kernel "
                  f"{km:.4f} ms" + (f", plain {pm:.4f} ms" if pm is not None else "")
                  + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {ops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, H100 SXM data sheet) = "
                  f"{100 * r['bound_ms'] / km:.1f}% of the bound ({against}); card {card}")
        del o, lse, delta

    # the library yardstick: SDPA on [B, H, S, hd], forward and forward+backward
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    lib = {}  # window -> (forward ms, forward+backward ms)
    for W in (0, 128):
        mask = None
        if W:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)

        def fwd(W=W, mask=mask):
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      is_causal=W == 0, enable_gqa=True)

        def fwd_bwd(W=W, mask=mask):
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               is_causal=W == 0, enable_gqa=True)
            torch.autograd.grad(o, (qt, kt, vt), dot)

        f_ms, fb_ms = cuda_ms(fwd), cuda_ms(fwd_bwd)
        lib[W] = (f_ms, fb_ms)
        print(f"[timing] library yardstick torch.nn.functional.scaled_dot_product_attention "
              f"(enable_gqa, {'is_causal' if W == 0 else 'boolean window mask'}, f32) at "
              f"window={W}: forward {f_ms:.4f} ms, forward+backward {fb_ms:.4f} ms; card {card}")
    reset_launches()
    for name in ATTN:
        r = out[(name, 0)]
        f_ms, fb_ms = lib[0]
        # the library's backward computes dq, dk and dv together
        r["library_ms"] = f_ms if name == "swa_attention_fwd" else fb_ms - f_ms
    return out


def lm_forward_flops(spec, sequences: int, seq: int) -> float:
    """Model FLOPs of one forward pass: the matmuls (2 per multiply-add)
    and the causal attention over its visible pairs."""
    d, ff, hd, h, kv = spec.d_model, spec.d_ff, spec.hd, spec.num_heads, spec.num_kv_heads
    tokens = sequences * seq
    per_layer = 2.0 * tokens * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff)
    per_layer += 4.0 * hd * h * sequences * visible_pairs(seq, spec.window)
    head = 2.0 * tokens * d * spec.padded_vocab
    return spec.n_units * per_layer + head


def lm_round_parts(card: str, run):
    """Where a full-width smollm-135m round goes, timed right after the
    main path, with no other phase's tensors around."""
    from torch.func import grad_and_value, vmap

    from repro_torch.core import synchronize
    from repro_torch.kernels.swa_attention import reset_launches

    model, plan, opt, state, batch, spec = (run[k] for k in ("model", "plan", "opt", "state",
                                                             "batch", "spec"))
    per_client = vmap(grad_and_value(model.loss_fn))
    parts_ms = {"per-client forward+backward":
                cuda_ms(lambda: per_client(state.params, batch), iters=3)}
    grads, _ = per_client(state.params, batch)
    parts_ms["optimizer"] = cuda_ms(lambda: opt.update(state.params, grads, state.opt_state),
                                    iters=3)
    del grads
    for label, fed in (("sync, ordinary round", (False, False, True)),
                       ("sync, round 8", (True, True, True))):
        parts_ms[label] = cuda_ms(
            lambda fed=fed: synchronize(state.params, plan, 0, fed_round=fed), iters=3)
    reset_launches()
    fb = parts_ms["per-client forward+backward"]
    seqs = batch["tokens"].shape[0] * batch["tokens"].shape[1]
    flops = 3 * lm_forward_flops(spec, seqs, batch["tokens"].shape[2])
    rate = flops / (fb * 1e-3)
    print(f"[timing] smollm-135m full-width round parts (ms): {json.dumps(parts_ms)}; "
          f"card {card}")
    print(f"[timing] smollm-135m per-client forward+backward: {flops / 1e12:.2f} TFLOP "
          f"(analytic model FLOPs, backward = 2x forward, causal attention) at "
          f"{rate / 1e12:.2f} TFLOP/s = {100 * rate / F32_FLOPS_PER_S:.1f}% of the 67 TFLOP/s "
          f"f32 peak (TF32 off); card {card}")
    return parts_ms


def attention_share(card: str, spec, parts_ms, attn_times) -> None:
    fb = parts_ms["per-client forward+backward"]
    attn = spec.n_units * sum(attn_times[(name, 0)]["ms"] for name in ATTN)
    print(f"[timing] smollm-135m attention kernels: {attn:.2f} ms of the {fb:.2f} ms "
          f"forward+backward ({spec.n_units} x (B4 + B5 dq + B5 dk/dv) at their timed "
          f"speed) = {100 * attn / fb:.1f}%; card {card}")


# --------------------------------------------------------------------------- #
# partial participation (B1m), the estimator, --auto-optimize, the API, the
# fleet simulator's backends
# --------------------------------------------------------------------------- #

MASK_KINDS = ("random", "zero groups", "all zero", "all ones")


def participation_mask(kind: str, N: int, J: int, gen, dev):
    """f32 0/1 [N]: about 60% at random; whole entity groups silent (every
    other group, the rest at random); none; all."""
    import torch

    if kind == "all zero":
        return torch.zeros(N, device=dev)
    if kind == "all ones":
        return torch.ones(N, device=dev)
    m = (torch.rand(N, generator=gen, device=dev) < 0.6).float()
    if kind == "zero groups":
        per = N // J
        for j in range(0, J, 2):
            m[j * per:(j + 1) * per] = 0.0
    return m


def silent_rows(mask, J: int, de, dg):
    """[N] bool: the rows a B1m launch must copy from ``keep`` bit for bit."""
    import torch

    N = mask.shape[0]
    if dg:
        return torch.full((N,), bool(mask.sum() == 0), device=mask.device)
    if de:
        return (mask.reshape(J, -1).sum(1) == 0).repeat_interleave(N // J)
    return torch.zeros(N, dtype=torch.bool, device=mask.device)


def jax_level_chain(x, mask, keep, de, dg, J):
    """The JAX package's ``synchronize(mask=)`` levels in x's own dtype: in
    bf16 the entity mean is rounded before the fed level reads it."""
    from repro_torch.kernels.tiered_aggregate.ref import _group_mean_masked

    y = x
    if de:
        y = _group_mean_masked(y, mask, keep, J)
    if dg:
        y = _group_mean_masked(y, mask, y if de else keep, 1)
    return y


def check_masked_kernels(spec):
    """B1m against its plain version: f32, bf16 and the int8 load; random
    masks, masks with zero-participant groups, all-zero and all-ones; every
    flag pair; edge shapes and every VGG-16 leaf width at J=5 and J=1.  The
    rows of a group without a participant must equal ``keep`` exactly.  In
    bf16 B1m also stays within BF16_MASKED_ULPS ulps of a column's largest
    |x| of JAX's level chain, which rounds once more (between the levels)."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        launches, masked_quantized_tiered_aggregate, masked_quantized_tiered_aggregate_ref,
        masked_tiered_aggregate, masked_tiered_aggregate_ref, reset_launches,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    flags = [(de, dg) for de in (0, 1) for dg in (0, 1)]
    N = 20
    cases = [(8, 4, 700), (20, 5, 2049), (4, 1, 100), (6, 6, 257)]
    cases += [(N, J, P) for P in vgg_leaf_widths(spec) for J in (5, 1)]
    errs = {"masked_tiered_aggregate": 0.0, "masked_tiered_aggregate_q8": 0.0}
    bf16_err, bf16_ulps = 0.0, 0.0
    calls = dict.fromkeys(errs, 0)
    reset_launches()
    for n, J, P in cases:
        for kind in MASK_KINDS:
            mask = participation_mask(kind, n, J, gen, dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n, P, generator=gen, device=dev).to(dtype)
                keep = torch.randn(n, P, generator=gen, device=dev).to(dtype)
                for de, dg in flags:
                    for k in (x, keep):  # keep = x: the clients' own state
                        out = masked_tiered_aggregate(x, mask, k, de, dg, J)
                        calls["masked_tiered_aggregate"] += 1
                        torch.cuda.synchronize()
                        ref = masked_tiered_aggregate_ref(x, mask, k, de, dg, J)
                        what = (f"B1m N={n} J={J} P={P} {dtype} mask {kind} "
                                f"do_entity={de} do_global={dg}")
                        assert out.dtype == dtype and out.shape == x.shape, what
                        e = max_err(out, ref, dtype, what)
                        rows = silent_rows(mask, J, de, dg)
                        if not torch.equal(out[rows], k[rows]):
                            raise AssertionError(f"{what}: silent rows are not keep")
                        if dtype == torch.float32:
                            errs["masked_tiered_aggregate"] = max(
                                errs["masked_tiered_aggregate"], e)
                            continue
                        bf16_err = max(bf16_err, e)
                        chain = jax_level_chain(x, mask, k, de, dg, J).float()
                        ulp = torch.exp2(torch.floor(torch.log2(x.float().abs().amax(0))) - 7)
                        u = float(((out.float() - chain).abs() / ulp).max())
                        if u > BF16_MASKED_ULPS:
                            raise AssertionError(f"{what}: {u} bf16 ulps from JAX's level "
                                                 f"chain, limit {BF16_MASKED_ULPS}")
                        bf16_ulps = max(bf16_ulps, u)
            x = torch.randn(n, P, generator=gen, device=dev) * 0.05
            keep = torch.randn(n, P, generator=gen, device=dev) * 0.05
            q, scales = q8_quantize(x, Q8_TILE)
            for de, dg in flags:
                out = masked_quantized_tiered_aggregate(q, scales, mask, keep, de, dg, J,
                                                        Q8_TILE)
                calls["masked_tiered_aggregate_q8"] += 1
                torch.cuda.synchronize()
                ref = masked_quantized_tiered_aggregate_ref(q, scales, mask, keep, de, dg, J,
                                                            Q8_TILE)
                what = f"B1m int8 N={n} J={J} P={P} mask {kind} do_entity={de} do_global={dg}"
                assert out.dtype == torch.float32 and out.shape == (n, P), what
                e = max_err(out, ref, torch.float32, what)
                rows = silent_rows(mask, J, de, dg)
                if not torch.equal(out[rows], keep[rows]):
                    raise AssertionError(f"{what}: silent rows are not keep")
                errs["masked_tiered_aggregate_q8"] = max(errs["masked_tiered_aggregate_q8"], e)
    got = {k: launches[k] for k in calls}
    if got != calls:
        raise AssertionError(f"B1m launches {got}, calls {calls}")
    reset_launches()
    n_checks = sum(calls.values())
    print(f"[masked] {n_checks} checks of B1m against its plain version passed "
          f"({len(cases)} shapes x masks {', '.join(MASK_KINDS)} x every flag pair; f32 "
          f"rtol {F32_RTOL} atol {F32_ATOL}, bf16 one ulp beyond that; silent groups keep "
          f"keep bit for bit); max |err| f32 {errs['masked_tiered_aggregate']:.3e} bf16 "
          f"{bf16_err:.3e} int8 {errs['masked_tiered_aggregate_q8']:.3e}; bf16 within "
          f"{bf16_ulps:g} ulps of JAX's level chain (limit {BF16_MASKED_ULPS}); launches {got}")
    return errs, {"masked_tiered_aggregate": bf16_err, "masked_tiered_aggregate_q8": None}


def masked_timings(card: str):
    """B1m at the largest VGG leaf [20, 2359296], as the participation path
    calls it: both levels fused (J=5) with a 60% mask; the int8 load on the
    fed level (J=1, tile 256)."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        masked_quantized_tiered_aggregate, masked_quantized_tiered_aggregate_ref,
        masked_tiered_aggregate, masked_tiered_aggregate_ref, reset_launches,
    )

    dev = torch.device("cuda", 0)
    N, P = 20, 9 * 512 * 512
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(N, P, generator=gen, device=dev)
    mask = participation_mask("random", N, 5, gen, dev)
    q, scales = q8_quantize(x, Q8_TILE)
    out = {}
    k, p = in_turns(lambda: masked_tiered_aggregate_ref(x, mask, x, 1, 1, 5),
                    lambda: masked_tiered_aggregate(x, mask, x, 1, 1, 5))
    # bytes: x read once, the output written once (keep is read only where
    # no client participated: not in this run); operations: w·x multiply-add
    out["masked_tiered_aggregate"] = dict(ms=k, plain_ms=p, bytes=2 * N * P * 4 + 4 * N,
                                          ops=2 * N * P)
    k, p = in_turns(
        lambda: masked_quantized_tiered_aggregate_ref(q, scales, mask, x, 0, 1, 1, Q8_TILE),
        lambda: masked_quantized_tiered_aggregate(q, scales, mask, x, 0, 1, 1, Q8_TILE))
    out["masked_tiered_aggregate_q8"] = dict(
        ms=k, plain_ms=p, bytes=N * P + 4 * N * P // Q8_TILE + 4 * N * P + 4 * N,
        ops=3 * N * P)  # dequantizing multiply, w·x multiply-add
    for name, r in out.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["ops"] / F32_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"[timing] {name} at [{N}, {P}] ({int(mask.sum())} of {N} participate): "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB at 3.35 "
              f"TB/s, H100 SXM data sheet) = {100 * r['bound_ms'] / r['ms']:.1f}% of the "
              f"bound; library call: none; card {card}")
    reset_launches()
    return out


def estimator_card_vs_cpu():
    """The bound-constant probe (4 rounds) of REDUCED VGG and REDUCED
    smollm-135m on the card and on the CPU, from one init: every HyperSpec
    field at rtol 1e-4."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.vgg16_cifar10 import REDUCED
    from repro_torch.core import default_plan, estimate_from_probe
    from repro_torch.models import SplittableModel, VggModel
    from repro_torch.optim import sgd

    N, b, rounds = 4, 2, 4
    rng = np.random.default_rng(3)
    hw = REDUCED.image_size
    vgg_batches = [{"images": rng.normal(size=(N, b, hw, hw, 3)).astype(np.float32),
                    "labels": rng.integers(0, 10, (N, b)).astype(np.int32)}
                   for _ in range(rounds)]
    lm = get_reduced("smollm-135m")
    runs = {"vgg16-cifar10 REDUCED": (VggModel(REDUCED), REDUCED.n_units, vgg_batches),
            "smollm-135m REDUCED": (SplittableModel(lm), lm.n_units,
                                    lm_batches(lm.vocab_size, N, b, 64, rounds))}
    for name, (model, n_units, batches) in runs.items():
        plan = default_plan(n_units, N, entities=(N, 2, 1))
        hp = {dev: estimate_from_probe(model, plan, sgd(0.05), batches,
                                       torch.Generator().manual_seed(0), 0.05, dev)
              for dev in ("cuda", "cpu")}
        for f in ("beta", "theta0", "sigma2", "G2"):
            np.testing.assert_allclose(getattr(hp["cuda"], f), getattr(hp["cpu"], f),
                                       rtol=1e-4, err_msg=f"{name} {f}")
        print(f"[estimator] {name} N={N}, {rounds} probe rounds: beta "
              f"{hp['cuda'].beta:.6g} (cpu {hp['cpu'].beta:.6g}), theta0 "
              f"{hp['cuda'].theta0:.6g}, sum G2 {hp['cuda'].G2.sum():.6g}, sum sigma2 "
              f"{hp['cuda'].sigma2.sum():.6g}; every field within rtol 1e-4 of the CPU's")


def auto_optimize_cli(probe_rounds: int = 8, rounds: int = 8):
    """``repro_torch.launch.train --auto-optimize`` at VGG-16 full width: the
    probe runs the initial plan, then BCD's plan trains; B1's launches are
    what the two plans imply."""
    import torch

    from repro_torch.core import default_plan
    from repro_torch.launch import train

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5", "--batch", "16",
            "--auto-optimize", "--probe-rounds", str(probe_rounds), "--rounds", str(rounds),
            "--log-every", "1"]
    torch.cuda.synchronize()
    reset_all_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    wall = time.perf_counter() - t0
    got = all_launches()
    text = buf.getvalue()
    print(text, end="")
    assert rc == 0, rc
    bcd = re.search(r"\[bcd\] cuts=\(([\d, ]+)\) intervals=\(([\d, ]+)\)", text)
    assert bcd, "no [bcd] line"
    cuts = tuple(int(v) for v in bcd.group(1).split(","))
    intervals = tuple(int(v) for v in bcd.group(2).split(","))
    _, spec, _, plan0, _, _ = train.setup(train.parse_args(argv + ["--device", "cpu"]))
    plan1 = default_plan(spec.n_units, 20, cuts=cuts, intervals=intervals,
                         entities=(20, 5, 1))
    leaves = lambda p: [2 * (hi - lo) for lo, hi in map(p.tier_bounds, range(p.M))]  # noqa: E731
    want = [a + b for a, b in zip(expected_launches(plan0, probe_rounds, False, leaves(plan0)),
                                  expected_launches(plan1, rounds, False, leaves(plan1)))]
    if (got["tiered_aggregate"], got["tiered_aggregate_q8"]) != tuple(want):
        raise AssertionError(f"--auto-optimize launches {got}, the probe's plan and "
                             f"BCD's imply B1, B2 = {want}")
    if any(v for k, v in got.items() if k not in AGG):
        raise AssertionError(f"--auto-optimize launched other kernels: {got}")
    losses = [float(v) for v in re.findall(r"loss (\S+)", text)]
    ms = [float(v) for v in re.findall(r"\((\S+) ms/round", text)]
    assert len(losses) == rounds and all(math.isfinite(v) for v in losses), losses
    print(f"[cli auto-optimize] VGG-16 full width, N=20, J2=5, batch 16: {probe_rounds} "
          f"probe rounds on cuts {plan0.cuts} intervals {plan0.intervals}, then BCD's cuts "
          f"{cuts} intervals {intervals} for {rounds} rounds in {wall:.2f} s; B1 launches "
          f"{got['tiered_aggregate']} as the two plans imply")
    print(json.dumps({"run": "cli-auto-optimize", "cuts": cuts, "intervals": intervals,
                      "loss": losses, "round_ms": ms}))
    return got


def api_train(api, spec, label: str):
    """``api.run(spec)`` in train mode on the card, counting launches; the
    engine step is wrapped to keep the last state and time each round."""
    import torch

    run_mod = sys.modules["repro_torch.api.run"]
    make_step = run_mod._make_step
    seen = {"t": []}

    def hooked(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def wrapped(*a):
            seen["t"].append(time.perf_counter())
            seen["state"], loss = step(*a)
            return seen["state"], loss

        return wrapped

    run_mod._make_step = hooked
    torch.cuda.synchronize()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        res = api.run(spec)
        wall = time.perf_counter() - t0
    finally:
        run_mod._make_step = make_step
    got = all_launches()
    losses = res.train["losses"]
    assert len(losses) == spec.run.rounds and all(math.isfinite(v) for v in losses), losses
    ms = [(b - a) * 1e3 for a, b in zip(seen["t"], seen["t"][1:])]
    print(f"[api] {label}: cuts {res.cuts} intervals {res.intervals}, {spec.run.rounds} "
          f"rounds in {wall:.2f} s (solve included), final loss {losses[-1]:.4f}")
    print(json.dumps({"run": f"api {label}", "cuts": res.cuts, "intervals": res.intervals,
                      "loss": losses, "round_ms": ms}))
    return res, got, seen["state"]


def api_paths(rounds: int = 8):
    """The declarative API at VGG-16 full width: the solve on the card's
    tables and on NumPy; train mode plain, over the int8 wire, and under
    the straggler deadline's participation masks (plain and int8)."""
    import numpy as np

    from repro_torch import api
    from repro_torch._tree import tree_leaves
    from repro_torch.core import tier_subtrees
    from repro_torch.core.tiers import TierPlan

    card_solve = api.run(api.paper_spec().replace(solver=api.SolverCfg(backend="jax")))
    host_solve = api.run(api.paper_spec().replace(solver=api.SolverCfg(backend="numpy")))
    if (card_solve.cuts, card_solve.intervals, card_solve.theta) != (
            host_solve.cuts, host_solve.intervals, host_solve.theta):
        raise AssertionError(f"solve on the card {card_solve} differs from NumPy's {host_solve}")
    print(f"[api] run(paper_spec()) solve: cuts {card_solve.cuts} intervals "
          f"{card_solve.intervals} theta {card_solve.theta!r} on the card's float64 tables "
          f"(solver backend 'jax') and on NumPy, equal")

    # lr 5e-4, the training CLI's for VGG-16: RunCfg's default 0.1 (the
    # REDUCED quickstart's) diverges at full VGG-16 width within 6 rounds
    train_run = api.RunCfg(mode="train", rounds=rounds, lr=5e-4)
    specs = {
        "paper-sec7 train": api.paper_spec(mode="train").replace(run=train_run),
        "compressed-int8 train": api.compressed_spec("int8").replace(run=train_run),
        "participation train": api.participation_spec().replace(run=train_run),
        "participation int8 train": api.participation_spec().replace(
            run=train_run, compression=api.CompressionCfg(codec="int8")),
    }
    counts = {}
    for label, spec in specs.items():
        res, got, state = api_train(api, spec, label)
        built = api.build(spec)
        plan = TierPlan(n_units=built.model_spec.n_units, num_clients=built.system.num_clients,
                        cuts=res.cuts, intervals=res.intervals, entities=built.system.entities)
        leaves = [2 * (hi - lo) for lo, hi in map(plan.tier_bounds, range(plan.M))]
        b1, b2 = expected_launches(plan, rounds, spec.compression is not None, leaves)
        masked = spec.participation is not None
        keys = MASKED if masked else AGG
        want = {k: 0 for k in got}
        want[keys[0]], want[keys[1]] = b1, b2
        if got != want:
            raise AssertionError(f"{label}: launches {got}, the plan implies {want}")
        if masked:
            pr = sys.modules["repro_torch.api.run"]._participation_masks(built, res.cuts)
            used = pr[np.arange(rounds) % pr.shape[0]]
            print(f"[api] {label}: the trace's masks let {int(used.sum())} of "
                  f"{used.size} client-rounds through (deadline "
                  f"{built.participation.deadline:.6g} s); B1m {b1} + int8 {b2} launches, "
                  "no B1/B2")
            if used.all():
                raise AssertionError(f"{label}: every client made every deadline")
        # every client row of each tier synced in the last round equals row 0
        for m, part in enumerate(tier_subtrees(state.params, plan)):
            interval = plan.levels(m)[-1][1]
            if interval > 1 and rounds % interval:
                continue
            for x in tree_leaves(part):
                if x.numel() and not bool((x == x[0:1]).all()):
                    raise AssertionError(f"{label}: tier {m} replicas differ after round "
                                         f"{rounds}")
        for k, v in got.items():
            counts.setdefault(label, {})[k] = v
    return counts


def sim_backends(card: str):
    """The fleet simulator on NumPy and on the card's float64 tensors:
    ``simulate_rounds`` on straggler-tail at 20 to 10^6 clients, the
    whole-lattice pricing (with and without a deadline) at 20 to 10^5;
    results equal with ``==``; times for ``fleet.AUTO_TORCH_MIN_ELEMS``."""
    import numpy as np

    from repro_torch.configs.vgg16_cifar10 import SPEC
    from repro_torch.core import SystemSpec, build_profile
    from repro_torch.core.batched import cut_lattice
    from repro_torch.sim import (
        deadline_for_rate, make_trace, simulate_lattice_rounds, simulate_rounds,
    )
    from repro_torch.sim.fleet import AUTO_TORCH_MIN_ELEMS

    cuts, intervals = (3, 8), (2, 4, 1)
    prof = build_profile(SPEC, batch=16)
    lattice = cut_lattice(SPEC.n_units, 3)

    def in_turns_host(fn_numpy, fn_torch):
        out, ms = {}, {"numpy": [], "torch": []}
        for be, fn in (("numpy", fn_numpy), ("torch", fn_torch), ("torch", fn_torch),
                       ("numpy", fn_numpy)):
            t = time.perf_counter()
            out[be] = fn()
            ms[be].append((time.perf_counter() - t) * 1e3)
        return out, min(ms["numpy"]), min(ms["torch"])

    rows = {"simulate_rounds": [], "lattice": []}
    for N in (20, 1_000, 10_000, 100_000, 1_000_000):
        system = SystemSpec.paper_three_tier(num_clients=N, num_edges=5 if N == 20 else N // 200,
                                             seed=0)
        trace = make_trace("straggler-tail", prof, system, rounds=4, seed=0)
        simulate_rounds(trace, cuts, intervals, backend="numpy")  # draws every round once
        simulate_rounds(trace, cuts, intervals, backend="torch")
        res, a, b = in_turns_host(
            lambda: simulate_rounds(trace, cuts, intervals, backend="numpy"),
            lambda: simulate_rounds(trace, cuts, intervals, backend="torch"))
        for f in ("split", "agg", "fired", "total", "participants"):
            if not np.array_equal(getattr(res["numpy"], f), getattr(res["torch"], f)):
                raise AssertionError(f"N={N}: simulate_rounds {f} differs between backends")
        rows["simulate_rounds"].append((N, N, a, b))
        if N <= 100_000:
            deadline = deadline_for_rate(trace, cuts, 0.75)
            r = 2 if N == 100_000 else 4
            for dl in (None, deadline):
                res, a, b = in_turns_host(
                    lambda: simulate_lattice_rounds(trace, lattice, rounds=r, backend="numpy",
                                                    deadline=dl),
                    lambda: simulate_lattice_rounds(trace, lattice, rounds=r, backend="torch",
                                                    deadline=dl))
                if not all(np.array_equal(x, y) for x, y in zip(res["numpy"], res["torch"])):
                    raise AssertionError(f"N={N}: lattice pricing (deadline {dl}) differs")
            rows["lattice"].append((lattice.shape[0] * N, N, a / r, b / r))
    out = {}
    for name, rs in rows.items():
        wins = [rs[i][0] for i in range(len(rs)) if all(x[3] < x[2] for x in rs[i:])]
        out[name] = {"rows": rs, "card_wins_from": min(wins) if wins else None}
        unit = "ms a round" if name == "lattice" else "ms for 4 rounds"
        print(f"[sim] {name} ({unit}; NumPy; torch on the card), best of 2 in turns, equal "
              "with ==: " + "; ".join(f"N={N} ({e} elems) {a:.3f}; {b:.3f}"
                                      for e, N, a, b in rs)
              + f". The card wins from {out[name]['card_wins_from'] or 'none of these'}"
              f"; card {card}")
    print(f"[sim] auto picks the card from {AUTO_TORCH_MIN_ELEMS} elems (clients x lattice "
          "rows) in the lattice pricing and NumPy for a round's [N] chain")
    print(json.dumps({"sim_backends": out}))
    return out


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

    from repro_torch.kernels.swa_attention.ops import SOURCE as SWA_SOURCE

    attn_build = attention_build_report(SWA_SOURCE)
    errs, bf16_errs = check_kernels(SPEC)
    ragged_errs, ragged_bf16_errs = check_ragged_kernels(SPEC)
    errs.update(ragged_errs)
    bf16_errs.update(ragged_bf16_errs)
    masked_errs, masked_bf16_errs = check_masked_kernels(SPEC)
    attn_errs, attn_bf16_errs = check_attention()
    solved = solve_classes(SPEC)
    solve_backend_timings(card, SPEC)
    card_vs_cpu()
    class_card_vs_cpu()
    lm_card_vs_cpu()
    estimator_card_vs_cpu()
    path_launches, run = main_path()
    for name in AGG:
        if path_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the VGG main path")
    class_launches, class_run = class_path(solved)
    for name in RAGGED:
        if class_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the per-class path")
    class_round_parts(card, class_run)
    del class_run
    cli_launches = lm_cli()
    lm_launches, lm_run = lm_main_path()
    for name in ("tiered_aggregate",) + ATTN:
        if lm_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the smollm-135m path")
    lm_parts = lm_round_parts(card, lm_run)
    del lm_run["state"], lm_run["batch"]
    auto_launches = auto_optimize_cli()
    api_launches = api_paths()
    masked_launches = {name: api_launches[path][name] for name, path in
                       zip(MASKED, ("participation train", "participation int8 train"))}
    for name, n in masked_launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the participation path")
    sim_backends(card)
    times = timings(card, run)
    times.update(ragged_timings(card))
    times.update(masked_timings(card))
    attn_times = attention_timings(card)
    attention_share(card, lm_run["spec"], lm_parts, attn_times)

    # max_abs_err: the f32 checks, the dtype the main paths launch;
    # max_abs_err_bf16: the bf16 instantiation (B2 is checked in f32 only).
    # launches: the count on the kernel's main path (VGG for B1/B2, the
    # full-width smollm-135m for B4/B5); launches_by_path: every path's count
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES["tiered_aggregate"],
        "replaces": REPLACES[name],
        "launches": path_launches[name],
        "launches_by_path": {"vgg16-cifar10": path_launches[name],
                             "smollm-135m": lm_launches[name],
                             "smollm-135m-reduced-cli": cli_launches[name],
                             "cli-auto-optimize": auto_launches[name],
                             **{path: api_launches[path][name] for path in api_launches}},
        "max_abs_err": errs[name],
        "max_abs_err_bf16": bf16_errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": None,
    } for name in AGG]
    # B3 and its twin: the per-class VGG-16 path (plain and int8 runs)
    kernels += [{
        "name": name, "route": "cuda", "source": SOURCES["tiered_aggregate"],
        "replaces": REPLACES[name],
        "launches": class_launches[name],
        "launches_by_path": {"vgg16-cifar10-per-class": class_launches[name],
                             "vgg16-cifar10": path_launches[name],
                             "smollm-135m": lm_launches[name]},
        "max_abs_err": errs[name],
        "max_abs_err_bf16": bf16_errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": None,
        **({"port_only": "no TPU kernel: the jnp tiers._ragged_units_mean"}
           if name == "ragged_tiered_aggregate" else {}),
    } for name in RAGGED]
    # B1m: the participation path (API train on participation_spec, and
    # with the int8 wire); the other paths launch it no time
    kernels += [{
        "name": name, "route": "cuda", "source": SOURCES["tiered_aggregate"],
        "replaces": REPLACES[name],
        "launches": masked_launches[name],
        "launches_by_path": {**{path: api_launches[path][name] for path in api_launches},
                             "vgg16-cifar10": path_launches[name],
                             "cli-auto-optimize": auto_launches[name],
                             "smollm-135m": lm_launches[name]},
        "max_abs_err": masked_errs[name],
        "max_abs_err_bf16": masked_bf16_errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": None,
        "port_only": "no TPU kernel: the jnp tiers._group_mean_masked",
    } for name in MASKED]
    B, S, H, K, hd = MAIN_ATTN
    # SDPA's backward computes dq, dk and dv in one call: its fair counterpart
    # is the two B5 passes together
    b5_pair = {"ms": sum(attn_times[(n, 0)]["ms"] for n in ATTN[1:]),
               "library_ms": attn_times[(ATTN[1], 0)]["library_ms"]}
    kernels += [{
        "name": name, "route": "cuda", "source": SOURCES["swa_attention"],
        "replaces": REPLACES[name],
        "launches": lm_launches[name],
        "launches_by_path": {"smollm-135m": lm_launches[name],
                             "smollm-135m-reduced-cli": cli_launches[name]},
        "max_abs_err": attn_errs[name],
        "max_abs_err_bf16": attn_bf16_errs[name],
        "ms": attn_times[(name, 0)]["ms"], "plain_ms": attn_times[(name, 0)]["plain_ms"],
        "bound_ms": attn_times[(name, 0)]["bound_ms"],
        "bound_by": attn_times[(name, 0)]["bound_by"],
        "bound_against": "3xTF32 on the tensor cores: 3 x operations at 495 TFLOP/s",
        "bound_ms_f32_cuda_cores": attn_times[(name, 0)]["bound_ms_f32_cuda_cores"],
        "build": attn_build[f"{KERNEL_FN[name]}<{hd}, f32>"],
        "library_ms": attn_times[(name, 0)]["library_ms"],
        "library": ("torch.nn.functional.scaled_dot_product_attention, "
                    + ("forward" if name == "swa_attention_fwd"
                       else "backward (dq, dk and dv together)")),
        **({} if name == "swa_attention_fwd" else {"library_ms_pair": b5_pair}),
        "timed_at": f"B={B} S={S} H={H} K={K} hd={hd} window=0 f32",
    } for name in ATTN]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
