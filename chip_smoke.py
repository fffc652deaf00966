#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card, its power limit, torch and CUDA versions (no card: exit 1);
2. build every CUDA kernel of the package with nvcc, in parallel; print
   ptxas's registers and spills and cuobjdump's count of tensor-core
   instructions of the attention kernels (B4, B5: HGMMA for the wgmma
   kernels, B4's and B5's at hd <= 64, B5's at 128 and B4's at 256, HMMA
   for the others), and fail if one has none, if a wgmma kernel or B5's
   8-warp (hd 256) kernels spill, or if ptxas notes C7520 (a wgmma
   kernel's wgmma serialised after a divergent path; its other notes that
   it serialised a kernel's wgmma, C7511, are printed), with the
   occupancy calculator's shared memory and blocks an SM; B4d's registers
   and spills;
3. hold each kernel against its plain PyTorch version on the card: the
   aggregation kernels (B1, B2) at the VGG main path's leaf shapes and at
   ragged edge shapes (B2 and B3 through ``kernels/tiered_aggregate/
   check.py``: the entry against the wire payload's route and B3's all-ones
   collapse onto B2 bit for bit); the participation-masked B1m (f32, bf16, int8 load)
   at the same shapes under random masks, masks with silent entity groups,
   all-zero and all-ones masks, every flag pair, silent groups keeping
   ``keep`` bit for bit; the per-class kernels (B3 and its dense twin) at the
   JAX package's ragged shapes, the largest VGG leaf and a stacked
   [N, U·E] row, every flag pair and member pattern; the per-class solve
   (Algorithm 2 with two cut classes) on the card's float64 tables against
   NumPy; the flash-attention forward (B4) and its two
   backward passes (B5) at the JAX package's test cases, the full-width
   smollm-135m shape at windows 0/128/256/512, the CLI's S=64 and REDUCED
   qwen2.5's hd 32 / GQA 4:1, paligemma-3b's Engine-B tiers (hd 256, one kv
   head, the prefix-LM mask at prefix 256) and REDUCED paligemma's, hd 256
   without a prefix, prefixes under a window, at tile edges, at S and past
   it, hd 256 where the dk/dv pass's splits meet an edge (G not a multiple
   of the split count, kv tiles no q row sees, ragged Sq and Sk, batch 1),
   the causal shapes at prefix 0 and 1 equal and repeating bit for bit,
   hd 128 (B5's half kernels: qwen2-1.5b's Engine-B shape and G 1 and 4,
   causal, windowed, prefixes at a 64-key tile's edge and one past it,
   Sq != Sk, ragged S) in f32 and bf16, each repeating bit for bit,
   bf16 (the forward and both backward passes, hd 64, paligemma's shape
   and hd 256 under a window), and under ``vmap(grad_and_value)``;
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
   then costs and robustness: B3m (the masked per-class mean) against its
   plain version at every VGG-16 leaf width and a stacked smollm-135m row
   (the per-class plan's members, all, none; all-ones, all-zero, 7-of-20 and
   silent-group masks; every flag pair; f32, bf16 within two ulps of JAX's
   level chain, the int8 load); the fault storm through ``api.run`` at full
   width — smollm-135m (N=8, J2=4, batch 1, seq 1024, cuts (6, 15),
   intervals (8, 4, 1)) and VGG-16 with bitflip and scale corruption, 8
   rounds at the ``fault-storm`` preset's rates, a checkpoint every 4
   rounds, the engine crashing at round 5 and resuming — every loss and
   param finite after every step, every tier whose fed level ran holding one
   value, B1m's launches as the plan and the step counters imply, smollm's
   peak memory at most 70 GB; the ``fault-storm`` preset itself; per-class
   VGG-16 under crashes and nan corruption with the guard on, 12 rounds
   plain and over the int8 wire, B3m's launches as the plan implies; the
   ``privacy-energy`` preset in train mode (DP, and DP then B2), its
   energy-priced solve on the card against NumPy, the DP wire repeating from
   one seed, z = 0 against the CPU; ``launch.train --staleness 2`` at VGG-16
   full width, 12 rounds and the drain, and staleness 0 against the
   synchronous dispatch bit for bit; then the online control loop through
   ``api.run(mode="control")`` at full width (``control_specs``): VGG-16
   under flaky-wan with a participation deadline (16 rounds, every sync on
   B1m, four switches) and smollm-135m under flaky-wan (8 rounds, B1 and
   B4/B5, two switches) -- the decisions equal a host ``Controller``'s on
   NumPy and on ``torch`` fed the run's observations, B1m / B1 / B4 / B5
   launch as each segment's plan implies with each migration's B1, each
   migration equals its plain version on a CPU copy and keeps every tier's
   client mean, every loss and param finite, every tier whose fed level ran
   holds one value, smollm's peak at most 70 GB; each beside the same spec
   in ``mode="train"``, with the migrations' ms and the re-solves' host
   time; then Engine B, the split-placement engine, through
   ``api.run(engine="b")`` at smollm-135m's full width (``engine_b_specs``:
   plain, over the int8 wire, under flaky-wan's participation deadline, and
   the control spec), each beside its ``engine="a"`` twin from one init --
   the fed means on B1 / B2 / B1m as the plan implies, B4 and both B5
   passes once per layer a round, losses within rtol 1e-4 of the twin's,
   ``engine_b_to_full`` within atol 1e-5 / rtol 1e-4 of its params (the
   int8 wire at atol 2e-3), the control decisions equal, every migration
   against its plain version and the client means, every loss and param
   finite, peak at most 70 GB, round medians beside the twin's; then the
   ``[zoo]`` phase (``zoo_paths``): granite-moe-1b-a400m at full width and
   depth through ``api.run(engine="b")`` (N=4, J2=2, batch 1, seq 512,
   cuts (4, 12), intervals (8, 4, 1), 8 rounds, plain and over the int8
   wire) and mamba2-1.3b likewise (cuts (4, 24)) -- launches as the plan
   and depth imply (B4/B5 once per attention layer a round, none for
   mamba2), every param finite, peak at most 70 GB, one MoE layer's
   dispatch and expert products timed; granite at half depth through
   Engine B beside its Engine-A twin (4 rounds, one init; losses rtol
   5e-4, params atol 1e-5 / rtol 1e-4 but for at most 1e-6 of the
   elements, each within 1e-4: routing near-ties), with the round-1
   routings that differ between the two engines' router products counted;
   mamba2-1.3b's init gradient norm at 4, 16 and 48 blocks; REDUCED
   granite and mamba2 through the CLI and REDUCED jamba through
   ``api.run`` on the card against the CPU (losses rtol 1e-4);
   then the ``[serve]`` phase (``serve_paths``): decode attention (B4d)
   against its plain version at the serve cells' shapes, every ported
   arch's REDUCED heads and a long cache (partly filled, wrapped, all
   masked; windows 0 and 32; f32 and bf16); the full-width smollm-135m
   that the main path trained, saved client-stacked with
   ``save_checkpoint``, every row equal, restored through
   ``launch.serve.load_serving_params`` and served by
   ``launch.serve.generate`` (batch 8, prompt 64, gen 64, cache 128; B4d
   30 layers x 128 steps); qwen2-1.5b (random, full width and depth),
   granite-moe-1b-a400m and mamba2-1.3b at full width, each served at that
   shape -- every decode held to its forward on the tokens it fed
   (teacher forcing, max-normalised 1e-4; granite at capacity E/k with its
   routing flips counted; mamba2 against the float64 forward, at most
   twice as far as the f32 forward), smollm-135m under a window of 32 over
   96 steps (the ring wraps) against the windowed forward, REDUCED jamba
   on the card against the CPU, and the serve CLI (REDUCED smollm-135m);
   paligemma-3b at full width and depth served the same way, its decode
   held to the forward of its dense twin (the same weights under
   ``family="dense", prefix_len=0``: the JAX package's VLM decode is text
   only); the ``[vlm]`` phase (``vlm_paths``, run after ``[serve]``; every
   phase boundary collects what earlier phases leave in reference cycles,
   so its cell finds the card empty): B4 and both B5 passes
   timed at paligemma-3b's Engine-B shape [4, 512, 8, 1, 256], prefix 256,
   beside SDPA with a boolean mask (dq + dk/dv over SDPA's backward), and
   the dk/dv pass at every split count beside ``dkv_splits``' choice;
   paligemma-3b at full width and depth
   through Engine B (N=4, J2=2, batch 1, 256 image-prefix and 256 text
   tokens a client from ``configs.shapes.concrete_inputs`` on the card,
   cuts (1, 2), intervals (2, 2, 1), SGD 5e-4, 4 rounds): B4/B5 18 a
   round, B1 by ``engine_b_fed``, finite losses and params, peak at most
   70 GB beside the reckoning, the round's ms and the attention share;
   its 4-layer full-width Engine-A twin from one init (losses rtol 1e-4,
   params atol 1e-5 / rtol 1e-4, the tied embedding's pad rows within a
   reckoned bound: Engine B's tied logits skip the pad mask); REDUCED
   paligemma through both engines on the card against the CPU; the
   ``[audio]`` phase (``audio_paths``, last, after ``[vlm]``): B4 and both
   B5 passes against their plain versions at whisper-large-v3's Engine-B
   shapes -- the encoder's bidirectional self-attention [4, 1500, 1500, 20,
   20, 64] (a prefix of S), the decoder's causal self-attention [4, 448,
   448] and its cross-attention q [4, 448] against k, v [4, 1500] (Sq !=
   Sk, a prefix of Sk) -- in f32 and bf16, each f32 output repeating bit
   for bit, and the decode cross route (B4d with every slot at position 0)
   at [8, 1, 20, 64] against [8, 1500, 20, 64]; each timed beside its
   plain version and SDPA, the decode route beside B4 at Sq = 1;
   whisper-large-v3 at full width and depth through Engine B (N=4, J2=2,
   batch 1, 1500 frames and 448 text tokens a client, cuts (2, 32),
   intervals (2, 2, 1), SGD 5e-4, 4 rounds): B4/B5 96 a round, B1 by
   ``engine_b_fed``, peak at most 70 GB beside ``audio_reckoning``; its
   Engine-A twin at 4 + 4 units (JAX's A == B tolerance: losses rtol 1e-5,
   params atol 5e-6 / rtol 1e-4); REDUCED whisper through both engines
   and 6 decode steps on the card against the CPU; whisper-large-v3
   decoding at full width (batch 8, cache 128, 64 timed steps; B4d 32
   self + 32 cross a step); the ``[qwen2]`` phase (``qwen2_paths``, after
   ``[audio]``): B4 and both B5 passes timed at qwen2-1.5b's Engine-B shape
   [4, 1024, 12, 2, 128], causal, beside their plain versions, the 3xTF32
   bound and SDPA (``is_causal``), and the dk/dv pass at every split count
   beside ``dkv_splits``' choice; qwen2-1.5b at full width and depth
   through Engine B (N=4, J2=2, batch 1, 1024 tokens a client, cuts (1, 2),
   intervals (2, 2, 1), SGD 5e-4, 4 rounds): B4/B5 28 a round, B1 by
   ``engine_b_fed``, finite losses and params, peak at most 70 GB beside
   the reckoning, the round's ms and the attention's share of it; REDUCED
   qwen2-1.5b and qwen3-32b (qk_norm) at head_dim 128 through both engines
   on the card against the CPU (losses rtol 1e-4, params atol 1e-5); the
   ``[remat]`` phase (``remat_paths``):
   smollm-135m at full width through Engine A with every unit
   rematerialised (``spec.remat``) -- ``"full"`` against no remat at seq
   1024 from one init, bit for bit; at seq 4096, the train_4k length, 3
   rounds under each of ``"full"``, ``"outs"`` and ``"dots"`` (losses equal
   at rtol 1e-6, groups equal after each round's levels, B4 twice a layer a
   round, B5 and B1 as without remat, peak at most 70 GB beside the
   dry-run's reckoning without remat) and Engine B under ``"full"`` for 2
   rounds against Engine A's losses (rtol 1e-4); the ``[dryrun]`` phase
   (``dryrun_paths``): ``python -m repro_torch.launch.dryrun`` on train_4k
   and decode_32k over the virtual pod mesh, and ``count_train_step`` at
   ``[remat]``'s ``"full"`` cell held to ``lm_forward_flops`` x (3 + 1 for
   the replay without the head) within 1%, printed as TFLOP/s over the
   measured round, its predicted memory beside the card's peak.  Each
   phase boundary prints a ``[memory]`` line: its seconds, the device
   memory allocated after a collection, the bytes each of ``main``'s names
   holds and the largest tensors none reaches;
6. kernel, plain-version, library and bound times: B1/B2, B1m, B3 and its twin
   at the largest VGG leaf [20, 2359296], B4/B5 at the full-width attention shape (window 0,
   the path's, and window 128; the plain version at window 0; B4's and B5's
   bound is 3xTF32 on the tensor cores, with the f32 CUDA-core one beside it); the parts
   of a full-width round of each model, the per-class one included; B3m and
   its int8 load at [20, 2359296], guard_health at both models' full
   width, the DP transform, and the new paths' round times beside their
   twins without faults, DP or staleness; B4d at the serve shape [8, 128,
   9, 3, 64] and a long cache [8, 8192, 12, 2, 128] beside its plain
   version, its bytes bound and SDPA; ms a decode step, tok/s and peak
   memory of each serve cell;
7. one JSON line describing every kernel, then the card, then
   ``{"ok": true, ...}`` as the last line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
import warnings
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
# B3m replaces no TPU kernel: the jnp tiers._ragged_units_mean under a mask
# (the fault guard's or participation's), dense and over the int8 wire
MASKED_RAGGED = ("masked_ragged_tiered_aggregate", "masked_ragged_tiered_aggregate_q8")
REPLACES.update(dict.fromkeys(MASKED_RAGGED, "src/repro/core/tiers.py:456"))
# round times (ms) of each path, by label, for the new paths' comparison
ROUND_MS = {}
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
# paligemma-3b through Engine B at full width (the [vlm] phase): N = 4
# clients x batch 1, 256 image-prefix and 256 text tokens a client; every
# tier folds the clients into the batch: attention at B = 4, S = 512, H = 8,
# K = 1, hd = 256, prefix 256.  REDUCED paligemma's cell: batch 2, S = 64.
VLM_ARCH = "paligemma-3b"
VLM_N, VLM_BATCH, VLM_PREFIX, VLM_TEXT = 4, 1, 256, 256
VLM_ATTN = (VLM_N * VLM_BATCH, VLM_PREFIX + VLM_TEXT, 8, 1, 256)
VLM_REDUCED_BATCH, VLM_REDUCED_SEQ = 2, 64
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

    from repro_torch.kernels.tiered_aggregate import tiered_aggregate, tiered_aggregate_ref
    from repro_torch.kernels.tiered_aggregate.check import assert_q8_matches_oracle

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
        for J in (5, 1):
            # every flag pair: B2 against its plain version, the entry
            # (quantize, then B2) against the payload route bit for bit
            e = assert_q8_matches_oracle(N, J, P, Q8_TILE, device=dev, x=x, weights=w)
            errs["tiered_aggregate_q8"] = max(errs["tiered_aggregate_q8"], e)
            n_checks += len(flags)
    print(f"[kernels] {n_checks} checks against the plain versions passed "
          f"(f32 rtol {F32_RTOL} atol {F32_ATOL}, bf16 one ulp beyond that); max |err| "
          f"B1 f32 {errs['tiered_aggregate']:.3e} B1 bf16 {bf16_err:.3e} "
          f"B2 {errs['tiered_aggregate_q8']:.3e}")
    return errs, {"tiered_aggregate": bf16_err, "tiered_aggregate_q8": None}


def _attention_kernel(mangled: str):
    """'swa_bwd_dq_kernel<64, f32>' for an attention kernel's mangled name
    (on wgmma at hd <= 64: B4's swa_fwd_wg_kernel, B5's swa_bwd_dq_wg_kernel
    and swa_bwd_dkv_wg_kernel; B5's swa_bwd_dq_wg_half_kernel and
    swa_bwd_dkv_wg_half_kernel at hd 128, and B4's swa_fwd_wg_wide_kernel at
    hd 256; on mma.sync: B4's swa_fwd_kernel at hd 80 to 128, B5's
    swa_bwd_dq_kernel and swa_bwd_dkv_kernel at hd 80 and 96,
    swa_bwd_dq_wide_kernel and swa_bwd_dkv_wide_kernel at hd 256), else
    None (the dk/dv merge, which multiplies nothing)."""
    m = re.search(r"(swa_(?:fwd|bwd_dq|bwd_dkv)(?:_wg_wide|_wg_half|_wide|_wg)?_kernel)ILi(\d+)E"
                  r"(f|13__nv_bfloat16)", mangled)
    return m and f"{m.group(1)}<{m.group(2)}, {'f32' if m.group(3) == 'f' else 'bf16'}>"


def attention_kernel_name(name: str, hd: int) -> str:
    """The kernel that a pass (a key of ATTN) runs at head dim hd."""
    from repro_torch.kernels.swa_attention.ops import HALF_HEAD_DIM, WG_HEAD_DIM

    if hd <= WG_HEAD_DIM:
        return KERNEL_FN[name].replace("_kernel", "_wg_kernel")
    if hd == HALF_HEAD_DIM and name != "swa_attention_fwd":
        return KERNEL_FN[name].replace("_kernel", "_wg_half_kernel")
    if name == "swa_attention_fwd":
        return KERNEL_FN[name].replace("_kernel", "_wg_wide_kernel") if hd > 128 else KERNEL_FN[name]
    return KERNEL_FN[name].replace("_kernel", "_wide_kernel") if hd > 128 else KERNEL_FN[name]


def attention_build_report(source) -> dict:
    """ptxas's registers and spills and cuobjdump's count of tensor-core
    instructions for every attention kernel of the built library (3 passes
    x 6 head dims x 2 dtypes): HGMMA (wgmma) for B4's and B5's kernels at
    hd <= 64, B5's at 128 and B4's at 256, HMMA (mma.sync) for the others;
    fails if one has none, if a wgmma or an 8-warp (hd 256) kernel spills,
    or if ptxas notes C7520 for a wgmma kernel (its wgmma serialised after
    a divergent path, which cost the hd-256 forward ~50%: PERF.md §6).
    Every other note that ptxas serialised a kernel's wgmma (C7511: too few
    registers for its pipeline) is printed.  For the kernels printed, the
    occupancy calculator's blocks an SM at the launch's dynamic shared
    memory."""
    import os

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.swa_attention import ops

    report, key, serialised = {}, None, []
    for line in build.build_log(source).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if "wgmma.mma_async instructions are serialized" in line:
            note = re.search(r"\((C\d+)\)", line)
            fn = re.search(r"function '(\S+?)'", line)
            serialised.append((_attention_kernel(fn.group(1)) if fn else None,
                               note.group(1) if note else None, line.strip()))
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
                report.setdefault(key, {}).update(hmma=0, hgmma=0)
        elif key and re.search(r"\bHMMA\b", line):
            report[key]["hmma"] += 1
        elif key and re.search(r"\bHGMMA\b", line):
            report[key]["hgmma"] += 1
    # the tensor-core instruction each kernel must show: HGMMA on wgmma
    for key, r in report.items():
        r["tensor_core"] = "HGMMA" if "_wg_" in key else "HMMA"
        r["tc_count"] = r["hgmma"] if "_wg_" in key else r["hmma"]
    if len(report) != 36 or any(r["tc_count"] == 0 for r in report.values()):
        raise AssertionError(f"attention kernels without tensor-core instructions: {report}")
    # hd 64: smollm-135m's, granite's and whisper's paths (on wgmma); hd 32:
    # the REDUCED paths' forward (on wgmma); hd 128: qwen2-1.5b's (the
    # backward on wgmma, the forward on mma.sync); hd 256: paligemma-3b's
    # (the forward on wgmma, the backward's 8-warp kernels)
    passes = dict(zip(ATTN, ("fwd", "dq", "dkv")))
    for hd in (32, 64, 128, 256):
        for dt in ("f32", "bf16"):
            for name in ATTN:
                if hd == 32 and name != "swa_attention_fwd":
                    continue
                key = f"{attention_kernel_name(name, hd)}<{hd}, {dt}>"
                r = report[key]
                r["blocks_per_sm"], r["smem_bytes"] = ops.occupancy(
                    passes[name], torch.float32 if dt == "f32" else torch.bfloat16, hd)
                print(f"[build] {key}: {r['registers']} registers, spill stores/loads "
                      f"{r['spill_stores']}/{r['spill_loads']} bytes (ptxas -v), {r['tc_count']} "
                      f"{r['tensor_core']} instructions (cuobjdump -sass), "
                      f"{r['smem_bytes'] / 1024:.1f} KB dynamic shared memory, "
                      f"{r['blocks_per_sm']} blocks an SM (occupancy calculator)")
    spilled = {k: r for k, r in report.items()
               if ("_wide_" in k or "_wg_" in k) and r["spill_stores"]}
    if spilled:
        raise AssertionError(f"the wgmma (hd <= 64, B5 at 128, B4 at 256) or hd-256 backward "
                             f"kernels spill: {spilled}")
    # C7520 on a wgmma kernel (or on a kernel the note does not name) fails
    wgmma = sorted(k for k in report if "_wg_" in k)
    c7520 = [n for n in serialised if n[1] == "C7520" and (n[0] is None or "_wg_" in n[0])]
    if c7520:
        raise AssertionError(f"ptxas serialised the wgmma of {len(c7520)} kernels after a "
                             f"divergent path (C7520): {c7520}")
    print(f"[build] ptxas notes no C7520 in any of the {len(wgmma)} wgmma instantiations: "
          f"{', '.join(wgmma)}")
    for kernel, code, _ in serialised:
        print(f"[build] ptxas serialised the wgmma of {kernel} ({code}: 'Potential Performance "
              f"Loss', too few registers for the wgmma pipeline where C7511)")
        if kernel in report:
            report[kernel].setdefault("serialised", []).append(code)
    print("[build] every attention kernel (B4 and B5, hd 32-256, f32 and bf16) has tensor-core "
          "instructions (HGMMA for the wgmma kernels at hd <= 64, B5's at 128 and B4's at 256, "
          "HMMA for the others): "
          + ", ".join(f"{k} {r['tc_count']}" for k, r in report.items()))
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
    ROUND_MS["VGG-16 CLI (3, 8), (8, 4, 1)"] = ms

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
    counts = {k: plain[k] + comp_all[k] for k in AGG + RAGGED + MASKED + MASKED_RAGGED}
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


def graph_ms(fn, iters: int = 20) -> float:
    """ms a call of ``fn`` replayed from a CUDA graph of ``iters`` calls: the
    card's time alone, without the host's time to issue each call."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return cuda_ms(g.replay, 10) / iters


def in_turns(plain, kernel):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def timings(card: str):
    """B1 and B2 at the largest VGG-16 leaf [20, 2359296]: kernel, plain
    version and bytes bound."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
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
    reset_launches()
    return out


def vgg_round_parts(card: str, run) -> None:
    """Where a full-width VGG-16 round's time goes: the per-client forward
    and backward, the optimizer, and the sync of an ordinary round (entity
    levels and the top tier) and of round 8 (every tier's fed level too),
    on the main path's trained state."""
    from torch.func import grad_and_value, vmap

    from repro_torch.core import synchronize
    from repro_torch.kernels.tiered_aggregate import reset_launches

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


def check_twin(x, w, m, de, dg, J, what, errs):
    """B3's dense twin held to its plain version; it must also leave every
    non-member's value as it was."""
    import torch

    from repro_torch.kernels.tiered_aggregate import (
        ragged_tiered_aggregate, ragged_tiered_aggregate_ref,
    )

    N, P = x.shape
    U = m.shape[1]
    out = ragged_tiered_aggregate(x, w, m, de, dg, J)
    torch.cuda.synchronize()
    e = max_err(out, ragged_tiered_aggregate_ref(x, w, m, de, dg, J), torch.float32,
                f"twin {what}")
    errs["ragged_tiered_aggregate"] = max(errs["ragged_tiered_aggregate"], e)
    keep = (m == 0).repeat_interleave(P // U, dim=1)
    if not torch.equal(out[keep], x[keep]):
        raise AssertionError(f"twin {what}: a non-member's value changed")


def check_b3(x, w, m, J, tile, errs):
    """B3 through ``kernels.tiered_aggregate.check`` on every flag pair: held
    to its plain version on one wire payload, the entry against the payload
    route and, where JAX's condition holds, the all-ones collapse onto B2,
    bit for bit."""
    from repro_torch.kernels.tiered_aggregate.check import assert_ragged_q8_matches_oracle

    N, P = x.shape
    e = assert_ragged_q8_matches_oracle(N, J, P, tile, device=x.device, x=x, weights=w, member=m)
    errs["ragged_tiered_aggregate_q8"] = max(errs["ragged_tiered_aggregate_q8"], e)


def check_ragged_kernels(spec):
    """B3 and its twin against their plain versions on the same inputs: the
    edge shapes of RAGGED_CASES, then every VGG-16 leaf width at the shapes
    the per-class path gives them (N=20, J=5 and 1, fed weights 1, tile
    Q8_TILE, each class's members, all, none)."""
    import torch

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
        xb = x.bfloat16() if P < 10**5 else None
        for pattern, m in ragged_members(N, J, U, gen, dev).items():
            check_b3(x, w, m, J, tile, errs)
            n_checks += len(flags)
            for de, dg in flags:
                what = f"N={N} J={J} P={P} U={U} {pattern} do_entity={de} do_global={dg}"
                check_twin(x, w, m, de, dg, J, what, errs)
                n_checks += 1
                if xb is not None:
                    ob = ragged_tiered_aggregate(xb, w, m, de, dg, J)
                    torch.cuda.synchronize()
                    bf16_err = max(bf16_err, max_err(
                        ob, ragged_tiered_aggregate_ref(xb, w, m, de, dg, J),
                        torch.bfloat16, f"twin bf16 {what}"))
                    n_checks += 1
        del x
    N = 20
    odd = (torch.arange(N, device=dev) % 2).float()[:, None]
    path_members = {"class 0 (odd rows)": odd, "class 1 (even rows)": 1.0 - odd,
                    "all": torch.ones(N, 1, device=dev), "none": torch.zeros(N, 1, device=dev)}
    ones = torch.ones(N, device=dev)
    for P in vgg_leaf_widths(spec):
        x = torch.randn(N, P, generator=gen, device=dev) * 0.05
        for J in (5, 1):
            for pattern, m in path_members.items():
                check_b3(x, ones, m, J, Q8_TILE, errs)
                n_checks += len(flags)
                for de, dg in flags:
                    what = f"path N={N} J={J} P={P} {pattern} do_entity={de} do_global={dg}"
                    check_twin(x, ones, m, de, dg, J, what, errs)
                    n_checks += 1
        del x
    print(f"[kernels] {n_checks} checks of B3 and its twin against their plain versions "
          f"passed, every VGG-16 leaf width at the per-class path's shapes among them "
          f"(f32 rtol {F32_RTOL} atol {F32_ATOL}, bf16 one ulp beyond that; "
          f"non-members kept exactly by the twin; B3 through kernels/tiered_aggregate/"
          f"check.py, its entry and the all-ones collapse onto B2 bit for bit); max |err| "
          f"twin f32 {errs['ragged_tiered_aggregate']:.3e} twin bf16 {bf16_err:.3e} "
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
        ROUND_MS[f"per-class {name}"] = ms
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


# hd 256 where the dk/dv pass's splits (dkv_splits) meet an edge, (B, Sq, Sk,
# H, K, hd, window, prefix): G not a multiple of the split count (G 6 in 4
# splits, G 4 in 3, on an H100's 132 SMs), kv tiles that no q row sees (Sq <
# Sk, causal) and a window of 48, ragged Sq and Sk, and batch 1 (8 splits,
# the most)
WIDE_EDGE_CASES = [(4, 512, 512, 6, 1, 256, 0, 0), (2, 512, 512, 8, 2, 256, 0, 256),
                   (1, 100, 300, 4, 1, 256, 0, 0), (1, 300, 300, 4, 1, 256, 48, 0),
                   (1, 130, 300, 8, 2, 256, 0, 300), (1, 300, 130, 6, 1, 256, 0, 0),
                   (1, 512, 512, 8, 1, 256, 0, 256)]


# B5 at hd 128 (the half kernels), (B, Sq, Sk, H, K, hd, window, prefix):
# qwen2-1.5b's Engine-B shape (G 6), causal at a ragged S with G 1 and 4, a
# window, a prefix at a 64-key tile's edge and one past it, a prefix under a
# window, the encoder's prefix of S, Sq != Sk under a prefix of Sk (one
# query among them), causal with Sq > Sk, and a window with Sq > Sk: each in
# f32 and bf16 against the plain version, repeating bit for bit
HALF_CASES = [(4, 1024, 1024, 12, 2, 128, 0, 0), (2, 333, 333, 4, 4, 128, 0, 0),
              (1, 300, 300, 8, 2, 128, 100, 0), (1, 256, 256, 6, 1, 128, 0, 64),
              (1, 256, 256, 6, 1, 128, 0, 65), (1, 300, 300, 4, 1, 128, 64, 100),
              (2, 500, 500, 4, 4, 128, 0, 500), (2, 130, 301, 12, 2, 128, 0, 301),
              (2, 1, 300, 4, 4, 128, 0, 300), (2, 301, 130, 6, 1, 128, 0, 0),
              (1, 130, 97, 6, 2, 128, 48, 0)]


def attention_cases():
    """(B, Sq, Sk, H, K, hd, window, prefix) of every attention check."""
    cases = [(1, 256, 4, 2, 64, 128), (2, 384, 4, 4, 128, 256), (1, 512, 8, 2, 80, 0),
             (1, 300, 4, 1, 64, 128), (1, 256, 6, 3, 96, 128),
             (1, 640, 4, 2, 64, 512)]  # tests/test_kernels_swa.py's CASES
    cases += [MAIN_ATTN + (w,) for w in (0, 128, 256, 512)]
    cases += [(32, 64, 3, 3, 64, 0)]   # the CLI: REDUCED smollm, N=8 x batch 4, S=64
    cases += [(8, 256, 8, 2, 32, 0)]   # REDUCED qwen2.5: hd 32, GQA 4:1
    # [zoo]: Engine B folds the clients into the batch, so every tier of
    # full-width granite-moe-1b-a400m (N=4 x batch 1, S=512, GQA 2:1, hd 64)
    # and REDUCED granite / jamba (N=8 x batch 2, S=64, hd 32)
    cases += [(4, 512, 16, 8, 64, 0), (16, 64, 4, 2, 32, 0)]
    cases = [c + (0,) for c in cases]
    # [vlm]: every Engine-B tier of full-width paligemma-3b (N=4 x batch 1,
    # 256 image + 256 text tokens, hd 256, one kv head, prefix 256) and
    # REDUCED paligemma (N=4 x batch 2, 4 + 60 tokens, hd 32, prefix 4)
    cases += [VLM_ATTN + (0, VLM_PREFIX), (VLM_N * VLM_REDUCED_BATCH, VLM_REDUCED_SEQ, 4, 1, 32,
                                           0, 4)]
    # hd 256 without a prefix (ragged, windowed); a prefix under a window
    # with a ragged tail; a prefix of 1 (the causal mask itself), at a tile
    # edge, one past it, of S - 1, of S and beyond S
    cases += [(2, 256, 8, 2, 256, 0, 0), (1, 300, 4, 1, 256, 64, 0),
              (1, 300, 4, 1, 64, 64, 100), (1, 130, 4, 2, 256, 48, 70),
              (2, 256, 4, 2, 64, 0, 1), (1, 256, 4, 1, 128, 0, 32), (1, 256, 8, 1, 256, 0, 33),
              (1, 200, 4, 2, 64, 0, 199), (1, 200, 4, 2, 80, 0, 200), (1, 96, 4, 4, 32, 0, 1000)]
    return ([(B, S, S, H, K, hd, W, P) for B, S, H, K, hd, W, P in cases] + WIDE_EDGE_CASES
            + HALF_CASES)


def normalised_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-9))


def check_attention():
    """B4 and each B5 pass against its plain version, on the same inputs: on
    wgmma at hd 32 and 64 (``swa_fwd_wg_kernel``, ``swa_bwd_dq_wg_kernel``,
    ``swa_bwd_dkv_wg_kernel``), B5 at 128 (``swa_bwd_dq_wg_half_kernel``,
    ``swa_bwd_dkv_wg_half_kernel``) and B4 at 256; the others on mma.sync.
    At hd 128 every case also repeats bit for bit, in f32 and in bf16."""
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
    n_bitwise = n_half = 0
    for B, Sq, Sk, H, K, hd, W, P in attention_cases():
        q, k, v = randn(B, Sq, H, hd), randn(B, Sk, K, hd), randn(B, Sk, K, hd)
        do = randn(B, Sq, H, hd)
        o, lse = swa_attention_fwd(q, k, v, W, P)
        dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
        dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P)
        torch.cuda.synchronize()
        what = f"B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd} window={W} prefix={P}"
        ro, rlse = swa_attention_ref(q, k, v, W, P)
        torch.testing.assert_close(o, ro, rtol=ATTN_TOL, atol=ATTN_TOL, msg=f"B4 o {what}")
        torch.testing.assert_close(lse, rlse, rtol=ATTN_TOL, atol=ATTN_TOL, msg=f"B4 lse {what}")
        rdq, rdelta = swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W, P)
        rdk, rdv = swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W, P)
        for name, got, ref in (("dq", dq, rdq), ("delta", delta, rdelta), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            e = normalised_err(got, ref)
            if e > ATTN_TOL:
                raise AssertionError(f"B5 {name} {what}: max error {e:.3e} of max|ref| "
                                     f"> {ATTN_TOL}")
        if hd == 128:
            # the half kernels (and the dk/dv pass's merge): a second call
            # repeats every output bit for bit
            twice = (swa_attention_fwd(q, k, v, W, P)
                     + swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
                     + swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P))
            for name, a, b in zip(("o", "lse", "dq", "delta", "dk", "dv"),
                                  (o, lse, dq, delta, dk, dv), twice):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} {what}: two calls differ in some bit")
            n_half += 1
        if W == 0 and P <= 1:
            # a prefix of 1 adds no visible key to the causal mask: its
            # kernels' other bounds must give the prefix-free results bit
            # for bit; a second call repeats them bit for bit
            again = (swa_attention_fwd(q, k, v, W, 1 - P)
                     + swa_attention_bwd_dq(q, k, v, o, lse, do, W, 1 - P)
                     + swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, 1 - P))
            twice = (swa_attention_fwd(q, k, v, W, P)
                     + swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
                     + swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P))
            for name, a, b, c in zip(("o", "lse", "dq", "delta", "dk", "dv"),
                                     (o, lse, dq, delta, dk, dv), again, twice):
                if not (torch.equal(a, b) and torch.equal(a, c)):
                    raise AssertionError(f"{name} {what}: prefix 0 and 1 (or two calls) "
                                         "differ in some bit")
            n_bitwise += 1
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

    # bf16 inputs against the f32 plain version, the JAX test's tolerance:
    # hd 64 under a window, paligemma-3b's tiers (hd 256, prefix 256) and hd
    # 256 under a window at G 6 (in 6 dk/dv splits)
    bf16_errs = dict.fromkeys(ATTN, 0.0)
    for B, S, H, K, hd, W, P in ((1, 256, 4, 2, 64, 128, 0), VLM_ATTN + (0, VLM_PREFIX),
                                 (1, 300, 6, 1, 256, 48, 0)):
        q, k, v, do = (randn(*s, dtype=torch.bfloat16) for s in
                       ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
        o, lse = swa_attention_fwd(q, k, v, W, P)
        ro, _ = swa_attention_ref(q.float(), k.float(), v.float(), W, P)
        torch.testing.assert_close(o.float(), ro, rtol=0, atol=3e-2, msg=f"B4 bf16 hd {hd}")
        bf16_errs["swa_attention_fwd"] = max(bf16_errs["swa_attention_fwd"],
                                             float((o.float() - ro).abs().max()))
        # the bf16 backward against the f32 plain version on the same bf16
        # inputs: one bf16 ulp beyond the f32 tolerance, as B1's bf16 check
        dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
        dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P)
        torch.cuda.synchronize()
        f = [x.float() for x in (q, k, v, o, do)]
        rdq, _ = swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W, P)
        rdk, rdv = swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W, P)
        for name, pairs in (("swa_attention_bwd_dq", ((dq, rdq),)),
                            ("swa_attention_bwd_dkv", ((dk, rdk), (dv, rdv)))):
            for got, ref in pairs:
                err = (got.float() - ref).abs()
                if bool((err > ATTN_TOL * ref.abs().max() + bf16_ulp(ref)).any()):
                    raise AssertionError(f"{name} bf16 hd {hd}: beyond one bf16 ulp of the f32 "
                                         "tolerance")
                bf16_errs[name] = max(bf16_errs[name], float(err.max()))
    # hd 128 in bf16: both B5 passes against the f32 plain version on the
    # same bf16 inputs (one bf16 ulp beyond the f32 tolerance of max|ref|),
    # a second call equal bit for bit
    for B, Sq, Sk, H, K, hd, W, P in HALF_CASES:
        q, do = (randn(B, Sq, H, hd, dtype=torch.bfloat16) for _ in range(2))
        k, v = (randn(B, Sk, K, hd, dtype=torch.bfloat16) for _ in range(2))
        o, lse = swa_attention_fwd(q, k, v, W, P)
        dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
        dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P)
        again = (swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
                 + swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P))
        torch.cuda.synchronize()
        for a, b in zip((dq, delta, dk, dv), again):
            if not torch.equal(a, b):
                raise AssertionError(f"hd 128 bf16 {(B, Sq, Sk, H, K, hd, W, P)}: two calls "
                                     "differ in some bit")
        f = [x.float() for x in (q, k, v, o, do)]
        rdq, _ = swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], W, P)
        rdk, rdv = swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], W, P)
        for name, pairs in (("swa_attention_bwd_dq", ((dq, rdq),)),
                            ("swa_attention_bwd_dkv", ((dk, rdk), (dv, rdv)))):
            for got, ref in pairs:
                err = (got.float() - ref).abs()
                if bool((err > ATTN_TOL * ref.abs().max() + bf16_ulp(ref)).any()):
                    raise AssertionError(f"{name} bf16 hd 128 {(B, Sq, Sk, H, K, hd, W, P)}: "
                                         "beyond one bf16 ulp of the f32 tolerance")
                bf16_errs[name] = max(bf16_errs[name], float(err.max()))
        n_half += 1

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
          f"passed (forward rtol=atol {ATTN_TOL}; backward {ATTN_TOL} of max|ref|; hd 32-256, "
          f"windows, prefixes 0 to past S, {len(WIDE_EDGE_CASES)} hd-256 edges of the dk/dv "
          f"splits, {len(HALF_CASES)} hd-128 cases on the half kernels); {n_bitwise} causal "
          f"shapes at prefix 0 and 1 equal bit for bit and repeating bit for bit; {n_half} "
          f"hd-128 runs (f32 and bf16) repeating bit for bit; bf16 (hd 64, hd 128, and hd 256 "
          f"at prefix "
          f"{VLM_PREFIX} and under a window of 48) forward within 3e-2 of f32 (max |err| {bf16_errs['swa_attention_fwd']:.3e}), bf16 "
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
            **dict.fromkeys(MASKED, 0), **dict.fromkeys(MASKED_RAGGED, 0),
            **dict.fromkeys(ATTN, n_units * rounds)}


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
    ROUND_MS["smollm-135m"] = ms
    return got, dict(model=model, plan=plan, opt=opt, state=state, batch=batch, spec=spec)


def attention_timings(card: str):
    """B4 and both B5 passes at the full-width shape (hd 64: all three on
    wgmma): kernel, plain, bound, and SDPA as the library yardstick (never
    called by the port); B4's ms and share of its bound beside SDPA's
    forward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.swa_attention import (
        reset_launches, swa_attention_bwd_dkv, swa_attention_bwd_dkv_ref,
        swa_attention_bwd_dq, swa_attention_bwd_dq_ref, swa_attention_fwd, swa_attention_ref,
    )
    from repro_torch.launch.dryrun_lib import attention_work

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
    r = out[("swa_attention_fwd", 0)]
    print(f"[timing] B4 (swa_fwd_wg_kernel) at B={B} S={S} H={H} K={K} hd={hd} window=0: "
          f"{r['ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% of its 3xTF32 bound "
          f"{r['bound_ms']:.4f} ms, against SDPA's forward {r['library_ms']:.4f} ms; card {card}")
    return out


def vlm_attention_timings(card: str):
    """B4 and both B5 passes at paligemma-3b's Engine-B shape (hd 256,
    prefix 256): ``cell_attention_timings``, SDPA under the prefix mask as a
    boolean attn_mask."""
    return cell_attention_timings(card, "paligemma-3b", VLM_ATTN, VLM_PREFIX, seed=4)


def cell_attention_timings(card: str, label: str, shape, P: int, seed: int):
    """B4 and both B5 passes at an Engine-B cell's shape (B, S, H, K, hd),
    causal under a prefix of P (0: none): kernel and plain in turns, the
    3xTF32 bound over the mask's visible pairs, and SDPA (eager,
    ``enable_gqa``, f32; ``is_causal`` at P = 0, else the prefix mask as a
    boolean attn_mask) as the library yardstick, never called by the port;
    then the dk/dv pass at every split count (its C entry, as the wrapper
    calls it) beside ``dkv_splits``' choice and the modelled makespans."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.swa_attention import (
        dkv_launch_splits, reset_launches, swa_attention_bwd_dkv, swa_attention_bwd_dkv_ref,
        swa_attention_bwd_dq, swa_attention_bwd_dq_ref, swa_attention_fwd, swa_attention_ref,
    )
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention.ref import visible
    from repro_torch.launch.dryrun_lib import attention_work, visible_pairs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, S, H, K, hd = shape
    q = torch.randn(B, S, H, hd, generator=gen, device=dev)
    k = torch.randn(B, S, K, hd, generator=gen, device=dev)
    v = torch.randn(B, S, K, hd, generator=gen, device=dev)
    do = torch.randn(B, S, H, hd, generator=gen, device=dev)
    o, lse = swa_attention_fwd(q, k, v, 0, P)
    _, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, 0, P)
    runs = {
        "swa_attention_fwd": (lambda: swa_attention_ref(q, k, v, 0, P),
                              lambda: swa_attention_fwd(q, k, v, 0, P)),
        "swa_attention_bwd_dq": (lambda: swa_attention_bwd_dq_ref(q, k, v, o, lse, do, 0, P),
                                 lambda: swa_attention_bwd_dq(q, k, v, o, lse, do, 0, P)),
        "swa_attention_bwd_dkv": (
            lambda: swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, 0, P),
            lambda: swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P)),
    }
    pos = torch.arange(S, device=dev)
    mask = visible(pos, pos, True, 0, P) if P else None
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def lib_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=not P,
                                                  enable_gqa=True)

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=not P,
                                             enable_gqa=True)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    f_ms, fb_ms = cuda_ms(lib_fwd), cuda_ms(lib_fwd_bwd)
    work = attention_work(B, S, H, K, hd, 0, P)
    splits = dkv_launch_splits(q, k, 0, P)
    out = {}
    for name, (plain, kernel) in runs.items():
        km, pm = in_turns(plain, kernel)
        ops, nbytes = work[name]
        by_tc = 3 * ops / TF32_FLOPS_PER_S * 1e3
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        r = dict(ms=km, plain_ms=pm, bound_ms=max(by_tc, by_bytes),
                 bound_by="operations" if by_tc >= by_bytes else "bytes", ops=ops, bytes=nbytes,
                 library_ms=f_ms if name == "swa_attention_fwd" else fb_ms - f_ms,
                 visible_pairs=visible_pairs(S, 0, P),
                 kernel=attention_kernel_name(name, hd))
        if name == "swa_attention_bwd_dkv":
            r["splits"] = splits
        out[name] = r
        print(f"[timing] {name} ({r['kernel']}) at {label}'s B={B} S={S} H={H} K={K} hd={hd} "
              f"prefix={P}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: 3 x {ops / 1e9:.2f} GFLOP at 495 TFLOP/s TF32 over "
              f"{r['visible_pairs']} visible pairs a head, {nbytes / 1e6:.1f} MB at 3.35 TB/s) "
              f"= {100 * r['bound_ms'] / km:.1f}% of the bound; card {card}")
    # the dk/dv pass at every split count (the C entry, as the wrapper calls
    # it): the measure of dkv_splits' choice and of DKV_MERGE_ROWS
    lib, dims = swa_ops._library(), swa_ops._dims(q, k, 0, P)
    ws = torch.empty(H // K * 2 * k.numel(), device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sweep = {}
    for n in range(1, H // K + 1):
        def call(n=n):
            if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                         dv.data_ptr(), ws.data_ptr(), n, *dims,
                                         torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("dk/dv launch failed")
        sweep[n] = cuda_ms(call)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    its = swa_ops.dkv_tile_iterations(S, S, H // K, 0, P, hd)
    spans = {n: swa_ops.dkv_makespan(its, B * K, n, sms) for n in sweep}
    out["swa_attention_bwd_dkv"].update(split_sweep_ms=sweep, split_makespans=spans)
    print(f"[timing] swa_attention_bwd_dkv at {label}'s shape by split count: "
          + ", ".join(f"{n} {ms:.4f}" for n, ms in sweep.items())
          + f" ms; dkv_splits chose {splits}; the busiest SM's block-iterations "
          + ", ".join(f"{n} {m}" for n, m in spans.items()) + f"; card {card}")
    b5 = out["swa_attention_bwd_dq"]["ms"] + out["swa_attention_bwd_dkv"]["ms"]
    print(f"[timing] library yardstick torch.nn.functional.scaled_dot_product_attention "
          f"(enable_gqa, {'the prefix mask as a boolean attn_mask' if P else 'is_causal'}, f32, "
          f"eager) at {label}'s shape: forward {f_ms:.4f} ms, forward+backward {fb_ms:.4f} ms "
          f"(backward {fb_ms - f_ms:.4f} against B5's two passes {b5:.4f}: dq + dk/dv over "
          f"SDPA's backward = {b5 / (fb_ms - f_ms):.3f}; dk/dv in {splits} splits a kv tile"
          f"{', then the merge' if splits > 1 else ''}); card {card}")
    reset_launches()
    return out


def lm_forward_flops(spec, sequences: int, seq: int) -> float:
    """Model FLOPs of one forward pass: the matmuls (2 per multiply-add)
    and the causal attention over its visible pairs."""
    from repro_torch.launch.dryrun_lib import visible_pairs

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
    ROUND_MS[f"api {label}"] = ms
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


# --------------------------------------------------------------------------- #
# costs and robustness: B3m, the fault storm (guard, crashes, outage, engine
# crash), the DP fed wire with energy pricing, bounded-staleness async
# --------------------------------------------------------------------------- #

B3M_MASKS = ("all-ones", "all-zero", "7-of-20", "silent entity group")


def b3m_mask(kind: str, N: int, J: int, gen, dev):
    """f32 0/1 [N]: everyone; no one; 7 clients at random; the first entity
    group silent and the rest present."""
    import torch

    if kind == "all-ones":
        return torch.ones(N, device=dev)
    if kind == "all-zero":
        return torch.zeros(N, device=dev)
    if kind == "7-of-20":
        m = torch.zeros(N, device=dev)
        m[torch.randperm(N, generator=gen, device=dev)[:min(7, N - 1)]] = 1.0
        return m
    m = torch.ones(N, device=dev)
    m[:N // J] = 0.0
    return m


def b3m_receivers(mask, member, P: int, J: int, de, dg):
    """[N, P] bool: the elements a B3m launch writes a mean to; every other
    element must equal ``keep`` bit for bit (or x, with neither level)."""
    N = mask.shape[0]
    m = member.reshape(N, -1)
    cw = m * mask[:, None]
    if dg:
        got = (m > 0) & (cw.sum(0, keepdim=True) > 0)
    elif de:
        got = (m > 0) & (cw.reshape(J, N // J, -1).sum(1) > 0).repeat_interleave(N // J, 0)
    else:
        got = m < 0
    return got.repeat_interleave(P // m.shape[1], dim=1)


def jax_ragged_chain(x, mask, member, keep, de, dg, J):
    """The JAX package's ``ragged_synchronize(mask=)`` unit levels in x's
    own dtype: each level's f32 mean is rounded to x's dtype."""
    from repro_torch.kernels.tiered_aggregate.ref import _ragged_level_masked

    N, P = x.shape
    m = member.float().reshape(N, -1)
    U = m.shape[1]
    m3 = m.reshape(N, U, 1)
    cw = m3 * mask.reshape(N, 1, 1)
    y, k = x.float().reshape(N, U, -1), keep.float().reshape(N, U, -1)
    if de:
        y = _ragged_level_masked(y, k, m3, cw, J).to(x.dtype).float()
    if dg:
        y = _ragged_level_masked(y, y if de else k, m3, cw, 1).to(x.dtype).float()
    return y.reshape(N, P)


def check_masked_ragged_kernels(spec):
    """B3m against its plain version at every VGG-16 leaf width (N=20, J=5
    and J=1) and at a stacked [N, U·E] row of smollm-135m's 30 units with a
    random [N, U] member: the solved per-class plan's class members, all, none; masks
    all-ones, all-zero, 7 of 20, one silent entity group; every flag pair;
    f32, bf16 (also within BF16_MASKED_ULPS ulps of a column's largest |x|
    of JAX's level chain, which rounds between the levels) and the int8
    load.  Every element that receives no mean equals ``keep`` bit for
    bit; an all-zero mask returns ``keep``."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        launches, masked_ragged_quantized_tiered_aggregate,
        masked_ragged_quantized_tiered_aggregate_ref, masked_ragged_tiered_aggregate,
        masked_ragged_tiered_aggregate_ref, reset_launches,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    flags = [(de, dg) for de in (0, 1) for dg in (0, 1)]
    N = 20
    odd = (torch.arange(N, device=dev) % 2).float()[:, None]
    class_members = {"class 0 (odd rows)": odd, "class 1 (even rows)": 1.0 - odd,
                     "all": torch.ones(N, 1, device=dev), "none": torch.zeros(N, 1, device=dev)}
    cases = [(N, J, P, class_members) for P in vgg_leaf_widths(spec) for J in (5, 1)]
    stacked = {"random [N, U]": (torch.rand(8, 30, generator=gen, device=dev) > 0.5).float(),
               "all": torch.ones(8, 30, device=dev)}
    cases.append((8, 4, 30 * 576, stacked))
    errs = dict.fromkeys(MASKED_RAGGED, 0.0)
    bf16_err = bf16_ulps = 0.0
    calls = dict.fromkeys(MASKED_RAGGED, 0)
    reset_launches()
    for n, J, P, members in cases:
        x = torch.randn(n, P, generator=gen, device=dev)
        keep = torch.randn(n, P, generator=gen, device=dev)
        xb, kb = x.bfloat16(), keep.bfloat16()
        q, scales = q8_quantize(x, Q8_TILE)
        colmax_ulp = torch.exp2(torch.floor(torch.log2(xb.float().abs().amax(0))) - 7)
        for kind in B3M_MASKS:
            mask = b3m_mask(kind, n, J, gen, dev)
            for pattern, m in members.items():
                for de, dg in flags:
                    what = (f"B3m N={n} J={J} P={P} member {pattern} mask {kind} "
                            f"do_entity={de} do_global={dg}")
                    rows = ~b3m_receivers(mask, m, P, J, de, dg)
                    out = masked_ragged_tiered_aggregate(x, mask, m, keep, de, dg, J)
                    ob = masked_ragged_tiered_aggregate(xb, mask, m, kb, de, dg, J)
                    oq = masked_ragged_quantized_tiered_aggregate(q, scales, mask, m, keep, de,
                                                                  dg, J, Q8_TILE)
                    for k in calls:
                        calls[k] += 2 if k == MASKED_RAGGED[0] else 1
                    torch.cuda.synchronize()
                    e = max_err(out, masked_ragged_tiered_aggregate_ref(x, mask, m, keep, de,
                                                                        dg, J),
                                torch.float32, what)
                    errs[MASKED_RAGGED[0]] = max(errs[MASKED_RAGGED[0]], e)
                    bf16_err = max(bf16_err, max_err(
                        ob, masked_ragged_tiered_aggregate_ref(xb, mask, m, kb, de, dg, J),
                        torch.bfloat16, f"{what} bf16"))
                    u = float(((ob.float() - jax_ragged_chain(xb, mask, m, kb, de, dg, J)).abs()
                               / colmax_ulp).max())
                    if u > BF16_MASKED_ULPS:
                        raise AssertionError(f"{what}: {u} bf16 ulps from JAX's level chain, "
                                             f"limit {BF16_MASKED_ULPS}")
                    bf16_ulps = max(bf16_ulps, u)
                    e = max_err(oq, masked_ragged_quantized_tiered_aggregate_ref(
                        q, scales, mask, m, keep, de, dg, J, Q8_TILE), torch.float32,
                        f"{what} int8")
                    errs[MASKED_RAGGED[1]] = max(errs[MASKED_RAGGED[1]], e)
                    if de or dg:
                        for o, k, t in ((out, keep, "f32"), (ob, kb, "bf16"), (oq, keep, "int8")):
                            if not torch.equal(o[rows], k[rows]):
                                raise AssertionError(f"{what} {t}: an element that receives "
                                                     "no mean is not keep")
                        if kind == "all-zero" and not torch.equal(out, keep):
                            raise AssertionError(f"{what}: an all-zero mask is not keep")
        del x, keep, xb, kb, q, scales
    got = {k: launches[k] for k in calls}
    if got != calls:
        raise AssertionError(f"B3m launches {got}, calls {calls}")
    reset_launches()
    print(f"[kernels] {sum(calls.values())} checks of B3m against its plain version passed "
          f"({len(cases)} shapes: every VGG-16 leaf width at J=5 and J=1, a stacked "
          f"smollm-135m row; members x masks {', '.join(B3M_MASKS)} x every flag pair x "
          f"f32, bf16, int8; f32 rtol {F32_RTOL} atol {F32_ATOL}, bf16 one ulp beyond that; "
          f"elements receiving no mean keep keep bit for bit); max |err| f32 "
          f"{errs[MASKED_RAGGED[0]]:.3e} bf16 {bf16_err:.3e} int8 "
          f"{errs[MASKED_RAGGED[1]]:.3e}; bf16 within {bf16_ulps:g} ulps of JAX's level chain "
          f"(limit {BF16_MASKED_ULPS}); launches {got}")
    return errs, {MASKED_RAGGED[0]: bf16_err, MASKED_RAGGED[1]: None}


def masked_expected(plan, steps, leaves):
    """B1m launches of the guarded (or masked) dense sync over the rounds a
    step ran, given each step's input counter: one fused launch per leaf of
    every tier whose entity or fed level runs."""
    n = 0
    for s in steps:
        for m in range(plan.M):
            levels = plan.levels(m)
            interval = levels[-1][1]
            if len(levels) == 2 or interval <= 1 or (s + 1) % interval == 0:
                n += leaves[m]
    return n


def fed_ran(plan, s: int, m: int) -> bool:
    interval = plan.levels(m)[-1][1]
    return interval <= 1 or (s + 1) % interval == 0


def api_fault_run(api, spec, label: str):
    """``api.run(spec)`` in train mode on the card under a faults section.
    The engine step is wrapped to record each step's input counter, time it
    to the next one (less the checks' own time), and check after every step
    that every param is finite and that every tier whose fed level ran holds
    one value."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.core import tier_subtrees
    from repro_torch.models.vgg import VggSpec

    built = api.build(spec)
    run_mod = sys.modules["repro_torch.api.run"]
    make_step = run_mod._make_step
    seen = {"t": [], "steps": [], "check_s": []}

    def hooked(b, model, plan, opt, with_mask):
        step = make_step(b, model, plan, opt, with_mask)
        seen["plan"] = plan

        def wrapped(state, *a):
            seen["t"].append(time.perf_counter())
            seen["steps"].append(state.step)
            out, loss = step(state, *a)
            torch.cuda.synchronize()
            t_check = time.perf_counter()
            for i, x in enumerate(tree_leaves(out.params)):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{label}: leaf {i} not finite after step "
                                         f"{state.step}")
            for m, part in enumerate(tier_subtrees(out.params, plan)):
                if fed_ran(plan, state.step, m):
                    for x in tree_leaves(part):
                        if x.numel() and not bool((x == x[0:1]).all()):
                            raise AssertionError(f"{label}: tier {m} replicas differ after "
                                                 f"step {state.step}")
            seen["state"] = out
            seen["check_s"].append(time.perf_counter() - t_check)
            return out, loss

        return wrapped

    run_mod._make_step = hooked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        res = api.run(spec, built=built)
        wall = time.perf_counter() - t0
    finally:
        run_mod._make_step = make_step
    got = all_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = res.train["losses"]
    if len(losses) != spec.run.rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses {losses}")
    plan = seen["plan"]
    leaves = tier_leaves(seen["state"].params, plan)
    want = {k: 0 for k in got}
    want["masked_tiered_aggregate"] = masked_expected(plan, seen["steps"], leaves)
    if not isinstance(built.model_spec, VggSpec):  # B4 and B5 on every layer
        want.update(dict.fromkeys(ATTN, built.model_spec.n_units * len(seen["steps"])))
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the plan and steps imply {want}")
    ms = [(b - a - c) * 1e3 for a, b, c in zip(seen["t"], seen["t"][1:], seen["check_s"])]
    fr = res.train["faults"]
    print(f"[faults] {label}: cuts {res.cuts} intervals {res.intervals}, "
          f"{spec.run.rounds} rounds in {wall:.2f} s (build, checkpoints and resume "
          f"included); step counters {seen['steps']}; faulty client-rounds "
          f"{fr['n_faulty_total']} in {fr['faulty_rounds']} rounds, checkpoints "
          f"{fr['checkpoints']}, resumed at round {fr['recovered_round']}; every loss and "
          f"param finite, every tier whose fed level ran holds one value; B1m "
          f"{got['masked_tiered_aggregate']} launches as the plan and steps imply, no "
          f"B1/B2; peak device memory {peak / 1e9:.2f} GB")
    print(json.dumps({"run": f"faults {label}", "loss": losses, "round_ms": ms,
                      "peak_bytes": peak, "faults": fr}))
    ROUND_MS[f"faults {label}"] = ms
    return res, got, seen["state"], ms, peak


def guard_ms(params, N: int):
    """guard_health's time on a client-stacked tree: the health alone, with
    the sanitized copy, and its two row reductions over every leaf."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.core.tiers import GuardSpec, guard_health

    g = GuardSpec()
    rows = [x.reshape(N, -1) for x in tree_leaves(params) if x.ndim and x.shape[0] == N]
    return {
        "health": cuda_ms(lambda: guard_health(params, N, g, sanitize=False), iters=5),
        "health+sanitize": cuda_ms(lambda: guard_health(params, N, g), iters=5),
        "aminmax pass": cuda_ms(lambda: [torch.aminmax(f, dim=1) for f in rows], iters=5),
        "2-norm pass": cuda_ms(lambda: [torch.linalg.vector_norm(f, dim=1) for f in rows],
                               iters=5),
    }


def fault_storm_paths(card: str):
    """The fault storm at full width through ``api.run``: smollm-135m (the
    storm preset's arch; B4/B5 on every layer), VGG-16 with bitflip and
    scale corruption, then the ``fault-storm`` preset as the JAX package
    defines it.  Every run 8 rounds at the preset's rates with
    checkpoint_every 4 and the engine crashing at round 5 (except the
    preset, 40 rounds)."""
    import torch

    from repro_torch import api

    ckpt = ROOT / "build" / "chip_smoke" / "faults"
    faults = dict(rounds=8, checkpoint_every=4, engine_crash_round=5)
    storm = api.fault_storm_spec(**faults)
    storm = storm.replace(faults=dataclasses.replace(storm.faults, checkpoint_dir=str(ckpt)))
    lm = storm.replace(
        model=api.ModelCfg(arch="smollm-135m", variant="full", batch=LM_BATCH, seq=1024),
        solver=api.SolverCfg(kind="fixed", cuts=(6, 15), intervals=(8, 4, 1)),
        run=api.RunCfg(mode="train", rounds=8, lr=5e-4, dataset_size=64))
    assert storm.faults.outage_start == 2 and storm.faults.outage_len == 1
    counts, out = {}, {}
    res, got, state, ms, peak = api_fault_run(api, lm, "smollm-135m full width")
    if peak > 70e9:
        raise AssertionError(f"smollm-135m fault storm peaked at {peak / 1e9:.2f} GB > 70 GB")
    counts["smollm-135m-fault-storm"] = got
    # the guard's cost at full width: the step's health check (no sanitized
    # copy) and the sync's (health + the sanitized tree), both each round
    gm = guard_ms(state.params, 8)
    med = sorted(ms)[len(ms) // 2]
    share = (gm["health"] + gm["health+sanitize"]) / med
    print(f"[timing] guard_health at smollm-135m full width (8 x 134.5 M f32), ms: "
          f"{json.dumps(gm)}; the two calls of a round are {100 * share:.1f}% of the "
          f"{med:.1f} ms median storm round; card {card}")
    out["smollm"] = dict(round_ms=ms, peak=peak, guard_ms=gm, share=share)
    del state
    vgg = storm.replace(
        model=api.ModelCfg(arch="vgg16-cifar10", variant="full", batch=16),
        system=api.SystemCfg(preset="paper-three-tier", num_clients=20, num_edges=5),
        solver=api.SolverCfg(kind="fixed", cuts=(3, 8), intervals=(8, 4, 1)),
        run=api.RunCfg(mode="train", rounds=8, lr=5e-4, dataset_size=4096))
    for mode in ("bitflip", "scale"):
        spec = vgg.replace(faults=dataclasses.replace(vgg.faults, corrupt_mode=mode))
        _, got, state, ms, _ = api_fault_run(api, spec, f"VGG-16 full width, {mode}")
        counts[f"vgg16-cifar10-fault-storm-{mode}"] = got
        out[f"vgg-{mode}"] = dict(round_ms=ms)
    gm = guard_ms(state.params, 20)
    print(f"[timing] guard_health at VGG-16 full width (20 x 15.0 M f32), ms: "
          f"{json.dumps(gm)}; card {card}")
    out["vgg-guard_ms"] = gm
    del state
    preset = api.fault_storm_spec()
    _, got, _, ms, _ = api_fault_run(api, preset, "fault-storm preset (REDUCED smollm-135m, "
                                                  "4 layers, N=8, 40 rounds)")
    counts["fault-storm-preset"] = got
    out["preset"] = dict(round_ms=ms)
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    return counts, out


def round_time_comparison(card: str) -> None:
    """Median round times of the new paths beside their unguarded twins."""
    def med(label):
        v = sorted(ROUND_MS.get(label, [])[1:] or ROUND_MS.get(label, [float("nan")]))
        return v[len(v) // 2]

    pairs = [("faults smollm-135m full width", "smollm-135m"),
             ("faults VGG-16 full width, bitflip", "VGG-16 CLI (3, 8), (8, 4, 1)"),
             ("faults VGG-16 full width, scale", "VGG-16 CLI (3, 8), (8, 4, 1)"),
             ("per-class storm plain", "per-class plain"),
             ("per-class storm int8", "per-class int8"),
             ("api privacy-energy train", "api paper-sec7 train"),
             ("api privacy-energy int8 train", "api compressed-int8 train"),
             ("async staleness 2", "VGG-16 CLI (3, 8), (8, 4, 1)")]
    print("[timing] median round ms (rounds 2 on), new path vs its twin without faults, "
          "DP or staleness: " + json.dumps({a: [med(a), b, med(b)] for a, b in pairs})
          + f"; card {card}")


def class_fault_storm(solved, rounds: int = 12):
    """Per-class VGG-16 at full width under the storm's crash and ``nan``
    corruption rates, the guard on: the solved class cuts and intervals,
    12 rounds plain and 12 over the int8 fed wire, the unit levels on B3m
    only; after rounds 6 and 12 the holders of every (unit, tier) agree."""
    import numpy as np
    import torch

    from repro_torch.compress import Int8Stochastic
    from repro_torch.core import TrainState, class_tier_members, default_plan, init_state_a
    from repro_torch.core.tiers import GuardSpec
    from repro_torch.faults import FaultSpec, apply_corruption, expand_faults
    from repro_torch.launch import train

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5",
            "--batch", "16", "--rounds", str(rounds)]
    class_cuts, intervals = solved["class_cuts"], solved["intervals"]
    fs = FaultSpec(seed=0, crash_rate=0.08, corrupt_rate=0.08, corrupt_mode="nan")
    counts = dict.fromkeys(MASKED_RAGGED, 0)
    by_run, ms_by = {}, {}
    for name, compressor in (("plain", None), ("int8", Int8Stochastic(tile=Q8_TILE))):
        args = train.parse_args(argv)
        device, spec, model, _, opt, loader = train.setup(args)
        N = args.clients
        plan = default_plan(spec.n_units, N, cuts=class_cuts[0], intervals=intervals,
                            entities=(N, args.edges, 1))
        members = class_tier_members(spec.n_units, class_cuts, solved["class_of"])
        state = init_state_a(model, plan, opt, torch.Generator().manual_seed(args.seed),
                             device)
        dispatch = train.make_dispatch(model, plan, opt, compressor=compressor,
                                       class_members=members, guard=GuardSpec())
        torch.cuda.synchronize()
        reset_all_launches()
        losses, ms, n_faulty = [], [], 0
        for r in range(rounds):
            t = time.perf_counter()
            rf = expand_faults(fs, r, N)
            n_faulty += rf.n_faulty
            if rf.corrupt.any():
                state = TrainState(apply_corruption(state.params, rf.corrupt, fs),
                                   state.opt_state, state.step)
            mask = torch.as_tensor(~rf.crashed, dtype=torch.float32, device=device)
            batch = train.to_device(loader.next_round(), device)
            state, loss = dispatch(state, batch, r, mask)
            losses.append(float(loss))  # waits for the round
            ms.append((time.perf_counter() - t) * 1e3)
            if (r + 1) % 6 == 0:
                assert_member_sets_agree(state.params, members.host,
                                         f"per-class storm {name}, round {r + 1}")
        got = all_launches()
        twin, b3 = ragged_expected(members.host, plan, rounds, compressor is not None)
        want = {k: 0 for k in got}
        want.update({MASKED_RAGGED[0]: twin, MASKED_RAGGED[1]: b3})
        if got != want:
            raise AssertionError(f"per-class storm {name}: launches {got}, the plan "
                                 f"implies {want}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"per-class storm {name}: losses {losses}")
        if not all(bool(torch.isfinite(x).all()) for u in state.params["units"]
                   for x in u.values()):
            raise AssertionError(f"per-class storm {name}: a param is not finite")
        for k in MASKED_RAGGED:
            counts[k] += got[k]
        by_run[f"vgg16-cifar10-per-class-fault-storm-{name}"] = got
        ms_by[name] = ms
        print(f"[faults] per-class VGG-16 {name}: class cuts {class_cuts}, intervals "
              f"{intervals}, N=20, J2=5, batch 16, {rounds} rounds, crash 0.08 and nan "
              f"corruption 0.08 ({n_faulty} faulty client-rounds), guard on: B3m "
              f"{got[MASKED_RAGGED[0]]} + int8 load {got[MASKED_RAGGED[1]]} launches as "
              f"the plan implies, nothing else; finite losses and params; the holders of "
              f"every (unit, tier) agree after rounds 6 and 12")
        print(json.dumps({"run": f"per-class fault storm {name}", "loss": losses,
                          "round_ms": ms}))
        ROUND_MS[f"per-class storm {name}"] = ms
        del state
    assert np.isfinite(sum(counts.values()))
    return counts, by_run, ms_by


def privacy_paths(card: str, rounds: int = 8):
    """``privacy_energy_spec`` through ``api.run`` at VGG-16 full width, 8
    rounds (DP z = 8, C = 1e-4 on the fed wire; energy pricing), and the same
    over the int8 wire (DP, then B2); the energy-priced solve on the card
    against NumPy; DP on the card reproducible from one seed; z = 0 on the
    card against the CPU on REDUCED VGG."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.vgg16_cifar10 import REDUCED
    from repro_torch.core import (
        build_train_step_a, default_plan, init_state_a, synchronize, tier_subtrees,
    )
    from repro_torch.core.tiers import FedWire, TierPlan
    from repro_torch.models import VggModel
    from repro_torch.optim import sgd
    from repro_torch.privacy import DPMechanism

    train_run = api.RunCfg(mode="train", rounds=rounds, lr=5e-4)
    budgets = dict(epsilon_budget=3e4, budget_j_per_round=25.0)
    card_solve = api.run(api.privacy_energy_spec(**budgets).replace(
        solver=api.SolverCfg(backend="jax")))
    host_solve = api.run(api.privacy_energy_spec(**budgets).replace(
        solver=api.SolverCfg(backend="numpy")))
    if (card_solve.cuts, card_solve.intervals, card_solve.theta, card_solve.energy,
            card_solve.privacy) != (host_solve.cuts, host_solve.intervals, host_solve.theta,
                                    host_solve.energy, host_solve.privacy):
        raise AssertionError(f"energy-priced solve on the card {card_solve} differs from "
                             f"NumPy's {host_solve}")
    print(f"[privacy] run(privacy_energy_spec(epsilon_budget=3e4, budget_j_per_round=25)) "
          f"solve: cuts {card_solve.cuts} intervals {card_solve.intervals} theta "
          f"{card_solve.theta!r}, round energy {card_solve.energy['round_energy_j']!r} J, "
          f"max rounds {card_solve.privacy['max_rounds']}: the card's tables equal NumPy's")
    specs = {"privacy-energy train": api.privacy_energy_spec().replace(run=train_run),
             "privacy-energy int8 train": api.privacy_energy_spec().replace(
                 run=train_run, compression=api.CompressionCfg(codec="int8"))}
    counts, ms_by = {}, {}
    for label, spec in specs.items():
        res, got, state = api_train(api, spec, label)
        built = api.build(spec)
        plan = TierPlan(n_units=built.model_spec.n_units, num_clients=built.system.num_clients,
                        cuts=res.cuts, intervals=res.intervals, entities=built.system.entities)
        leaves = [2 * (hi - lo) for lo, hi in map(plan.tier_bounds, range(plan.M))]
        b1, b2 = expected_launches(plan, rounds, True, leaves)
        want = {k: 0 for k in got}
        if spec.compression is None:
            want["tiered_aggregate"] = b1 + b2  # the DP'd fed mean on B1
        else:
            want["tiered_aggregate"], want["tiered_aggregate_q8"] = b1, b2
        if got != want:
            raise AssertionError(f"{label}: launches {got}, the plan implies {want}")
        for m, part in enumerate(tier_subtrees(state.params, plan)):
            if fed_ran(plan, rounds - 1, m):
                for x in tree_leaves(part):
                    if x.numel() and not bool((x == x[0:1]).all()):
                        raise AssertionError(f"{label}: tier {m} replicas differ after "
                                             f"round {rounds}")
        if res.train["privacy"]["epsilon_spent"] is None:
            raise AssertionError(f"{label}: no epsilon in {res.train['privacy']}")
        print(f"[privacy] {label}: z {res.train['privacy']['noise_multiplier']} C "
              f"{res.train['privacy']['clip']}, epsilon after {rounds} rounds "
              f"{res.train['privacy']['epsilon_spent']:.6g}; round energy "
              f"{res.energy['round_energy_j']!r} J; launches B1 {got['tiered_aggregate']} "
              f"B2 {got['tiered_aggregate_q8']} as the plan implies; every tier synced in "
              f"round {rounds} holds one value")
        counts[label] = got
        # DP on the card: one seed, one (round, leaf), the same draw bit for bit
        mech = built.dp_mechanism
        twice = [synchronize(state.params, plan, 7, compressor=FedWire(mech, 7,
                                                                        built.compressor))
                 for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*map(tree_leaves, twice))):
            raise AssertionError(f"{label}: the DP sync does not repeat from one seed")
        other = synchronize(state.params, plan, 7, compressor=FedWire(
            DPMechanism(mech.clip, mech.noise_multiplier, seed=mech.seed + 1), 7,
            built.compressor))
        if all(torch.equal(a, b) for a, b in zip(tree_leaves(twice[0]), tree_leaves(other))):
            raise AssertionError(f"{label}: another seed drew the same noise")
        del state, twice, other
    print("[privacy] the DP fed wire on the card repeats bit for bit from one seed and "
          "draws other noise from another")
    # z = 0 (clip only): the card against the CPU on REDUCED VGG
    N, b = 4, 2
    rng = np.random.default_rng(9)
    hw = REDUCED.image_size
    batches = [{"images": rng.normal(size=(N, b, hw, hw, 3)).astype(np.float32),
                "labels": rng.integers(0, 10, (N, b)).astype(np.int32)} for _ in range(3)]
    plan = default_plan(REDUCED.n_units, N, cuts=(1, 3), intervals=(1, 1, 1),
                        entities=(N, 2, 1))
    model, opt = VggModel(REDUCED), sgd(0.01)
    losses = {}
    for dev in ("cuda", "cpu"):
        device = torch.device(dev)
        state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), device)
        step = build_train_step_a(model, plan, opt,
                                  privacy=DPMechanism(clip=1.0, noise_multiplier=0.0))
        losses[dev] = []
        for batch in batches:
            state, loss = step(state, {k: torch.from_numpy(v).to(device)
                                       for k, v in batch.items()})
            losses[dev].append(float(loss))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    print(f"[card vs cpu] REDUCED VGG with the DP wire at z = 0 (clip 1.0), N=4, 3 rounds: "
          f"losses cuda {losses['cuda']} cpu {losses['cpu']} (rtol 1e-4)")
    return counts


def async_expected(plan, rounds: int, s, leaves):
    """B1 launches of the async dispatch: the in-step levels with the async
    tiers' fed levels off, then one launch per leaf of tier m for each
    deferred fed level applied (due rounds, then the drain)."""
    b1, pending = 0, []
    for r in range(rounds):
        for m in range(plan.M):
            levels = plan.levels(m)
            fed = fed_ran(plan, r, m) and not s[m]
            if len(levels) == 2 or fed:
                b1 += leaves[m]
        pending += [(r + s[m], m) for m in range(plan.M - 1)
                    if s[m] and (r + 1) % plan.intervals[m] == 0]
        b1 += sum(leaves[m] for due, m in pending if due <= r)
        pending = [p for p in pending if p[0] > r]
    return b1 + sum(leaves[m] for _, m in pending)


def async_paths(rounds: int = 12):
    """``launch.train --staleness 2`` at VGG-16 full width, 12 rounds and
    the drain; then staleness 0 against the synchronous dispatch, bit for
    bit on the card (4 rounds, cuDNN's deterministic algorithms)."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.core import init_state_a
    from repro_torch.core.async_agg import make_async_trainer, normalize_staleness
    from repro_torch.launch import train

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5", "--batch", "16",
            "--rounds", str(rounds), "--log-every", "1"]
    torch.cuda.synchronize()
    reset_all_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv + ["--staleness", "2"])
    wall = time.perf_counter() - t0
    got = all_launches()
    text = buf.getvalue()
    print(text, end="")
    assert rc == 0 and "[async staleness=2]" in text, rc
    _, _, _, plan, _, _ = train.setup(train.parse_args(argv + ["--device", "cpu"]))
    s = normalize_staleness(2, plan)
    leaves = [2 * (hi - lo) for lo, hi in map(plan.tier_bounds, range(plan.M))]
    want = {k: 0 for k in got}
    want["tiered_aggregate"] = async_expected(plan, rounds, s, leaves)
    if got != want:
        raise AssertionError(f"--staleness 2 launches {got}, the schedule implies {want}")
    losses = [float(v) for v in re.findall(r"loss (\S+)", text)]
    ms = [float(v) for v in re.findall(r"\((\S+) ms/round", text)]
    assert len(losses) == rounds and all(math.isfinite(v) for v in losses), losses
    print(f"[async] launch.train --staleness 2 at VGG-16 full width (N=20, J2=5, batch 16, "
          f"cuts {plan.cuts}, intervals {plan.intervals}, staleness {s}): {rounds} rounds "
          f"and the drain in {wall:.2f} s; B1 {got['tiered_aggregate']} launches as the "
          f"deferred schedule implies; finite losses")
    print(json.dumps({"run": "async staleness 2", "loss": losses, "round_ms": ms}))
    ROUND_MS["async staleness 2"] = ms
    # staleness 0 is the synchronous dispatch, bit for bit
    args = train.parse_args(argv)
    device, _, model, plan, opt, loader = train.setup(args)
    batches = [train.to_device(loader.next_round(), device) for _ in range(4)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name in ("async staleness 0", "synchronous dispatch"):
            state = init_state_a(model, plan, opt, torch.Generator().manual_seed(0), device)
            if name == "synchronous dispatch":
                step = train.make_dispatch(model, plan, opt)
            else:
                trainer = make_async_trainer(model, plan, opt, staleness=0)
                step = trainer.run_round
            losses = []
            for r, batch in enumerate(batches):
                state, loss = step(state, batch, r)
                losses.append(float(loss))
            runs[name] = (losses, state)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (la, sa), (lb, sb) = runs.values()
    if la != lb or not all(torch.equal(a, b) for a, b in zip(tree_leaves(sa.params),
                                                             tree_leaves(sb.params))):
        raise AssertionError("staleness 0 differs from the synchronous dispatch on the card")
    print(f"[async] staleness 0 equals the synchronous dispatch bit for bit on the card "
          f"(VGG-16 full width, 4 rounds, losses {la})")
    return got, ms


def control_specs(api):
    """The two control configurations (PERF.md §4).  The decisions are host
    NumPy and do not depend on the training: VGG-16 switches at rounds 3,
    6, 9 and 12 (three of them move the cuts), smollm-135m at rounds 2 (to
    cuts (1, 2)) and 5 (``tests/test_torch_control.py`` pins VGG-16's
    decisions to the JAX package's)."""
    vgg = api.paper_spec(eps_scale=20.0).replace(
        name="control-vgg16",
        scenario=api.ScenarioCfg(name="flaky-wan", rounds=16, seed=0, quantile=0.5),
        participation=api.ParticipationCfg(target_rate=0.9),
        solver=api.SolverCfg(kind="fixed", cuts=(3, 8), intervals=(2, 2, 1)),
        run=api.RunCfg(mode="control", rounds=16, lr=5e-4),
        control=api.ControlCfg(window=4, min_window=4, cooldown=2, rel_tol=0.1))
    lm = api.paper_spec().replace(
        name="control-smollm-135m",
        model=api.ModelCfg(arch="smollm-135m", variant="full", batch=LM_BATCH, seq=1024),
        system=api.SystemCfg(preset="paper-three-tier", num_clients=8, num_edges=4),
        scenario=api.ScenarioCfg(name="flaky-wan", rounds=16, seed=0, quantile=0.5),
        solver=api.SolverCfg(kind="fixed", cuts=(6, 15), intervals=(8, 4, 1)),
        run=api.RunCfg(mode="control", rounds=8, lr=5e-4, dataset_size=64),
        control=api.ControlCfg(window=4, min_window=3, cooldown=2, rel_tol=0.25))
    return vgg, lm


def decision_key(d):
    """A control decision less its wall clock."""
    return (d.round_index, d.trigger, d.old_cuts, d.old_intervals, d.new_cuts,
            d.new_intervals, d.switched, dataclasses.asdict(d.drift))


def tier_parts(params, plan):
    """Each tier's leaves: Engine B's tier stacks as they are, Engine A's
    client-stacked tree sliced by the plan."""
    from repro_torch.core import tier_subtrees

    return params if isinstance(params, list) else tier_subtrees(params, plan)


def full_view(params, plan):
    """The client-stacked tree: Engine B's tiers repeated over their
    clients (``engine_b_to_full``), Engine A's params as they are."""
    from repro_torch.core.engine import engine_b_to_full

    return engine_b_to_full(None, plan, params) if isinstance(params, list) else params


def one_row(params):
    """One client row of the whole model (for counting each tier's leaves
    under any plan)."""
    from repro_torch._tree import tree_map
    from repro_torch.core import combine_tiers

    if not isinstance(params, list):
        return tree_map(lambda x: x[:1], params)
    return combine_tiers([tree_map(lambda x: x[:1], p) for p in params],
                         {"units": params[0]["units"]})


def engine_b_fed(plan, s: int, leaves) -> int:
    """Engine B's fed-mean launches in the step with input counter ``s``:
    one per leaf of each tier with several entities whose I_m is due."""
    return sum(leaves[m] for m in range(plan.M)
               if plan.entities[m] > 1 and (s + 1) % plan.intervals[m] == 0)


def control_run(api, spec, label: str, tag: str = "control", keep_state: bool = False):
    """``api.run(spec)`` in control mode on the card, on the spec's engine.
    The engine step, the state migration and the controller are wrapped:
    each step's input counter and plan are kept, every param is checked
    finite after every step and every tier whose fed level ran to hold one
    value; each migration is timed alone, its B1 launches counted, its
    result held to the plain version on a CPU copy and each new tier's
    client mean to the pre-switch one (f32 tolerance); every observation is
    kept, and a host ``Controller`` on ``backend="numpy"`` and one on
    ``"torch"`` fed them must decide as the run did.  (The re-solve prices
    the lattice from the window's NumPy tables on either backend;
    ``"torch"`` resolves the card and builds nothing else there.)
    ``keep_state`` returns the last state too."""
    import torch

    from repro_torch import control as ctl_mod
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.core import TrainState, tier_subtrees
    from repro_torch.models.vgg import VggSpec

    built = api.build(spec)
    N = built.system.num_clients
    run_mod = sys.modules["repro_torch.api.run"]
    make_step, migrate, controller = run_mod._make_step, ctl_mod.migrate_state, ctl_mod.Controller
    seen = {"t": [], "steps": [], "plans": [], "check_s": [], "obs": [], "migrations": []}

    def hooked(b, model, plan, opt, with_mask):
        step = make_step(b, model, plan, opt, with_mask)

        def wrapped(state, *a):
            seen["t"].append(time.perf_counter())
            seen["steps"].append(state.step)
            seen["plans"].append(plan)
            out, loss = step(state, *a)
            torch.cuda.synchronize()
            t_check = time.perf_counter()
            for i, x in enumerate(tree_leaves(out.params)):
                if not bool(torch.isfinite(x).all()):
                    raise AssertionError(f"{label}: leaf {i} not finite after step "
                                         f"{state.step}")
            for m, part in enumerate(tier_parts(out.params, plan)):
                if fed_ran(plan, state.step, m):
                    for x in tree_leaves(part):
                        if x.numel() and not bool((x == x[0:1]).all()):
                            raise AssertionError(f"{label}: tier {m} replicas differ after "
                                                 f"step {state.step}")
            seen["state"] = out
            seen["check_s"].append(time.perf_counter() - t_check)
            return out, loss

        return wrapped

    def migrating(state, new_plan, opt, **kw):
        torch.cuda.synchronize()
        before = all_launches()
        t0 = time.perf_counter()
        out = migrate(state, new_plan, opt, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = all_launches()
        t_check = time.perf_counter()
        on_cpu = lambda t: tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, t)  # noqa: E731
        old = TrainState(on_cpu(state.params), on_cpu(state.opt_state), state.step)
        plain = migrate(old, new_plan, opt, **kw)
        got = on_cpu(out.params)
        err = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(plain.params)):
            torch.testing.assert_close(a, b, rtol=F32_RTOL, atol=F32_ATOL)
            if a.numel():
                err = max(err, float((a - b).abs().max()))
        old_plan = kw.get("old_plan")
        for m, (new, pre) in enumerate(zip(
                tier_subtrees(full_view(got, new_plan), new_plan),
                tier_subtrees(full_view(old.params, old_plan), new_plan))):
            for a, b in zip(tree_leaves(new), tree_leaves(pre)):
                if a.numel():
                    torch.testing.assert_close(a.mean(0), b.mean(0), rtol=F32_RTOL,
                                               atol=F32_ATOL)
        del old, plain, got
        seen["migrations"].append(dict(
            plan=new_plan, ms=ms, max_abs_err=err,
            launches={k: after[k] - before[k] for k in after if after[k] != before[k]}))
        seen["check_s"][-1] += time.perf_counter() - t_check
        return out

    class Recording(controller):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["controller"] = self

        def observe(self, obs):
            seen["obs"].append(obs)
            super().observe(obs)

    run_mod._make_step, ctl_mod.migrate_state, ctl_mod.Controller = (
        hooked, migrating, Recording)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    try:
        t0 = time.perf_counter()
        res = api.run(spec, built=built)
        wall = time.perf_counter() - t0
    finally:
        run_mod._make_step, ctl_mod.migrate_state, ctl_mod.Controller = (
            make_step, migrate, controller)
    got = all_launches()
    peak = torch.cuda.max_memory_allocated()
    c = res.control
    losses = c["losses"]
    if len(losses) != spec.run.rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses {losses}")
    ran = seen["controller"]
    if ran.n_switches < 1 or not any(d.new_cuts != d.old_cuts for d in ran.decisions):
        raise AssertionError(f"{label}: no switch of the cuts: {c['switch_log']}")
    cc = spec.control
    host = {}
    for backend in ("numpy", "torch"):
        h = controller(built.problem, c["initial_cuts"], c["initial_intervals"],
                       window=cc.window, check_every=cc.check_every, rel_tol=cc.rel_tol,
                       cooldown=cc.cooldown, min_window=cc.min_window, quantile=cc.quantile,
                       warm_start=cc.warm_start, backend=backend,
                       max_switches=cc.max_switches, fault_tol=cc.fault_tol)
        for r, obs in enumerate(seen["obs"]):
            h.observe(obs)
            h.maybe_replan(r)
        if [decision_key(d) for d in h.decisions] != [decision_key(d) for d in ran.decisions]:
            raise AssertionError(f"{label}: a host Controller on {backend} decides "
                                 f"{[d.describe() for d in h.decisions]}, the run "
                                 f"{[d.describe() for d in ran.decisions]}")
        host[backend] = h.resolve_quantiles((0.5, 0.95))

    # launches: each step's sync as its segment's plan implies (B1m under
    # masks, else B1; Engine B's fed means only), B4/B5 on every layer of a
    # transformer, and each migration's entity means, one B1 launch per
    # leaf of a tier with J < N
    params = one_row(seen["state"].params)
    masked = built.participation is not None
    want = {k: 0 for k in got}
    sync = MASKED[0] if masked else AGG[0]
    for s, plan in zip(seen["steps"], seen["plans"]):
        if spec.run.engine == "b":
            want[sync] += engine_b_fed(plan, s, tier_leaves(params, plan))
        else:
            want[sync] += masked_expected(plan, [s], tier_leaves(params, plan))
    if not isinstance(built.model_spec, VggSpec):
        want.update(dict.fromkeys(ATTN, built.model_spec.n_units * len(seen["steps"])))
    for mig in seen["migrations"]:
        plan = mig["plan"]
        n = sum(k for m, k in enumerate(tier_leaves(params, plan)) if plan.entities[m] < N)
        if mig["launches"] != {AGG[0]: n}:
            raise AssertionError(f"{label}: a migration launched {mig['launches']}, its plan "
                                 f"implies B1 {n}")
        want[AGG[0]] += n
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the segments' plans imply {want}")
    ms = [(b - a - k) * 1e3 for a, b, k in zip(seen["t"], seen["t"][1:], seen["check_s"])]
    switch_rounds = [s["round"] for s in c["switches"]]
    mig_ms = [m["ms"] for m in seen["migrations"]]
    print(f"[{tag}] {label}: {spec.run.rounds} rounds in {wall:.2f} s; switches "
          + "; ".join(c["switch_log"])
          + f"; segments {[(s['rounds'], s['cuts'], s['intervals']) for s in c['segments']]}; "
          f"piecewise bound {c['piecewise_bound']!r} (static {c['static_bound']!r}); the "
          f"decisions equal a host Controller's on numpy and on torch "
          f"fed the same {len(seen['obs'])} observations; launches {got} as the segments' "
          f"plans imply (migrations: {[m['launches'] for m in seen['migrations']]}); every "
          f"migration equals the plain version on a CPU copy (max |err| "
          f"{max(m['max_abs_err'] for m in seen['migrations']):.3g}) and keeps each tier's "
          f"client mean; every loss and param finite, every tier whose fed level ran holds "
          f"one value; peak device memory {peak / 1e9:.2f} GB")
    print(f"[{tag}] {label}: migration ms {[round(v, 3) for v in mig_ms]}; re-solve host "
          f"time (not device time) p50/p95 s: the run {c['resolve_p50_s']:.6f} / "
          f"{c['resolve_p95_s']:.6f}, host numpy {host['numpy'][0]:.6f} / "
          f"{host['numpy'][1]:.6f}, host torch backend {host['torch'][0]:.6f} / "
          f"{host['torch'][1]:.6f}")
    print(json.dumps({"run": f"{tag} {label}", "loss": losses, "round_ms": ms,
                      "switch_rounds": switch_rounds, "migration_ms": mig_ms,
                      "peak_bytes": peak, "resolve_host_s": {
                          "run": [c["resolve_p50_s"], c["resolve_p95_s"]], **host}}))
    ROUND_MS[f"{tag} {label}"] = ms
    out = dict(round_ms=ms, migration_ms=mig_ms, switch_rounds=switch_rounds, peak=peak,
               resolve=host, losses=losses, decisions=[decision_key(d) for d in ran.decisions],
               migration_err=[m["max_abs_err"] for m in seen["migrations"]],
               plan=seen["plans"][-1])
    if keep_state:
        out["state"] = seen["state"]
    # the hooks above (the local class among them) are a reference cycle
    # that holds ``seen``: without this, the last state (smollm-135m's 8
    # replicas and their optimizer state, 5.5 GB) outlives the phase until
    # a collection
    seen.clear()
    return got, out


def control_paths(card: str):
    """``api.run(mode="control")`` at full width: VGG-16 under flaky-wan
    with the participation deadline (every sync on B1m, each switch's
    migration on B1), then smollm-135m under flaky-wan without one (B1 and
    B4/B5); each beside the same spec in ``mode="train"``."""
    from repro_torch import api

    vgg, lm = control_specs(api)
    counts, out = {}, {}
    for label, spec, key in (("VGG-16 full width", vgg, "control-vgg16"),
                             ("smollm-135m full width", lm, "control-smollm-135m")):
        got, out[key] = control_run(api, spec, label)
        if key == "control-smollm-135m" and out[key]["peak"] > 70e9:
            raise AssertionError(f"smollm-135m under control peaked at "
                                 f"{out[key]['peak'] / 1e9:.2f} GB > 70 GB")
        counts[key] = got
        twin = spec.replace(run=dataclasses.replace(spec.run, mode="train"))
        api_train(api, twin, f"control twin {label}")
    med = lambda v: sorted(v[1:])[len(v[1:]) // 2]  # noqa: E731
    print("[timing] median round ms (rounds 2 on) under control vs the same spec in "
          "mode=train: " + json.dumps({
              label: [med(ROUND_MS[f"control {label}"]),
                      med(ROUND_MS[f"api control twin {label}"])]
              for label in ("VGG-16 full width", "smollm-135m full width")})
          + f"; card {card}")
    return counts, out


# Engine B against its Engine-A twin at full width: losses at rtol 1e-4,
# the client-stacked params at atol 1e-5 / rtol 1e-4 (TF32 off); over the
# int8 wire an f32 difference can flip one quantized value by one step (a
# tile's absmax / 127), so those params are held at JAX's own int8 A == B
# allowance, atol 2e-3, with the count beyond the f32 tolerance printed
ENGINE_B_LOSS_RTOL, ENGINE_B_ATOL, ENGINE_B_RTOL, ENGINE_B_Q8_ATOL = 1e-4, 1e-5, 1e-4, 2e-3
# a MoE twin: a token whose k-th and (k+1)-th gates nearly tie may take
# another expert in each engine (their router products have other shapes,
# so they round apart: 2 of 196 608 routings at granite's round 1); its
# experts' and embedding row's updates then differ by up to lr x one
# token's gradient.  Those elements (at most 1e-6 of all: 2 973 of granite's
# half-depth 2.97 G, where 2 flips put 347 beyond the f32 tolerance, up to
# 3.13e-5) are held at 1e-4; the losses at 5e-4: one flipped token moves a
# round's mean loss by up to its own loss change / the round's tokens
# (8.37e-5 relative at granite's half-depth round 4, from 2 flips at round 1)
ENGINE_B_FLIP_ATOL, ENGINE_B_FLIP_SHARE, ENGINE_B_FLIP_LOSS_RTOL = 1e-4, 1e-6, 5e-4


def engine_b_specs(api):
    """PR 12's smollm-135m cell (PERF.md §4) through ``api.run(engine="b")``:
    plain (the fed means on B1), over the int8 wire (B2), under flaky-wan
    with the 0.75 participation deadline (B1m, weighted by the entities'
    participant counts), and the ``[control]`` phase's smollm-135m spec in
    ``mode="control"`` (``migrate_state_b`` at each switch, on B1)."""
    _, lm = control_specs(api)
    train = lm.replace(name="engine-b-smollm-135m", scenario=None, control=None,
                       run=api.RunCfg(mode="train", rounds=8, lr=5e-4, dataset_size=64,
                                      engine="b"))
    return {
        "engine-b-smollm-135m": train,
        "engine-b-smollm-135m-int8": train.replace(
            name="engine-b-smollm-135m-int8", compression=api.CompressionCfg(codec="int8")),
        "engine-b-smollm-135m-masked": train.replace(
            name="engine-b-smollm-135m-masked",
            scenario=api.ScenarioCfg(name="flaky-wan", rounds=16, seed=0, quantile=0.5),
            participation=api.ParticipationCfg(target_rate=0.75)),
        "engine-b-control-smollm-135m": lm.replace(
            name="engine-b-control-smollm-135m",
            run=dataclasses.replace(lm.run, engine="b")),
    }


def engine_b_pair(api, key: str, spec, card: str, route_flips: bool = False):
    """One Engine-B run at full width beside its Engine-A twin from the same
    init (the API's seed): the twin first, its last params moved to the host
    and its state freed; then Engine B, its peak device memory alone.  Train
    mode: B's launches as the plan implies (the fed means, B4/B5 on every
    layer); control mode: ``control_run``'s checks, and B's decisions equal
    A's.  Losses and the client-stacked params (``engine_b_to_full``)
    against A's; every loss and param finite; peak at most 70 GB.
    ``route_flips`` (a MoE arch): a near-tie routed differently by the two
    engines' router products moves the loss and the params its token
    reaches: the losses are held at ``ENGINE_B_FLIP_LOSS_RTOL``, and at
    most ``ENGINE_B_FLIP_SHARE`` of the elements may pass the f32
    tolerance, each within ``ENGINE_B_FLIP_ATOL``."""
    import numpy as np
    import torch

    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.core.engine import engine_b_to_full
    from repro_torch.core.tiers import TierPlan

    host = lambda t: tree_map(lambda x: x.cpu(), t)  # noqa: E731
    twin = spec.replace(run=dataclasses.replace(spec.run, engine="a"))
    control = spec.run.mode == "control"
    if control:
        _, a = control_run(api, twin, f"{key} twin A", tag="engine-b", keep_state=True)
        a_losses, a_params = a["losses"], host(a.pop("state").params)
    else:
        res, _, state = api_train(api, twin, f"{key} twin A")
        a_losses, a_params = res.train["losses"], host(state.params)
        del state
    torch.cuda.empty_cache()
    if control:
        got, b = control_run(api, spec, key, tag="engine-b", keep_state=True)
        if b["decisions"] != a["decisions"]:
            raise AssertionError(f"{key}: Engine B decided {b['decisions']}, A "
                                 f"{a['decisions']}")
        losses, state, plan, peak = b["losses"], b.pop("state"), b["plan"], b["peak"]
    else:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, got, state = api_train(api, spec, key)
        peak = torch.cuda.max_memory_allocated()
        built = api.build(spec)
        plan = TierPlan(n_units=built.model_spec.n_units, num_clients=built.system.num_clients,
                        cuts=res.cuts, intervals=res.intervals, entities=built.system.entities)
        leaves = tier_leaves(one_row(state.params), plan)
        sync = AGG[1] if spec.compression is not None else (
            MASKED[0] if spec.participation is not None else AGG[0])
        want = {k: 0 for k in got}
        want[sync] = sum(engine_b_fed(plan, s, leaves) for s in range(spec.run.rounds))
        want.update(dict.fromkeys(ATTN, built.model_spec.n_units * spec.run.rounds))
        if got != want:
            raise AssertionError(f"{key}: launches {got}, the plan and depth imply {want}")
        losses = res.train["losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{key}: losses {losses}")
    loss_err = float(np.max(np.abs(np.subtract(losses, a_losses)) / np.abs(a_losses)))
    loss_rtol = ENGINE_B_FLIP_LOSS_RTOL if route_flips else ENGINE_B_LOSS_RTOL
    np.testing.assert_allclose(losses, a_losses, rtol=loss_rtol)
    q8 = spec.compression is not None
    full = engine_b_to_full(None, plan, state.params)
    err, beyond, total = 0.0, 0, 0
    for i, (x, y) in enumerate(zip(tree_leaves(full), tree_leaves(a_params))):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{key}: leaf {i} not finite")
        y = y.to(x.device)
        d = (x - y).abs()
        beyond += int((d > ENGINE_B_ATOL + ENGINE_B_RTOL * y.abs()).sum())
        total += x.numel()
        if x.numel():
            err = max(err, float(d.max()))
        atol = ENGINE_B_Q8_ATOL if q8 else ENGINE_B_FLIP_ATOL if route_flips else ENGINE_B_ATOL
        torch.testing.assert_close(x, y, rtol=ENGINE_B_RTOL, atol=atol)
    if route_flips and beyond > ENGINE_B_FLIP_SHARE * total:
        raise AssertionError(f"{key}: {beyond} of {total} elements beyond the f32 tolerance, "
                             f"more than {ENGINE_B_FLIP_SHARE} of them")
    del full, state, a_params
    torch.cuda.empty_cache()
    if peak > 70e9:
        raise AssertionError(f"{key}: Engine B peaked at {peak / 1e9:.2f} GB > 70 GB")
    prefix = "engine-b" if control else "api"
    med = lambda v: sorted(v[1:])[len(v[1:]) // 2]  # noqa: E731
    ms_b, ms_a = med(ROUND_MS[f"{prefix} {key}"]), med(ROUND_MS[f"{prefix} {key} twin A"])
    print(f"[engine-b] {key}: cuts {plan.cuts} intervals {plan.intervals}; launches {got} as "
          f"the plan and depth imply; losses within {loss_err:.3g} relative of Engine A's "
          f"(rtol {loss_rtol}); params max |B - A| {err:.3g}, {beyond} of {total} "
          f"beyond atol {ENGINE_B_ATOL} + rtol {ENGINE_B_RTOL}"
          + (f" (held at atol {ENGINE_B_Q8_ATOL}: the int8 wire)" if q8 else "")
          + (f" (held at atol {ENGINE_B_FLIP_ATOL} on at most {ENGINE_B_FLIP_SHARE} of the "
             f"elements: routing near-ties)" if route_flips else "")
          + f"; every loss and param finite; median round ms B {ms_b:.2f}, A {ms_a:.2f}; "
          f"peak device memory B {peak / 1e9:.2f} GB; card {card}")
    return got, dict(round_ms_b=ms_b, round_ms_a=ms_a, peak=peak, loss_err=loss_err,
                     param_err=err, beyond=beyond)


def engine_b_paths(card: str):
    """The ``[engine-b]`` phase: the four ``engine_b_specs`` runs, each
    beside its Engine-A twin; B1, B2, B1m and B4/B5 must each be launched."""
    from repro_torch import api

    counts, out = {}, {}
    for key, spec in engine_b_specs(api).items():
        counts[key], out[key] = engine_b_pair(api, key, spec, card)
    for key, names in (("engine-b-smollm-135m", (AGG[0],) + ATTN),
                       ("engine-b-smollm-135m-int8", (AGG[1],)),
                       ("engine-b-smollm-135m-masked", (MASKED[0],)),
                       ("engine-b-control-smollm-135m", (AGG[0],) + ATTN)):
        for name in names:
            if counts[key][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {key}")
    print("[timing] Engine B at full width, median round ms (rounds 2 on) B vs its A twin "
          "and B's peak GB: " + json.dumps({
              k: [v["round_ms_b"], v["round_ms_a"], v["peak"] / 1e9] for k, v in out.items()})
          + f"; card {card}")
    return counts, out


def robustness_timings(card: str):
    """B3m at the largest VGG leaf [20, 2359296] as the per-class storm
    calls it (both levels fused, J=5, every client a member, 7 of 20
    present), its int8 load on the fed level (J=1, tile 256), and the
    per-class plan's alternating members; the DP transform at that leaf."""
    import torch

    from repro_torch.compress.quantize import q8_quantize
    from repro_torch.kernels.tiered_aggregate import (
        masked_ragged_quantized_tiered_aggregate, masked_ragged_quantized_tiered_aggregate_ref,
        masked_ragged_tiered_aggregate, masked_ragged_tiered_aggregate_ref, reset_launches,
    )
    from repro_torch.privacy import DPMechanism

    dev = torch.device("cuda", 0)
    N, P = 20, 9 * 512 * 512
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(N, P, generator=gen, device=dev)
    mask = b3m_mask("7-of-20", N, 5, gen, dev)
    everyone = torch.ones(N, 1, device=dev)
    alternating = (torch.arange(N, device=dev) % 2).float()[:, None]
    q, scales = q8_quantize(x, Q8_TILE)
    out = {}
    k, p = in_turns(lambda: masked_ragged_tiered_aggregate_ref(x, mask, everyone, x, 1, 1, 5),
                    lambda: masked_ragged_tiered_aggregate(x, mask, everyone, x, 1, 1, 5))
    # bytes: x read once, the output written once (keep is read only by the
    # rows that receive no mean: none here); operations: cw·x multiply-add
    out[MASKED_RAGGED[0]] = dict(ms=k, plain_ms=p, bytes=2 * N * P * 4 + 8 * N,
                                 ops=2 * N * P, what="every client a member, 7 of 20 present")
    k, p = in_turns(
        lambda: masked_ragged_quantized_tiered_aggregate_ref(q, scales, mask, everyone, x, 0,
                                                             1, 1, Q8_TILE),
        lambda: masked_ragged_quantized_tiered_aggregate(q, scales, mask, everyone, x, 0, 1,
                                                         1, Q8_TILE))
    out[MASKED_RAGGED[1]] = dict(
        ms=k, plain_ms=p, bytes=N * P + 4 * N * P // Q8_TILE + 4 * N * P + 8 * N,
        ops=3 * N * P, what="every client a member, 7 of 20 present, fed level")
    k, p = in_turns(
        lambda: masked_ragged_tiered_aggregate_ref(x, mask, alternating, x, 1, 1, 5),
        lambda: masked_ragged_tiered_aggregate(x, mask, alternating, x, 1, 1, 5))
    # the non-members' 10 rows read keep once more
    alt = dict(ms=k, plain_ms=p, bytes=2 * N * P * 4 + 10 * P * 4 + 8 * N, ops=2 * N * P,
               what="alternating members (the per-class plan's classes), 7 of 20 present")
    for name, r in list(out.items()) + [("masked_ragged_tiered_aggregate (alternating)", alt)]:
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["ops"] / F32_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        print(f"[timing] {name} at [{N}, {P}] ({r['what']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB at 3.35 TB/s, H100 SXM data sheet) = "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; library call: none; "
              f"card {card}")
    mech = DPMechanism(clip=1e-4, noise_multiplier=8.0)
    dp_ms = cuda_ms(lambda: mech.transform(x, 3, salt=1))
    clip_ms = cuda_ms(lambda: DPMechanism(clip=1e-4, noise_multiplier=0.0).transform(x, 3))
    print(f"[timing] DP transform at [{N}, {P}] f32: clip and noise {dp_ms:.4f} ms, clip "
          f"only {clip_ms:.4f} ms; card {card}")
    reset_launches()
    del x, q, scales
    return out, {"dp_transform_ms": dp_ms, "dp_clip_only_ms": clip_ms}


# --------------------------------------------------------------------------- #
# [sharded]: Engine A's client axis over torch.distributed ranks
# --------------------------------------------------------------------------- #

SHARD_CASES = ("plain", "int8", "mask", "guard+mask")
# sharded against the unsharded card run, at the port's Engine-A tolerance
# on the card (int8: one quantization step on params).  The reference's
# sharded rtol 2e-5 on losses holds on the CPU tests' REDUCED cell; at
# VGG-16's full width the f32 summation order of the spanning levels alone
# (params within 1.5e-6) moved the plain run's losses by 2.95e-5 relative
# over 8 rounds with cuDNN deterministic (NVIDIA H100 80GB HBM3, 700 W)
SHARD_LOSS_RTOL, SHARD_ATOL, SHARD_RTOL, SHARD_Q8_ATOL = 1e-4, 1e-5, 1e-4, 2e-3
SHARD_NAN_ROUND, SHARD_NAN_CLIENT = 3, 7


def sharded_expected(plan, D: int, rounds: int, compressed: bool, masked: bool,
                     leaves) -> dict:
    """(B1, B2, B1m, B1m int8) launches one rank makes, as
    ``core.sharded`` lowers each level: device-local levels launch what the
    unsharded sync launches with groups / D; a one-group level that spans
    launches B1 (B2 over the int8 wire) for its partial sums, with or
    without a mask; a spanning level of G > 1 groups is a matmul."""
    n = dict.fromkeys(("b1", "b2", "b1m", "b1m_q8"), 0)
    for r in range(rounds):
        for m in range(plan.M):
            levels = plan.levels(m)
            g = levels[0][0] if len(levels) == 2 else 0
            interval = levels[-1][1]
            fed = interval <= 1 or (r + 1) % interval == 0
            wire = compressed and m < plan.M - 1 and plan.entities[m] > 1
            L = leaves[m]
            local, local_q8 = ("b1m", "b1m_q8") if masked else ("b1", "b2")
            if g % D == 0 and (not fed or D == 1):
                if wire and fed:
                    n[local] += L * bool(g)
                    n[local_q8] += L
                elif g or fed:
                    n[local] += L
                continue
            if g and g % D == 0:
                n[local] += L
            elif g == 1:
                n["b1"] += L
            if fed:
                n["b2" if wire else "b1"] += L
    return n


def shard_masks(N: int, rounds: int, J: int):
    """Round masks: client i sits out round r when i ≡ r (mod 3), and in
    round 2 the first entity group is silent as a whole."""
    import numpy as np

    masks = np.stack([(np.arange(N) % 3 != r % 3) for r in range(rounds)]).astype(np.float32)
    masks[2, :N // J] = 0.0
    return masks


def shard_cell(argv, device):
    """(model, plan, opt, loader) of the VGG-16 main path's cell on ``device``."""
    from repro_torch.launch import train

    args = train.parse_args(argv + ["--device", str(device)])
    _, _, model, plan, opt, loader = train.setup(args)
    return model, plan, opt, loader, args


def shard_case_kwargs(case: str):
    from repro_torch.compress import Int8Stochastic
    from repro_torch.core.tiers import GuardSpec

    return {"plain": {}, "int8": {"compressor": Int8Stochastic(tile=Q8_TILE)},
            "mask": {"with_mask": True},
            "guard+mask": {"with_mask": True, "guard": GuardSpec()}}[case]


def shard_run(case: str, argv, rounds: int, mesh=None):
    """One case of the cell over ``rounds`` rounds, unsharded or on this
    rank's shard of ``mesh``: (losses, params, round ms, collective ms a
    round).  The guard case puts a NaN into client 7's first weight before
    round 3."""
    import numpy as np
    import torch

    from repro_torch.core import build_train_step_a, init_state_a
    from repro_torch.core import sharded as sh
    from repro_torch.core.sharded import (
        build_sharded_train_step_a, init_sharded_state_a, local_rows,
    )
    from repro_torch.launch.mesh import mesh_device

    device = mesh_device(mesh) if mesh is not None else torch.device("cuda", 0)
    model, plan, opt, loader, args = shard_cell(argv, device)
    kw = shard_case_kwargs(case)
    gen = torch.Generator().manual_seed(args.seed)
    N, base = plan.num_clients, 0
    if mesh is None:
        state = init_state_a(model, plan, opt, gen, device)
        build = lambda f: build_train_step_a(model, plan, opt, fed_round=f, **kw)
    else:
        state = init_sharded_state_a(model, plan, opt, gen, mesh)
        build = lambda f: build_sharded_train_step_a(model, plan, opt, mesh, fed_round=f,
                                                     **kw)
        base = sh._client_base(mesh, ("data",), N // sh.num_client_shards(mesh, "data"))
    masks = shard_masks(N, rounds, plan.entities[1])
    # the collectives, timed on the host clock around a device sync
    coll = {"ms": 0.0}
    saved = sh._all_reduce, sh._all_gather

    def timed(fn):
        def call(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            coll["ms"] += (time.perf_counter() - t) * 1e3
            return out
        return call

    if mesh is not None:
        sh._all_reduce, sh._all_gather = timed(saved[0]), timed(saved[1])
    steps, losses, ms = {}, [], []
    try:
        for r in range(rounds):
            batch = loader.next_round()
            if mesh is not None:
                batch = local_rows(batch, mesh, ("data",), N)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for k, v in batch.items()}
            if case == "guard+mask" and r == SHARD_NAN_ROUND:
                row = SHARD_NAN_CLIENT - base
                w = state.params["units"][0]["w"]
                if 0 <= row < w.shape[0]:
                    w[row].view(-1)[0] = float("nan")
            f = tuple((r + 1) % I == 0 if I > 1 else True for I in plan.intervals)
            if f not in steps:
                steps[f] = build(f)
            extra = (torch.from_numpy(masks[r]).to(device),) if kw.get("with_mask") else ()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = steps[f](state, batch, *extra)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t) * 1e3)
    finally:
        sh._all_reduce, sh._all_gather = saved
    return losses, state.params, ms, coll["ms"] / rounds, plan


def shard_rank(root: str, argv, rounds: int):
    """One rank of the 2-rank gloo rehearsal on the shared card: every case
    on this rank's 10 clients, its rows held against the unsharded card
    run's row 0 (every tier syncs in round 8, so the reference's rows are
    equal); returns every rank's report to rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch._tree import tree_leaves
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(data=dist.get_world_size(), model=1, device="cuda",
                           backend="gloo")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # as the reference run: cuDNN's default convolution backward does not
    # repeat itself bit for bit, which would hide the sharding's own error
    torch.backends.cudnn.deterministic = True
    report = {"rank": dist.get_rank(), "cases": {}}
    for case in SHARD_CASES:
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        losses, params, ms, coll_ms, plan = shard_run(case, argv, rounds, mesh)
        counts = dict(all_launches())
        ref = torch.load(Path(root) / f"ref-{case}.pt")
        worst = viol = 0.0
        atol = SHARD_Q8_ATOL if case == "int8" else SHARD_ATOL
        for x, r0 in zip(tree_leaves(params), ref["row0"]):
            err = (x.float() - r0.to(x.device)[None]).abs()
            worst = max(worst, float(err.max()))
            viol = max(viol, float((err - atol - SHARD_RTOL * r0.to(x.device).abs()).max()))
        report["cases"][case] = {
            "losses": losses, "round_ms": ms, "collective_ms": coll_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: counts[k] for k in AGG + MASKED},
            "max_param_err": worst, "violation": viol,
            "finite": all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)),
        }
        del params
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, report)
    return out


def sharded_one_rank(argv, rounds: int):
    """(a): one NCCL rank at full width — the CLI with ``--shard-data 1`` and
    ``api.run`` with ``ShardingCfg(data=1)``, plain and over the int8 wire,
    each equal to its unsharded run bit for bit, launching B1 (and B2) as
    the main path does."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.api.spec import ShardingCfg
    from repro_torch.launch import train

    out_dir = ROOT / "build" / "chip_smoke"
    texts, counts = {}, {}
    # cuDNN's default convolution backward may sum in a varying order, so
    # the unsharded CLI does not repeat itself bit for bit: said here, then
    # every run of (a) takes cuDNN's deterministic algorithms
    again = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert train.main(argv) == 0
        again.append([ln.split("(")[0] for ln in buf.getvalue().splitlines()
                      if ln.startswith("round")])
    print(f"[sharded] (a) the unsharded CLI run twice with cuDNN's default algorithms: "
          f"losses {'repeat' if again[0] == again[1] else 'differ: ' + str(again)}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _sharded_one_rank(argv, rounds, out_dir, texts, counts)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _sharded_one_rank(argv, rounds: int, out_dir, texts, counts):
    import numpy as np

    from repro_torch import api
    from repro_torch.api.spec import ShardingCfg
    from repro_torch.launch import train

    for label, extra in (("unsharded", []), ("shard-data 1", ["--shard-data", "1"])):
        reset_all_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv + extra + ["--checkpoint", str(out_dir / f"{label}.npz")])
        assert rc == 0, (label, rc)
        counts[label] = dict(all_launches())
        texts[label] = [ln.split("(")[0] for ln in buf.getvalue().splitlines()
                        if ln.startswith("round")]
    assert "[sharded over ('data',) (1 ranks, nccl)]" in buf.getvalue(), buf.getvalue()
    if texts["shard-data 1"] != texts["unsharded"] or len(texts["unsharded"]) != rounds:
        raise AssertionError(f"[sharded] --shard-data 1 losses {texts}")
    with np.load(out_dir / "unsharded.npz") as a, np.load(out_dir / "shard-data 1.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"[sharded] --shard-data 1 checkpoint {k} differs")
    for label in texts:
        (out_dir / f"{label}.npz").unlink()
    b1 = counts["shard-data 1"]["tiered_aggregate"]
    assert (b1, counts["shard-data 1"]["tiered_aggregate_q8"]) == (214, 0), counts
    assert counts["shard-data 1"] == counts["unsharded"], counts
    print(f"[sharded] (a) one NCCL rank, CLI --shard-data 1 (cuDNN deterministic): "
          f"{rounds} losses and the checkpoint equal the unsharded CLI's bit for bit; B1 "
          f"{b1} launches, B2 0")
    train_run = api.RunCfg(mode="train", rounds=rounds, lr=5e-4)
    fixed = api.SolverCfg(kind="fixed", cuts=(3, 8), intervals=(8, 4, 1))
    api_counts = {}
    for label, spec, want in (
            ("plain", api.paper_spec(mode="train"), (214, 0)),
            ("int8", api.compressed_spec("int8"), (208, 26))):
        spec = spec.replace(solver=fixed, run=train_run)
        ref = api.run(spec).train
        reset_all_launches()
        got = api.run(spec.replace(run=dataclasses.replace(
            train_run, sharding=ShardingCfg(data=1)))).train
        n = all_launches()
        api_counts[label] = dict(n)
        if got["losses"] != ref["losses"]:
            raise AssertionError(f"[sharded] api {label}: {got['losses']} != {ref['losses']}")
        assert (n["tiered_aggregate"], n["tiered_aggregate_q8"]) == want, (label, n)
        assert got["sharding"] == {"data": 1, "model": 1, "pods": 0, "client_shards": 1}
        print(f"[sharded] (a) one NCCL rank, api.run {label} with ShardingCfg(data=1) "
              f"(cuDNN deterministic): "
              f"{rounds} losses equal the unsharded run's bit for bit; B1 "
              f"{n['tiered_aggregate']} B2 {n['tiered_aggregate_q8']} launches "
              f"(the main path's {want})")
    return counts["shard-data 1"], api_counts


def sharded_paths(card: str, rounds: int = 8):
    """The ``[sharded]`` phase: (a) one NCCL rank, bit for bit; (b) a
    rehearsal of two ranks on the one card over gloo, the collectives
    staged through the host — not a multi-GPU measurement."""
    import shutil

    import numpy as np
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.launch.mesh import run_on_ranks

    argv = ["--arch", "vgg16-cifar10", "--clients", "20", "--edges", "5",
            "--batch", "16", "--rounds", str(rounds), "--log-every", "1"]
    t0 = time.perf_counter()
    cli_counts, api_counts = sharded_one_rank(argv, rounds)
    t_a = time.perf_counter() - t0

    # (b): the unsharded card run of each case is the reference, with
    # cuDNN's deterministic algorithms as the ranks take them
    root = ROOT / "build" / "chip_smoke" / "sharded"
    root.mkdir(parents=True, exist_ok=True)
    refs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for case in SHARD_CASES:
        losses, params, ms, _, plan = shard_run(case, argv, rounds)
        leaves = tree_leaves(params)
        for x in leaves:  # every tier synced in round 8: one value per leaf
            if not bool((x == x[0:1]).all()):
                raise AssertionError(f"[sharded] unsharded {case}: replicas differ")
        torch.save({"row0": [x[0].cpu() for x in leaves]}, root / f"ref-{case}.pt")
        refs[case] = {"losses": losses, "round_ms": ms}
        del params, leaves
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    D = 2
    leaves = [2 * (hi - lo) for lo, hi in map(plan.tier_bounds, range(plan.M))]
    t1 = time.perf_counter()
    reports = run_on_ranks(shard_rank, D, device="cuda", backend="gloo",
                           store_dir=str(root), args=(str(root), argv, rounds))
    t_b = time.perf_counter() - t1
    shutil.rmtree(root, ignore_errors=True)
    per_rank = {}
    for rep in reports:
        for case, got in rep["cases"].items():
            want = sharded_expected(plan, D, rounds, case == "int8", "mask" in case, leaves)
            n = got["launches"]
            have = {"b1": n[AGG[0]], "b2": n[AGG[1]], "b1m": n[MASKED[0]],
                    "b1m_q8": n[MASKED[1]]}
            if have != want:
                raise AssertionError(f"[sharded] rank {rep['rank']} {case}: launches "
                                     f"{have}, the plan implies {want}")
            ref = refs[case]["losses"]
            lerrs = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref)]
            lerr = max(lerrs)
            if not (got["finite"] and lerr <= SHARD_LOSS_RTOL and got["violation"] <= 0.0):
                raise AssertionError(
                    f"[sharded] rank {rep['rank']} {case}: losses rel err {lerr:.3g} "
                    f"(limit {SHARD_LOSS_RTOL}), params max err {got['max_param_err']:.3g} "
                    f"(tolerance exceeded by {got['violation']:.3g}), finite "
                    f"{got['finite']}")
            med = float(np.median(got["round_ms"][1:]))
            ref_med = float(np.median(refs[case]["round_ms"][1:]))
            print(f"[sharded] (b) rehearsal, 2 gloo ranks sharing the card (collectives "
                  f"through the host; not a multi-GPU measurement), rank {rep['rank']} "
                  f"{case}: losses rel err {lerr:.3g} (by round "
                  f"{', '.join(f'{e:.2g}' for e in lerrs)}), params max abs err "
                  f"{got['max_param_err']:.3g}; launches B1 {have['b1']} B2 {have['b2']} "
                  f"B1m {have['b1m']} B1m-int8 {have['b1m_q8']} (predicted {want}); median "
                  f"round {med:.2f} ms (unsharded card run {ref_med:.2f} ms), collectives "
                  f"{got['collective_ms']:.2f} ms a round, peak {got['peak_gb']:.2f} GB; "
                  f"card {card}")
            per_rank.setdefault(case, {})[rep["rank"]] = have
    print(f"[sharded] phase: (a) {t_a:.1f} s, (b) {t_b:.1f} s for {len(SHARD_CASES)} cases "
          f"x {rounds} rounds on {D} ranks (spawn included)")
    counts = {"sharded-cli-1-rank": cli_counts}
    for label, n in api_counts.items():
        counts[f"sharded-api-1-rank-{label}"] = n
    for case, ranks in per_rank.items():
        counts[f"sharded-2-ranks-gloo-{case}"] = {
            **dict.fromkeys(all_launches(), 0),
            AGG[0]: sum(v["b1"] for v in ranks.values()),
            AGG[1]: sum(v["b2"] for v in ranks.values()),
            MASKED[0]: sum(v["b1m"] for v in ranks.values()),
            MASKED[1]: sum(v["b1m_q8"] for v in ranks.values())}
    return counts


# --------------------------------------------------------------------------- #
# [zoo]: the MoE, SSM and hybrid families
# --------------------------------------------------------------------------- #

ZOO_MOE, ZOO_SSM, ZOO_HYBRID = "granite-moe-1b-a400m", "mamba2-1.3b", "jamba-1.5-large-398b"
ZOO_SEQ = 512
# SGD learning rates that do not diverge in 8 rounds: granite at 5e-4;
# mamba2 at 1e-6 (48 blocks at 1e-5 went 11.22 -> 48.64 in 8 rounds on the
# card): its init's gradient grows with depth, in JAX and the port alike
# (tests/test_torch_ssm.py, d 32: |grad| ~5.7 at 4 blocks, ~2.7e4 at 48,
# where neither package's f32 gradient stays near the float64 one), and
# ``zoo_depth_gradients`` reads that growth at full width
ZOO_LR = {ZOO_MOE: 5e-4, ZOO_SSM: 1e-6}
# the full-width cells through Engine B: arch, num_layers (None: the
# config's), cuts, rounds, codecs
ZOO_CELLS = {
    "zoo-granite-moe-1b-a400m": (ZOO_MOE, None, (4, 12), 8, (None, "int8")),
    "zoo-mamba2-1.3b": (ZOO_SSM, None, (4, 24), 8, (None,)),
}
# Engine B against its Engine-A twin: granite at half depth, cuts (2, 6)
ZOO_TWIN = ("zoo-granite-half-depth", ZOO_MOE, 12, (2, 6), 4)
ZOO_PEAK_LIMIT = 70e9
ZOO_CARD_RTOL = 1e-4


def zoo_spec(api, name, arch, num_layers, cuts, rounds, codec=None):
    """A full-width zoo cell through ``api.run(engine="b")``: N=4 clients,
    J2=2 edges, batch 1, seq 512, intervals (8, 4, 1), SGD at the arch's
    ``ZOO_LR``."""
    spec = api.paper_spec().replace(
        name=name,
        model=api.ModelCfg(arch=arch, variant="full", batch=1, seq=ZOO_SEQ,
                           num_layers=num_layers),
        system=api.SystemCfg(preset="paper-three-tier", num_clients=4, num_edges=2),
        solver=api.SolverCfg(kind="fixed", cuts=cuts, intervals=(8, 4, 1)),
        run=api.RunCfg(mode="train", rounds=rounds, lr=ZOO_LR[arch], dataset_size=64,
                       engine="b"))
    if codec is not None:
        spec = spec.replace(name=f"{name}-{codec}", compression=api.CompressionCfg(codec=codec))
    return spec


def zoo_attention_layers(model_spec) -> int:
    """Attention layers a forward runs: one a unit (one a hybrid super-block),
    none in the SSM family."""
    return 0 if model_spec.family == "ssm" else model_spec.n_units


def zoo_moe_timing(spec, params, x, groups: int):
    """CUDA-event ms of one MoE layer's forward+backward on ``x`` at
    ``groups`` dispatch groups, and of its expert products alone on
    buffers of the dispatch's shape [G, E, cap, d]; the difference is the
    dispatch (router, top-k, ranks, the scatter into the buffers, the
    combine)."""
    import torch

    from repro_torch.models import layers as L

    E, K = spec.moe.num_experts, spec.moe.top_k
    G = groups
    cap = int(max(1, math.ceil(x.shape[0] * x.shape[1] // G * K / E * spec.moe.capacity_factor)))
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    xx = x.detach().clone().requires_grad_(True)
    ein = torch.randn((G, E, cap, spec.d_model), device=x.device, requires_grad=True)

    def whole():
        out, aux = L.moe(p, xx, spec, groups=G)
        (out.square().sum() + aux).backward()

    def experts():
        h = torch.einsum("gecd,edf->gecf", ein, p["w1"])
        g = torch.einsum("gecd,edf->gecf", ein, p["w3"])
        out = torch.einsum("gecf,efd->gecd", torch.nn.functional.silu(h) * g, p["w2"])
        out.square().sum().backward()

    return cuda_ms(whole, iters=10), cuda_ms(experts, iters=10)


def zoo_cell(api, key, arch, num_layers, cuts, rounds, codec, card):
    """One full-width cell through ``api.run(engine="b")``: launches as the
    plan and depth imply (the fed means on B1, or B2 over the int8 wire, by
    ``engine_b_fed``; B4 and both B5 passes once per attention layer a
    round), every loss and param finite, the parameters Engine B holds,
    peak device memory at most 70 GB, the round-time median; for the MoE
    arch, one layer's MoE forward+backward at the top tier's shape timed
    with CUDA events, its dispatch apart from its expert products."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.core.tiers import TierPlan

    spec = zoo_spec(api, key, arch, num_layers, cuts, rounds, codec)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, got, state = api_train(api, spec, spec.name)
    peak = torch.cuda.max_memory_allocated()
    built = api.build(spec)
    ms = built.model_spec
    plan = TierPlan(n_units=ms.n_units, num_clients=built.system.num_clients, cuts=res.cuts,
                    intervals=res.intervals, entities=built.system.entities)
    leaves = tier_leaves(one_row(state.params), plan)
    want = {k: 0 for k in got}
    want[AGG[1] if codec else AGG[0]] = sum(engine_b_fed(plan, s, leaves)
                                            for s in range(rounds))
    want.update(dict.fromkeys(ATTN, zoo_attention_layers(ms) * rounds))
    if got != want:
        raise AssertionError(f"{spec.name}: launches {got}, the plan and depth imply {want}")
    held = 0
    for i, x in enumerate(tree_leaves(state.params)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{spec.name}: leaf {i} not finite")
        held += x.numel()
    if peak > ZOO_PEAK_LIMIT:
        raise AssertionError(f"{spec.name}: peaked at {peak / 1e9:.2f} GB > 70 GB")
    med = lambda v: sorted(v[1:])[len(v[1:]) // 2]  # noqa: E731
    round_ms = med(ROUND_MS[f"api {spec.name}"])
    out = dict(round_ms=round_ms, peak=peak, held=held, losses=res.train["losses"])
    line = (f"[zoo] {spec.name}: {ms.num_layers} layers, d {ms.d_model}, "
            f"{ms.total_param_count()} params; Engine B holds {held} ({held * 4 / 1e9:.2f} GB "
            f"f32); cuts {plan.cuts} intervals {plan.intervals}; launches {got} as the plan "
            f"and depth imply; losses {[round(v, 4) for v in res.train['losses']]}; every "
            f"param finite; median round {round_ms:.2f} ms (rounds 2 on); peak device memory "
            f"{peak / 1e9:.2f} GB")
    if ms.moe is not None and codec is None:
        N = built.system.num_clients
        top = {k: v[0, 0] for k, v in state.params[-1]["units"]["moe"].items()}
        del state
        torch.cuda.empty_cache()
        x = torch.randn((N * spec.model.batch, ZOO_SEQ, ms.d_model), device=top["w1"].device,
                        generator=torch.Generator(top["w1"].device).manual_seed(0))
        layer_ms, expert_ms = zoo_moe_timing(ms, top, x, N)
        out.update(moe_layer_ms=layer_ms, moe_expert_ms=expert_ms)
        line += (f"; one MoE layer fwd+bwd at the top tier's shape ({N} groups of "
                 f"{spec.model.batch * ZOO_SEQ} tokens) {layer_ms:.3f} ms, its expert products "
                 f"{expert_ms:.3f} ms, the dispatch {layer_ms - expert_ms:.3f} ms; x "
                 f"{ms.n_units} layers = {100 * ms.n_units * layer_ms / round_ms:.1f}% of the "
                 f"round (dispatch {100 * ms.n_units * (layer_ms - expert_ms) / round_ms:.1f}%)")
    else:
        del state
    torch.cuda.empty_cache()
    print(line + f"; card {card}")
    return got, out


def zoo_routing_flips(api, spec):
    """The (token, k) routings whose expert differs between the two engines'
    router products at round 1.  The round-1 global batch runs through the
    init model with every client's tokens in a group of their own
    (``moe_groups = N``, as Engine B's top tier), each layer's MoE input
    recorded; each layer's top-k is then taken on those inputs as Engine B
    routes them (one [N, b·S, d] x [d, E] product) and as Engine A does
    (``vmap`` over the N clients' replicas of the router).  Returns
    (differing pairs, pairs, the smallest k-th/(k+1)-th gate margin)."""
    import torch
    from torch.func import vmap

    from repro_torch._device import resolve_device
    from repro_torch.models import layers as L

    run_mod = sys.modules["repro_torch.api.run"]
    built = api.build(spec)
    model, loader, _, N = run_mod._training_setup(built)
    ms = built.model_spec
    dev = resolve_device()
    params = model.init_params(torch.Generator().manual_seed(spec.run.seed), dev)
    toks = torch.from_numpy(loader.next_round()["tokens"]).to(dev)
    b, S = toks.shape[1], toks.shape[2]
    inputs, real = [], L.moe

    def record(p, x, s, groups=1):
        inputs.append((p["router"], x))
        return real(p, x, s, groups=groups)

    L.moe, model.moe_groups = record, N
    try:
        with torch.no_grad():
            carry = model.frontend_apply(params["frontend"], {"tokens": toks.reshape(N * b, S)})
            model.apply_units(params["units"], carry, 0, ms.n_units)
    finally:
        L.moe, model.moe_groups = real, 1
    del params
    flips, margin, K, E = 0, math.inf, ms.moe.top_k, ms.moe.num_experts
    with torch.no_grad():
        for router, x in inputs:
            probs, _, ids_b = L.moe_route({"router": router}, x.reshape(N, b * S, -1), ms)
            reps = router[None].expand(N, *router.shape).contiguous()
            ids_a = vmap(lambda r, xc: L.moe_route({"router": r}, xc.reshape(1, b * S, -1),
                                                   ms)[2][0])(reps, x.reshape(N, b, S, -1))
            hot = lambda ids: torch.zeros(N, b * S, E, device=dev).scatter_(-1, ids, 1.0)  # noqa: E731
            flips += int((hot(ids_a) * (1.0 - hot(ids_b))).sum())
            top = torch.topk(probs, K + 1, dim=-1).values
            margin = min(margin, float((top[..., K - 1] - top[..., K]).min()))
    return flips, len(inputs) * N * b * S * K, margin


def zoo_cli_card_vs_cpu(arch: str, rounds: int = 3):
    """``python -m repro_torch.launch.train --arch <id>`` (REDUCED, S=64, N=8,
    J2=4, batch 2) on the card and with ``--device cpu``: the same init and
    batches, each round's loss read from the dispatch, rtol 1e-4; the
    card's launches as the plan and depth imply."""
    import numpy as np
    import torch

    from repro_torch.core import replicate_for_clients
    from repro_torch.launch import train

    argv = ["--arch", arch, "--clients", "8", "--edges", "4", "--batch", "2",
            "--rounds", str(rounds), "--log-every", "1"]
    real, losses = train.make_dispatch, {}
    for dev in ("cuda", "cpu"):
        rec = losses[dev] = []

        def hooked(*a, **k):
            dispatch = real(*a, **k)

            def wrapped(state, batch, r, mask=None):
                state, loss = dispatch(state, batch, r, mask)
                rec.append(float(loss))
                return state, loss

            return wrapped

        train.make_dispatch = hooked
        reset_all_launches()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = train.main(argv + ["--device", dev])
        finally:
            train.make_dispatch = real
        assert rc == 0, rc
        if dev == "cuda":
            got = all_launches()
    _, spec, model, plan, _, _ = train.setup(train.parse_args(argv + ["--device", "cpu"]))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    want = lm_expected(plan, replicate_for_clients(params, plan.num_clients),
                       spec.n_units, rounds)
    want.update(dict.fromkeys(ATTN, zoo_attention_layers(spec) * rounds))
    if got != want:
        raise AssertionError(f"{arch} CLI launches {got}, the plan and depth imply {want}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=ZOO_CARD_RTOL)
    err = float(np.max(np.abs(np.subtract(losses["cuda"], losses["cpu"])) /
                       np.abs(losses["cpu"])))
    print(f"[zoo] {arch} REDUCED through the CLI (Engine A, N=8, J2=4, batch 2, S=64, "
          f"{rounds} rounds): losses cuda {losses['cuda']} cpu {losses['cpu']}, within "
          f"{err:.3g} relative (rtol {ZOO_CARD_RTOL}); launches {got} as the plan implies")
    return got


def zoo_api_card_vs_cpu(api, arch: str = ZOO_HYBRID, rounds: int = 3):
    """``api.run`` on Engine A, REDUCED (2 super-blocks for jamba), N=8,
    J2=4, batch 2, seq 64, on the card and on the CPU: losses rtol 1e-4;
    the card's launches as the plan and depth imply."""
    import numpy as np

    from repro_torch.core.tiers import TierPlan

    spec = api.paper_spec().replace(
        name=f"zoo-{arch}-reduced",
        model=api.ModelCfg(arch=arch, variant="reduced", batch=2, seq=64),
        system=api.SystemCfg(num_clients=8, num_edges=4),
        solver=api.SolverCfg(kind="fixed", cuts=(1, 1), intervals=(2, 2, 1)),
        run=api.RunCfg(mode="train", rounds=rounds, dataset_size=64, lr=0.1))
    res, got, state = api_train(api, spec, spec.name)
    cpu = api.run(spec, device="cpu")
    built = api.build(spec)
    ms = built.model_spec
    plan = TierPlan(n_units=ms.n_units, num_clients=built.system.num_clients, cuts=res.cuts,
                    intervals=res.intervals, entities=built.system.entities)
    want = lm_expected(plan, state.params, ms.n_units, rounds)
    want.update(dict.fromkeys(ATTN, zoo_attention_layers(ms) * rounds))
    if got != want:
        raise AssertionError(f"{spec.name}: launches {got}, the plan and depth imply {want}")
    a, c = res.train["losses"], cpu.train["losses"]
    np.testing.assert_allclose(a, c, rtol=ZOO_CARD_RTOL)
    err = float(np.max(np.abs(np.subtract(a, c)) / np.abs(c)))
    print(f"[zoo] {arch} REDUCED through api.run (Engine A, N=8, J2=4, batch 2, S=64, "
          f"{rounds} rounds): losses cuda {a} cpu {c}, within {err:.3g} relative (rtol "
          f"{ZOO_CARD_RTOL}); launches {got} as the plan implies")
    return got


def zoo_depth_gradients(card: str, depths=(4, 16, 48)):
    """mamba2-1.3b at full width at init: one batch's (1 x 512 tokens) loss
    gradient norm through the first 4, 16 and all 48 blocks of one init, the
    step lr x |grad| that SGD takes at ``ZOO_LR`` and at 1e-5.  The CPU
    tests hold the port's growth with depth against JAX's at d 32
    (``tests/test_torch_ssm.py``); here it is read at the cell's width.
    Every gradient finite."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs import get_spec
    from repro_torch.models import SplittableModel

    dev = resolve_device()
    full = get_spec(ZOO_SSM)
    params = SplittableModel(full).init_params(torch.Generator().manual_seed(0), dev)
    toks = torch.randint(0, full.vocab_size, (1, ZOO_SEQ + 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    norms = {}
    for n in depths:
        model = SplittableModel(dataclasses.replace(full, num_layers=n))
        p = tree_map(lambda x: x.detach().requires_grad_(True),
                     {**params, "units": tree_map(lambda x: x[:n], params["units"])})
        loss = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"{ZOO_SSM} at {n} blocks: a gradient is not finite")
        norms[n] = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
        del loss, grads, p
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    lr = ZOO_LR[ZOO_SSM]
    print(f"[zoo] {ZOO_SSM} full width at init, one batch of {ZOO_SEQ} tokens: |grad| "
          + ", ".join(f"{n} blocks {v:.6g}" for n, v in norms.items())
          + f"; SGD's step lr x |grad| at {max(depths)} blocks {lr * norms[max(depths)]:.4g} "
          f"(lr {lr}), {1e-5 * norms[max(depths)]:.4g} at 1e-5; card {card}")
    return norms


def zoo_paths(card: str):
    """The ``[zoo]`` phase: granite-moe-1b-a400m at full width and depth
    through Engine B, plain and over the int8 wire; its half-depth Engine-A
    twin check with the routing flips at round 1; mamba2-1.3b at full width
    and depth through Engine B; REDUCED granite and mamba2 through the CLI
    and REDUCED jamba through ``api.run`` on the card against the CPU."""
    from repro_torch import api

    counts, out = {}, {}
    t0 = time.perf_counter()
    for key, (arch, layers, cuts, rounds, codecs) in ZOO_CELLS.items():
        for codec in codecs:
            name = key if codec is None else f"{key}-{codec}"
            counts[name], out[name] = zoo_cell(api, key, arch, layers, cuts, rounds, codec,
                                               card)
    key, arch, layers, cuts, rounds = ZOO_TWIN
    spec = zoo_spec(api, key, arch, layers, cuts, rounds)
    flips, pairs, margin = zoo_routing_flips(api, spec)
    print(f"[zoo] {key}: at round 1, {flips} of {pairs} (token, k) routings "
          f"({100 * flips / pairs:.4f}%) differ between Engine B's router product and "
          f"Engine A's on the same inputs; smallest k-th/(k+1)-th gate margin {margin:.3g}")
    counts[key], out[key] = engine_b_pair(api, key, spec, card, route_flips=True)
    out[key].update(route_flips=flips, route_pairs=pairs, route_margin=margin)
    out["zoo-mamba2-depth-gradients"] = zoo_depth_gradients(card)
    for a in (ZOO_MOE, ZOO_SSM):
        counts[f"zoo-cli-{a}-reduced"] = zoo_cli_card_vs_cpu(a)
    counts[f"zoo-{ZOO_HYBRID}-reduced"] = zoo_api_card_vs_cpu(api)
    for path, names in (("zoo-granite-moe-1b-a400m", (AGG[0],) + ATTN),
                        ("zoo-granite-moe-1b-a400m-int8", (AGG[1],) + ATTN),
                        ("zoo-mamba2-1.3b", (AGG[0],)),
                        (f"zoo-{ZOO_HYBRID}-reduced", (AGG[0],) + ATTN)):
        for name in names:
            if counts[path][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
    print("[timing] [zoo] full width through Engine B, median round ms (rounds 2 on) and "
          "peak GB: " + json.dumps({k: [v["round_ms"], v["peak"] / 1e9] for k, v in out.items()
                                    if "round_ms" in v})
          + f"; phase {time.perf_counter() - t0:.1f} s; card {card}")
    return counts, out


# --------------------------------------------------------------------------- #
# [vlm]: paligemma-3b through Engine B at full width (ROADMAP A14.4)
# --------------------------------------------------------------------------- #

# Engine B at full width and depth: N = 4 clients, J2 = 2 edges, cuts
# (1, 2) (tier 1: the embedding, the projection and 1 unit a client; tier
# 2: 1 unit an edge; tier 3: 16 units), intervals (2, 2, 1), SGD.  A step
# holds the params, their gradients and the SGD's new params at once: at
# cuts (2, 6) that peaked at 66.83 GB and ran out of memory through
# fragmentation, at (1, 2) at 57.68 GB (`vlm_reckoning`)
VLM_EDGES, VLM_CUTS, VLM_INTERVALS, VLM_ROUNDS, VLM_LR = 2, (1, 2), (2, 2, 1), 4, 5e-4
# the Engine-A twin at full width, 4 layers: cuts (1, 2)
VLM_TWIN_LAYERS, VLM_TWIN_CUTS = 4, (1, 2)
VLM_REDUCED_ROUNDS = 3
VLM_PEAK_LIMIT = 70e9
VLM_LOSS_RTOL = 1e-4  # the twin, and REDUCED card against CPU
VLM_ATOL, VLM_RTOL = 1e-5, 1e-4  # the twin's params


def leaves_by_path(tree, prefix=()):
    """{"frontend/embed": leaf, ...}: a tree's leaves keyed by their paths,
    whatever the order its dicts were built in."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves_by_path(sub, prefix + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in leaves_by_path(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): tree}


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator maps new blocks as expandable segments inside
    the block, then as before.  The [vlm] cell's largest leaves (tier 1's
    four copies of the padded embedding, 8.4 GB each) and their gradients
    and updates left 12.7 GiB of the card reserved but unusable in fixed
    segments, and a step ran out of memory at 65.7 GB allocated on an H100
    80GB; with expandable segments the same step peaked at 57.68 GB."""
    import torch

    # torch 2.11 names the setter anew and warns on the old name
    settings = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    settings = settings or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


class _GivenInit:
    """Stands in for the model in ``init_state_b``: its init is given, so
    both engines start from one draw."""

    def __init__(self, params):
        self.params = params

    def init_params(self, generator, device=None):
        return self.params


def vlm_batches(spec, N: int, b: int, seq: int, rounds: int, seed: int, device):
    """``rounds`` batches of N clients x b sequences of ``seq`` positions
    (the VLM: the image prefix and the text; the audio model: ``seq`` text
    tokens beside its frames), drawn by the port's ``concrete_inputs`` on
    ``device`` from one seeded generator; leaves [N, b, ...]."""
    import torch

    from repro_torch.configs.shapes import concrete_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(rounds):
        batch = concrete_inputs(spec, N * b, seq, gen, device)
        out.append({k: v.reshape(N, b, *v.shape[1:]) for k, v in batch.items()})
    return out


def vlm_unit_params(spec) -> int:
    """One dense unit's parameters: q, k, v, o, the SwiGLU MLP, two norms."""
    d, hd = spec.d_model, spec.hd
    return (d * spec.num_heads * hd * 2 + 2 * d * spec.num_kv_heads * hd + 3 * d * spec.d_ff
            + 2 * d)


def vlm_reckoning(spec, plan, tokens: int, text: int, unit=None, frontend=None) -> dict:
    """The memory an Engine-B step needs, reckoned before the run: the
    parameters each tier's entities hold (tier 1 also the padded embedding
    and the projection; a dense LM's ``unit`` and ``frontend`` given).  The
    backward holds them, their gradients, the MLP's four [tokens, d_ff] f32
    intermediates a layer and the text's tied logits with their softmax and
    gradient [text tokens, padded_vocab] x 3; the SGD update the params,
    the gradients and the new params, 3 x the params."""
    unit = vlm_unit_params(spec) if unit is None else unit
    if frontend is None:
        frontend = spec.padded_vocab * spec.d_model + spec.d_model ** 2
    bounds = [plan.tier_bounds(m) for m in range(plan.M)]
    held = sum(plan.entities[m] * ((hi - lo) * unit + (frontend if m == 0 else 0))
               for m, (lo, hi) in enumerate(bounds)) + spec.d_model
    acts = spec.n_units * 4 * tokens * spec.d_ff * 4
    logits = 3 * text * spec.padded_vocab * 4
    backward, update = 2 * 4 * held + acts + logits, 3 * 4 * held
    return dict(unit=unit, frontend=frontend, held=held, activations=acts, logits=logits,
                backward=backward, update=update, total=max(backward, update))


def vlm_train(step, states, batches):
    """(state, losses, host ms of each round ending in a device sync) from
    the state in the one-element list ``states``, taken out of it: no name
    keeps the initial params alive beside the trained ones."""
    import torch

    state = states.pop()
    losses, ms = [], []
    for batch in batches:
        t = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    return state, losses, ms


def engine_b_want(plan, tier_params, attn_layers: int, rounds: int) -> dict:
    """Engine B's launches over ``rounds`` rounds: B1 by ``engine_b_fed`` on
    each tier's leaves that hold elements (a tier's empty encoder or decoder
    stack launches nothing), B4 and each B5 pass once an attention layer a
    round."""
    from repro_torch._tree import tree_leaves

    want = {k: 0 for k in all_launches()}
    leaves = [sum(1 for x in tree_leaves(p) if x.numel()) for p in tier_params]
    want[AGG[0]] = sum(engine_b_fed(plan, s, leaves) for s in range(rounds))
    want.update(dict.fromkeys(ATTN, attn_layers * rounds))
    return want


def engine_b_cell(tag: str, model, plan, opt, cell: dict, reckoned: dict, attn_layers: int,
                  limit: float):
    """``model`` at full width through Engine B from a seeded init drawn on
    the card: ``cell`` gives the batch a client (``b``), the positions
    ``vlm_batches`` draws (``seq``), the rounds and the two seeds.  The
    reckoning is printed first and must stay under ``limit``.  Launches as
    ``engine_b_want`` implies; losses and params finite; the peak at most
    ``limit``; the parameters held equal the reckoning's.  Returns
    (launches, {round_ms (median of rounds 2 on), rounds_ms, peak, held,
    losses, reckoned})."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.core import build_train_step_b, init_state_b

    label = f"{tag} {model.spec.name}"
    dev = serve_device()
    print(f"{tag} reckoned before the run: Engine B holds {reckoned['held']} parameters "
          f"({4 * reckoned['held'] / 1e9:.2f} GB f32); the backward "
          f"{reckoned['backward'] / 1e9:.2f} GB (params and gradients "
          f"{8 * reckoned['held'] / 1e9:.2f}, activations {reckoned['activations'] / 1e9:.2f}, "
          f"logits {reckoned['logits'] / 1e9:.2f}), the update {reckoned['update'] / 1e9:.2f} GB "
          "(params, gradients, new params)", flush=True)
    if reckoned["total"] > limit:
        raise AssertionError(f"{label}: the reckoning {reckoned['total'] / 1e9:.2f} GB is over "
                             f"the {limit / 1e9:.0f} GB line: move the cuts")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(cell["init_seed"])
    with dev:
        states = [init_state_b(model, plan, opt, gen, dev)]
    batches = vlm_batches(model.spec, plan.num_clients, cell["b"], cell["seq"], cell["rounds"],
                          cell["batch_seed"], dev)
    held = sum(x.numel() for x in tree_leaves(states[0].params))
    want = engine_b_want(plan, states[0].params, attn_layers, cell["rounds"])
    reset_all_launches()
    state, losses, ms = vlm_train(build_train_step_b(model, plan, opt), states, batches)
    got = all_launches()
    peak = torch.cuda.max_memory_allocated()
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the plan and depth imply {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses {losses}")
    for i, x in enumerate(tree_leaves(state.params)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: leaf {i} not finite")
    if peak > limit:
        raise AssertionError(f"{label}: peaked at {peak / 1e9:.2f} GB > {limit / 1e9:.0f} GB")
    if held != reckoned["held"]:
        raise AssertionError(f"{label}: Engine B holds {held} parameters, reckoned "
                             f"{reckoned['held']}")
    del state, batches
    torch.cuda.empty_cache()
    return got, dict(round_ms=sorted(ms[1:])[len(ms[1:]) // 2], rounds_ms=ms, peak=peak,
                     held=held, losses=losses, reckoned=reckoned)


def engine_twin(tag: str, path: str, model, plan, opt, inits: list, batches, attn_layers: int,
                tols: tuple, own_leaves=None):
    """Engine A, then Engine B from the same init (``inits``, a one-element
    list, emptied once B holds it, so that no name keeps it alive), on
    ``batches``; A's params go to the host and are freed before B starts.
    Launches as the plan implies; losses within rtol ``tols[0]``;
    ``engine_b_to_full`` of B's params within atol ``tols[1]`` / rtol
    ``tols[2]`` of A's leaf by leaf, but for the leaves that
    ``own_leaves(leaves_a, leaves_b)`` takes out and holds itself (it
    returns their largest |diff| and what it found).  Returns (launches
    keyed ``path``-a / -b, {losses_a, losses_b, loss_rtol, worst, peak,
    round_ms_a, round_ms_b, own})."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.core import (
        TrainState, build_train_step_a, build_train_step_b, init_state_b, replicate_for_clients,
    )
    from repro_torch.core.engine import engine_b_to_full

    loss_rtol, atol, rtol = tols
    rounds = len(batches)
    torch.cuda.reset_peak_memory_stats()
    counts = {}
    params = replicate_for_clients(inits[0], plan.num_clients)
    states = [TrainState(params, opt.init(params), 0)]
    del params
    reset_all_launches()
    state, losses_a, ms_a = vlm_train(build_train_step_a(model, plan, opt), states, batches)
    counts[f"{path}-a"] = all_launches()
    want_a = lm_expected(plan, state.params, model.spec.n_units, rounds)
    want_a.update(dict.fromkeys(ATTN, attn_layers * rounds))
    host_a = tree_map(lambda x: x.cpu(), state.params)
    del state
    torch.cuda.empty_cache()
    dev = serve_device()
    with dev:
        states = [init_state_b(_GivenInit(inits.pop()), plan, opt, None, dev)]
    want_b = engine_b_want(plan, states[0].params, attn_layers, rounds)
    reset_all_launches()
    state, losses_b, ms_b = vlm_train(build_train_step_b(model, plan, opt), states, batches)
    counts[f"{path}-b"] = all_launches()
    peak = torch.cuda.max_memory_allocated()
    host_b = tree_map(lambda x: x.cpu(), state.params)
    del state
    torch.cuda.empty_cache()
    for name, want in (("a", want_a), ("b", want_b)):
        got = counts[f"{path}-{name}"]
        if {k: got.get(k, 0) for k in want} != want:
            raise AssertionError(f"{tag} twin Engine {name.upper()}: launches {got}, the plan "
                                 f"implies {want}")
    loss_err = max(abs(lb - la) / abs(la) for la, lb in zip(losses_a, losses_b))
    if not loss_err <= loss_rtol:
        raise AssertionError(f"{tag} twin: losses A {losses_a} B {losses_b}, rtol "
                             f"{loss_err:.3e} > {loss_rtol}")
    leaves_a = leaves_by_path(host_a)
    leaves_b = leaves_by_path(engine_b_to_full(model, plan, host_b))
    if leaves_a.keys() != leaves_b.keys():
        raise AssertionError(f"{tag} twin: leaves {sorted(leaves_b)} against {sorted(leaves_a)}")
    worst, own = own_leaves(leaves_a, leaves_b) if own_leaves else (0.0, None)
    for name, a in leaves_a.items():
        c = leaves_b[name]
        torch.testing.assert_close(c, a, atol=atol, rtol=rtol, msg=f"{tag} twin: {name}")
        if a.numel():
            worst = max(worst, float((c - a).abs().max()))
    return counts, dict(losses_a=losses_a, losses_b=losses_b, loss_rtol=loss_err, worst=worst,
                        peak=peak, round_ms_a=sorted(ms_a[1:])[1],
                        round_ms_b=sorted(ms_b[1:])[1], own=own)


def reduced_card_vs_cpu(tag: str, path: str, model, plan, p0, batches, attn_layers: int,
                        rtol: float, params_atol=None):
    """Engine A and Engine B from one CPU init ``p0`` on NumPy ``batches``
    (leaves [N, b, ...]), SGD 0.1, on the card and on the CPU: losses within
    ``rtol`` (and, given ``params_atol``, the final params within it and
    rtol 1e-4, leaf by leaf); the card's launches as the plan implies.
    Returns (losses keyed (engine, device), launches keyed ``path``-a /
    -b)."""
    import numpy as np
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.core import (
        TrainState, build_train_step_a, build_train_step_b, init_state_b, replicate_for_clients,
    )
    from repro_torch.optim import sgd

    opt, rounds = sgd(0.1), len(batches)
    losses, counts = {}, {}
    for engine in ("a", "b"):
        finals = {}
        for name in ("cuda", "cpu"):
            device = torch.device(name)
            params = tree_map(lambda x: x.to(device), p0)
            if engine == "a":
                stacked = replicate_for_clients(params, plan.num_clients)
                state = TrainState(stacked, opt.init(stacked), 0)
                step = build_train_step_a(model, plan, opt)
            else:
                state = init_state_b(_GivenInit(params), plan, opt, None, device)
                step = build_train_step_b(model, plan, opt)
                want = engine_b_want(plan, state.params, attn_layers, rounds)
            reset_all_launches()
            got = []
            for batch in batches:
                state, loss = step(state, {k: torch.from_numpy(v).to(device)
                                           for k, v in batch.items()})
                got.append(float(loss))
            losses[(engine, name)] = got
            if name == "cuda":
                counts[f"{path}-{engine}"] = launched = all_launches()
                if engine == "a":
                    want = lm_expected(plan, state.params, model.spec.n_units, rounds)
                    want.update(dict.fromkeys(ATTN, attn_layers * rounds))
                if {k: launched.get(k, 0) for k in want} != want:
                    raise AssertionError(f"{tag} REDUCED Engine {engine.upper()}: launches "
                                         f"{launched}, the plan implies {want}")
            finals[name] = leaves_by_path(tree_map(lambda x: x.cpu(), state.params))
        np.testing.assert_allclose(losses[(engine, "cuda")], losses[(engine, "cpu")], rtol=rtol)
        if params_atol is not None:
            for leaf, x in finals["cpu"].items():
                torch.testing.assert_close(finals["cuda"][leaf], x, atol=params_atol, rtol=1e-4,
                                           msg=f"{tag} REDUCED Engine {engine.upper()}: {leaf}")
    return losses, counts


def vlm_cell(card: str, attn_times):
    """paligemma-3b at full width and depth through Engine B: N=4, J2=2,
    batch 1, 256 image-prefix and 256 text tokens a client, cuts (1, 2),
    intervals (2, 2, 1), SGD at 5e-4, 4 rounds from a seeded init drawn on
    the card (``engine_b_cell``): B4 and both B5 passes launch once a layer
    a round, B1 as ``engine_b_fed`` predicts; the peak at most 70 GB,
    beside ``vlm_reckoning``; the round's ms and the attention kernels'
    share of it (18 layers x their time at the tiers' shape)."""
    from repro_torch.configs import get_spec
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel
    from repro_torch.optim import sgd

    spec = get_spec(VLM_ARCH)
    model = SplittableModel(spec)
    N, b, seq = VLM_N, VLM_BATCH, VLM_PREFIX + VLM_TEXT
    plan = default_plan(spec.n_units, N, cuts=VLM_CUTS, intervals=VLM_INTERVALS,
                        entities=(N, VLM_EDGES, 1))
    reckoned = vlm_reckoning(spec, plan, N * b * seq, N * b * VLM_TEXT)
    cell = dict(b=b, seq=seq, rounds=VLM_ROUNDS, init_seed=25, batch_seed=26)
    got, out = engine_b_cell("[vlm]", model, plan, sgd(VLM_LR), cell, reckoned, spec.n_units,
                             VLM_PEAK_LIMIT)
    attn_ms = spec.n_units * sum(attn_times[name]["ms"] for name in ATTN)
    out.update(attention_ms=attn_ms, attention_share=attn_ms / out["round_ms"])
    print(f"[vlm] paligemma-3b at full width and depth through Engine B ({spec.num_layers} "
          f"layers, d {spec.d_model}, hd {spec.hd}, {spec.total_param_count()} params; N={N}, "
          f"J2={VLM_EDGES}, batch {b}, {VLM_PREFIX} image-prefix + {VLM_TEXT} text tokens a "
          f"client; cuts {plan.cuts}, intervals {plan.intervals}, SGD {VLM_LR}): launches "
          f"{got} as the plan and depth imply; losses {[round(v, 4) for v in out['losses']]}; "
          f"every param finite; Engine B holds {out['held']} params "
          f"({out['held'] * 4 / 1e9:.2f} GB f32); reckoned {reckoned['total'] / 1e9:.2f} GB, "
          f"measured peak {out['peak'] / 1e9:.2f} GB (limit 70); rounds "
          f"{[round(v, 1) for v in out['rounds_ms']]} ms, median (rounds 2 on) "
          f"{out['round_ms']:.2f} ms, of which B4 + B5 {attn_ms:.2f} ms ({spec.n_units} layers "
          f"x their time at the tiers' shape) = {100 * out['attention_share']:.1f}%; card {card}")
    return got, out


def vlm_pad_bound(model, params, batch, rounds: int, lr: float):
    """A bound on how far Engine B's pad rows of the tied embedding move
    from Engine A's, from the init: Engine A masks the pad logits, so its
    pad rows get no gradient; Engine B's do not (ROADMAP §C), and a client's
    row v moves by lr times the token mean of p_tv h_t a round (its tier-1
    gradient scaled by J = N, the fed means averaging the clients).  So the
    distance is at most rounds x lr x max p_pad x max |h|, taken on the
    first batch at the init, doubled for the drift over the rounds."""
    import torch

    from repro_torch.models import layers as L

    spec = model.spec
    with torch.no_grad():
        batch0 = {k: v[0] for k, v in batch.items()}
        carry = model.frontend_apply(params["frontend"], batch0)
        carry = model.apply_units(params["units"], carry, 0, spec.n_units,
                                  prefix_len=model.prefix_len)
        h = L.rms_norm(carry["h"], params["head"]["norm"], spec.norm_eps)[:, spec.prefix_len:]
        logits = h @ params["frontend"]["embed"].T
        p_pad = torch.softmax(logits, dim=-1)[..., spec.vocab_size:]
        p_max, h_max = float(p_pad.max()), float(h.abs().max())
        # ln(1 + the pad rows' share of the softmax), in float64: in f32 it
        # rounds to 0 where the logits are far from uniform
        share = torch.exp(torch.logsumexp(logits[..., spec.vocab_size:].double(), -1)
                          - torch.logsumexp(logits[..., : spec.vocab_size].double(), -1))
        gap = float(torch.log1p(share).mean())
    return dict(bound=2 * rounds * lr * p_max * h_max, p_pad_max=p_max, h_max=h_max,
                loss_gap=gap)


def vlm_twin(card: str):
    """Engine A against Engine B from one init at full width, 4 layers
    (N=4, J2=2, cuts (1, 2), the cell's batches, SGD, 4 rounds), through
    ``engine_twin``.  Losses rtol 1e-4, ``engine_b_to_full`` against A's
    params atol 1e-5 / rtol 1e-4 but for the tied embedding's 64 pad rows
    (257 216 padded to 257 280): Engine B's tied logits skip the pad mask
    (ROADMAP §C), so its loss sits ln(1 + the pad rows' share of the
    softmax) above A's (~2.5e-4 nats at near-uniform logits), and its pad
    rows move where A's stay; they are held to ``vlm_pad_bound`` apart."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel
    from repro_torch.optim import sgd

    spec = dataclasses.replace(get_spec(VLM_ARCH), num_layers=VLM_TWIN_LAYERS)
    model = SplittableModel(spec)
    N, V = VLM_N, spec.vocab_size
    plan = default_plan(spec.n_units, N, cuts=VLM_TWIN_CUTS, intervals=VLM_INTERVALS,
                        entities=(N, VLM_EDGES, 1))
    torch.cuda.empty_cache()
    inits = [card_init(model, 27)]
    batches = vlm_batches(spec, N, VLM_BATCH, VLM_PREFIX + VLM_TEXT, VLM_ROUNDS, 28,
                          serve_device())
    pad = vlm_pad_bound(model, inits[0], batches[0], VLM_ROUNDS, VLM_LR)

    def embedding(leaves_a, leaves_b):
        emb_a, emb_b = leaves_a.pop("frontend/embed"), leaves_b.pop("frontend/embed")
        dist = float((emb_b[:, V:] - emb_a[:, V:]).abs().max())
        if not dist <= pad["bound"]:
            raise AssertionError(f"[vlm] twin: the pad rows {dist:.3e} apart, above the "
                                 f"reckoned {pad['bound']:.3e}")
        torch.testing.assert_close(emb_b[:, :V], emb_a[:, :V], atol=VLM_ATOL, rtol=VLM_RTOL,
                                   msg="[vlm] twin: the embedding's vocabulary rows")
        return float((emb_b[:, :V] - emb_a[:, :V]).abs().max()), dist

    counts, out = engine_twin("[vlm]", "vlm-paligemma-3b-twin", model, plan, sgd(VLM_LR), inits,
                              batches, spec.n_units, (VLM_LOSS_RTOL, VLM_ATOL, VLM_RTOL),
                              embedding)
    out.update(pad_distance=out.pop("own"), pad=pad)
    gaps = [lb - la for la, lb in zip(out["losses_a"], out["losses_b"])]
    print(f"[vlm] paligemma-3b twin at full width, {VLM_TWIN_LAYERS} layers (N={N}, cuts "
          f"{plan.cuts}): Engine A first, then B from the same init; losses A "
          f"{[round(v, 5) for v in out['losses_a']]} B {[round(v, 5) for v in out['losses_b']]} "
          f"(rtol {VLM_LOSS_RTOL}), B - A {[f'{g:.3e}' for g in gaps]} against the reckoned "
          f"{pad['loss_gap']:.3e} nats of the pad rows' softmax share at the init "
          f"(ln({spec.padded_vocab} / {V}) = {math.log(spec.padded_vocab / V):.3e} at "
          f"uniform logits); engine_b_to_full within atol {VLM_ATOL} / rtol {VLM_RTOL} of A "
          f"(max |diff| {out['worst']:.3e}) but for the {spec.padded_vocab - V} pad rows, "
          f"{out['pad_distance']:.3e} apart, bound {pad['bound']:.3e} (2 x {VLM_ROUNDS} rounds "
          f"x lr {VLM_LR} x max p_pad {pad['p_pad_max']:.3e} x max |h| {pad['h_max']:.3f}); "
          f"launches A {counts['vlm-paligemma-3b-twin-a']}, B {counts['vlm-paligemma-3b-twin-b']} "
          f"as the plan implies; round ms A {out['round_ms_a']:.2f}, B {out['round_ms_b']:.2f} "
          f"(median of rounds 2 on); peak {out['peak'] / 1e9:.2f} GB; card {card}")
    return counts, out


def vlm_reduced_card_vs_cpu(rounds: int = VLM_REDUCED_ROUNDS):
    """REDUCED paligemma, Engine A and Engine B, N=4, J2=2, batch 2, 4 + 60
    tokens, cuts (1, 1), 3 rounds from one init and NumPy batches, on the
    card and on the CPU (``reduced_card_vs_cpu``): losses rtol 1e-4; the
    card's launches as the plan implies."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel

    spec = get_reduced(VLM_ARCH)
    model = SplittableModel(spec)
    N, b, seq = VLM_N, VLM_REDUCED_BATCH, VLM_REDUCED_SEQ
    plan = default_plan(spec.n_units, N, cuts=(1, 1), intervals=(2, 2, 1),
                        entities=(N, VLM_EDGES, 1))
    p0 = model.init_params(torch.Generator().manual_seed(0), torch.device("cpu"))
    rng = np.random.default_rng(0)
    batches = [{
        "patch_embeds": rng.normal(size=(N, b, spec.prefix_len, spec.d_model)).astype(np.float32),
        "tokens": rng.integers(0, spec.vocab_size, (N, b, seq - spec.prefix_len)).astype(np.int32),
        "labels": rng.integers(0, spec.vocab_size, (N, b, seq - spec.prefix_len)).astype(np.int32),
    } for _ in range(rounds)]
    losses, counts = reduced_card_vs_cpu("[vlm]", "vlm-paligemma-3b-reduced", model, plan, p0,
                                         batches, spec.n_units, VLM_LOSS_RTOL)
    print(f"[vlm] REDUCED paligemma-3b (N={N}, batch {b}, {spec.prefix_len} + "
          f"{seq - spec.prefix_len} tokens, {rounds} rounds) on the card against the CPU: "
          + "; ".join(f"Engine {e.upper()} cuda {losses[(e, 'cuda')]} cpu {losses[(e, 'cpu')]}"
                      for e in ("a", "b"))
          + f" (rtol {VLM_LOSS_RTOL}); launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return counts


def vlm_paths(card: str):
    """The ``[vlm]`` phase: B4/B5 timed at paligemma-3b's Engine-B shape;
    the full-width, full-depth Engine-B cell; its 4-layer Engine-A twin;
    REDUCED paligemma on the card against the CPU.  Its cell needs 58 GB of
    the card's 80: it starts after a collection, as every phase boundary
    of ``main`` makes one, so that the tensors earlier phases leave in
    reference cycles are gone."""
    import torch

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[vlm] device memory allocated at the phase's start: {before / 1e9:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after a collection")
    attn_times = vlm_attention_timings(card)
    counts, out = {}, {"attention": attn_times}
    with expandable_segments():
        counts["vlm-paligemma-3b"], out["vlm-paligemma-3b"] = vlm_cell(card, attn_times)
        twin_counts, out["vlm-paligemma-3b-twin"] = vlm_twin(card)
    counts.update(twin_counts)
    counts.update(vlm_reduced_card_vs_cpu())
    for path in ("vlm-paligemma-3b", "vlm-paligemma-3b-reduced-b"):
        for name in (AGG[0],) + ATTN:
            if counts[path][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[timing] [vlm] paligemma-3b through Engine B: median round "
          f"{out['vlm-paligemma-3b']['round_ms']:.2f} ms, peak "
          f"{out['vlm-paligemma-3b']['peak'] / 1e9:.2f} GB; phase "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"left allocated; card {card}")
    return counts, out


# --------------------------------------------------------------------------- #
# [qwen2]: qwen2-1.5b trained at full width and depth, attention at hd 128
# --------------------------------------------------------------------------- #

QWEN2_ARCH = "qwen2-1.5b"
# the cell (arXiv:2407.10671's widths and depth): N = 4 clients x batch 1,
# J2 = 2 edges, 1024 tokens a client; the client tier holds the embedding
# and unit 0, the edges unit 1, the cloud the other 26 and the head
QWEN2_N, QWEN2_EDGES, QWEN2_BATCH, QWEN2_SEQ = 4, 2, 1, 1024
QWEN2_CUTS, QWEN2_INTERVALS, QWEN2_ROUNDS, QWEN2_LR = (1, 2), (2, 2, 1), 4, 5e-4
QWEN2_PEAK_LIMIT = 70e9
# every Engine-B tier folds the clients into the batch: B = 4, S, H, K, hd
QWEN2_ATTN = (QWEN2_N * QWEN2_BATCH, QWEN2_SEQ, 12, 2, 128)
# REDUCED qwen2-1.5b (QKV bias) and qwen3-32b (qk_norm) at head_dim 128 on
# the card against the CPU: N = 4, J2 = 2, batch 2, 160 tokens, 3 rounds
QWEN2_REDUCED = ("qwen2-1.5b", "qwen3-32b")
QWEN2_REDUCED_BATCH, QWEN2_REDUCED_SEQ, QWEN2_REDUCED_ROUNDS = 2, 160, 3
QWEN2_CARD_RTOL, QWEN2_CARD_ATOL = 1e-4, 1e-5  # losses rtol; params atol (rtol 1e-4)


def qwen2_cell(card: str, attn_times):
    """qwen2-1.5b at full width and depth through Engine B: N=4, J2=2, batch
    1, 1024 tokens a client, cuts (1, 2), intervals (2, 2, 1), SGD at 5e-4,
    4 rounds from a seeded init drawn on the card (``engine_b_cell``): B4
    and both B5 passes launch once a layer a round (28), B1 as
    ``engine_b_fed`` predicts; the peak at most 70 GB, beside
    ``vlm_reckoning`` (the unit with its QKV bias, the padded embedding);
    the round's ms and the attention kernels' share of it (28 layers x
    their time at the tiers' shape)."""
    from repro_torch.configs import get_spec
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel
    from repro_torch.optim import sgd

    spec = get_spec(QWEN2_ARCH)
    model = SplittableModel(spec)
    N, b, seq = QWEN2_N, QWEN2_BATCH, QWEN2_SEQ
    plan = default_plan(spec.n_units, N, cuts=QWEN2_CUTS, intervals=QWEN2_INTERVALS,
                        entities=(N, QWEN2_EDGES, 1))
    reckoned = vlm_reckoning(spec, plan, N * b * seq, N * b * seq, unit=spec.unit_param_count(0),
                             frontend=spec.padded_vocab * spec.d_model)
    cell = dict(b=b, seq=seq, rounds=QWEN2_ROUNDS, init_seed=29, batch_seed=30)
    got, out = engine_b_cell("[qwen2]", model, plan, sgd(QWEN2_LR), cell, reckoned,
                             spec.n_units, QWEN2_PEAK_LIMIT)
    attn_ms = spec.n_units * sum(attn_times[name]["ms"] for name in ATTN)
    out.update(attention_ms=attn_ms, attention_share=attn_ms / out["round_ms"])
    print(f"[qwen2] qwen2-1.5b at full width and depth through Engine B ({spec.num_layers} "
          f"layers, d {spec.d_model}, {spec.num_heads} heads, {spec.num_kv_heads} kv heads, hd "
          f"{spec.hd}, d_ff {spec.d_ff}, vocab {spec.vocab_size}, {spec.total_param_count()} "
          f"params; N={N}, J2={QWEN2_EDGES}, batch {b}, {seq} tokens a client; cuts "
          f"{plan.cuts}, intervals {plan.intervals}, SGD {QWEN2_LR}): launches {got} as the "
          f"plan and depth imply; losses {[round(v, 4) for v in out['losses']]}; every param "
          f"finite; Engine B holds {out['held']} params ({out['held'] * 4 / 1e9:.2f} GB f32); "
          f"reckoned {reckoned['total'] / 1e9:.2f} GB, measured peak {out['peak'] / 1e9:.2f} GB "
          f"(limit 70); rounds {[round(v, 1) for v in out['rounds_ms']]} ms, median (rounds 2 "
          f"on) {out['round_ms']:.2f} ms, of which B4 + B5 {attn_ms:.2f} ms ({spec.n_units} "
          f"layers x their time at the tiers' shape) = {100 * out['attention_share']:.1f}%; "
          f"card {card}")
    return got, out


def qwen2_reduced_card_vs_cpu(rounds: int = QWEN2_REDUCED_ROUNDS):
    """REDUCED qwen2-1.5b and qwen3-32b at head_dim 128, Engine A and
    Engine B, N=4, J2=2, batch 2, 160 tokens, cuts (1, 1), 3 rounds from one
    init and NumPy batches, on the card (B4 on mma.sync, B5 on the hd-128
    wgmma kernels) and on the CPU (the plain versions), through
    ``reduced_card_vs_cpu``: losses rtol 1e-4, params atol 1e-5 / rtol
    1e-4; the card's launches as the plan implies."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel

    N, b, seq = QWEN2_N, QWEN2_REDUCED_BATCH, QWEN2_REDUCED_SEQ
    counts = {}
    for arch in QWEN2_REDUCED:
        spec = dataclasses.replace(get_reduced(arch), head_dim=128)
        model = SplittableModel(spec)
        plan = default_plan(spec.n_units, N, cuts=(1, 1), intervals=(2, 2, 1),
                            entities=(N, QWEN2_EDGES, 1))
        p0 = model.init_params(torch.Generator().manual_seed(0), torch.device("cpu"))
        rng = np.random.default_rng(1)
        batches = [{k: rng.integers(0, spec.vocab_size, (N, b, seq)).astype(np.int32)
                    for k in ("tokens", "labels")} for _ in range(rounds)]
        losses, got = reduced_card_vs_cpu("[qwen2]", f"qwen2-{arch}-reduced-hd128", model, plan,
                                          p0, batches, spec.n_units, QWEN2_CARD_RTOL,
                                          params_atol=QWEN2_CARD_ATOL)
        counts.update(got)
        print(f"[qwen2] REDUCED {arch} at head_dim 128 ({spec.num_layers} layers, d "
              f"{spec.d_model}, {spec.num_heads} heads, {spec.num_kv_heads} kv heads"
              f"{', qk_norm' if spec.qk_norm else ''}{', QKV bias' if spec.qkv_bias else ''}; "
              f"N={N}, batch {b}, {seq} tokens, {rounds} rounds) on the card against the CPU: "
              + "; ".join(f"Engine {e.upper()} cuda {losses[(e, 'cuda')]} cpu "
                          f"{losses[(e, 'cpu')]}" for e in ("a", "b"))
              + f" (losses rtol {QWEN2_CARD_RTOL}, params atol {QWEN2_CARD_ATOL}); launches "
              + ", ".join(f"{k} {v}" for k, v in got.items()))
    return counts


def qwen2_paths(card: str):
    """The ``[qwen2]`` phase: B4/B5 timed at qwen2-1.5b's Engine-B shape
    (hd 128, causal); the full-width, full-depth Engine-B cell; REDUCED
    qwen2-1.5b and qwen3-32b at head_dim 128 on the card against the CPU."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    attn_times = cell_attention_timings(card, QWEN2_ARCH, QWEN2_ATTN, 0, seed=5)
    counts, out = {}, {"attention": attn_times}
    with expandable_segments():
        counts["qwen2-1.5b"], out["qwen2-1.5b"] = qwen2_cell(card, attn_times)
    counts.update(qwen2_reduced_card_vs_cpu())
    for path in ("qwen2-1.5b",) + tuple(f"qwen2-{a}-reduced-hd128-b" for a in QWEN2_REDUCED):
        for name in (AGG[0],) + ATTN:
            if counts[path][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[timing] [qwen2] qwen2-1.5b through Engine B: median round "
          f"{out['qwen2-1.5b']['round_ms']:.2f} ms, of which B4 + B5 "
          f"{out['qwen2-1.5b']['attention_ms']:.2f} ms "
          f"({100 * out['qwen2-1.5b']['attention_share']:.1f}%), peak "
          f"{out['qwen2-1.5b']['peak'] / 1e9:.2f} GB; phase {time.perf_counter() - t0:.1f} s; "
          f"card {card}")
    return counts, out


# --------------------------------------------------------------------------- #
# [audio]: whisper-large-v3, encoder-decoder (ROADMAP A14.5)
# --------------------------------------------------------------------------- #

AUDIO_ARCH = "whisper-large-v3"
# the cell: N = 4 clients x batch 1, J2 = 2 edges; 1500 encoder positions
# (the stubbed frames) and 448 text tokens a client (Whisper's decoder
# context, arXiv:2212.04356); the client tier holds the frontend and 2
# encoder units, the edges the other 30, the cloud the 32 decoder units and
# the head
AUDIO_N, AUDIO_EDGES, AUDIO_BATCH, AUDIO_TEXT = 4, 2, 1, 448
AUDIO_CUTS, AUDIO_INTERVALS, AUDIO_ROUNDS, AUDIO_LR = (2, 32), (2, 2, 1), 4, 5e-4
AUDIO_TWIN_LAYERS, AUDIO_TWIN_CUTS = 4, (2, 4)  # 4 encoder + 4 decoder units
AUDIO_PEAK_LIMIT = 70e9
# the twin at JAX's own A == B tolerance: losses rtol, params atol / rtol
AUDIO_LOSS_RTOL, AUDIO_ATOL, AUDIO_RTOL = 1e-5, 5e-6, 1e-4
AUDIO_CARD_RTOL = 1e-4  # REDUCED on the card against the CPU
AUDIO_REDUCED_BATCH, AUDIO_REDUCED_TEXT, AUDIO_REDUCED_ROUNDS = 2, 32, 3
AUDIO_DECODE_B, AUDIO_DECODE_C, AUDIO_DECODE_WARM, AUDIO_DECODE_STEPS = 8, 128, 4, 64
# every Engine-B tier folds the clients into the batch: B = 4 on each; label
# -> (B, Sq, Sk, H, K, hd, prefix).  The encoder's bidirectional attention is
# a prefix of S; the cross-attention's prefix Sk lets every query see every key
AUDIO_ATTN = {
    "encoder": (4, 1500, 1500, 20, 20, 64, 1500),
    "decoder self": (4, AUDIO_TEXT, AUDIO_TEXT, 20, 20, 64, 0),
    "cross": (4, AUDIO_TEXT, 1500, 20, 20, 64, 1500),
}
# a decode step's cross-attention: one query against the 1500 encoder slots
AUDIO_CROSS_DECODE = (AUDIO_DECODE_B, 1500, 20, 20, 64)


def audio_attention_layers(spec) -> int:
    """B4 (and each B5 pass) launches a round: an encoder unit's
    self-attention, a decoder unit's self- and cross-attention."""
    return spec.encoder_layers + 2 * spec.num_layers


def attention_passes(q, k, v, do, W: int, P: int):
    """(o, lse, dq, delta, dk, dv): B4, then both B5 passes."""
    from repro_torch.kernels.swa_attention import (
        swa_attention_bwd_dkv, swa_attention_bwd_dq, swa_attention_fwd,
    )

    o, lse = swa_attention_fwd(q, k, v, W, P)
    dq, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
    dk, dv = swa_attention_bwd_dkv(q, k, v, lse, delta, do, W, P)
    return o, lse, dq, delta, dk, dv


def check_audio_attention():
    """B4 and both B5 passes against their plain versions at the cell's three
    shapes, f32 (forward rtol = atol ATTN_TOL, backward ATTN_TOL of max|ref|)
    and bf16 (o, dq, dk and dv within one bf16 ulp of each value beyond
    ATTN_TOL of max|ref|, against the f32 plain version on the same
    inputs); a
    second call repeats each f32 output bit for bit.  Then the decode
    cross route, B4d with every slot at position 0, against its plain
    version on non-zero caches, f32 and bf16."""
    import torch

    from repro_torch.kernels.swa_attention import (
        reset_launches, swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref,
        swa_attention_ref, swa_decode, swa_decode_ref,
    )

    dev = serve_device()
    gen = torch.Generator(device=dev).manual_seed(12)
    errs = {name: {"f32": 0.0, "bf16": 0.0} for name in ATTN}
    for label, (B, Sq, Sk, H, K, hd, P) in AUDIO_ATTN.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, Sk, K, hd, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            o, lse, dq, delta, dk, dv = attention_passes(q, k, v, do, 0, P)
            torch.cuda.synchronize()
            what = f"[audio] {label} B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd} prefix={P} {dtype}"
            f = [x.float() for x in (q, k, v, o, do)]
            ro, rlse = swa_attention_ref(f[0], f[1], f[2], 0, P)
            rdq, rdelta = swa_attention_bwd_dq_ref(f[0], f[1], f[2], f[3], lse, f[4], 0, P)
            rdk, rdv = swa_attention_bwd_dkv_ref(f[0], f[1], f[2], lse, delta, f[4], 0, P)
            key = "f32" if dtype == torch.float32 else "bf16"
            if dtype == torch.float32:
                torch.testing.assert_close(o, ro, rtol=ATTN_TOL, atol=ATTN_TOL, msg=f"B4 o {what}")
                torch.testing.assert_close(lse, rlse, rtol=ATTN_TOL, atol=ATTN_TOL,
                                           msg=f"B4 lse {what}")
                for name, got, ref in (("dq", dq, rdq), ("delta", delta, rdelta),
                                       ("dk", dk, rdk), ("dv", dv, rdv)):
                    e = normalised_err(got, ref)
                    if e > ATTN_TOL:
                        raise AssertionError(f"B5 {name} {what}: {e:.3e} of max|ref| > {ATTN_TOL}")
                again = attention_passes(q, k, v, do, 0, P)
                for name, a, b in zip(("o", "lse", "dq", "delta", "dk", "dv"),
                                      (o, lse, dq, delta, dk, dv), again):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} {what}: a second call differs in some bit")
            else:
                for name, got, ref in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                                       ("dv", dv, rdv)):
                    err = (got.float() - ref).abs()
                    if bool((err > ATTN_TOL * ref.abs().max() + bf16_ulp(ref)).any()):
                        raise AssertionError(f"{name} {what}: beyond one bf16 ulp of the f32 "
                                             "tolerance")
            for name, pairs in (("swa_attention_fwd", ((o, ro),)),
                                ("swa_attention_bwd_dq", ((dq, rdq),)),
                                ("swa_attention_bwd_dkv", ((dk, rdk), (dv, rdv)))):
                for got, ref in pairs:
                    errs[name][key] = max(errs[name][key], float((got.float() - ref).abs().max()))
            del q, k, v, do, o, lse, dq, delta, dk, dv, f, ro, rlse, rdq, rdelta, rdk, rdv
    B, C, H, K, hd = AUDIO_CROSS_DECODE
    slots = torch.zeros((C,), dtype=torch.int32, device=dev)
    cross = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, C, K, hd, generator=gen, device=dev).to(dtype) for _ in range(2))
        for q_pos in (0, 447):
            qp = torch.tensor([q_pos], dtype=torch.int32, device=dev)
            o = swa_decode(q, k, v, slots, qp)
            ref = swa_decode_ref(q.float(), k.float(), v.float(), slots, qp)
            err = (o.float() - ref).abs()
            tol = ATTN_TOL + ATTN_TOL * ref.abs()
            if dtype == torch.bfloat16:
                tol = tol + bf16_ulp(ref)
            if not bool((err <= tol).all()):
                raise AssertionError(f"[audio] the decode cross route {dtype} q_pos {q_pos}: "
                                     f"max |err| {float(err.max()):.3e}")
            key = "f32" if dtype == torch.float32 else "bf16"
            cross[key] = max(cross.get(key, 0.0), float(err.max()))
    reset_launches()
    print(f"[audio] B4, B5 dq and B5 dk/dv against their plain versions at the cell's shapes "
          + "; ".join(f"{label} {list(s)}" for label, s in AUDIO_ATTN.items())
          + f" (B, Sq, Sk, H, K, hd, prefix): f32 within rtol=atol {ATTN_TOL} (forward) and "
          f"{ATTN_TOL} of max|ref| (backward), repeating bit for bit; bf16 o, dq, dk, dv within "
          f"one bf16 ulp beyond {ATTN_TOL} of max|ref|; max |err| "
          + ", ".join(f"{n} f32 {e['f32']:.3e} bf16 {e['bf16']:.3e}" for n, e in errs.items())
          + f"; the decode cross route (B4d, every slot at position 0) at q {[B, 1, H, hd]} "
          f"against k, v {[B, C, K, hd]}: f32 within rtol=atol {ATTN_TOL} (max |err| "
          f"{cross['f32']:.3e}), bf16 within one ulp beyond it ({cross['bf16']:.3e})")
    return errs, cross


def audio_attention_timings(card: str):
    """B4 and both B5 passes at each of the cell's shapes (hd 64: all three on
    wgmma), B4's share of its bound beside SDPA's forward: the kernel and its
    plain version in turns, eagerly, the 3xTF32 bound over the visible
    pairs, and SDPA (eager, f32, no mask; causal for the decoder's
    self-attention) as the library yardstick, never called by the port.
    Then the decode cross-attention's two routes beside its plain version
    and SDPA: B4d with every slot at position 0 (the route the port takes)
    and B4 at Sq = 1 (prefix Sk)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.swa_attention import (
        reset_launches, swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref, swa_attention_fwd,
        swa_attention_ref, swa_decode, swa_decode_ref,
    )
    from repro_torch.kernels.swa_attention import swa_attention_bwd_dkv, swa_attention_bwd_dq
    from repro_torch.launch.dryrun_lib import decode_work, pairs_work

    dev = serve_device()
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for label, (B, Sq, Sk, H, K, hd, P) in AUDIO_ATTN.items():
        q, do = (torch.randn(B, Sq, H, hd, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(B, Sk, K, hd, generator=gen, device=dev) for _ in range(2))
        o, lse = swa_attention_fwd(q, k, v, 0, P)
        _, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, 0, P)
        runs = {
            "swa_attention_fwd": (lambda: swa_attention_ref(q, k, v, 0, P),
                                  lambda: swa_attention_fwd(q, k, v, 0, P)),
            "swa_attention_bwd_dq": (lambda: swa_attention_bwd_dq_ref(q, k, v, o, lse, do, 0, P),
                                     lambda: swa_attention_bwd_dq(q, k, v, o, lse, do, 0, P)),
            "swa_attention_bwd_dkv": (
                lambda: swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, 0, P),
                lambda: swa_attention_bwd_dkv(q, k, v, lse, delta, do, 0, P)),
        }
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        causal = P == 0

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        def lib_fwd_bwd():
            res = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            torch.autograd.grad(res, (qt, kt, vt), dot)

        f_ms, fb_ms = cuda_ms(lib_fwd), cuda_ms(lib_fwd_bwd)
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        work = pairs_work(B, Sq, Sk, H, K, hd, pairs)
        res = {}
        for name, (plain, kernel) in runs.items():
            km, pm = in_turns(plain, kernel)
            ops, nbytes = work[name]
            by_tc = 3 * ops / TF32_FLOPS_PER_S * 1e3
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            r = dict(ms=km, plain_ms=pm, bound_ms=max(by_tc, by_bytes),
                     bound_by="operations" if by_tc >= by_bytes else "bytes", ops=ops,
                     bytes=nbytes, library_ms=f_ms if name == "swa_attention_fwd" else fb_ms - f_ms,
                     visible_pairs=pairs, shape=[B, Sq, Sk, H, K, hd], prefix=P)
            res[name] = r
            print(f"[timing] [audio] {name} at whisper-large-v3's {label} B={B} Sq={Sq} Sk={Sk} "
                  f"H={H} K={K} hd={hd} prefix={P}: kernel {km:.4f} ms, plain {pm:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: 3 x {ops / 1e9:.2f} GFLOP at "
                  f"495 TFLOP/s TF32 over {pairs} visible pairs a head, {nbytes / 1e6:.1f} MB at "
                  f"3.35 TB/s) = {100 * r['bound_ms'] / km:.1f}% of the bound; card {card}")
        r = res["swa_attention_fwd"]
        print(f"[timing] [audio] B4 (swa_fwd_wg_kernel) at the {label} shape: {r['ms']:.4f} ms, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of its 3xTF32 bound {r['bound_ms']:.4f} ms, "
              f"against SDPA's forward {f_ms:.4f} ms; card {card}")
        print(f"[timing] [audio] library yardstick "
              f"torch.nn.functional.scaled_dot_product_attention "
              f"(f32, eager, {'is_causal' if causal else 'no mask'}) at the {label} shape: forward "
              f"{f_ms:.4f} ms, backward {fb_ms - f_ms:.4f} ms against B5's two passes "
              f"{res['swa_attention_bwd_dq']['ms'] + res['swa_attention_bwd_dkv']['ms']:.4f}; "
              f"card {card}")
        out[label] = res
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot

    # the decode cross-attention: one query against every slot
    B, C, H, K, hd = AUDIO_CROSS_DECODE
    q = torch.randn(B, 1, H, hd, generator=gen, device=dev)
    k, v = (torch.randn(B, C, K, hd, generator=gen, device=dev) for _ in range(2))
    slots = torch.zeros((C,), dtype=torch.int32, device=dev)
    qp = torch.tensor([100], dtype=torch.int32, device=dev)
    b4d_ms, plain_ms = in_turns(lambda: swa_decode_ref(q, k, v, slots, qp),
                                lambda: swa_decode(q, k, v, slots, qp))
    b4_ms = cuda_ms(lambda: swa_attention_fwd(q, k, v, 0, C))
    o_b4d = swa_decode(q, k, v, slots, qp)
    o_b4, _ = swa_attention_fwd(q, k, v, 0, C)
    torch.testing.assert_close(o_b4, o_b4d, rtol=ATTN_TOL, atol=ATTN_TOL,
                               msg="[audio] the decode cross routes")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt)

    lib_ms = cuda_ms(library)
    ops, nbytes = decode_work(B, C, H, K, hd, C, C)
    by_ops, by_bytes = ops / F32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    r = dict(ms=b4d_ms, b4_route_ms=b4_ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(by_ops, by_bytes),
             bound_by="operations" if by_ops >= by_bytes else "bytes",
             ops=ops, bytes=nbytes, shape=[B, C, H, K, hd],
             route="B4d" if b4d_ms <= b4_ms else "B4 at Sq = 1 (faster here; the port takes B4d)")
    out["decode cross"] = r
    print(f"[timing] [audio] the decode cross-attention q [{B}, 1, {H}, {hd}] against k, v "
          f"[{B}, {C}, {K}, {hd}], f32, every slot visible, each called eagerly: B4d (every slot "
          f"at position 0, the port's route) {b4d_ms:.4f} ms, B4 at Sq = 1 (prefix {C}) "
          f"{b4_ms:.4f} ms, plain {plain_ms:.4f} ms, library (scaled_dot_product_attention, no "
          f"mask) {lib_ms:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB at 3.35 TB/s) = {100 * r['bound_ms'] / b4d_ms:.1f}% for B4d, "
          f"{100 * r['bound_ms'] / b4_ms:.1f}% for B4; card {card}")
    reset_launches()
    return out


def audio_unit_params(spec):
    """(an encoder unit's, a decoder unit's) parameters: q, k, v, o and a
    norm per attention block (the decoder's second is the cross-attention),
    the GELU MLP (w1, w2) and its norm."""
    d, ff = spec.d_model, spec.d_ff
    attn = 4 * d * spec.num_heads * spec.hd + d
    mlp = 2 * d * ff + d
    return attn + mlp, 2 * attn + mlp


def audio_reckoning(spec, plan, enc_tokens: int, dec_tokens: int) -> dict:
    """The memory an Engine-B step needs, reckoned before the run: the
    parameters each tier's entities hold (tier 1 also the embedding, the
    frames' projection and the encoder positions; the top tier the head);
    the activations the backward keeps: an encoder unit about 18 tensors of
    [tokens, d] f32 (the normed input, q, k, v, o and the attention's
    statistics, the MLP's input) and the MLP's two [tokens, d_ff] (its
    product and its GELU), a decoder unit about 24 [tokens, d] and two
    [tokens, d_ff] of its own, and its cross-attention's k and v of the
    encoder's tokens; the logits with their softmax and gradient [text
    tokens, padded_vocab] x 3.  The SGD update holds the params, the
    gradients and the new params, 3 x the params."""
    from repro_torch.models.model import enc_dec_range

    d, ff = spec.d_model, spec.d_ff
    enc, dec = audio_unit_params(spec)
    frontend = spec.padded_vocab * d + d * d + spec.encoder_len * d
    head = d + d * spec.padded_vocab
    ne = spec.encoder_layers
    held = 0
    for m in range(plan.M):
        lo, hi = plan.tier_bounds(m)
        (e_lo, e_hi), (d_lo, d_hi) = enc_dec_range(lo, hi, ne)
        n_enc, n_dec = e_hi - e_lo, d_hi - d_lo
        held += plan.entities[m] * (n_enc * enc + n_dec * dec + (frontend if m == 0 else 0)
                                    + (head if m == plan.M - 1 else 0))
    acts = 4 * (spec.encoder_layers * enc_tokens * (18 * d + 2 * ff)
                + spec.num_layers * (dec_tokens * (24 * d + 2 * ff) + 2 * enc_tokens * d))
    logits = 3 * dec_tokens * spec.padded_vocab * 4
    backward, update = 2 * 4 * held + acts + logits, 3 * 4 * held
    return dict(unit_enc=enc, unit_dec=dec, frontend=frontend, head=head, held=held,
                activations=acts, logits=logits, backward=backward, update=update,
                total=max(backward, update))


def audio_cell(card: str, attn_times):
    """whisper-large-v3 at full width and depth through Engine B: N=4, J2=2,
    batch 1, 1500 frames and 448 text tokens a client, cuts (2, 32),
    intervals (2, 2, 1), SGD 5e-4, 4 rounds from a seeded init drawn on the
    card (``engine_b_cell``).  B4 and both B5 passes launch 96 times a round
    (32 encoder, 32 decoder self-, 32 cross-attention), B1 as
    ``engine_b_fed`` predicts; the peak at most 70 GB, beside
    ``audio_reckoning``; the round's ms and the attention kernels' share of
    it."""
    from repro_torch.configs import get_spec
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel
    from repro_torch.optim import sgd

    spec = get_spec(AUDIO_ARCH)
    model = SplittableModel(spec)
    N, b = AUDIO_N, AUDIO_BATCH
    plan = default_plan(spec.n_units, N, cuts=AUDIO_CUTS, intervals=AUDIO_INTERVALS,
                        entities=(N, AUDIO_EDGES, 1))
    reckoned = audio_reckoning(spec, plan, N * b * spec.encoder_len, N * b * AUDIO_TEXT)
    cell = dict(b=b, seq=AUDIO_TEXT, rounds=AUDIO_ROUNDS, init_seed=35, batch_seed=36)
    got, out = engine_b_cell("[audio]", model, plan, sgd(AUDIO_LR), cell, reckoned,
                             audio_attention_layers(spec), AUDIO_PEAK_LIMIT)
    per_layer = {label: sum(attn_times[label][n]["ms"] for n in ATTN) for label in AUDIO_ATTN}
    attn_ms = (spec.encoder_layers * per_layer["encoder"]
               + spec.num_layers * (per_layer["decoder self"] + per_layer["cross"]))
    out.update(attention_ms=attn_ms, attention_share=attn_ms / out["round_ms"],
               attention_ms_by_layer=per_layer)
    n_params = (reckoned["frontend"] + spec.encoder_layers * reckoned["unit_enc"]
                + spec.num_layers * reckoned["unit_dec"] + reckoned["head"])
    print(f"[audio] whisper-large-v3 at full width and depth through Engine B "
          f"({spec.encoder_layers} encoder + {spec.num_layers} decoder units, d {spec.d_model}, "
          f"{spec.num_heads} heads of hd {spec.hd}, {n_params} params in the model's tree "
          f"(the spec's analytic count, {spec.total_param_count()}, prices SwiGLU MLPs); "
          f"N={N}, J2={AUDIO_EDGES}, batch {b}, {spec.encoder_len} frames + "
          f"{AUDIO_TEXT} text tokens a client; cuts {plan.cuts}, intervals {plan.intervals}, "
          f"SGD {AUDIO_LR}): launches {got} as the plan and depth imply; losses "
          f"{[round(v, 4) for v in out['losses']]}; every param finite; Engine B holds "
          f"{out['held']} params ({out['held'] * 4 / 1e9:.2f} GB f32); reckoned "
          f"{reckoned['total'] / 1e9:.2f} GB, measured peak {out['peak'] / 1e9:.2f} GB (limit "
          f"70); rounds {[round(v, 1) for v in out['rounds_ms']]} ms, median (rounds 2 on) "
          f"{out['round_ms']:.2f} ms, of which B4 + B5 {attn_ms:.2f} ms ({spec.encoder_layers} x "
          f"{per_layer['encoder']:.4f} encoder + {spec.num_layers} x "
          f"({per_layer['decoder self']:.4f} self + {per_layer['cross']:.4f} cross) ms, each "
          f"timed alone at the tiers' shape) = {100 * out['attention_share']:.1f}%; card {card}")
    return got, out


def audio_twin(card: str):
    """Engine A against Engine B from one init at full width, 4 encoder and 4
    decoder units (N=4, J2=2, cuts (2, 4): the client tier holds the
    frontend and 2 encoder units, the edges the other 2, the cloud the
    decoder; the cell's batches, SGD, 4 rounds), through ``engine_twin``.
    Held at JAX's own A == B tolerance: losses rtol 1e-5,
    ``engine_b_to_full`` against A's params atol 5e-6 / rtol 1e-4.  (Engine
    A at full depth would hold 4 replicas of 1.6 B parameters, their
    gradients and the new params: ~77 GB.)"""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.core import default_plan
    from repro_torch.models import SplittableModel
    from repro_torch.optim import sgd

    spec = dataclasses.replace(get_spec(AUDIO_ARCH), num_layers=AUDIO_TWIN_LAYERS,
                               encoder_layers=AUDIO_TWIN_LAYERS)
    model = SplittableModel(spec)
    N = AUDIO_N
    plan = default_plan(spec.n_units, N, cuts=AUDIO_TWIN_CUTS, intervals=AUDIO_INTERVALS,
                        entities=(N, AUDIO_EDGES, 1))
    torch.cuda.empty_cache()
    inits = [card_init(model, 37)]
    batches = vlm_batches(spec, N, AUDIO_BATCH, AUDIO_TEXT, AUDIO_ROUNDS, 38, serve_device())
    counts, out = engine_twin("[audio]", "audio-whisper-large-v3-twin", model, plan,
                              sgd(AUDIO_LR), inits, batches, audio_attention_layers(spec),
                              (AUDIO_LOSS_RTOL, AUDIO_ATOL, AUDIO_RTOL))
    print(f"[audio] whisper-large-v3 twin at full width, {AUDIO_TWIN_LAYERS} encoder + "
          f"{AUDIO_TWIN_LAYERS} decoder units (N={N}, cuts {plan.cuts}): Engine A first, then B "
          f"from the same init; losses A {[round(v, 6) for v in out['losses_a']]} B "
          f"{[round(v, 6) for v in out['losses_b']]}, largest relative gap "
          f"{out['loss_rtol']:.3e} (rtol {AUDIO_LOSS_RTOL}); engine_b_to_full within atol "
          f"{AUDIO_ATOL} / rtol {AUDIO_RTOL} of A (max |diff| {out['worst']:.3e}); launches A "
          f"{counts['audio-whisper-large-v3-twin-a']}, B {counts['audio-whisper-large-v3-twin-b']}"
          f" as the plan implies; round ms A {out['round_ms_a']:.2f}, B {out['round_ms_b']:.2f} "
          f"(median of rounds 2 on); peak {out['peak'] / 1e9:.2f} GB; card {card}")
    return counts, out


def audio_reduced_card_vs_cpu(rounds: int = AUDIO_REDUCED_ROUNDS):
    """REDUCED whisper, Engine A and Engine B, N=4, J2=2, batch 2, 16 frames
    and 32 text tokens, cuts (1, 2) (inside the encoder, at the enc/dec
    boundary), 3 rounds from one init and NumPy batches, on the card and on
    the CPU (``reduced_card_vs_cpu``): losses rtol 1e-4; the card's launches
    as the plan implies.  Then 6 decode steps with the same non-zero cross
    caches on both: logits at a max-normalised 1e-4."""
    import numpy as np
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.core import default_plan
    from repro_torch.kernels.swa_attention import decode_launches
    from repro_torch.models import SplittableModel

    spec = get_reduced(AUDIO_ARCH)
    model = SplittableModel(spec)
    N, b, text = AUDIO_N, AUDIO_REDUCED_BATCH, AUDIO_REDUCED_TEXT
    plan = default_plan(spec.n_units, N, cuts=(1, 2), intervals=(2, 2, 1),
                        entities=(N, AUDIO_EDGES, 1))
    p0 = model.init_params(torch.Generator().manual_seed(0), torch.device("cpu"))
    rng = np.random.default_rng(0)
    batches = [{
        "frames": rng.normal(size=(N, b, spec.encoder_len, spec.d_model)).astype(np.float32),
        "tokens": rng.integers(0, spec.vocab_size, (N, b, text)).astype(np.int32),
        "labels": rng.integers(0, spec.vocab_size, (N, b, text)).astype(np.int32),
    } for _ in range(rounds)]
    losses, counts = reduced_card_vs_cpu("[audio]", "audio-whisper-large-v3-reduced", model, plan,
                                         p0, batches, audio_attention_layers(spec),
                                         AUDIO_CARD_RTOL)
    steps, cross = 6, rng.normal(size=(2, spec.num_layers, 2, spec.encoder_len,
                                       spec.num_kv_heads, spec.hd)).astype(np.float32)
    toks = torch.from_numpy(rng.integers(0, spec.vocab_size, (2, steps)).astype(np.int32))
    logits = {}
    for name in ("cuda", "cpu"):
        device = torch.device(name)
        params = tree_map(lambda x: x.to(device), p0)
        caches = model.init_caches(2, 8, device)
        for i, key in enumerate(("xk", "xv")):
            caches[key].copy_(torch.from_numpy(cross[i]))
        reset_all_launches()
        out = []
        with torch.no_grad():
            for i in range(steps):
                step_logits, caches = model.decode_step(params, toks[:, i:i + 1].to(device),
                                                        caches, i)
                out.append(step_logits.float().cpu())
        if name == "cuda":
            counts["audio-whisper-large-v3-reduced-decode"] = {DECODE: decode_launches[DECODE]}
            if decode_launches[DECODE] != steps * 2 * spec.num_layers:
                raise AssertionError(f"[audio] REDUCED decode: {decode_launches[DECODE]} B4d "
                                     f"launches, not {steps} steps x {2 * spec.num_layers}")
        logits[name] = torch.stack(out, 1)
    dec_err = norm_err(logits["cuda"], logits["cpu"], spec.vocab_size)
    if not dec_err <= AUDIO_CARD_RTOL:
        raise AssertionError(f"[audio] REDUCED decode card against CPU: {dec_err:.3e}")
    print(f"[audio] REDUCED whisper-large-v3 (N={N}, batch {b}, {spec.encoder_len} frames + "
          f"{text} tokens, cuts {plan.cuts}, {rounds} rounds) on the card against the CPU: "
          + "; ".join(f"Engine {e.upper()} cuda {losses[(e, 'cuda')]} cpu {losses[(e, 'cpu')]}"
                      for e in ("a", "b"))
          + f" (rtol {AUDIO_CARD_RTOL}); {steps} decode steps with non-zero cross caches "
          f"within {dec_err:.3e} (max-normalised); launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return counts


def serve_whisper(card: str):
    """whisper-large-v3 decoding at full width and depth through
    ``decode_step`` (both CLIs refuse audio, as the JAX package's do), with
    random weights drawn on the card: batch 8, a cache of 128, the cross
    caches [8, 1500, 20, 64] a layer filled with standard normal values
    (nothing in either package fills them from an encoder), 4 warm-up steps,
    then 64 timed (CUDA events); each step launches B4d 32 times for the
    decoder's self-attention and 32 times for its cross-attention, the
    latter read apart: the B4d launches made inside each call of
    ``layers._cross_attention``; ms a step, tok/s, peak; the logits
    finite."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.kernels.swa_attention import decode_launches
    from repro_torch.models import SplittableModel
    from repro_torch.models import layers as L

    spec = get_spec(AUDIO_ARCH)
    model = SplittableModel(spec)
    dev = serve_device()
    B, C = AUDIO_DECODE_B, AUDIO_DECODE_C
    params = card_init(model, 39)
    caches = model.init_caches(B, C, dev)
    gen = torch.Generator(device=dev).manual_seed(40)
    for key in ("xk", "xv"):
        caches[key].normal_(generator=gen)
    steps = AUDIO_DECODE_WARM + AUDIO_DECODE_STEPS
    toks = torch.randint(0, spec.vocab_size, (B, steps), generator=gen, device=dev,
                         dtype=torch.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    finite = True
    cross_attention, cross = L._cross_attention, [0]

    def counted(*args, **kwargs):
        before = decode_launches[DECODE]
        out = cross_attention(*args, **kwargs)
        cross[0] += decode_launches[DECODE] - before
        return out

    L._cross_attention = counted
    try:
        with torch.no_grad():
            for i in range(steps):
                if i == AUDIO_DECODE_WARM:
                    torch.cuda.synchronize()
                    reset_all_launches()
                    cross[0] = 0
                    start.record()
                logits, caches = model.decode_step(params, toks[:, i:i + 1], caches, i)
                finite &= bool(torch.isfinite(logits[:, : spec.vocab_size]).all())
        end.record()
        torch.cuda.synchronize()
    finally:
        L._cross_attention = cross_attention
    got, got_cross = decode_launches[DECODE], cross[0]
    want = spec.num_layers * AUDIO_DECODE_STEPS
    if (got - got_cross, got_cross) != (want, want):
        raise AssertionError(f"[audio] decode: B4d launched {got - got_cross} times for the "
                             f"self-attention and {got_cross} for the cross-attention, "
                             f"{spec.num_layers} each a step x {AUDIO_DECODE_STEPS} steps "
                             f"make {want}")
    if not finite:
        raise AssertionError("[audio] decode: non-finite logits")
    ms = start.elapsed_time(end) / AUDIO_DECODE_STEPS
    res = {"ms_per_step": ms, "tok_s": B / (ms / 1e3), "peak": torch.cuda.max_memory_allocated(),
           "launches": got, "launches_cross": got_cross}
    del params, caches
    torch.cuda.empty_cache()
    print(f"[audio] whisper-large-v3 decoding at full width ({spec.num_layers} decoder units, "
          f"random weights drawn on the card): batch {B}, cache {C}, cross caches "
          f"[{B}, {spec.encoder_len}, {spec.num_kv_heads}, {spec.hd}] a layer, "
          f"{AUDIO_DECODE_WARM} warm-up + {AUDIO_DECODE_STEPS} timed steps: "
          f"{res['ms_per_step']:.3f} ms a step (CUDA events, the logits checked finite each "
          f"step), {res['tok_s']:.1f} tok/s, peak {res['peak'] / 1e9:.2f} GB; B4d {got} "
          f"launches: {got - got_cross} self-attention + {got_cross} counted inside the "
          f"cross-attention calls = ({spec.num_layers} + {spec.num_layers}) x "
          f"{AUDIO_DECODE_STEPS} steps; card {card}")
    return res


def audio_paths(card: str):
    """The ``[audio]`` phase: B4/B5 and the decode cross route against their
    plain versions at the cell's shapes, and timed; the full-width,
    full-depth Engine-B cell; its 4 + 4-unit Engine-A twin; REDUCED whisper
    on the card against the CPU (both engines and decoding); decoding at
    full width."""
    import torch

    t0 = time.perf_counter()
    errs, cross_errs = check_audio_attention()
    attn_times = audio_attention_timings(card)
    counts, out = {}, {"attention": attn_times, "errors": errs, "cross_errors": cross_errs}
    with expandable_segments():
        counts["audio-whisper-large-v3"], out["audio-whisper-large-v3"] = audio_cell(
            card, attn_times)
        twin_counts, out["audio-whisper-large-v3-twin"] = audio_twin(card)
    counts.update(twin_counts)
    counts.update(audio_reduced_card_vs_cpu())
    out["serve"] = serve_whisper(card)
    counts["audio-whisper-large-v3-serve"] = {DECODE: out["serve"]["launches"]}
    counts["audio-whisper-large-v3-serve-cross"] = {DECODE: out["serve"]["launches_cross"]}
    for path in ("audio-whisper-large-v3", "audio-whisper-large-v3-reduced-b"):
        for name in (AGG[0],) + ATTN:
            if counts[path][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[timing] [audio] whisper-large-v3 through Engine B: median round "
          f"{out['audio-whisper-large-v3']['round_ms']:.2f} ms, peak "
          f"{out['audio-whisper-large-v3']['peak'] / 1e9:.2f} GB; decoding "
          f"{out['serve']['ms_per_step']:.3f} ms a step; phase {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated; card {card}")
    return counts, out


# --------------------------------------------------------------------------- #
# [serve]: decoding at full width (ROADMAP A14.3)
# --------------------------------------------------------------------------- #

DECODE = "swa_decode"
SOURCES[DECODE] = "src/repro_torch/kernels/swa_attention/csrc/swa_decode.cu"
# B4d replaces no TPU kernel: the jnp _sdpa of attention's cache branch
REPLACES[DECODE] = "src/repro/models/layers.py:280"
# the serve cells: batch 8, prompt 64, gen 64, cache-len 128
SERVE_B, SERVE_P, SERVE_G, SERVE_C = 8, 64, 64, 128
# teacher-forced decode logits against the forward on the same tokens,
# max-normalised: max |decode - forward| <= SERVE_TF_TOL * max |forward|
SERVE_TF_TOL = 1e-4
# smollm-135m's ring on the card: window 32, cache 32, 96 steps
SERVE_RING = (32, 32, 96)
# mamba2-1.3b's 48 blocks at init: f32 evaluations land far from the float64
# one (ROADMAP §C), so its decode is held to at most twice the f32 forward's
# distance from the float64 forward
SERVE_F64_FACTOR = 2.0
# a routing flip between decode and forward must be a near-tie: the
# forward's k-th/(k+1)-th gate margin under this
SERVE_FLIP_MARGIN = 1e-5
# B4d timed at the smollm-135m serve shape (its main path), qwen2-1.5b's
# heads at a long cache (f32 and bf16, full and filled to q_pos 1023: an
# eighth of its tiles visible) and at C 1024, where the split count changes:
# label -> ((B, C, H, K, hd), dtype, q_pos of a partly filled cache or None
# for every slot filled and visible)
DECODE_TIMED = {
    "serve": ((8, 128, 9, 3, 64), "f32", None),
    "long cache": ((8, 8192, 12, 2, 128), "f32", None),
    "long cache bf16": ((8, 8192, 12, 2, 128), "bf16", None),
    "long cache filled to 1023": ((8, 8192, 12, 2, 128), "f32", 1023),
    "C 1024": ((8, 1024, 12, 2, 128), "f32", None),
    # paligemma-3b's serve cell: hd 256, 8 query heads on one kv head
    "paligemma serve": ((8, 128, 8, 1, 256), "f32", None),
}
# qwen2-1.5b served from a full long cache: batch 8, slots 0..8191 filled,
# then 4 warm-up and 64 timed decode steps (8192 + 68 slots)
SERVE_LONG_B, SERVE_LONG_FILLED, SERVE_LONG_WARM, SERVE_LONG_TIMED = 8, 8192, 4, 64
SERVE_CKPT = ROOT / "build" / "chip_smoke" / "smollm-135m-trained.npz"


def serve_device():
    """The device of the ``[serve]`` phase: the card."""
    import torch

    return torch.device("cuda", 0)


def card_init(model, seed: int):
    """``model.init_params`` with its random draws made on the card from a
    CUDA generator (the card as the default device): the port's own init,
    without drawing 1.5 B numbers on one host thread."""
    import torch

    dev = serve_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with dev:
        return model.init_params(gen, dev)


def decode_shapes():
    """(B, C, H, K, hd) of every B4d check: the three serve cells, the ring,
    each ported attention arch's REDUCED heads, and the long cache."""
    from repro_torch.configs import ARCH_IDS, get_reduced, get_spec

    shapes = [(SERVE_B, SERVE_C, s.num_heads, s.num_kv_heads, s.hd)
              for s in map(get_spec, ("smollm-135m", "qwen2-1.5b", ZOO_MOE, VLM_ARCH))]
    shapes.append((SERVE_B, SERVE_RING[1], 9, 3, 64))
    shapes += [(8, 64, s.num_heads, s.num_kv_heads, s.hd) for s in map(get_reduced, ARCH_IDS)
               if s.family != "ssm"]
    shapes += [shape for shape, _, _ in DECODE_TIMED.values()]
    return sorted(set(shapes))


def slot_positions(kind: str, C: int, q_pos: int, dev):
    """cache_pos of C slots read at position q_pos: partly filled (0..q_pos,
    the rest -1), a wrapped ring (slot p % C holds p), or all ahead of the
    query (every slot masked)."""
    import torch

    if kind == "partly filled":
        pos = torch.where(torch.arange(C) <= q_pos, torch.arange(C), -1)
    elif kind == "wrapped":
        pos = torch.roll(torch.arange(q_pos + 1 - C, q_pos + 1), (q_pos + 1) % C)
    else:
        pos = torch.arange(C) + q_pos + 1
    return pos.to(device=dev, dtype=torch.int32)


def decode_heads_a_warp(G: int, hd: int) -> int:
    """The query heads a warp of B4d's split kernel takes (its HPW): one up
    to G = 4 and at hd 256, else two."""
    return 1 if G <= 4 or hd > 128 else 2


def decode_build_report(source) -> dict:
    """ptxas's registers and spills of each B4d instantiation: the split
    kernel (5 head dims x 1 or 2 query heads a warp, and hd 256 at one, x
    f32, bf16) and the merge kernel (f32, bf16); fails on a spill."""
    from repro_torch.kernels import build

    def dt(mangled: str) -> str:
        return "f32" if mangled == "f" else "bf16"

    report, key = {}, None
    for line in build.build_log(source).read_text().splitlines():
        m = re.search(r"Compiling entry function '\S*swa_decode_kernelILi(\d+)ELi(\d+)E"
                      r"(f|13__nv_bfloat16)", line)
        m2 = re.search(r"Compiling entry function '\S*swa_decode_merge_kernelI"
                       r"(f|13__nv_bfloat16)E", line)
        if m:
            key = f"swa_decode_kernel<{m.group(1)}, {m.group(2)}, {dt(m.group(3))}>"
        elif m2:
            key = f"swa_decode_merge_kernel<{dt(m2.group(1))}>"
        elif key and "Used" in line:
            report.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        elif key and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line).groups()
            report.setdefault(key, {}).update(spill_stores=int(stores), spill_loads=int(loads))
    if len(report) != 24:
        raise AssertionError(f"B4d: {len(report)} kernel instantiations in the build log, not 24")
    print("[build] B4d (swa_decode_kernel, swa_decode_merge_kernel) registers / spill stores: "
          + ", ".join(f"{k} {r['registers']} / {r['spill_stores']} B" for k, r in report.items())
          + "; a call launches the split kernel, then the merge kernel when S > 1")
    spilled = [k for k, r in report.items() if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"B4d: ptxas spills in {spilled}")
    return report


def check_decode_attention():
    """B4d against its plain version on the card, on the same inputs: every
    shape of ``decode_shapes``, a partly filled cache, a wrapped ring and an
    all-masked row, windows 0 and 32, f32 (rtol = atol ATTN_TOL) and bf16
    (within one bf16 ulp beyond it, against the f32 plain version on the
    same bf16 inputs); an all-masked row is NaN in both."""
    import torch

    from repro_torch.kernels.swa_attention import reset_launches, swa_decode, swa_decode_ref

    dev = serve_device()
    gen = torch.Generator(device=dev).manual_seed(5)
    errs, n = {"f32": 0.0, "bf16": 0.0}, 0
    for B, C, H, K, hd in decode_shapes():
        for kind, q_pos in (("partly filled", C // 2), ("wrapped", 2 * C + 5),
                            ("all masked", C // 2)):
            for W in (0, 32):
                for dtype in (torch.float32, torch.bfloat16):
                    q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
                    k, v = (torch.randn(B, C, K, hd, generator=gen, device=dev).to(dtype)
                            for _ in range(2))
                    pos = slot_positions(kind, C, q_pos, dev)
                    qp = torch.tensor([q_pos], dtype=torch.int32, device=dev)
                    o = swa_decode(q, k, v, pos, qp, W)
                    torch.cuda.synchronize()
                    ref = swa_decode_ref(q.float(), k.float(), v.float(), pos, qp, W)
                    what = f"B4d B={B} C={C} H={H} K={K} hd={hd} {kind} window={W} {dtype}"
                    if kind == "all masked":
                        if not (bool(torch.isnan(o).all()) and bool(torch.isnan(ref).all())):
                            raise AssertionError(f"{what}: not NaN as the plain version")
                        continue
                    err = (o.float() - ref).abs()
                    tol = ATTN_TOL + ATTN_TOL * ref.abs()
                    if dtype == torch.bfloat16:
                        tol = tol + bf16_ulp(ref)
                    if not bool((err <= tol).all()):
                        raise AssertionError(f"{what}: {int((err > tol).sum())} elements beyond "
                                             f"the tolerance, max |err| {float(err.max()):.3e}")
                    key = "f32" if dtype == torch.float32 else "bf16"
                    errs[key] = max(errs[key], float(err.max()))
                    n += 1
    reset_launches()
    print(f"[serve] B4d against its plain version: {len(decode_shapes())} shapes x (partly "
          f"filled, wrapped, all masked) x windows (0, 32) x (f32, bf16), {n} compared and "
          f"the all-masked rows NaN in both; f32 within rtol=atol {ATTN_TOL} (max |err| "
          f"{errs['f32']:.3e}), bf16 within one bf16 ulp beyond it (max |err| "
          f"{errs['bf16']:.3e})")
    return errs


def norm_err(got, ref, V: int) -> float:
    """max |got - ref| / max |ref| over the first V logits."""
    ref = ref[..., :V].double()
    return float((got[..., :V].double() - ref).abs().max() / ref.abs().max())


def forward_logits(model, params, tokens):
    import torch

    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": tokens})
    return logits.float()


def teacher_forced(model, params, tokens, cache_len: int):
    """Every decode step's logits [B, S, padded_vocab] over ``tokens``."""
    import torch

    caches = model.init_caches(tokens.shape[0], cache_len, tokens.device)
    out = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            logits, _ = model.decode_step(params, tokens[:, i : i + 1], caches, i)
            out.append(logits.float())
    return torch.stack(out, dim=1)


def serve_prompt(vocab: int, seed: int = 23):
    import torch

    return torch.randint(0, vocab, (SERVE_B, SERVE_P), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32).to(serve_device())


def attention_layers(spec) -> int:
    """Attention layers a decode step runs: one a unit, none for SSM."""
    return 0 if spec.family == "ssm" else spec.n_units


def serve_generate(label: str, model, params, prompt, card: str):
    """``launch.serve.generate`` at the serve shape (prompt 64, gen 64,
    cache 128, greedy), its logits kept, after a 4-step warm-up (the
    first use of each kernel and matmul shape): B4d's launches counted
    from 0 and held to attention layers x steps, ms a decode step (CUDA
    events), tok/s and peak device memory."""
    import torch

    from repro_torch.kernels.swa_attention import decode_launches
    from repro_torch.launch.serve import generate

    generate(model, params, prompt[:, :2], 2, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run = generate(model, params, prompt, SERVE_G, SERVE_C, keep_logits=True)
    end.record()
    torch.cuda.synchronize()
    steps = SERVE_P + SERVE_G
    got = decode_launches[DECODE]
    want = attention_layers(model.spec) * steps
    if got != want:
        raise AssertionError(f"{label}: {got} B4d launches, {attention_layers(model.spec)} "
                             f"attention layers x {steps} steps make {want}")
    if not bool(torch.isfinite(run.logits[..., : model.spec.vocab_size]).all()):
        raise AssertionError(f"{label}: non-finite logits")
    ms = start.elapsed_time(end)
    res = {"ms_per_step": ms / steps, "tok_s": SERVE_B * steps / (ms / 1e3),
           "peak": torch.cuda.max_memory_allocated(), "launches": got}
    print(f"[serve] {label}: batch {SERVE_B}, prompt {SERVE_P}, gen {SERVE_G}, cache "
          f"{SERVE_C}: {res['ms_per_step']:.3f} ms a decode step (CUDA events, logits kept), "
          f"{res['tok_s']:.1f} tok/s, peak {res['peak'] / 1e9:.2f} GB; B4d {got} launches "
          f"= {attention_layers(model.spec)} layers x {steps} steps; card {card}")
    return run, res


def check_teacher_forced(label: str, model, params, run) -> float:
    """The run's decode logits against the forward on the tokens it fed."""
    e = norm_err(run.logits, forward_logits(model, params, run.fed), model.spec.vocab_size)
    if not e <= SERVE_TF_TOL:
        raise AssertionError(f"{label}: teacher-forced decode {e:.3e} (max-normalised) from "
                             f"the forward, above {SERVE_TF_TOL}")
    print(f"[serve] {label}: teacher-forced decode within {e:.3e} of the forward's logits "
          f"(max-normalised; tolerance {SERVE_TF_TOL}) at all {run.fed.shape[1]} positions")
    return e


def save_trained_lm(lm_run) -> Path:
    """The full-width smollm-135m state that ``lm_main_path`` trained,
    client-stacked, through the port's ``save_checkpoint``."""
    from repro_torch.checkpoint import save_checkpoint

    t = time.perf_counter()
    plan = lm_run["plan"]
    save_checkpoint(str(SERVE_CKPT), lm_run["state"].params, step=lm_run["state"].step,
                    meta={"cuts": list(plan.cuts), "intervals": list(plan.intervals)})
    print(f"[serve] saved the trained smollm-135m state ({plan.num_clients} client rows) to "
          f"{SERVE_CKPT.relative_to(ROOT)} in {time.perf_counter() - t:.1f} s")
    return SERVE_CKPT


def serve_trained_smollm(ckpt: Path, card: str):
    """The smollm-135m that the main path trained, restored from its
    client-stacked checkpoint through ``load_serving_params`` (every client
    row equal first), served, and held to its forward."""
    import numpy as np
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.launch.serve import load_serving_params
    from repro_torch.models import SplittableModel

    spec = get_spec("smollm-135m")
    model = SplittableModel(spec)
    with np.load(ckpt) as z:
        names = [k for k in z.files if k != "__meta__"]
        rows = {z[k].shape[0] for k in names}
        assert_replicas_equal(((k, z[k]) for k in names), "the trained smollm-135m checkpoint")
        wq0 = torch.from_numpy(z["units/attn/wq"][0])
    params = load_serving_params(str(ckpt), card_init(model, 99))
    if not torch.equal(params["units"]["attn"]["wq"].cpu(), wq0):
        raise AssertionError("load_serving_params did not restore row 0 of the checkpoint")
    print(f"[serve] smollm-135m: {len(names)} leaves of {rows} client rows, every row equal; "
          f"row 0 restored through load_serving_params")
    run, res = serve_generate("smollm-135m (trained by the main path)", model, params,
                              serve_prompt(spec.vocab_size), card)
    res["tf_err"] = check_teacher_forced("smollm-135m", model, params, run)
    ckpt.unlink()
    return model, params, res


def serve_ring(model, params, card: str):
    """smollm-135m under a window of 32 with a 32-slot cache over 96 steps:
    the ring wraps twice on the card, and the decode equals the windowed
    forward (B4 at window 32) at every position."""
    import torch

    from repro_torch.kernels.swa_attention import decode_launches
    from repro_torch.models import SplittableModel

    W, C, S = SERVE_RING
    mw = SplittableModel(model.spec.with_window(W))
    toks = torch.randint(0, mw.spec.vocab_size, (SERVE_B, S),
                         generator=torch.Generator().manual_seed(31)).to(serve_device())
    reset_all_launches()
    dec = teacher_forced(mw, params, toks, C)
    torch.cuda.synchronize()
    got = decode_launches[DECODE]
    if got != mw.spec.n_units * S:
        raise AssertionError(f"ring: {got} B4d launches, not {mw.spec.n_units * S}")
    e = norm_err(dec, forward_logits(mw, params, toks), mw.spec.vocab_size)
    if not (e <= SERVE_TF_TOL and bool(torch.isfinite(dec).all())):
        raise AssertionError(f"ring: decode {e:.3e} from the windowed forward")
    print(f"[serve] smollm-135m window {W}, cache {C}, {S} steps (the ring wraps at 32 and "
          f"64): decode within {e:.3e} of the windowed forward (max-normalised; tolerance "
          f"{SERVE_TF_TOL}), finite; B4d {got} launches; card {card}")
    return {"tf_err": e, "launches": got}


def serve_qwen(card: str):
    """qwen2-1.5b, the JAX CLI's default arch, at full width and depth with
    random weights: served, and held to its forward; then the same weights
    decode from a full long cache (``serve_long_cache``)."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models import SplittableModel

    spec = get_spec("qwen2-1.5b")
    model = SplittableModel(spec)
    params = card_init(model, 15)
    run, res = serve_generate(f"qwen2-1.5b ({spec.total_param_count()} params, random)",
                              model, params, serve_prompt(spec.vocab_size), card)
    res["tf_err"] = check_teacher_forced("qwen2-1.5b", model, params, run)
    del run
    torch.cuda.empty_cache()
    long = serve_long_cache(model, params, card)
    del params
    torch.cuda.empty_cache()
    return res, long


def serve_paligemma(card: str):
    """paligemma-3b at full width and depth with random weights drawn on
    the card, served at the serve shape: the VLM decodes its text as a
    dense model (the JAX package's decode: no image prefix, no √d scale), so
    its decode is held to the forward of the same weights under
    ``family="dense", prefix_len=0``; B4d at hd 256, one kv head."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.models import SplittableModel

    spec = get_spec(VLM_ARCH)
    model = SplittableModel(spec)
    params = card_init(model, 29)
    run, res = serve_generate(f"paligemma-3b ({spec.total_param_count()} params, random; hd "
                              f"{spec.hd}, {spec.num_heads} heads on {spec.num_kv_heads} kv head)",
                              model, params, serve_prompt(spec.vocab_size), card)
    twin = SplittableModel(dataclasses.replace(spec, family="dense", prefix_len=0))
    res["tf_err"] = check_teacher_forced("paligemma-3b against its dense twin's forward", twin,
                                         params, run)
    del run, params
    torch.cuda.empty_cache()
    return res


def serve_long_cache(model, params, card: str):
    """A timing cell: the model decodes at batch 8 from a full cache of
    8192 slots (a quarter of the 32 768 tokens qwen2-1.5b's config allows).
    Slots 0..8191 of every layer's k and v are filled in place with seeded
    normal values at the scale of the model's own k and v (their std per
    layer after one decode step on a one-slot cache), positions 0..8191,
    each index 8192.  The first of 4 warm-up steps (positions 8192..8195)
    is held, within SERVE_TF_TOL max-normalised, to the same step on a copy
    of the caches with ``layers.swa_decode`` replaced by ``swa_decode_ref``
    for that step alone (the replacement lives here, never in the program);
    then 64 steps (8196..8259) are timed with CUDA events, B4d's launches
    counted from 0 (one a layer a step), and B4d's share of a step read as
    launches x its events-timed ms on the last step's cache."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.kernels.swa_attention import decode_launches, swa_decode, swa_decode_ref
    from repro_torch.models import layers

    B, F, W, T = SERVE_LONG_B, SERVE_LONG_FILLED, SERVE_LONG_WARM, SERVE_LONG_TIMED
    spec, dev = model.spec, serve_device()
    n_layers = attention_layers(spec)
    toks = torch.randint(0, spec.vocab_size, (B, 1 + W + T),
                         generator=torch.Generator().manual_seed(41), dtype=torch.int32).to(dev)
    with torch.no_grad():
        probe = model.init_caches(B, 1, dev)
        model.decode_step(params, toks[:, :1], probe, 0)
        k_std = probe["attn"]["k"].float().flatten(1).std(dim=1).tolist()
        v_std = probe["attn"]["v"].float().flatten(1).std(dim=1).tolist()
        del probe
        caches = model.init_caches(B, F + W + T, dev)
        a = caches["attn"]
        gen = torch.Generator(device=dev).manual_seed(43)
        for u in range(n_layers):
            a["k"][u, :, :F].normal_(generator=gen).mul_(k_std[u])
            a["v"][u, :, :F].normal_(generator=gen).mul_(v_std[u])
        a["positions"][:, :F] = torch.arange(F, dtype=torch.int32, device=dev)
        a["index"].fill_(F)
        copy = tree_map(lambda x: x.clone(), caches)
        logits, _ = model.decode_step(params, toks[:, 1:2], caches, F)
        kernel = layers.swa_decode
        layers.swa_decode = swa_decode_ref
        try:
            ref, _ = model.decode_step(params, toks[:, 1:2], copy, F)
        finally:
            layers.swa_decode = kernel
        del copy
        torch.cuda.empty_cache()
        e = norm_err(logits.float(), ref.float(), spec.vocab_size)
        if not (e <= SERVE_TF_TOL and bool(torch.isfinite(logits[:, : spec.vocab_size]).all())):
            raise AssertionError(f"long cache: the first step's logits {e:.3e} (max-normalised) "
                                 f"from the plain-version step, above {SERVE_TF_TOL}")
        for i in range(1, W):
            model.decode_step(params, toks[:, 1 + i : 2 + i], caches, F + i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(W, W + T):
            logits, _ = model.decode_step(params, toks[:, 1 + i : 2 + i], caches, F + i)
        end.record()
        torch.cuda.synchronize()
    got = decode_launches[DECODE]
    if got != n_layers * T:
        raise AssertionError(f"long cache: {got} B4d launches, {n_layers} layers x {T} steps "
                             f"make {n_layers * T}")
    if not bool(torch.isfinite(logits[:, : spec.vocab_size]).all()):
        raise AssertionError("long cache: non-finite logits")
    ms = start.elapsed_time(end) / T
    peak = torch.cuda.max_memory_allocated()
    q = torch.randn(B, 1, spec.num_heads, spec.hd, generator=torch.Generator(device=dev)
                    .manual_seed(47), device=dev).to(spec.cdtype)
    qp = torch.tensor([F + W + T - 1], dtype=torch.int32, device=dev)
    b4d_ms = cuda_ms(lambda: swa_decode(q, a["k"][0], a["v"][0], a["positions"][0], qp))
    res = {"ms_per_step": ms, "tok_s": B / (ms / 1e3), "peak": peak, "launches": got,
           "first_step_err": e, "b4d_ms": b4d_ms, "b4d_share": n_layers * b4d_ms / ms,
           "cache": [B, F + W + T, spec.num_kv_heads, spec.hd]}
    print(f"[serve] {spec.name} from a full long cache: batch {B}, slots 0..{F - 1} filled, "
          f"cache {F + W + T}, {T} timed steps after {W}: {ms:.3f} ms a decode step (CUDA "
          f"events), {res['tok_s']:.1f} tok/s, peak {peak / 1e9:.2f} GB; B4d {got} launches = "
          f"{n_layers} layers x {T} steps, {b4d_ms:.4f} ms a launch on the last step's cache, "
          f"{n_layers} x that = {100 * res['b4d_share']:.1f}% of a step; the first step within "
          f"{e:.3e} of the plain-version step (max-normalised; tolerance {SERVE_TF_TOL}); "
          f"card {card}")
    del caches, a
    torch.cuda.empty_cache()
    return res


def serve_granite(card: str):
    """granite-moe-1b-a400m at full width: served at its capacity (B4d 24 a
    step); then teacher forcing at capacity E/k, where neither the decode
    batch's 8 tokens nor the forward's 1024 drop a (token, k) pair (at 1.25
    the two compete for different capacities, in JAX as here).  The
    routings of decode and forward are compared token by token: a flip
    must be a near-tie (the forward's k-th/(k+1)-th gate margin under
    SERVE_FLIP_MARGIN), and each row is compared before its first flip."""
    import torch

    from repro_torch.configs import get_spec
    from repro_torch.launch.serve import generate
    from repro_torch.models import SplittableModel
    from repro_torch.models import layers as L

    spec = get_spec(ZOO_MOE)
    model = SplittableModel(spec)
    params = card_init(model, 16)
    prompt = serve_prompt(spec.vocab_size)
    _, res = serve_generate(f"granite-moe-1b-a400m ({spec.total_param_count()} params, "
                            f"random, capacity {spec.moe.capacity_factor})", model, params,
                            prompt, card)
    E, K = spec.moe.num_experts, spec.moe.top_k
    nodrop = SplittableModel(dataclasses.replace(
        spec, moe=dataclasses.replace(spec.moe, capacity_factor=E / K)))
    real, calls = L.moe_route, []

    def recording(p, xg, s):
        probs, gates, ids = real(p, xg, s)
        srt = torch.sort(probs, dim=-1, descending=True).values
        calls.append((torch.sort(ids, dim=-1).values, srt[..., K - 1] - srt[..., K]))
        return probs, gates, ids

    L.moe_route = recording
    try:
        run = generate(nodrop, params, prompt, SERVE_G, SERVE_C, keep_logits=True)
        n_dec = len(calls)
        fwd = forward_logits(nodrop, params, run.fed)
    finally:
        L.moe_route = real
    U, S = spec.n_units, run.fed.shape[1]
    if n_dec != U * S or len(calls) != U * S + U:
        raise AssertionError(f"granite: {n_dec} decode and {len(calls) - n_dec} forward "
                             f"router calls, not {U * S} and {U}")
    dec_ids = torch.stack([torch.stack([calls[i * U + u][0][0] for u in range(U)])
                           for i in range(S)])  # [S, U, B, K]
    fwd_ids = torch.stack([calls[n_dec + u][0][0] for u in range(U)])  # [U, B*S, K]
    fwd_margin = torch.stack([calls[n_dec + u][1][0] for u in range(U)])  # [U, B*S]
    fwd_ids = fwd_ids.reshape(U, SERVE_B, S, K).permute(2, 0, 1, 3)  # [S, U, B, K]
    fwd_margin = fwd_margin.reshape(U, SERVE_B, S).permute(2, 0, 1)
    flip = (dec_ids != fwd_ids).any(-1)  # [S, U, B]
    flips = int(flip.sum())
    if flips and float(fwd_margin[flip].max()) >= SERVE_FLIP_MARGIN:
        raise AssertionError(f"granite: a routing flip at margin {float(fwd_margin[flip].max())}")
    first = torch.full((SERVE_B,), S, dtype=torch.long, device=flip.device)
    for b in range(SERVE_B):
        at = torch.nonzero(flip[:, :, b].any(1)).flatten()
        if at.numel():
            first[b] = at[0]
    keep = torch.arange(S, device=flip.device)[None, :] < first[:, None]  # [B, S]
    V = spec.vocab_size
    diff = (run.logits[..., :V] - fwd[..., :V]).abs().amax(-1)
    e = float(diff[keep].max() / fwd[..., :V][keep].abs().max())
    share = float(keep.float().mean())
    if not (e <= SERVE_TF_TOL and share >= 0.5):
        raise AssertionError(f"granite: teacher-forced decode {e:.3e} from the forward on "
                             f"{100 * share:.1f}% of the positions")
    print(f"[serve] granite-moe-1b-a400m at capacity E/k = {E / K:g}: {flips} of "
          f"{U * S * SERVE_B} (token, layer) routings differ between decode and forward"
          + (f" (largest forward margin {float(fwd_margin[flip].max()):.3g})" if flips else "")
          + f"; teacher-forced decode within {e:.3e} of the forward (max-normalised; tolerance "
          f"{SERVE_TF_TOL}) on {100 * share:.1f}% of the (row, position) pairs, each row "
          f"before its first flip; card {card}")
    res.update(tf_err=e, route_flips=flips, tf_share=share)
    del params, run, fwd
    torch.cuda.empty_cache()
    return res


def serve_mamba(card: str):
    """mamba2-1.3b at full width (48 blocks, no attention: no B4d launch):
    served; its decode logits against the forward's in float64, at most
    SERVE_F64_FACTOR times as far from them as the f32 forward is (or
    within SERVE_TF_TOL of the f32 forward); and its first 2 blocks
    alone, teacher-forced, within SERVE_TF_TOL of their forward."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_spec
    from repro_torch.models import SplittableModel

    spec = get_spec(ZOO_SSM)
    model = SplittableModel(spec)
    params = card_init(model, 17)
    run, res = serve_generate(f"mamba2-1.3b ({spec.total_param_count()} params, random)",
                              model, params, serve_prompt(spec.vocab_size), card)
    V = spec.vocab_size
    fwd = forward_logits(model, params, run.fed)
    f64 = forward_logits(SplittableModel(spec.with_dtypes("float64", "float64")),
                         tree_map(lambda x: x.double(), params), run.fed)
    d_dec, d_fwd, d_df = norm_err(run.logits, f64, V), norm_err(fwd, f64, V), \
        norm_err(run.logits, fwd, V)
    if not (d_dec <= SERVE_F64_FACTOR * d_fwd or d_df <= SERVE_TF_TOL):
        raise AssertionError(f"mamba2: decode {d_dec:.3e} from the float64 forward, the f32 "
                             f"forward {d_fwd:.3e}")
    del params, run, fwd, f64
    torch.cuda.empty_cache()
    spec2 = dataclasses.replace(spec, num_layers=2)
    m2 = SplittableModel(spec2)
    p2 = card_init(m2, 18)
    toks = serve_prompt(V, seed=24)
    e2 = norm_err(teacher_forced(m2, p2, toks, SERVE_P), forward_logits(m2, p2, toks), V)
    if not e2 <= SERVE_TF_TOL:
        raise AssertionError(f"mamba2 2 blocks: teacher-forced decode {e2:.3e} from the forward")
    print(f"[serve] mamba2-1.3b: teacher-forced decode {d_dec:.3e} from the float64 forward "
          f"where the f32 forward is {d_fwd:.3e} (limit {SERVE_F64_FACTOR:g}x), {d_df:.3e} "
          f"from the f32 forward (max-normalised); its first 2 blocks alone within {e2:.3e} of "
          f"their forward (tolerance {SERVE_TF_TOL}); card {card}")
    res.update(tf_err=d_df, f64_err_decode=d_dec, f64_err_forward=d_fwd, tf_err_2_blocks=e2)
    torch.cuda.empty_cache()
    return res


def serve_jamba_card_vs_cpu(card: str, steps: int = 16):
    """REDUCED jamba-1.5-large-398b, one init on both devices, 16 teacher-
    forced decode steps on the card and on the CPU: logits within
    ZOO_CARD_RTOL (max-normalised); B4d once per super-block a step."""
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.swa_attention import decode_launches
    from repro_torch.models import SplittableModel

    spec = get_reduced(ZOO_HYBRID)
    model = SplittableModel(spec)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, spec.vocab_size, (2, steps), generator=torch.Generator().manual_seed(1))
    reset_all_launches()
    card_logits = teacher_forced(model, tree_map(lambda x: x.to(serve_device()), params), toks.to(serve_device()), steps)
    torch.cuda.synchronize()
    got = decode_launches[DECODE]
    cpu_logits = teacher_forced(model, params, toks, steps)
    e = norm_err(card_logits.cpu(), cpu_logits, spec.vocab_size)
    if got != spec.n_units * steps or not e <= ZOO_CARD_RTOL:
        raise AssertionError(f"jamba REDUCED: {got} B4d launches, card {e:.3e} from the CPU")
    print(f"[serve] {ZOO_HYBRID} REDUCED ({spec.n_units} super-blocks): {steps} decode steps "
          f"on the card within {e:.3e} of the CPU (max-normalised; tolerance {ZOO_CARD_RTOL}); "
          f"B4d {got} launches; card {card}")
    return {"card_vs_cpu": e, "launches": got}


def serve_cli(card: str):
    """``python -m repro_torch.launch.serve --arch smollm-135m`` (REDUCED, as
    the JAX CLI) in this process: exit 0, its ``[serve]`` line, B4d once per
    layer a step."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.swa_attention import decode_launches
    from repro_torch.launch import serve

    P, G = 16, 32
    argv = ["--arch", "smollm-135m", "--batch", str(SERVE_B), "--prompt-len", str(P),
            "--gen", str(G), "--cache-len", "64"]
    reset_all_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    got = decode_launches[DECODE]
    line = next((l for l in buf.getvalue().splitlines() if l.startswith("[serve] arch=")), None)
    want = get_reduced("smollm-135m").n_units * (P + G)
    if rc != 0 or line is None or got != want:
        raise AssertionError(f"serve CLI: rc {rc}, line {line!r}, {got} B4d launches (not {want})")
    print(f"[serve] CLI {' '.join(argv)}: exit 0, '{line}'; B4d {got} launches; card {card}")
    return {"launches": got}


def decode_read_slots(pos, q_pos: int, window: int = 0):
    """(visible slots, slots of the tiles that hold a visible one) of a
    cache whose slots hold ``pos``, read at ``q_pos``."""
    import torch

    from repro_torch.kernels.swa_attention.ops import DECODE_TILE

    pos = pos.long().cpu()
    ok = (pos >= 0) & (pos <= q_pos)
    if window > 0:
        ok &= pos > q_pos - window
    C = pos.shape[0]
    tiles = -(-C // DECODE_TILE)
    hit = torch.zeros(tiles * DECODE_TILE, dtype=torch.bool)
    hit[:C] = ok
    hit = hit.reshape(tiles, DECODE_TILE).any(dim=1).tolist()
    return int(ok.sum()), sum(min(DECODE_TILE, C - t * DECODE_TILE)
                              for t in range(tiles) if hit[t])


def decode_timings(card: str):
    """B4d at every shape of DECODE_TIMED: the kernel's ms called eagerly
    (the wrapper's host time included, in turns with the plain version),
    the plain version's ms and SDPA's with the mask as a bias (enable_gqa,
    the library yardstick), all three timed the same way; beside them
    ``graph_ms``, the kernel's time on the card alone (a CUDA graph of 20
    wrapper calls replayed), the split count S and the bound (the bytes of
    the tiles that hold a visible slot).  Each timed call reads the next of
    n copies of the cache, n such that the bytes read by n calls exceed
    twice the 50 MB L2: a decode step's 28 layers find their caches cold
    too."""
    import itertools
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.swa_attention import (
        decode_launch_splits, reset_launches, swa_decode, swa_decode_ref,
    )
    from repro_torch.kernels.swa_attention.ref import mask_bias
    from repro_torch.launch.dryrun_lib import decode_work

    dev = serve_device()
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for label, ((B, C, H, K, hd), dname, filled) in DECODE_TIMED.items():
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, C, K, hd, generator=gen, device=dev).to(dtype) for _ in range(2))
        q_pos = C - 1 if filled is None else filled
        pos = slot_positions("partly filled", C, q_pos, dev)
        qp = torch.tensor([q_pos], dtype=torch.int32, device=dev)
        visible, read = decode_read_slots(pos, q_pos)
        n = max(1, math.ceil(2 * 50e6 / (2 * B * K * hd * read * k.element_size())))
        caches = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n - 1)]
        flat = itertools.cycle(caches)
        trans = itertools.cycle([tuple(x.transpose(1, 2).contiguous() for x in kv)
                                 for kv in caches])
        km, pm = in_turns(lambda: swa_decode_ref(q, *next(flat), pos, qp),
                          lambda: swa_decode(q, *next(flat), pos, qp))
        gm = graph_ms(lambda: swa_decode(q, *next(flat), pos, qp))
        qt = q.transpose(1, 2).contiguous()
        bias = mask_bias(qp.long(), pos.long(), True, 0, 0, (pos >= 0)[None].expand(B, C))
        bias = bias[:, None].to(dtype)  # [B, 1, 1, C]

        def library():
            return F.scaled_dot_product_attention(qt, *next(trans), attn_mask=bias,
                                                  enable_gqa=True)

        got = swa_decode(q, k, v, pos, qp)
        if dtype == torch.float32:
            torch.testing.assert_close(library().transpose(1, 2), got, rtol=ATTN_TOL,
                                       atol=ATTN_TOL)
        else:  # the kernel within one bf16 ulp; SDPA rounds its softmax in bf16
            ref = swa_decode_ref(q.float(), k.float(), v.float(), pos, qp)
            if not bool(((got.float() - ref).abs()
                         <= ATTN_TOL + ATTN_TOL * ref.abs() + bf16_ulp(ref)).all()):
                raise AssertionError(f"B4d at the {label} shape: beyond one bf16 ulp")
            torch.testing.assert_close(library().transpose(1, 2).float(), ref, rtol=2e-2,
                                       atol=2e-2)
        lm = cuda_ms(library)
        ops, nbytes = decode_work(B, C, H, K, hd, visible, read, q.element_size())
        by_ops, by_bytes = ops / F32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        S = decode_launch_splits(q, k)
        r = dict(ms=km, graph_ms=gm, plain_ms=pm, bound_ms=max(by_ops, by_bytes),
                 bound_by="operations" if by_ops >= by_bytes else "bytes", library_ms=lm,
                 ops=ops, bytes=nbytes, shape=[B, C, H, K, hd], dtype=dname, q_pos=q_pos,
                 visible=visible, read_slots=read, splits=S, launches_a_call=1 + (S > 1),
                 cache_copies=n)
        out[label] = r
        print(f"[timing] B4d swa_decode at the {label} shape B={B} C={C} H={H} K={K} hd={hd} "
              f"({dname}, q_pos {q_pos}: {visible} slots visible, {read} read; {n} cache "
              f"copies in turn), S={S} splits "
              f"({r['launches_a_call']} launch(es) a call), each called eagerly: kernel {km:.4f} "
              f"ms, plain {pm:.4f} ms, library (scaled_dot_product_attention, float mask bias, "
              f"enable_gqa) {lm:.4f} ms; the kernel on the card alone {gm:.4f} ms (a graph of "
              f"20 calls replayed); bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s, {ops / 1e6:.1f} MFLOP at 67 TFLOP/s f32; "
              f"H100 SXM data sheet) = {100 * r['bound_ms'] / km:.1f}% eager, "
              f"{100 * r['bound_ms'] / gm:.1f}% on the card alone; card {card}")
    reset_launches()
    return out


def serve_paths(card: str, ckpt: Path):
    """The ``[serve]`` phase: B4d against its plain version; the trained
    smollm-135m served from its checkpoint, its ring under a window;
    qwen2-1.5b, granite-moe-1b-a400m, mamba2-1.3b and paligemma-3b at full
    width; REDUCED
    jamba on the card against the CPU; the serve CLI; B4d's times."""
    import torch

    t0 = time.perf_counter()
    errs = check_decode_attention()
    out, counts = {}, {}
    model, params, out["serve-smollm-135m"] = serve_trained_smollm(ckpt, card)
    out["serve-smollm-135m-ring"] = serve_ring(model, params, card)
    del model, params
    torch.cuda.empty_cache()
    out["serve-qwen2-1.5b"], out["serve-qwen2-1.5b-long-cache"] = serve_qwen(card)
    out["serve-granite-moe-1b-a400m"] = serve_granite(card)
    out["serve-mamba2-1.3b"] = serve_mamba(card)
    out["serve-paligemma-3b"] = serve_paligemma(card)
    out[f"serve-{ZOO_HYBRID}-reduced"] = serve_jamba_card_vs_cpu(card)
    out["serve-cli-smollm-135m-reduced"] = serve_cli(card)
    for path, r in out.items():
        counts[path] = r["launches"]
    for path in ("serve-smollm-135m", "serve-qwen2-1.5b", "serve-granite-moe-1b-a400m",
                 "serve-paligemma-3b"):
        if counts[path] == 0:
            raise AssertionError(f"kernel {DECODE} was not launched on {path}")
    times = decode_timings(card)
    print("[timing] [serve] ms a decode step, tok/s and peak GB at batch 8 (prompt 64, gen 64; "
          "the long cache: 8192 filled, 64 timed steps): "
          + json.dumps({k: [round(v["ms_per_step"], 4), round(v["tok_s"], 1),
                            round(v["peak"] / 1e9, 3)] for k, v in out.items()
                        if "ms_per_step" in v})
          + f"; phase {time.perf_counter() - t0:.1f} s; card {card}")
    return counts, out, errs, times


# --------------------------------------------------------------------------- #
# [remat] and [dryrun]: smollm-135m trained at the train_4k length under each
# remat policy (ROADMAP A14.6), and the dry-run's count of the same step (A15)
# --------------------------------------------------------------------------- #

# configs/shapes.SHAPES["train_4k"].seq_len: the dry-run's train shape, where
# JAX applies remat; without remat the full-width cell reckons ~134 GB
REMAT_SEQ = 4096
REMAT_POLICIES = ("full", "outs", "dots")
REMAT_ROUNDS, REMAT_B_ROUNDS = 3, 2
REMAT_CHECK_SEQ, REMAT_CHECK_ROUNDS = 1024, 2  # (a): remat against none, bit for bit
REMAT_PEAK_LIMIT = 70e9
REMAT_RTOL = 1e-6  # the policies' losses against one another
REMAT_B_RTOL = 1e-4  # Engine B against Engine A, as [engine-b]
# the card's peak over the dry-run's (arg_bytes + temp_bytes) of the same
# step: PERF.md says why this band
REMAT_MEMORY_BAND = (0.8, 1.25)
DRYRUN_SHAPES = ("train_4k", "decode_32k")
DRYRUN_FLOPS_RTOL = 0.01


def remat_cell(seq: int, policy=None):
    """(device, model, plan, opt, loader) of the full-width smollm-135m cell
    as ``lm_main_path`` builds it through the CLI's pieces (N=8, J2=4,
    batch 1, cuts (6, 15), SGD), at ``seq`` tokens, each unit
    rematerialised under ``policy`` (None: no remat)."""
    from repro_torch.configs import get_spec
    from repro_torch.launch import train

    spec = get_spec("smollm-135m")
    if policy is not None:
        spec = dataclasses.replace(spec, remat=True, remat_policy=policy)
    args = train.parse_args(["--arch", "smollm-135m", "--clients", "8", "--edges", "4",
                             "--batch", str(LM_BATCH)])
    device, _, model, plan, opt, loader = train.setup(args, spec=spec, seq=seq)
    assert plan.cuts == (6, 15) and plan.intervals == (8, 4, 1), plan
    return device, model, plan, opt, loader


def remat_train(model, plan, opt, p0, batches, device, engine: str = "a"):
    """``len(batches)`` rounds from the init ``p0`` (one draw for every run;
    the engines copy it) on Engine A's dispatch or Engine B's step: (state,
    losses, host ms a round ending in a device sync, launches, peak
    bytes)."""
    import torch

    from repro_torch.core import build_train_step_b, init_state_a, init_state_b
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init = init_state_a if engine == "a" else init_state_b
    state = init(_GivenInit(p0), plan, opt, None, device)
    if engine == "a":
        step = train.make_dispatch(model, plan, opt)
    else:
        step_b = build_train_step_b(model, plan, opt)
        step = lambda st, b, r: step_b(st, b)
    reset_all_launches()
    losses, ms = [], []
    for r, batch in enumerate(batches):
        t = time.perf_counter()
        state, loss = step(state, batch, r)
        losses.append(float(loss))  # waits for the round
        ms.append((time.perf_counter() - t) * 1e3)
    return state, losses, ms, all_launches(), torch.cuda.max_memory_allocated()


def assert_groups_equal(params, plan, what: str) -> None:
    """Every client replica equal to its entity group's after a round whose
    entity levels ran: tier m's rows equal in groups of N / J_m (the top
    tier's across all clients)."""
    from repro_torch._tree import tree_leaves

    N = plan.num_clients
    for m, part in enumerate(tier_parts(params, plan)):
        per = N // plan.entities[m]
        for i, x in enumerate(tree_leaves(part)):
            g = x.reshape(plan.entities[m], per, *x.shape[1:])
            if per > 1 and x.numel() and not bool((g == g[:, :1]).all()):
                raise AssertionError(f"{what}: tier {m + 1} leaf {i} differs within a group")


def remat_paths(card: str):
    """The ``[remat]`` phase: smollm-135m at full width and depth through
    Engine A with every unit rematerialised.  (a) ``"full"`` against the same
    run without remat at seq 1024 from one init, bit for bit; (b) at seq 4096
    (train_4k's length) 3 rounds under each policy: finite losses equal
    across the policies at rtol 1e-6, groups equal after each round's
    levels, B4 launched twice per layer a round (the backward's replay),
    B5 and B1 as without remat, peak at most 70 GB beside the dry-run's
    reckoning without remat; (c) Engine B under ``"full"`` at the same cell
    for 2 rounds, its losses within rtol 1e-4 of (b)'s Engine A."""
    import numpy as np
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.launch import train
    from repro_torch.launch.dryrun_lib import count_train_step

    t0 = time.perf_counter()
    counts, out = {}, {}
    device, model, plan, opt, loader = remat_cell(REMAT_CHECK_SEQ)
    # one seeded draw (on the host, as lm_main_path's) for every run
    p0 = model.init_params(torch.Generator().manual_seed(0), device)
    # (a) at the main path's length: remat changes no number
    runs = {}
    batches = [train.to_device(loader.next_round(), device) for _ in range(REMAT_CHECK_ROUNDS)]
    for policy in (None, "full"):
        _, model, plan, opt, _ = remat_cell(REMAT_CHECK_SEQ, policy)
        state, losses, _, _, _ = remat_train(model, plan, opt, p0, batches, device)
        runs[policy] = (losses, state.params)
        del state
    (l0, q0), (l1, q1) = runs[None], runs["full"]
    exact = l0 == l1 and all(torch.equal(a, b) for a, b in zip(tree_leaves(q1), tree_leaves(q0)))
    if not exact:
        np.testing.assert_allclose(l1, l0, rtol=REMAT_RTOL)
        for a, b in zip(tree_leaves(q1), tree_leaves(q0)):
            torch.testing.assert_close(a, b, rtol=REMAT_RTOL, atol=0)
    print(f"[remat] (a) smollm-135m full width, seq {REMAT_CHECK_SEQ}, {REMAT_CHECK_ROUNDS} "
          f"rounds: \"full\" against no remat from one init: losses {l1} against {l0}, "
          + ("losses and params bit for bit" if exact else f"within rtol {REMAT_RTOL}, "
             "not bit for bit"), flush=True)
    out["bit_for_bit"] = exact
    del runs, q0, q1
    # (b) at train_4k's length, each policy from the same init and batches
    device, model, plan, opt, loader = remat_cell(REMAT_SEQ)
    batches = [train.to_device(loader.next_round(), device) for _ in range(REMAT_ROUNDS)]
    plain = count_train_step(model, plan, opt, batches[0], fed_round=(False, False, True))
    reckoned = plain["arg_bytes"] + plain["temp_bytes"]
    print(f"[remat] reckoned without remat at seq {REMAT_SEQ} (launch/dryrun_lib."
          f"count_train_step): {reckoned / 1e9:.2f} GB (state and batch "
          f"{plain['arg_bytes'] / 1e9:.2f}, the step's peak {plain['temp_bytes'] / 1e9:.2f}) "
          f"against the {REMAT_PEAK_LIMIT / 1e9:.0f} GB line", flush=True)
    out["reckoned_no_remat"] = reckoned
    losses_by = {}
    for policy in REMAT_POLICIES:
        _, model, plan, opt, _ = remat_cell(REMAT_SEQ, policy)
        state, losses, ms, got, peak = remat_train(model, plan, opt, p0, batches, device)
        want = lm_expected(plan, state.params, model.spec.n_units, REMAT_ROUNDS)
        want[ATTN[0]] *= 2  # the backward replays each unit's forward
        label = f"remat-{policy}-smollm-135m-seq{REMAT_SEQ}"
        if got != want:
            raise AssertionError(f"{label}: launches {got}, the plan, depth and replay imply "
                                 f"{want}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label}: losses {losses}")
        assert_groups_equal(state.params, plan, label)
        if peak > REMAT_PEAK_LIMIT:
            raise AssertionError(f"{label}: peaked at {peak / 1e9:.2f} GB > "
                                 f"{REMAT_PEAK_LIMIT / 1e9:.0f} GB")
        del state
        counts[label] = got
        losses_by[policy] = losses
        med = sorted(ms[1:])[len(ms[1:]) // 2]
        out[policy] = dict(losses=losses, round_ms=med, rounds_ms=ms, peak=peak)
        print(f"[remat] (b) {label} (N=8, J2=4, batch {LM_BATCH}, cuts {plan.cuts}): losses "
              f"{losses}; peak {peak / 1e9:.2f} GB (reckoned without remat "
              f"{reckoned / 1e9:.2f}); median round {med:.1f} ms (rounds {ms}); launches "
              f"{got}; groups equal; card {card}", flush=True)
    for policy in REMAT_POLICIES[1:]:
        np.testing.assert_allclose(losses_by[policy], losses_by["full"], rtol=REMAT_RTOL)
    # (c) Engine B under "full" at the same cell
    _, model, plan, opt, _ = remat_cell(REMAT_SEQ, "full")
    state, losses, ms, got, peak = remat_train(model, plan, opt, p0, batches[:REMAT_B_ROUNDS],
                                               device, engine="b")
    want = engine_b_want(plan, state.params, model.spec.n_units, REMAT_B_ROUNDS)
    want[ATTN[0]] *= 2
    label = f"remat-full-engine-b-smollm-135m-seq{REMAT_SEQ}"
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the plan, depth and replay imply {want}")
    np.testing.assert_allclose(losses, losses_by["full"][:REMAT_B_ROUNDS], rtol=REMAT_B_RTOL)
    if peak > REMAT_PEAK_LIMIT:
        raise AssertionError(f"{label}: peaked at {peak / 1e9:.2f} GB")
    del state
    counts[label] = got
    out["engine-b"] = dict(losses=losses, rounds_ms=ms, peak=peak)
    print(f"[remat] (c) {label}: losses {losses} against Engine A's "
          f"{losses_by['full'][:REMAT_B_ROUNDS]} (rtol {REMAT_B_RTOL}); peak "
          f"{peak / 1e9:.2f} GB; rounds {ms} ms; launches {got}; card {card}", flush=True)
    out["batch"] = batches[0]
    del p0
    print(f"[remat] phase {time.perf_counter() - t0:.1f} s; card {card}")
    return counts, out


def dryrun_paths(card: str, remat_out):
    """The ``[dryrun]`` phase: (a) ``python -m repro_torch.launch.dryrun`` as
    a subprocess on train_4k and decode_32k over the virtual pod mesh, each
    record written and printed; (b) ``count_train_step`` at ``[remat]``'s
    ``"full"`` cell: its FLOPs against ``lm_forward_flops`` x (3 for the
    forward and backward + 1 for the units' replay), within 1%, over (b)'s
    median round as TFLOP/s, and its (arg_bytes + temp_bytes) beside the
    card's peak of that run, the ratio within REMAT_MEMORY_BAND.  It
    launches no kernel."""
    import os

    from repro_torch.configs import get_spec
    from repro_torch.launch.dryrun_lib import count_train_step

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    records = {}
    # the CLI's runs, one process a shape, side by side (each is host work)
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
         "--shape", shape, "--mesh", "pod", "--out", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for shape in DRYRUN_SHAPES}
    try:
        for shape, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun {shape}: exit {proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs.values():
            proc.kill()
    for shape in DRYRUN_SHAPES:
        path = out_dir / f"smollm-135m_{shape}_16x16_baseline.json"
        rec = json.loads(path.read_text())
        records[shape] = rec
        print(f"[dryrun] (a) smollm-135m {shape} on the virtual pod mesh (16x16, rank 0's "
              f"view; lowered in {rec['lower_s']} s, counted in {rec['step_s']} s): flops "
              f"{rec['flops']:.6g}, collective_bytes {rec['collective_bytes']:.6g}, "
              f"collectives {json.dumps(rec['collectives'])}, arg_bytes {rec['arg_bytes']}, "
              f"temp_bytes {rec['temp_bytes']}; {path.relative_to(ROOT)}", flush=True)
    print(f"[dryrun] (a) both CLI runs in {time.perf_counter() - t0:.1f} s", flush=True)
    # (b) the [remat] (b) "full" step, counted on meta tensors
    _, model, plan, opt, _ = remat_cell(REMAT_SEQ, "full")
    reset_all_launches()
    got = count_train_step(model, plan, opt, remat_out["batch"], fed_round=(False, False, True))
    if any(all_launches().values()):
        raise AssertionError(f"count_train_step launched kernels: {all_launches()}")
    spec = get_spec("smollm-135m")
    N, b, S = remat_out["batch"]["tokens"].shape
    fwd = lm_forward_flops(spec, N * b, S)
    head = 2.0 * N * b * S * spec.d_model * spec.padded_vocab
    want = 3 * fwd + (fwd - head)
    if abs(got["flops"] / want - 1) > DRYRUN_FLOPS_RTOL:
        raise AssertionError(f"count_train_step {got['flops']:.6g} FLOPs, lm_forward_flops "
                             f"x (3 + 1 without the head) {want:.6g}")
    ms = remat_out["full"]["round_ms"]
    peak = remat_out["full"]["peak"]
    predicted = got["arg_bytes"] + got["temp_bytes"]
    ratio = peak / predicted
    print(f"[dryrun] (b) count_train_step at [remat]'s \"full\" cell (N={N}, batch {b}, seq "
          f"{S}): {got['flops']:.6g} FLOPs (products {got['aten_flops']:.6g}, attention "
          f"kernels {got['kernel_flops']:.6g}) against lm_forward_flops x (3 + 1 without "
          f"the head) {want:.6g} ({100 * (got['flops'] / want - 1):+.3f}%); over the median "
          f"round {ms:.1f} ms: {got['flops'] / (ms * 1e-3) / 1e12:.2f} TFLOP/s; predicted "
          f"memory arg {got['arg_bytes'] / 1e9:.3f} + temp {got['temp_bytes'] / 1e9:.3f} = "
          f"{predicted / 1e9:.3f} GB against the card's peak {peak / 1e9:.3f} GB: ratio "
          f"{ratio:.4f} (band {REMAT_MEMORY_BAND}); counted in {got['step_s']} s; card {card}",
          flush=True)
    if not REMAT_MEMORY_BAND[0] <= ratio <= REMAT_MEMORY_BAND[1]:
        raise AssertionError(f"the card's peak over the dry-run's prediction {ratio:.4f} is "
                             f"outside {REMAT_MEMORY_BAND}")
    print(f"[dryrun] phase {time.perf_counter() - t0:.1f} s; card {card}")
    return dict(records=records, flops=got["flops"], want=want, ratio=ratio,
                predicted=predicted, peak=peak,
                tflops=got["flops"] / (ms * 1e-3) / 1e12)


def cuda_storages(obj, seen=None) -> dict:
    """{storage pointer: bytes} of the CUDA tensors reachable from ``obj``
    through dicts, lists, tuples, sets and objects' attributes (modules,
    classes and functions are not followed)."""
    import types

    import torch

    seen = set() if seen is None else seen
    found, stack = {}, [obj]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                st = x.untyped_storage()
                found[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend(x)
        elif not isinstance(x, (type, types.ModuleType, types.FunctionType, types.MethodType,
                                str, bytes, int, float)) and hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return found


def referrer_chain(obj, skip: set, depth: int = 5) -> str:
    """Who keeps ``obj`` alive: up to ``depth`` referrers, each the first
    one that is not a frame or in ``skip`` (ids), named by type, a dict by
    the key that holds the child, a generator or function by its code's
    name and place, and a closure cell by the function that holds it."""
    import types

    def name(parent, child) -> str:
        if isinstance(parent, dict):
            key = next((repr(k) for k, v in parent.items() if v is child), None)
            return f"dict[{key}]" if key else "dict"
        if isinstance(parent, types.GeneratorType):
            code = parent.gi_code
            return f"generator {code.co_qualname} ({Path(code.co_filename).name}:" \
                   f"{code.co_firstlineno})"
        if isinstance(parent, types.FunctionType):
            return f"function {parent.__qualname__}"
        return type(parent).__name__

    names, skip = [], set(skip)
    for _ in range(depth):
        refs = [r for r in gc.get_referrers(obj)
                if id(r) not in skip and not isinstance(r, types.FrameType)]
        skip.add(id(refs))  # this list refers to the parent the next step asks about
        if not refs:
            break
        parent = refs[0]
        if isinstance(parent, types.CellType):
            # the function whose closure holds the cell
            owners = [f for t in gc.get_referrers(parent) if isinstance(t, tuple)
                      for f in gc.get_referrers(t) if isinstance(f, types.FunctionType)]
            skip.add(id(owners))
            if owners:
                names.append(f"cell of {name(owners[0], None)}")
                obj = owners[0]
                continue
        names.append(name(parent, obj))
        obj = parent
    return " <- ".join(names) or "nothing"


def loose_tensors(reached: dict, top_n: int = 4):
    """(bytes, count, descriptions of the ``top_n`` largest) of the CUDA
    storages of 1 MB or more that no storage of ``reached`` is: each
    described by shape, dtype, size and ``referrer_chain``."""
    import torch

    loose = {}
    with warnings.catch_warnings():  # deprecated module proxies warn on isinstance
        warnings.simplefilter("ignore")
        every = gc.get_objects()
        tensors = [obj for obj in every if isinstance(obj, torch.Tensor)]
    for obj in tensors:
        if obj.is_cuda:
            st = obj.untyped_storage()
            if st.data_ptr() not in reached and st.nbytes() >= 1 << 20:
                loose.setdefault(st.data_ptr(), (st.nbytes(), obj))
    top = sorted(loose.values(), key=lambda pair: -pair[0])[:top_n]
    skip = {id(every), id(tensors), id(loose), id(top)} | {id(pair) for pair in top}
    chains = []  # a loop, not a generator: a generator's frame would refer to the tensors
    for n, t in top:
        chains.append(f"{tuple(t.shape)} {t.dtype} {n / 1e9:.3f} GB <- {referrer_chain(t, skip)}")
    return sum(n for n, _ in loose.values()), len(loose), chains


def phase_boundary(label: str, scope: dict, since: float) -> float:
    """At the end of a phase: print the seconds since ``since`` (the last
    boundary's return), ``torch.cuda.memory_allocated()`` before and after a
    collection, the device bytes each name of ``scope`` (``main``'s locals)
    holds, and the largest CUDA tensors no such name reaches (before the
    collection: garbage in reference cycles, or held elsewhere; after it:
    held elsewhere) with the chain of objects that refer to them; returns
    the time of this boundary."""
    import torch

    torch.cuda.synchronize()
    seconds = time.perf_counter() - since
    before = torch.cuda.memory_allocated()
    held, reached = {}, {}
    for name, obj in scope.items():
        if name.startswith("__"):
            continue
        found = cuda_storages(obj)
        if found:
            held[name] = sum(found.values())
            reached.update(found)
    cyc_bytes, cyc_n, cyc = loose_tensors(reached)
    gc.collect()
    after = torch.cuda.memory_allocated()
    kept_bytes, kept_n, kept = loose_tensors(reached)
    named = ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sorted(held.items(), key=lambda t: -t[1]))
    print(f"[memory] after {label}: {seconds:.1f} s; {before / 1e9:.3f} GB allocated, "
          f"{after / 1e9:.3f} GB after a collection; held by main's names: {named or 'none'}; "
          f"reached by no name before the collection: {cyc_bytes / 1e9:.3f} GB in {cyc_n} "
          f"storages of 1 MB or more{': ' + '; '.join(cyc) if cyc else ''}; after it: "
          f"{kept_bytes / 1e9:.3f} GB in {kept_n}{': ' + '; '.join(kept) if kept else ''}",
          flush=True)
    return time.perf_counter()


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

    clock = time.perf_counter()
    from repro_torch.kernels.swa_attention.ops import DECODE_SOURCE, SOURCE as SWA_SOURCE

    attn_build = attention_build_report(SWA_SOURCE)
    decode_build = decode_build_report(DECODE_SOURCE)
    errs, bf16_errs = check_kernels(SPEC)
    ragged_errs, ragged_bf16_errs = check_ragged_kernels(SPEC)
    errs.update(ragged_errs)
    bf16_errs.update(ragged_bf16_errs)
    masked_errs, masked_bf16_errs = check_masked_kernels(SPEC)
    mr_errs, mr_bf16_errs = check_masked_ragged_kernels(SPEC)
    attn_errs, attn_bf16_errs = check_attention()
    clock = phase_boundary("the kernel checks", locals(), clock)
    solved = solve_classes(SPEC)
    solve_backend_timings(card, SPEC)
    card_vs_cpu()
    class_card_vs_cpu()
    lm_card_vs_cpu()
    estimator_card_vs_cpu()
    clock = phase_boundary("the card-against-CPU checks", locals(), clock)
    path_launches, run = main_path()
    for name in AGG:
        if path_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the VGG main path")
    vgg_round_parts(card, run)
    del run  # the trained VGG-16 state: 1.22 GB that no later phase reads
    clock = phase_boundary("the VGG main path", locals(), clock)
    class_launches, class_run = class_path(solved)
    for name in RAGGED:
        if class_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the per-class path")
    class_round_parts(card, class_run)
    del class_run
    clock = phase_boundary("the per-class path", locals(), clock)
    cli_launches = lm_cli()
    lm_launches, lm_run = lm_main_path()
    for name in ("tiered_aggregate",) + ATTN:
        if lm_launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the smollm-135m path")
    lm_parts = lm_round_parts(card, lm_run)
    serve_ckpt = save_trained_lm(lm_run)
    del lm_run["state"], lm_run["batch"]
    clock = phase_boundary("the smollm-135m paths", locals(), clock)
    auto_launches = auto_optimize_cli()
    api_launches = api_paths()
    clock = phase_boundary("--auto-optimize and the API", locals(), clock)
    masked_launches = {name: api_launches[path][name] for name, path in
                       zip(MASKED, ("participation train", "participation int8 train"))}
    for name, n in masked_launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the participation path")
    sim_backends(card)
    clock = phase_boundary("the fleet simulator", locals(), clock)
    storm_counts, _ = fault_storm_paths(card)
    clock = phase_boundary("the fault storm", locals(), clock)
    class_storm, class_storm_by_run, _ = class_fault_storm(solved)
    for name in MASKED_RAGGED:
        if class_storm[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the per-class storm")
    clock = phase_boundary("the per-class storm", locals(), clock)
    privacy_counts = privacy_paths(card)
    async_launches, _ = async_paths()
    clock = phase_boundary("privacy, energy and staleness", locals(), clock)
    control_counts, _ = control_paths(card)
    clock = phase_boundary("[control]", locals(), clock)
    for path, names in (("control-vgg16", (MASKED[0], AGG[0])),
                        ("control-smollm-135m", (AGG[0],) + ATTN)):
        for name in names:
            if control_counts[path][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
    engine_b_counts, _ = engine_b_paths(card)
    clock = phase_boundary("[engine-b]", locals(), clock)
    zoo_counts, _ = zoo_paths(card)
    clock = phase_boundary("[zoo]", locals(), clock)
    sharded_counts = sharded_paths(card)
    clock = phase_boundary("[sharded]", locals(), clock)
    for path, name in (("sharded-cli-1-rank", AGG[0]), ("sharded-api-1-rank-int8", AGG[1]),
                       ("sharded-2-ranks-gloo-plain", AGG[0]),
                       ("sharded-2-ranks-gloo-int8", AGG[1])):
        if sharded_counts[path][name] == 0:
            raise AssertionError(f"kernel {name} was not launched on {path}")
    serve_counts, serve_out, decode_errs, decode_times = serve_paths(card, serve_ckpt)
    clock = phase_boundary("[serve]", locals(), clock)
    # the two largest cells, after every other path: each phase boundary
    # collects the reference cycles that earlier phases leave behind
    vlm_counts, vlm_out = vlm_paths(card)
    clock = phase_boundary("[vlm]", locals(), clock)
    audio_counts, audio_out = audio_paths(card)
    clock = phase_boundary("[audio]", locals(), clock)
    qwen2_counts, qwen2_out = qwen2_paths(card)
    clock = phase_boundary("[qwen2]", locals(), clock)
    remat_counts, remat_out = remat_paths(card)
    for path, got in remat_counts.items():
        # Engine B's two rounds are due no fed mean: its B1 count is 0
        for name in ATTN + (() if "engine-b" in path else (AGG[0],)):
            if got[name] == 0:
                raise AssertionError(f"kernel {name} was not launched on {path}")
    clock = phase_boundary("[remat]", locals(), clock)
    dryrun_paths(card, remat_out)
    del remat_out
    clock = phase_boundary("[dryrun]", locals(), clock)
    times = timings(card)
    times.update(ragged_timings(card))
    times.update(masked_timings(card))
    robust_times, _ = robustness_timings(card)
    times.update(robust_times)
    round_time_comparison(card)
    attn_times = attention_timings(card)
    attention_share(card, lm_run["spec"], lm_parts, attn_times)
    clock = phase_boundary("the timings", locals(), clock)

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
    # the [audio] paths: training (every counter) and decoding (B4d's alone)
    audio_decode = {k: v[DECODE] for k, v in audio_counts.items() if set(v) == {DECODE}}
    audio_train = {k: v for k, v in audio_counts.items() if k not in audio_decode}
    new_paths = {**storm_counts, **class_storm_by_run, **privacy_counts,
                 "async-staleness-2": async_launches, **control_counts, **engine_b_counts,
                 **zoo_counts, **vlm_counts, **audio_train, **qwen2_counts, **sharded_counts,
                 **remat_counts}
    for row in kernels:
        row["launches_by_path"].update(
            {path: got[row["name"]] for path, got in new_paths.items()})
    # B3m: the per-class fault storm (plain and over the int8 wire)
    kernels += [{
        "name": name, "route": "cuda", "source": SOURCES["tiered_aggregate"],
        "replaces": REPLACES[name],
        "launches": class_storm[name],
        "launches_by_path": {"vgg16-cifar10": path_launches[name],
                             "smollm-135m": lm_launches[name],
                             "vgg16-cifar10-per-class": class_launches.get(name, 0),
                             **{path: got[name] for path, got in new_paths.items()}},
        "max_abs_err": mr_errs[name],
        "max_abs_err_bf16": mr_bf16_errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": None,
        "port_only": "no TPU kernel: the jnp tiers._ragged_units_mean under a mask",
    } for name in MASKED_RAGGED]
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
                             "smollm-135m-reduced-cli": cli_launches[name],
                             **{path: got[name] for path, got in new_paths.items()}},
        "max_abs_err": attn_errs[name],
        "max_abs_err_bf16": attn_bf16_errs[name],
        "ms": attn_times[(name, 0)]["ms"], "plain_ms": attn_times[(name, 0)]["plain_ms"],
        "bound_ms": attn_times[(name, 0)]["bound_ms"],
        "bound_by": attn_times[(name, 0)]["bound_by"],
        "bound_against": "3xTF32 on the tensor cores: 3 x operations at 495 TFLOP/s",
        "bound_ms_f32_cuda_cores": attn_times[(name, 0)]["bound_ms_f32_cuda_cores"],
        "build": attn_build[f"{attention_kernel_name(name, hd)}<{hd}, f32>"],
        "library_ms": attn_times[(name, 0)]["library_ms"],
        "library": ("torch.nn.functional.scaled_dot_product_attention, "
                    + ("forward" if name == "swa_attention_fwd"
                       else "backward (dq, dk and dv together)")),
        **({} if name == "swa_attention_fwd" else {"library_ms_pair": b5_pair}),
        "timed_at": f"B={B} S={S} H={H} K={K} hd={hd} window=0 f32",
        # paligemma-3b's Engine-B tiers: hd 256 (the forward on wgmma, the
        # backward's 8-warp kernels and the dk/dv pass's splits),
        # the prefix-LM mask; the library call is SDPA with a boolean mask
        "vlm": {**{k: vlm_out["attention"][name][k] for k in
                   ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "visible_pairs")},
                "timed_at": (f"B={VLM_ATTN[0]} S={VLM_ATTN[1]} H={VLM_ATTN[2]} K={VLM_ATTN[3]} "
                             f"hd={VLM_ATTN[4]} prefix={VLM_PREFIX} f32"),
                "launches": vlm_counts["vlm-paligemma-3b"][name],
                **({"splits": vlm_out["attention"][name]["splits"]}
                   if name == "swa_attention_bwd_dkv" else {}),
                "build": attn_build[f"{attention_kernel_name(name, VLM_ATTN[4])}"
                                    f"<{VLM_ATTN[4]}, f32>"]},
        # whisper-large-v3's Engine-B tiers: the encoder (bidirectional, a
        # prefix of S), the decoder's self-attention and its cross-attention
        # (Sq != Sk); the library call is SDPA without a mask (causal for
        # the decoder's self-attention)
        "audio": {"launches": audio_counts["audio-whisper-large-v3"][name],
                  "max_abs_err": audio_out["errors"][name]["f32"],
                  "max_abs_err_bf16": audio_out["errors"][name]["bf16"],
                  **{label: {k: audio_out["attention"][label][name][k] for k in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "visible_pairs", "shape", "prefix")} for label in AUDIO_ATTN}},
        # qwen2-1.5b's Engine-B tiers: hd 128, causal (B5 on the half wgmma
        # kernels, the dk/dv pass in splits and a merge; B4 on mma.sync);
        # the library call is SDPA (is_causal); launches on [qwen2]'s cell
        "qwen2": {**{k: qwen2_out["attention"][name][k] for k in
                     ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "visible_pairs",
                      "kernel")},
                  "timed_at": (f"B={QWEN2_ATTN[0]} S={QWEN2_ATTN[1]} H={QWEN2_ATTN[2]} "
                               f"K={QWEN2_ATTN[3]} hd={QWEN2_ATTN[4]} causal f32"),
                  "launches": qwen2_counts["qwen2-1.5b"][name],
                  **({"splits": qwen2_out["attention"][name]["splits"],
                      "split_sweep_ms": qwen2_out["attention"][name]["split_sweep_ms"]}
                     if name == "swa_attention_bwd_dkv" else {}),
                  **({} if name == "swa_attention_fwd" else {"library_ms_pair": {
                      "ms": sum(qwen2_out["attention"][n]["ms"] for n in ATTN[1:]),
                      "library_ms": qwen2_out["attention"][ATTN[1]]["library_ms"]}}),
                  "build": attn_build[f"{attention_kernel_name(name, QWEN2_ATTN[4])}"
                                      f"<{QWEN2_ATTN[4]}, f32>"]},
    } for name in ATTN]
    # B4d: decode attention, on the [serve] paths; its main path is the
    # trained smollm-135m served at batch 8, prompt 64, gen 64
    B, C, H, K, hd = DECODE_TIMED["serve"][0]
    t = decode_times["serve"]
    long_shape = DECODE_TIMED["long cache"][0]
    kernels.append({
        "name": DECODE, "route": "cuda", "source": SOURCES[DECODE], "replaces": REPLACES[DECODE],
        "launches": serve_counts["serve-smollm-135m"],
        "launches_by_path": {**serve_counts, **audio_decode},
        "max_abs_err": decode_errs["f32"], "max_abs_err_bf16": decode_errs["bf16"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": ("torch.nn.functional.scaled_dot_product_attention (float mask bias, "
                    "enable_gqa, f32)"),
        "timed_at": (f"B={B} C={C} H={H} K={K} hd={hd} f32, every slot visible; ms, "
                     "plain_ms and library_ms called eagerly; graph_ms (in timings) the "
                     "kernel alone on the card, a CUDA graph of 20 calls replayed"),
        "launches_a_call": "1 (S = 1) or 2 (the split kernel, then the merge kernel)",
        "long_cache": decode_times["long cache"],
        "timings": decode_times,
        "serve_long_cache": serve_out["serve-qwen2-1.5b-long-cache"],
        "build": decode_build[
            f"swa_decode_kernel<{hd}, {decode_heads_a_warp(H // K, hd)}, f32>"],
        "build_long_cache": decode_build[
            f"swa_decode_kernel<{long_shape[4]}, "
            f"{decode_heads_a_warp(long_shape[2] // long_shape[3], long_shape[4])}, f32>"],
        "build_merge": decode_build["swa_decode_merge_kernel<f32>"],
        "build_hd256": decode_build["swa_decode_kernel<256, 1, f32>"],
        # whisper-large-v3's decode cross-attention: one query against the
        # 1500 encoder slots, every slot at position 0; beside it the other
        # route, B4 at Sq = 1
        "audio_cross": {**audio_out["attention"]["decode cross"],
                        "max_abs_err": audio_out["cross_errors"]["f32"],
                        "max_abs_err_bf16": audio_out["cross_errors"]["bf16"],
                        "launches": audio_decode["audio-whisper-large-v3-serve-cross"],
                        "build": decode_build[
                            f"swa_decode_kernel<{AUDIO_CROSS_DECODE[4]}, "
                            f"{decode_heads_a_warp(1, AUDIO_CROSS_DECODE[4])}, f32>"]},
        "port_only": "no TPU kernel: the jnp _sdpa of attention's cache branch",
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
