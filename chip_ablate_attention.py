#!/usr/bin/env python3
"""Time the attention kernels (B4, B5) against edited copies of their source,
on one GPU.

    python3 chip_ablate_attention.py [VARIANT ...]

Each variant is ``csrc/swa_attention.cu`` with its headers
(``mma_tf32.cuh``, ``wgmma_tf32.cuh``) and one edit, built with the
package's nvcc flags into ``build/ablation/`` (all builds started together)
and loaded through ctypes beside the package's own build; naming variants
builds only those.  Every variant's forward (B4) and backward passes (B5
dq, dk/dv) are timed with CUDA events in turns (the variants in order, then
in reverse, one card) and held against the plain versions: the "fwd" and
"wg" variants at the full-width smollm-135m shape, f32 [8, 1024, 9, 3, 64],
window 0, and at whisper-large-v3's encoder, f32 [4, 1500, 20, 20, 64],
prefix 1500 (bidirectional), where B4 and both B5 passes run on wgmma; the
"wide" variants at paligemma-3b's Engine-B shape, f32 [4, 512, 8, 1, 256],
prefix 256, where B4 runs swa_fwd_wg_wide_kernel (B5 the 8-warp mma.sync
kernels, unsplit here); the "half" variants at qwen2-1.5b's Engine-B
shape, f32 [4, 1024, 12, 2, 128], causal, where B5 runs the hd-128 wgmma
kernels (swa_bwd_dq_wg_half_kernel, swa_bwd_dkv_wg_half_kernel; the dk/dv
pass in the split count that the package's wrapper launches, unless the
variant names one) and B4 mma.sync; "as built" at all four.  ptxas's
registers and spills of the wgmma forwards and of the wgmma passes (<64,
f32>, the wide forward <256, f32|bf16>, the half passes <128, f32|bf16>),
and the serialisation notes ptxas gives them (C75xx), are printed beside
them.  A variant that changes the
arithmetic says so: it is a measure of what a part of the kernels costs,
not a kernel.  The mma.sync kernels (``mma_tf32.cuh``: B4 at hd 80-128, B5
at 80-256) are edited by no variant.
  as built            the package's source, unedited.
Edits of the forward (B4) on wgmma (hd <= 64):
  fwd serial          no overlap: each consumer warpgroup waits for tile
                      t - 1's p.v before it issues tile t's s, then for s
                      (the same values, bit for bit);
  fwd one product     one wgmma a k-step, big.big, in s and in p.v (wrong,
                      1xTF32: it prices the two small terms);
  fwd 64-key tiles    kv tiles of 64 keys instead of 32 (in 2 stages: 4 do
                      not fit in shared memory);
  fwd 3 stages        a kv ring of 3 stages instead of 4;
  fwd setmaxnreg      the dq pass's register hand-over in the forward too:
                      the producer at 56 registers, the consumers at 224
                      (the forward runs every warp at the 168 that ptxas
                      allots 12 warps);
  fwd 2 stages        a kv ring of 2 stages;
  fwd turns           the two consumer warpgroups take turns at issuing
                      their products (two mbarriers, n_t + 1 turns each),
                      so that one's softmax runs under the other's products;
  fwd q small in registers
                      q's small part held as register A fragments (the
                      first term of s RS, as the dq pass holds q's)
                      instead of in shared memory;
  fwd q big in registers
                      q's big part held as register A fragments, the two
                      terms of s that read it RS, its small part in shared
                      memory;
  fwd plain descriptors
                      each k-step's wgmma descriptor made whole
                      (``wg::desc``, as the backward passes make them)
                      instead of as a tile's low word plus a constant.
Edits of B5's wgmma passes (hd <= 64):
  wg no derive        the producer warpgroup derives no small parts or
                      transposes (wrong: it prices that shared-memory pass,
                      which runs beside the consumers' products);
  wg one product      one wgmma a k-step, big.big, in every product (wrong:
                      it prices the two small terms);
  wg no setmaxnreg    the dq pass's register hand-over dropped: every warp
                      at the 168 registers that ptxas allots 12 warps.
Edits of B4 at hd 256 (swa_fwd_wg_wide_kernel; its knobs, as built 32-key
tiles, pieces of 64 columns, 4 in the ring, q's small parts in shared
memory, the consumers at 224 registers):
  wide 6 stages       a ring of 6 pieces (the depth; a ring is even, so
                      that a slot's pieces are one warpgroup's, and 8 do
                      not fit);
  wide 32-column pieces
                      pieces of 32 columns (8 KB with their small
                      parts), 8 in the ring: the same bytes (the piece
                      width);
  wide q small in registers
                      q's small parts as register A fragments (64
                      registers a thread, the first term of s RS), the
                      ring at 8 pieces;
  wide 64-key tiles   kv tiles of 64 keys (pieces of 64 x 64, 32 KB), which
                      fit only beside q's small parts in registers (as in
                      the variant above): 4 pieces, twice the bytes;
  wide 232 registers  the consumers at 232 registers and the producer at
                      40 (as built 224 and 56);
  wide no derive      the producer derives nothing (wrong: it prices the
                      derivation's shared-memory passes);
  wide roles by warp index
                      the roles chosen by threadIdx.x / 32 (as built by a
                      warpgroup index from __shfl_sync, which ptxas knows
                      to be uniform; else it serialises the wgmma, C7520);
  wide b held         the batch and head indices held from the consumers'
                      start to the output (as built read again there: held,
                      the batch index spilled);
  wide waits polled in C++
                      every mbarrier wait (of every wgmma kernel) polled in
                      a C++ loop around one try_wait, as before PR 31 (as
                      built, one PTX loop);
  wide one product    one wgmma a k-step, big.big, in s and in p.v (wrong,
                      1xTF32: it prices the two small terms).
Edits of B5 at hd 128 (the half kernels; their knobs, as built: 6 pieces
in the dq pass's ring, 4 in the dk/dv pass's):
  half dq 4 stages    the dq pass's ring at 4 pieces;
  half dkv 6 stages   the dk/dv pass's ring at 6 pieces;
  half k-step fence   each k-step's descriptors made just before its
                      products (their low words opaque there), not all of
                      a product's at once;
  half no derive      the producer derives no small parts or transposes
                      (wrong: it prices that shared-memory pass);
  half one product    one wgmma a k-step, big.big, in every product of both
                      passes (wrong, 1xTF32: it prices the two small terms);
  half 232 registers, half 240 registers
                      the consumers at 232 (the producer 40) or 240 (the
                      producer 24: setmaxnreg's least) registers, as built
                      224 (and 56);
  half dq one commit group
                      the dq pass's s and dp in one wgmma commit group (as
                      built one each, as the dk/dv pass's s^T and dp^T);
  half waits between  each tile's second piece awaited between its two score
                      products, and the dk/dv pass's q piece released
                      between their waits (the first build's order; as
                      built both pieces are awaited first and nothing runs
                      while the products fly);
  half no exchange    no barrier and no sum between the two warpgroups'
                      partial score products (wrong: it prices the
                      exchange);
  half dk/dv unsplit, half dk/dv in 3 splits, half dk/dv in 6 splits
                      the dk/dv pass in one, three or six splits a kv tile
                      (no edit: the split count the wrapper's dkv_splits
                      would not choose here).
"""
from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

CU, HEADER, WG_HEADER = "swa_attention.cu", "mma_tf32.cuh", "wgmma_tf32.cuh"
# the forward on wgmma: tile t's s issued beside tile t - 1's p.v (and the
# serial order), its products' three terms, the dq pass's register hand-over
FWD_OVERLAP = "      issue_s(stage(t));\n      issue_pv(stage(prev));\n      wg::wait<1>();\n"
FWD_SERIAL = ("      issue_pv(stage(prev));\n      wg::wait<0>();\n      issue_s(stage(t));\n"
              "      wg::wait<0>();\n")
FWD_S3 = ("      wg::mma_ss<BK>(sc, qs, kb, kk > 0);\n      wg::mma_ss<BK>(sc, qb, ks, 1);\n"
          "      wg::mma_ss<BK>(sc, qb, kb, 1);\n")
FWD_STAGES = "constexpr int kWgFwdStages = 4;"
FWD_PV3 = ("      wg::mma_rs<HD>(part, ps[n], tb, n > 0);\n      wg::mma_rs<HD>(part, pb[n], ts, 1);\n"
           "      wg::mma_rs<HD>(part, pb[n], tb, 1);\n")
FWD_DEALLOC_LINE = "    if constexpr (HD > 32) wg::reg_dealloc<kWgProducerRegs>();\n"
FWD_DEALLOC = "  if (warp >= kWgConsumers / 32) {\n" + FWD_DEALLOC_LINE + "    constexpr int kDerivers"
# the consumers' q: its small part derived into shared memory, the
# descriptors as low words, the kv loop's three parts (for "fwd turns")
FWD_QSMEM = """  for (int c = 0; c < HD / 16; ++c) {
    const int at = c * kWgRows * 16 + r0 * 16;
    small_tile(Qsm + at, Qs + at, 64 * 16, threadIdx.x & 127, 128);
  }
  wg::proxy_fence();
  wg::named_sync(kWgFwdGroupSync + wgi, 128);
"""
FWD_QREG = """  uint32_t {name}[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      {name}[kk][e] = __float_as_uint({value}(
          Qs[wg::swz(wr + g + 8 * (e & 1), 8 * kk + t4 + 4 * (e >> 1), kWgRows)]));
"""
FWD_DESC = ("  const uint32_t q_lo = wg::desc_lo(Qs + r0 * 16);\n"
            "  auto at = [](uint32_t lo, int floats) { return wg::desc_of(lo + floats / 4); };\n")
FWD_S_DESC = ("    uint32_t q = q_lo, k_lo = wg::desc_lo(Ks);\n    wg::reg_fence(q);\n#pragma unroll\n"
              "    for (int kk = 0; kk < KS; ++kk) {\n"
              "      const uint64_t qb = at(q, kstep(kk, kWgRows)), "
              "qs = at(q, kWgRows * HD + kstep(kk, kWgRows));\n"
              "      const uint64_t kb = at(k_lo, kstep(kk, BK)), ks = at(k_lo, 2 * TILE + kstep(kk, BK));\n")
FWD_S_PLAIN = ("#pragma unroll\n    for (int kk = 0; kk < KS; ++kk) {\n"
               "      const uint64_t qb = wg::desc(Qs + kstep(kk, kWgRows) + r0 * 16);\n"
               "      const uint64_t qs = wg::desc(Qsm + kstep(kk, kWgRows) + r0 * 16);\n"
               "      const uint64_t kb = wg::desc(Ks + kstep(kk, BK)), "
               "ks = wg::desc(Ks + 2 * TILE + kstep(kk, BK));\n")
FWD_PV_DESC = ("    const uint32_t v_lo = wg::desc_lo(Ks + 3 * TILE);\n#pragma unroll\n"
               "    for (int n = 0; n < BK / 8; ++n) {\n"
               "      const uint64_t tb = at(v_lo, kstep(n, HD)), ts = at(v_lo, TILE + kstep(n, HD));\n")
FWD_PV_PLAIN = ("#pragma unroll\n    for (int n = 0; n < BK / 8; ++n) {\n"
                "      const uint64_t tb = wg::desc(Ks + 3 * TILE + kstep(n, HD));\n"
                "      const uint64_t ts = wg::desc(Ks + 4 * TILE + kstep(n, HD));\n")
FWD_SKIP_LEAD = "  int t = 0;\n  for (; t < n_t && !live(t); ++t) skip(t);\n"
FWD_TURNS = """  uint64_t* turn = qbar + 1;  // warpgroup w's turn to issue: turn[w]
  if (threadIdx.x == 0) {
    wg::bar_init(&turn[0], 1);
    wg::bar_init(&turn[1], 1);
    wg::bar_arrive(&turn[0]);
    wg::bar_init_fence();
  }
  wg::named_sync(kWgSync, kWgConsumers);
  int slot = 0;
  auto turn_wait = [&]() { wg::bar_wait(&turn[wgi], slot & 1); };
  auto turn_pass = [&]() {
    if ((threadIdx.x & 127) == 0) wg::bar_arrive(&turn[wgi ^ 1]);
    ++slot;
  };
  auto turn_skip = [&](int t) {
    wg::bar_wait(&full[t % NS], (t / NS) & 1);
    turn_wait();
    turn_pass();
    release(t);
  };
  int t = 0;
  for (; t < n_t && !live(t); ++t) turn_skip(t);
"""
FWD_FIRST = "    wg::fence();\n    issue_s(stage(t));\n    wg::wait<0>();\n"
FWD_STEADY = ("      wg::fence();\n      issue_s(stage(t));\n      issue_pv(stage(prev));\n"
              "      wg::wait<1>();\n")
FWD_LAST = """    wg::fence();
    issue_pv(stage(prev));
    wg::wait<0>();
    reg_fence_all(part);
    reg_fence_all(pb);
    reg_fence_all(ps);
    release(prev);
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] += part[x];
  }
  for (; t < n_t; ++t) skip(t);
"""
FWD_LAST_TURNS = """    if (t < n_t) wg::bar_wait(&full[t % NS], (t / NS) & 1);
    turn_wait();
    wg::fence();
    issue_pv(stage(prev));
    turn_pass();
    wg::wait<0>();
    reg_fence_all(part);
    reg_fence_all(pb);
    reg_fence_all(ps);
    release(prev);
    if (t < n_t) release(t);
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] += part[x];
    ++t;
  }
  for (; t < n_t; ++t) turn_skip(t);
  if (t == n_t) {
    turn_wait();
    turn_pass();
  }
"""
FWD_ALLOC = ("  if constexpr (HD > 32) wg::reg_alloc<kWgConsumerRegs>();\n"
             "  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;\n"
             "  const int r0 = 64 * wgi, wr = r0 + 16 * w;  // the warpgroup's first row, the warp's\n"
             "\n  // the small parts of the warpgroup's 64 rows")
# B4 at hd 256 (swa_fwd_wg_wide_kernel): its knobs, and the three terms of
# s and of p.v
WIDE_KEYS = "constexpr int kWideFwdKeys = 32;"
WIDE_PIECE = "constexpr int kWideFwdPiece = 64;"
WIDE_STAGES = "constexpr int kWideFwdStages = 4;"
WIDE_QSM = "constexpr bool kWideFwdQsmRegs = false;"
WIDE_REGS = "constexpr int kWideFwdConsumerRegs = 224;"
WIDE_S3 = ("      if constexpr (QR) wg::mma_rs<BK>(sc, qsm[PW / 8 * x + kk], kb, more);\n"
           "      else wg::mma_ss<BK>(sc, at(ql, BQ * HD + kstep(qk, BQ)), kb, more);\n"
           "      wg::mma_ss<BK>(sc, qb, ks, 1);\n      wg::mma_ss<BK>(sc, qb, kb, 1);\n")
WIDE_S3_ONE = "      wg::mma_ss<BK>(sc, qb, kb, more);\n"
WIDE_PV3 = ("        wg::mma_rs<PW>(part, ps[n], tb, n > 0);\n"
            "        wg::mma_rs<PW>(part, pb[n], ts, 1);\n        wg::mma_rs<PW>(part, pb[n], tb, 1);\n")
WIDE_PV3_ONE = "        wg::mma_rs<PW>(part, pb[n], tb, n > 0);\n"
WIDE_ROLES = ("  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == kWgConsumers / 128) {\n"
              "    wg::reg_dealloc<kWideFwdProducerRegs>();")
WIDE_WGI = ("  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0), w = warp & 3, "
            "g = lane >> 2,\n            t4 = lane & 3, tid = threadIdx.x & 127;")
WIDE_TOP = "  const int q0 = wh.q0, j_lo = wh.j_lo, n_t = wh.n_t;\n"
WIDE_OUT_B = "  const int b = blockIdx.x / sh.H, h = blockIdx.x % sh.H;\n"
# mbarrier waits polled in a C++ loop (before PR 31's single PTX loop)
WAIT_PTX = ('__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {\n'
             '  asm volatile(\n'
             '      "{\\n.reg .pred p;\\n.reg .u32 n;\\nmov.u32 n, 0;\\n"\n'
             '      "WAIT:\\n"\n'
             '      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"\n'
             '      "@p bra DONE;\\n"\n'
             '      "add.u32 n, n, 1;\\nsetp.eq.u32 p, n, 67108864;\\n@p trap;\\n"\n'
             '      "bra.uni WAIT;\\n"\n'
             '      "DONE:\\n}\\n"\n'
             '      :: "r"(smem_addr(bar)), "r"(parity) : "memory");\n'
             '}\n')
WAIT_LOOP = ('__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {\n'
             '  const uint32_t addr = smem_addr(bar);\n'
             '  uint32_t done = 0;\n'
             '  for (uint32_t polls = 0; !done; ++polls) {\n'
             '    if (polls == (1u << 26)) __trap();\n'
             '    asm volatile(\n'
             '        "{\\n.reg .pred p;\\n"\n'
             '        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"\n'
             '        "selp.u32 %0, 1, 0, p;\\n}\\n"\n'
             '        : "=r"(done) : "r"(addr), "r"(parity) : "memory");\n'
             '  }\n'
             '}\n')
# B5 at hd 128 (the half kernels): their knobs, their three-term products
HALF_DQ_STAGES = "constexpr int kHalfDqStages = 6;"
HALF_DKV_STAGES = "constexpr int kHalfDkvStages = 4;"
HALF_DERIVE = ("    if (P % PIECES >= 4) {\n"
               "      transpose_warp<kHalfHd / 2, kHalfTile>(dst, dst + kHalfPiece, lane);\n"
               "      __syncwarp();\n    }\n"
               "    small_tile(dst + kHalfPiece, dst, kHalfPiece, lane, 32);\n")
HALF_ONE = [
    ("        wg::mma_ss<BK>(sc, at(ql, 2 * BQ * HD + kstep(qk, BQ)), bb, kk > 0);\n"
     "        wg::mma_ss<BK>(sc, ab_, bs, 1);\n        wg::mma_ss<BK>(sc, ab_, bb, 1);\n",
     "        wg::mma_ss<BK>(sc, ab_, bb, kk > 0);\n"),
    ("        wg::mma_ss<BK>(dp, at(ql, 3 * BQ * HD + kstep(qk, BQ)), bb, kk > 0);\n"
     "        wg::mma_ss<BK>(dp, ab_, bs, 1);\n        wg::mma_ss<BK>(dp, ab_, bb, 1);\n",
     "        wg::mma_ss<BK>(dp, ab_, bb, kk > 0);\n"),
    ("      wg::mma_rs<HALF>(part, as[n], tb, n > 0);\n      wg::mma_rs<HALF>(part, ab[n], ts, 1);\n"
     "      wg::mma_rs<HALF>(part, ab[n], tb, 1);\n",
     "      wg::mma_rs<HALF>(part, ab[n], tb, n > 0);\n"),
    ("        wg::mma_ss<BQ>(st, ks, bb, kk > 0);\n        wg::mma_ss<BQ>(st, kb, bs, 1);\n"
     "        wg::mma_ss<BQ>(st, kb, bb, 1);\n", "        wg::mma_ss<BQ>(st, kb, bb, kk > 0);\n"),
    ("        wg::mma_ss<BQ>(dpt, vs, bb, kk > 0);\n        wg::mma_ss<BQ>(dpt, vb, bs, 1);\n"
     "        wg::mma_ss<BQ>(dpt, vb, bb, 1);\n", "        wg::mma_ss<BQ>(dpt, vb, bb, kk > 0);\n"),
    ("        wg::mma_rs<HALF>(part, as[n], tb, n > 0);\n        wg::mma_rs<HALF>(part, ab[n], ts, 1);\n"
     "        wg::mma_rs<HALF>(part, ab[n], tb, 1);\n",
     "        wg::mma_rs<HALF>(part, ab[n], tb, n > 0);\n"),
]
HALF_REGS = "constexpr int kHalfConsumerRegs = 224;"
# each k-step's descriptors' low words opaque before its products
HALF_KSTEP_FN = ("// The derivers of a half kernel's ring",
                 "__device__ __forceinline__ void kstep_fence(uint32_t& a, uint32_t& b) {\n"
                 "  wg::reg_fence(a);\n  wg::reg_fence(b);\n}\n\n"
                 "// The derivers of a half kernel's ring")
HALF_KSTEP = [
    ("      const uint32_t b_lo = wg::desc_lo(kp);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n",
     "      uint32_t b_lo = wg::desc_lo(kp);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n        kstep_fence(ql, b_lo);\n"),
    ("      const uint32_t b_lo = wg::desc_lo(vp);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n",
     "      uint32_t b_lo = wg::desc_lo(vp);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n        kstep_fence(ql, b_lo);\n"),
    ("      const uint32_t b_lo = wg::desc_lo(qp);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n",
     "      uint32_t b_lo = wg::desc_lo(qp);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n        kstep_fence(kl, b_lo);\n"),
    ("      const uint32_t b_lo = wg::desc_lo(op);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n",
     "      uint32_t b_lo = wg::desc_lo(op);\n#pragma unroll\n"
     "      for (int kk = 0; kk < KS; ++kk) {\n        kstep_fence(kl, b_lo);\n"),
]
HALF_DQ_ONE_COMMIT = ("      wg::commit();\n    }\n    {\n      const uint32_t b_lo = wg::desc_lo(vp);\n",
                      "    }\n    {\n      const uint32_t b_lo = wg::desc_lo(vp);\n")
# each tile's second piece awaited between its two score products (the
# first build's order, which ptxas serialised, C7511)
HALF_WAIT_BETWEEN = [
    ("    float* kp = piece(t, wgi);\n    float* vp = piece(t, 2 + wgi);\n    wg::fence();\n",
     "    float* kp = piece(t, wgi);\n    wg::fence();\n"),
    ("      wg::commit();\n    }\n    {\n      const uint32_t b_lo = wg::desc_lo(vp);\n",
     "      wg::commit();\n    }\n    float* vp = piece(t, 2 + wgi);\n    {\n"
     "      const uint32_t b_lo = wg::desc_lo(vp);\n"),
    ("    float* qp = piece(t, wgi);\n    float* op = piece(t, 2 + wgi);\n    wg::fence();\n",
     "    float* qp = piece(t, wgi);\n    wg::fence();\n"),
    ("      wg::commit();\n    }\n    {\n      const uint32_t b_lo = wg::desc_lo(op);\n",
     "      wg::commit();\n    }\n    float* op = piece(t, 2 + wgi);\n    {\n"
     "      const uint32_t b_lo = wg::desc_lo(op);\n"),
    ("    wg::wait<0>();\n    reg_fence_all(st);\n    reg_fence_all(dpt);\n"
     "    release(t, wgi);  // the q piece\n",
     "    wg::wait<1>();\n    reg_fence_all(st);\n    release(t, wgi);  // the q piece\n"
     "    wg::wait<0>();\n    reg_fence_all(dpt);\n"),
]
HALF_EXCHANGE = [
    ("    wg::named_sync(kHalfXSync, kWgConsumers);\n    const float* theirs = Ring + slot(t, wgi ^ 1) "
     "* 2 * PART;\n#pragma unroll\n    for (int x = 0; x < BK / 2; ++x) {\n"
     "      sc[x] += theirs[x * 128 + tid];\n      dp[x] += theirs[BQ * BK + x * 128 + tid];\n    }\n",
     ""),
    ("    wg::named_sync(kHalfXSync, kWgConsumers);\n    const float* theirs = Ring + slot(t, 2 + (wgi ^ 1)) "
     "* 2 * PART;\n#pragma unroll\n    for (int x = 0; x < BQ / 2; ++x) {\n"
     "      st[x] += theirs[x * 128 + tid];\n      dpt[x] += theirs[BK * BQ + x * 128 + tid];\n    }\n",
     ""),
]
# the dk/dv pass's split count by variant (no edit); others: the wrapper's
HALF_SPLITS = {"half dk/dv unsplit": 1, "half dk/dv in 3 splits": 3, "half dk/dv in 6 splits": 6}
WIDE_DERIVE = ("      if (P % PIECES >= 2 * KP) {\n"
               "        transpose_warp<PW, BK>(dst, dst + PART, lane);\n        __syncwarp();\n"
               "      }\n      small_tile(dst + PART, dst, PART, lane, 32);\n")
# the two small terms of every wgmma product (dq pass: s, dp, dq; dk/dv
# pass: s^T, dp^T, then dv and dk in one loop)
WG_SMALL = [
    "        wg::mma_rs<BK>(sc, qsm[kk], kb, kk > 0);\n        wg::mma_ss<BK>(sc, qb, ks, 1);\n",
    "        wg::mma_rs<BK>(dp, osm[kk], vb, kk > 0);\n        wg::mma_ss<BK>(dp, ob, vs, 1);\n",
    "      wg::mma_rs<HD>(part, as[n], tb, n > 0);\n      wg::mma_rs<HD>(part, ab[n], ts, 1);\n",
    "        wg::mma_ss<BQ>(st, ks, qb, kk > 0);\n        wg::mma_ss<BQ>(st, kb, qs, 1);\n",
    "        wg::mma_ss<BQ>(dpt, vs, ob, kk > 0);\n        wg::mma_ss<BQ>(dpt, vb, os, 1);\n",
    "        wg::mma_rs<HD>(part, as[n], tb, n > 0);\n"
    "        wg::mma_rs<HD>(part, ab[n], ts, 1);\n",
]
SETMAXNREG = '  asm volatile("setmaxnreg.{}.sync.aligned.u32 %0;\\n" :: "n"(N));'
WG_DERIVE = [
    "      small_tile(Ks + 2 * TILE, Ks, 2 * TILE, pt, 128);  // k's and v's small parts\n"
    "      transpose_tile<HD>(Ks + 4 * TILE, Ks + 5 * TILE, Ks, pt, 128);\n",
    "      small_tile(Qs + 2 * TILE, Qs, 2 * TILE, pt, 128);  // q's and do's small parts\n",
    "      transpose_tile<HD>(QTb, QTs, Qs, pt, 128);\n"
    "      transpose_tile<HD>(dOTb, dOTs, Qs + TILE, pt, 128);\n",
]


# name -> [(file, edited text, replacement)], whether the numerics hold
VARIANTS = {
    "as built": ([], True),
    "fwd serial": ([(CU, FWD_OVERLAP, FWD_SERIAL)], True),
    "fwd one product": ([(CU, FWD_S3, "      wg::mma_ss<BK>(sc, qb, kb, kk > 0);\n"),
                         (CU, FWD_PV3, "      wg::mma_rs<HD>(part, pb[n], tb, n > 0);\n")], False),
    "fwd 64-key tiles": ([(CU, "constexpr int kWgFwdKeys = 32;", "constexpr int kWgFwdKeys = 64;"),
                          (CU, FWD_STAGES, FWD_STAGES.replace("4", "2"))], True),
    "fwd 3 stages": ([(CU, FWD_STAGES, FWD_STAGES.replace("4", "3"))], True),
    "fwd setmaxnreg": ([(CU, FWD_DEALLOC.replace(FWD_DEALLOC_LINE, ""), FWD_DEALLOC),
                        (CU, FWD_ALLOC.split("\n", 1)[1], FWD_ALLOC)], True),
    "fwd 2 stages": ([(CU, FWD_STAGES, FWD_STAGES.replace("4", "2"))], True),
    "fwd turns": ([
        (CU, "         (3 * kWgFwdStages + 1) * sizeof(uint64_t) + 1024;",
         "         (3 * kWgFwdStages + 3) * sizeof(uint64_t) + 1024;"),
        (CU, FWD_SKIP_LEAD, FWD_TURNS),
        (CU, FWD_FIRST, "    turn_wait();\n    wg::fence();\n    issue_s(stage(t));\n"
                        "    turn_pass();\n    wg::wait<0>();\n"),
        (CU, FWD_STEADY, "      turn_wait();\n" + FWD_STEADY.replace(
            "      wg::wait<1>();\n", "      turn_pass();\n      wg::wait<1>();\n")),
        (CU, FWD_LAST, FWD_LAST_TURNS)], True),
    "fwd q small in registers": ([
        (CU, FWD_QSMEM, FWD_QREG.format(name="qsm", value="wg::small_part")),
        (CU, FWD_S3, FWD_S3.replace("mma_ss<BK>(sc, qs,", "mma_rs<BK>(sc, qsm[kk],"))], True),
    "fwd q big in registers": ([
        (CU, FWD_QSMEM, FWD_QSMEM + FWD_QREG.format(name="qbr", value="")),
        (CU, FWD_S3, FWD_S3.replace("mma_ss<BK>(sc, qb,", "mma_rs<BK>(sc, qbr[kk],"))], True),
    "fwd plain descriptors": ([(CU, FWD_DESC, ""), (CU, FWD_S_DESC, FWD_S_PLAIN),
                               (CU, FWD_PV_DESC, FWD_PV_PLAIN)], True),
    "wg no derive": ([(CU, x, "") for x in WG_DERIVE], False),
    "wg one product": ([(CU, x, "") for x in WG_SMALL], False),
    "wg no setmaxnreg": ([(WG_HEADER, SETMAXNREG.format("inc"), ""),
                          (WG_HEADER, SETMAXNREG.format("dec"), "")], True),
    "wide 6 stages": ([(CU, WIDE_STAGES, WIDE_STAGES.replace("4", "6"))], True),
    "wide 32-column pieces": ([(CU, WIDE_PIECE, WIDE_PIECE.replace("64", "32")),
                               (CU, WIDE_STAGES, WIDE_STAGES.replace("4", "8"))], True),
    "wide q small in registers": ([(CU, WIDE_QSM, WIDE_QSM.replace("false", "true")),
                                   (CU, WIDE_STAGES, WIDE_STAGES.replace("4", "8"))], True),
    "wide 64-key tiles": ([(CU, WIDE_KEYS, WIDE_KEYS.replace("32", "64")),
                           (CU, WIDE_QSM, WIDE_QSM.replace("false", "true"))], True),
    "wide 232 registers": ([(CU, WIDE_REGS, WIDE_REGS.replace("224", "232"))], True),
    "wide no derive": ([(CU, WIDE_DERIVE, "")], False),
    "wide one product": ([(CU, WIDE_S3, WIDE_S3_ONE), (CU, WIDE_PV3, WIDE_PV3_ONE)], False),
    "wide roles by warp index": ([
        (CU, WIDE_ROLES, "  if (warp >= kWgConsumers / 32) {\n    wg::reg_dealloc<kWideFwdProducerRegs>();"),
        (CU, WIDE_WGI, "  const int wgi = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3, "
                       "tid = threadIdx.x & 127;")], True),
    "wide b held": ([(CU, WIDE_TOP, "  const int b = wh.b, h = wh.h, q0 = wh.q0, j_lo = wh.j_lo, "
                                    "n_t = wh.n_t;\n"), (CU, WIDE_OUT_B, "")], True),
    "wide waits polled in C++": ([(WG_HEADER, WAIT_PTX, WAIT_LOOP)], True),
    "half dq 4 stages": ([(CU, HALF_DQ_STAGES, HALF_DQ_STAGES.replace("6", "4"))], True),
    "half dkv 6 stages": ([(CU, HALF_DKV_STAGES, HALF_DKV_STAGES.replace("4", "6"))], True),
    "half k-step fence": ([(CU, old, new) for old, new in HALF_KSTEP]
                          + [(CU, HALF_KSTEP_FN[0], HALF_KSTEP_FN[1])], True),
    "half no derive": ([(CU, HALF_DERIVE, "")], False),
    "half one product": ([(CU, old, new) for old, new in HALF_ONE], False),
    "half 232 registers": ([(CU, HALF_REGS, HALF_REGS.replace("224", "232"))], True),
    "half 240 registers": ([(CU, HALF_REGS, HALF_REGS.replace("224", "240"))], True),
    "half dq one commit group": ([(CU, *HALF_DQ_ONE_COMMIT)], True),
    "half waits between": ([(CU, old, new) for old, new in HALF_WAIT_BETWEEN], True),
    "half no exchange": ([(CU, old, new) for old, new in HALF_EXCHANGE], False),
    **{name: ([], True) for name in HALF_SPLITS},
}


# the instances reported: name -> its mangled kernel, head dim and dtype
REPORTED = {"swa_fwd_wg_kernel": "swa_fwd_wg_kernelILi64EfEE",
            "swa_bwd_dq_wg_kernel": "swa_bwd_dq_wg_kernelILi64EfEE",
            "swa_bwd_dkv_wg_kernel": "swa_bwd_dkv_wg_kernelILi64EfEE",
            "swa_fwd_wg_wide_kernel": "swa_fwd_wg_wide_kernelILi256EfEE",
            "swa_fwd_wg_wide_kernel bf16": "swa_fwd_wg_wide_kernelILi256E13__nv_bfloat16EE",
            "swa_bwd_dq_wg_half_kernel": "swa_bwd_dq_wg_half_kernelILi128EfEE",
            "swa_bwd_dq_wg_half_kernel bf16": "swa_bwd_dq_wg_half_kernelILi128E13__nv_bfloat16EE",
            "swa_bwd_dkv_wg_half_kernel": "swa_bwd_dkv_wg_half_kernelILi128EfEE",
            "swa_bwd_dkv_wg_half_kernel bf16":
                "swa_bwd_dkv_wg_half_kernelILi128E13__nv_bfloat16EE"}


def fwd_build(log: str) -> dict:
    """ptxas's registers and spills of REPORTED's instances, and the codes
    of its notes that it serialised their wgmma (C75xx)."""
    out, inside = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if "wgmma.mma_async instructions are serialized" in line:
            code = re.search(r"\((C\d+)\)", line)
            for k, mangled in REPORTED.items():
                if mangled in line:
                    out.setdefault(k, {}).setdefault("serialised", []).append(
                        code.group(1) if code else "?")
        if m:
            inside = next((k for k, mangled in REPORTED.items() if mangled in m.group(1)), None)
        elif inside and "Used" in line:
            out.setdefault(inside, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        elif inside and "spill stores" in line:
            out.setdefault(inside, {})["spill_bytes"] = [int(x) for x in re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()]
    return out


def build_variants(out: Path, names):
    """{variant: (loaded library, the build report)} of the variants `names`;
    one nvcc per variant, all started together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.swa_attention.ops import SOURCE

    jobs = {}
    for i, name in enumerate(names):
        edits = VARIANTS[name][0]
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        text = {CU: SOURCE.read_text(), HEADER: (SOURCE.parent / HEADER).read_text(),
                WG_HEADER: (SOURCE.parent / WG_HEADER).read_text()}
        for f, old, new in edits:
            if text[f].count(old) != 1:
                raise AssertionError(f"variant {name!r}: its edit of {f} no longer applies")
            text[f] = text[f].replace(old, new)
        for f, body in text.items():
            (d / f).write_text(body)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / CU)]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # dtype, B, Sq, Sk, H, K, hd, window, prefix, scale, stream
        dims = [i] * 9 + [f, p]
        lib.swa_attention_fwd.argtypes = [p] * 5 + dims
        lib.swa_attention_bwd_dq.argtypes = [p] * 8 + dims
        lib.swa_attention_bwd_dkv.argtypes = [p] * 8 + [p, i] + dims  # ws, splits
        for fn in (lib.swa_attention_fwd, lib.swa_attention_bwd_dq, lib.swa_attention_bwd_dkv):
            fn.restype = i
        libs[name] = (lib, fwd_build(log))
    return libs


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# B, S, H, K, hd, window, prefix: smollm-135m's full-width path (causal),
# whisper-large-v3's encoder (bidirectional: a prefix of S) and
# paligemma-3b's Engine-B tiers (hd 256, the prefix-LM mask)
SHAPES = {"smollm-135m": (8, 1024, 9, 3, 64, 0, 0),
          "whisper encoder": (4, 1500, 20, 20, 64, 0, 1500),
          "paligemma-3b": (4, 512, 8, 1, 256, 0, 256),
          "qwen2-1.5b": (4, 1024, 12, 2, 128, 0, 0)}


def shapes_of(name: str):
    """The shapes at which a variant is timed: the "wide" ones at hd 256,
    the "half" ones at hd 128, the others at hd 64, "as built" at all."""
    if name == "as built":
        return tuple(SHAPES)
    if name.startswith("half"):
        return ("qwen2-1.5b",)
    return ("paligemma-3b",) if name.startswith("wide") else ("smollm-135m", "whisper encoder")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"chip_ablate_attention.py: no variant {unknown}; the variants are "
              f"{list(VARIANTS)}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_ablate_attention.py: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ablate_attention.py: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.swa_attention import (
        dkv_launch_splits, swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref, swa_attention_ref,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants(ROOT / "build" / "ablation", names)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (B, S, H, K, hd, W, P) in SHAPES.items():
        here = [name for name in libs if label in shapes_of(name)]
        if not here:
            continue
        gen = torch.Generator(device=dev).manual_seed(3)
        q, do = (torch.randn(B, S, H, hd, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(B, S, K, hd, generator=gen, device=dev) for _ in range(2))
        ro, rlse = swa_attention_ref(q, k, v, W, P)
        ro = ro.contiguous()
        # every variant's backward reads the plain forward's o and lse
        rdq, delta = swa_attention_bwd_dq_ref(q, k, v, ro, rlse, do, W, P)
        rdk, rdv = swa_attention_bwd_dkv_ref(q, k, v, rlse, delta, do, W, P)
        dims = (0, B, S, S, H, K, hd, W, P, 1.0 / math.sqrt(hd), stream)
        ws = torch.empty(H // K * 2 * k.numel(), device=dev)  # the split dk/dv's sums

        times = {name: [] for name in here}
        errs = {}
        for name in here + here[::-1]:
            lib, _ = libs[name]
            o, lse = torch.empty_like(q), torch.empty_like(rlse)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            dl = torch.empty_like(rlse)

            def run_fwd(lib=lib, o=o, lse=lse):
                if lib.swa_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         lse.data_ptr(), *dims):
                    raise RuntimeError("forward launch failed")

            def run_dq(lib=lib, dq=dq, dl=dl):
                if lib.swa_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            ro.data_ptr(), do.data_ptr(), rlse.data_ptr(),
                                            dl.data_ptr(), dq.data_ptr(), *dims):
                    raise RuntimeError("dq launch failed")

            # hd 256: one split; hd 128: the variant's, else the wrapper's
            splits = (HALF_SPLITS.get(name, dkv_launch_splits(q, k, W, P)) if hd == 128
                      else 1)

            def run_dkv(lib=lib, dk=dk, dv=dv, splits=splits):
                if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             do.data_ptr(), rlse.data_ptr(), delta.data_ptr(),
                                             dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), splits,
                                             *dims):
                    raise RuntimeError("dk/dv launch failed")

            times[name].append((cuda_ms(run_fwd), cuda_ms(run_dq), cuda_ms(run_dkv)))
            # the forward: worst |err| / (2e-5 + 2e-5 |ref|) of o and lse (at most
            # 1 within its tolerance); the backward: max err / max|ref| of dq, dk, dv
            errs[name] = ([float(((a - r).abs() / (2e-5 + 2e-5 * r.abs())).max())
                           for a, r in ((o, ro), (lse, rlse))],
                          [float((a - r).abs().max() / r.abs().max())
                           for a, r in ((dq, rdq), (dk, rdk), (dv, rdv))])
        for name, ts in times.items():
            keeps = VARIANTS[name][1]
            fwd_err, bwd_err = errs[name]
            build = libs[name][1]
            rows.append({"variant": name, "shape": label, "keeps_numerics": keeps,
                         "dkv_splits": (HALF_SPLITS.get(name, dkv_launch_splits(q, k, W, P))
                                        if hd == 128 else 1),
                         "fwd_ms": [t[0] for t in ts], "dq_ms": [t[1] for t in ts],
                         "dkv_ms": [t[2] for t in ts], "build_f32": build,
                         "fwd_err_o_lse_of_tolerance": fwd_err,
                         "err_dq_dk_dv_of_max_ref": bwd_err})
            print(f"[ablation] {label} {name:16s} fwd {ts[0][0]:.4f}, {ts[1][0]:.4f} ms; dq "
                  f"{ts[0][1]:.4f}, {ts[1][1]:.4f} ms; dk/dv {ts[0][2]:.4f}, {ts[1][2]:.4f} ms; "
                  "registers and spill stores/loads bytes "
                  + ", ".join(f"{k} {b.get('registers')} {b.get('spill_bytes')}"
                              + (f" serialised {b['serialised']}" if b.get("serialised") else "")
                              for k, b in build.items())
                  + "; fwd |err| / tolerance (o, lse) " + ", ".join(f"{e:.2e}" for e in fwd_err)
                  + "; max err / max|ref| (dq, dk, dv) " + ", ".join(f"{e:.2e}" for e in bwd_err)
                  + ("" if keeps else " (changes the arithmetic: timing only)")
                  + f"; f32 [{B}, {S}, {H}, {K}, {hd}] window {W} prefix {P}; card {card}")
            if keeps and (max(fwd_err) > 1.0 or max(bwd_err) > 2e-5):
                raise AssertionError(f"variant {name!r} misses the tolerance: {errs[name]}")
        del q, do, k, v, ro, rlse, rdq, delta, rdk, rdv, ws
    print(json.dumps({"ablation": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
