#!/usr/bin/env python3
"""Time the attention kernels (B4, B5) against edited copies of their source,
on one GPU.

    python3 chip_ablate_attention.py [VARIANT ...]

Each variant is ``csrc/swa_attention.cu`` with its headers
(``mma_tf32.cuh``, ``wgmma_tf32.cuh``) and one edit, built with the
package's nvcc flags into ``build/ablation/`` (all builds started together)
and loaded through ctypes beside the package's own build; naming variants
builds only those.  Every variant's forward (B4) and backward passes (B5
dq, dk/dv) are timed with CUDA events at the full-width smollm-135m shape,
f32 [8, 1024, 9, 3, 64], window 0, and at whisper-large-v3's encoder, f32
[4, 1500, 20, 20, 64], prefix 1500 (bidirectional), in turns (the variants
in order, then in reverse, one card), and held against the plain versions;
ptxas's registers and spills of the forward and of both wgmma passes at
<64, f32> are printed beside them.  A variant that changes the arithmetic
says so: it is a measure of what a part of the kernels costs, not a kernel.

Edits of ``mma_tf32.cuh``, which reach B4 and B5 at hd 80-128 (B5 at hd
<= 64 runs on wgmma, hd 256 on the 8-warp kernels):
  as built          the package's source, unedited;
  cvt.rna split     the TF32 rounding by cvt.rna.tf32.f32 instead of the
                    integer add and mask (the same values);
  split free        no split: big = the f32 bits, small = 0 (wrong: it
                    prices the split's instructions);
  one product       the two small-term mma dropped (wrong, 1xTF32: it prices
                    the extra mma).
Edits of the forward (B4) alone, each within the forward's tolerance:
  fwd expf            the scores in natural-log units and expf, where the
                      kernel folds log2(e) into q's scale and takes exp2f;
  fwd one s acc       s's three products summed in one accumulator, where
                      the kernel sums the two small terms in a second one;
  fwd 4-byte loads    q and k at a pitch of hd + 4 and load_a / load_b's
                      fragments (one 4-byte load a value), where the kernel
                      permutes the k slots and loads 8 bytes a lane;
  fwd q split once    q's fragments split once per block and kept in
                      registers (hd / 8 x 8 of them), 2 blocks an SM;
  fwd 64-key tiles    kv tiles of 64 keys instead of 32, 2 blocks an SM (the
                      shared memory of the ring);
  fwd 4 blocks/SM     the launch bound of 3 blocks an SM raised to 4 (128
                      registers a thread);
  fwd 2 blocks/SM     ... lowered to 2.
Edits of B5's wgmma passes (hd <= 64):
  wg no derive        the producer warpgroup derives no small parts or
                      transposes (wrong: it prices that shared-memory pass,
                      which runs beside the consumers' products);
  wg one product      one wgmma a k-step, big.big, in every product (wrong:
                      it prices the two small terms);
  wg no setmaxnreg    the dq pass's register hand-over dropped: every warp
                      at the 168 registers that ptxas allots 12 warps.
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

MMA3 = """  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);"""
ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
SPLIT = "  big = to_tf32(x);\n  small = to_tf32(x - __uint_as_float(big));"
FWD_BOUND = "__launch_bounds__(kThreads, HD <= 64 ? 3 : 1)\nswa_fwd_kernel("
FWD_Q = ("      uint32_t qb[4], qs[4];\n"
         "      load_a_pairs(Qs, LDQ, wr, kk, qscale, qb, qs);\n")
FWD_ACC = "  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f}, acc[NT][4];\n"
S_MMA = ("        tf32::mma(sl[n], qs, kb);\n        tf32::mma(sl[n], qb, ks);\n"
         "        tf32::mma(s[n], qb, kb);\n")
S_ADD = ("#pragma unroll\n    for (int n = 0; n < NS; ++n)\n#pragma unroll\n"
         "      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];\n")
CU, HEADER, WG_HEADER = "swa_attention.cu", "mma_tf32.cuh", "wgmma_tf32.cuh"
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


def blocks(n: int):
    return [(CU, FWD_BOUND, FWD_BOUND.replace("? 3", f"? {n}"))]


# name -> [(file, edited text, replacement)], whether the numerics hold
VARIANTS = {
    "as built": ([], True),
    "cvt.rna split": ([(HEADER, ROUND, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) '
                                       ': "f"(x));\n  return r;')], True),
    "split free": ([(HEADER, SPLIT, "  big = __float_as_uint(x);\n  small = 0u;")], False),
    "one product": ([(HEADER, MMA3, "  mma(d, a_big, b_big);")], False),
    "fwd expf": ([
        (CU, "const float qscale = sh.scale * kLog2e;", "const float qscale = sh.scale;"),
        (CU, "exp2f(s[n][e] - m_new)", "expf(s[n][e] - m_new)"),
        (CU, "exp2f(m[r] - m_new)", "expf(m[r] - m_new)"),
        (CU, "kLn2 * m[e2] + logf(lr)", "m[e2] + logf(lr)"),
    ], True),
    "fwd one s acc": ([(CU, S_MMA, "        tf32::mma3(s[n], qb, qs, kb, ks);\n"),
                       (CU, S_ADD, "")], True),
    "fwd 4-byte loads": ([
        (CU, "LDQ = HD + 8", "LDQ = HD + 4"),
        (CU, "load_a_pairs(Qs, LDQ, wr, kk, qscale, qb, qs);",
         "tf32::load_a(Qs, LDQ, wr, kk, qscale, qb, qs);"),
        (CU, "load_b_pairs(Ks, LDQ, 8 * n, kk, kb, ks);",
         "tf32::load_b(Ks, LDQ, 8 * n, kk, 1.0f, kb, ks);"),
        (CU, "((BQ + 2 * kFwdKeys) * (HD + 8)", "((BQ + 2 * kFwdKeys) * (HD + 4)"),
    ], True),
    "fwd q split once": (blocks(2) + [
        (CU, FWD_ACC, "  tf32::cp_async_wait<0>();\n  __syncthreads();\n"
                      "  uint32_t qfb[NT][4], qfs[NT][4];\n#pragma unroll\n"
                      "  for (int c = 0; c < NT; ++c)\n"
                      "    load_a_pairs(Qs, LDQ, wr, 8 * c, qscale, qfb[c], qfs[c]);\n"
                      + FWD_ACC),
        (CU, FWD_Q, "      const uint32_t (&qb)[4] = qfb[kk / 8];\n"
                    "      const uint32_t (&qs)[4] = qfs[kk / 8];\n"),
    ], True),
    "fwd 64-key tiles": ([(CU, "constexpr int kFwdKeys = 32;", "constexpr int kFwdKeys = 64;")]
                         + blocks(2), True),
    "fwd 4 blocks/SM": (blocks(4), True),
    "fwd 2 blocks/SM": (blocks(2), True),
    "wg no derive": ([(CU, x, "") for x in WG_DERIVE], False),
    "wg one product": ([(CU, x, "") for x in WG_SMALL], False),
    "wg no setmaxnreg": ([(WG_HEADER, SETMAXNREG.format("inc"), ""),
                          (WG_HEADER, SETMAXNREG.format("dec"), "")], True),
}


REPORTED = ("swa_fwd_kernel", "swa_bwd_dq_wg_kernel", "swa_bwd_dkv_wg_kernel")


def fwd_build(log: str) -> dict:
    """ptxas's registers and spills of REPORTED's kernels at <64, f32>."""
    out, inside = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inside = next((k for k in REPORTED if f"{k}ILi64EfEE" in m.group(1)), None)
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


# B, S, H, K, hd, window, prefix: smollm-135m's full-width path (causal)
# and whisper-large-v3's encoder (bidirectional: a prefix of S)
SHAPES = {"smollm-135m": (8, 1024, 9, 3, 64, 0, 0),
          "whisper encoder": (4, 1500, 20, 20, 64, 0, 1500)}


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
        swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref, swa_attention_ref,
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
        gen = torch.Generator(device=dev).manual_seed(3)
        q, do = (torch.randn(B, S, H, hd, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(B, S, K, hd, generator=gen, device=dev) for _ in range(2))
        ro, rlse = swa_attention_ref(q, k, v, W, P)
        ro = ro.contiguous()
        # every variant's backward reads the plain forward's o and lse
        rdq, delta = swa_attention_bwd_dq_ref(q, k, v, ro, rlse, do, W, P)
        rdk, rdv = swa_attention_bwd_dkv_ref(q, k, v, rlse, delta, do, W, P)
        dims = (0, B, S, S, H, K, hd, W, P, 1.0 / math.sqrt(hd), stream)

        times = {name: [] for name in libs}
        errs = {}
        for name in list(libs) + list(libs)[::-1]:
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

            def run_dkv(lib=lib, dk=dk, dv=dv):
                if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             do.data_ptr(), rlse.data_ptr(), delta.data_ptr(),
                                             dk.data_ptr(), dv.data_ptr(), None, 1,
                                             *dims):  # hd 64: no split
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
                         "fwd_ms": [t[0] for t in ts], "dq_ms": [t[1] for t in ts],
                         "dkv_ms": [t[2] for t in ts], "build_64_f32": build,
                         "fwd_err_o_lse_of_tolerance": fwd_err,
                         "err_dq_dk_dv_of_max_ref": bwd_err})
            print(f"[ablation] {label} {name:16s} fwd {ts[0][0]:.4f}, {ts[1][0]:.4f} ms; dq "
                  f"{ts[0][1]:.4f}, {ts[1][1]:.4f} ms; dk/dv {ts[0][2]:.4f}, {ts[1][2]:.4f} ms; "
                  f"<64, f32> registers and spill stores/loads bytes "
                  + ", ".join(f"{k} {b.get('registers')} {b.get('spill_bytes')}"
                              for k, b in build.items())
                  + "; fwd |err| / tolerance (o, lse) " + ", ".join(f"{e:.2e}" for e in fwd_err)
                  + "; max err / max|ref| (dq, dk, dv) " + ", ".join(f"{e:.2e}" for e in bwd_err)
                  + ("" if keeps else " (changes the arithmetic: timing only)")
                  + f"; f32 [{B}, {S}, {H}, {K}, {hd}] window {W} prefix {P}; card {card}")
            if keeps and (max(fwd_err) > 1.0 or max(bwd_err) > 2e-5):
                raise AssertionError(f"variant {name!r} misses the tolerance: {errs[name]}")
        del q, do, k, v, ro, rlse, rdq, delta, rdk, rdv
    print(json.dumps({"ablation": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
