#!/usr/bin/env python3
"""Time B5's two passes against edited copies of their source, on one GPU.

    python3 chip_ablate_b5.py

Each variant is ``csrc/swa_attention.cu`` and ``csrc/mma_tf32.cuh`` with
one edit, built with the package's nvcc flags into ``build/ablation/``
(all builds started together) and loaded through ctypes beside the
package's own build.  Every variant's dq and dk/dv passes are timed with
CUDA events at the full-width smollm-135m shape, f32 [8, 1024, 9, 3, 64],
window 0, in turns (the variants in order, then in reverse, one card), and
held against the plain versions.  A variant that changes the arithmetic
says so: it is a measure of what a part of the kernel costs, not a kernel.

  as built        the package's source, unedited;
  cvt.rna split   the TF32 rounding by cvt.rna.tf32.f32 instead of the
                  integer add and mask (the same values);
  split free      no split: big = the f32 bits, small = 0 (wrong: it
                  prices the split's instructions);
  one product     the two small-term mma dropped (wrong, 1xTF32: it prices
                  the extra mma).
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MMA3 = """  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);"""
ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
SPLIT = "  big = to_tf32(x);\n  small = to_tf32(x - __uint_as_float(big));"
# name -> [(edited text in mma_tf32.cuh, replacement)], whether the numerics hold
VARIANTS = {
    "as built": ([], True),
    "cvt.rna split": ([(ROUND, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) '
                               ': "f"(x));\n  return r;')], True),
    "split free": ([(SPLIT, "  big = __float_as_uint(x);\n  small = 0u;")], False),
    "one product": ([(MMA3, "  mma(d, a_big, b_big);")], False),
}


def build_variants(out: Path):
    """{variant: loaded library}; one nvcc per variant, all started together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.swa_attention.ops import SOURCE

    jobs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        header = (SOURCE.parent / "mma_tf32.cuh").read_text()
        for old, new in edits:
            if old not in header:
                raise AssertionError(f"variant {name!r}: its edit no longer applies")
            header = header.replace(old, new)
        (d / "mma_tf32.cuh").write_text(header)
        (d / SOURCE.name).write_text(SOURCE.read_text())
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / SOURCE.name)]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.swa_attention_bwd_dq, lib.swa_attention_bwd_dkv):
            fn.argtypes = [p] * 8 + [i, i, i, i, i, i, i, f, p]
            fn.restype = i
        libs[name] = lib
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


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_ablate_b5.py: src/repro_torch is missing beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ablate_b5.py: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.swa_attention import (
        swa_attention_bwd_dkv_ref, swa_attention_bwd_dq_ref, swa_attention_fwd,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants(ROOT / "build" / "ablation")

    dev = torch.device("cuda", 0)
    B, S, H, K, hd, W = 8, 1024, 9, 3, 64, 0
    gen = torch.Generator(device=dev).manual_seed(3)
    q, do = (torch.randn(B, S, H, hd, generator=gen, device=dev) for _ in range(2))
    k, v = (torch.randn(B, S, K, hd, generator=gen, device=dev) for _ in range(2))
    o, lse = swa_attention_fwd(q, k, v, W)
    rdq, delta = swa_attention_bwd_dq_ref(q, k, v, o, lse, do, W)
    rdk, rdv = swa_attention_bwd_dkv_ref(q, k, v, lse, delta, do, W)
    stream = torch.cuda.current_stream().cuda_stream
    dims = (0, B, S, H, K, hd, W, 1.0 / math.sqrt(hd), stream)

    times = {name: [] for name in libs}
    errs = {}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dl = torch.empty_like(lse)

        def run_dq(lib=lib, dq=dq, dl=dl):
            if lib.swa_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        do.data_ptr(), lse.data_ptr(), dl.data_ptr(),
                                        dq.data_ptr(), *dims):
                raise RuntimeError("dq launch failed")

        def run_dkv(lib=lib, dk=dk, dv=dv):
            if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                         dv.data_ptr(), *dims):
                raise RuntimeError("dk/dv launch failed")

        times[name].append((cuda_ms(run_dq), cuda_ms(run_dkv)))
        errs[name] = [float((a - r).abs().max() / r.abs().max())
                      for a, r in ((dq, rdq), (dk, rdk), (dv, rdv))]
    rows = []
    for name, ts in times.items():
        row = {"variant": name, "keeps_numerics": VARIANTS[name][1],
               "dq_ms": [t[0] for t in ts], "dkv_ms": [t[1] for t in ts],
               "err_dq_dk_dv_of_max_ref": errs[name]}
        rows.append(row)
        print(f"[ablation] {name:14s} dq {ts[0][0]:.4f}, {ts[1][0]:.4f} ms; dk/dv "
              f"{ts[0][1]:.4f}, {ts[1][1]:.4f} ms; max err / max|ref| (dq, dk, dv) "
              + ", ".join(f"{e:.2e}" for e in errs[name])
              + ("" if VARIANTS[name][1] else " (changes the arithmetic: timing only)")
              + f"; f32 [{B}, {S}, {H}, {K}, {hd}] window {W}; card {card}")
        if VARIANTS[name][1] and max(errs[name]) > 2e-5:
            raise AssertionError(f"variant {name!r} misses the 2e-5 tolerance: {errs[name]}")
    print(json.dumps({"ablation": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
