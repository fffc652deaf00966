#!/usr/bin/env python3
"""Hold the attention kernels (B4, B5) of this tree against an earlier
tree's, bit for bit, on one GPU, where queries and keys are one sequence.

    python3 chip_compare_parent.py PARENT_DIR

PARENT_DIR holds a checkout of the earlier commit (``git archive`` of it,
unpacked).  Its ``csrc/swa_attention.cu`` takes one sequence length S in
each C entry (dtype, B, S, H, K, hd, window, prefix, scale, stream); this
tree's takes Sq and Sk.  Both sources are built with the package's nvcc
flags, in parallel; then B4, the dq pass and the dk/dv pass of both run on
the same inputs at every head dim, f32 and bf16, causal, windowed, with a
prefix and bidirectional (a prefix of S), at ragged and tile-edge lengths,
and every output (o, lse, dq, delta, dk, dv) must be equal bit for bit.
Prints the card, the count of equal outputs, and exits non-zero on any
difference.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REL = Path("src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu")

# B, S, H, K, hd, window, prefix
CASES = [(8, 1024, 9, 3, 64, 0, 0), (8, 1024, 9, 3, 64, 128, 0), (1, 300, 4, 1, 64, 128, 0),
         (2, 384, 4, 4, 128, 256, 0), (1, 512, 8, 2, 80, 0, 0), (1, 256, 6, 3, 96, 128, 0),
         (8, 256, 8, 2, 32, 0, 0), (4, 512, 16, 8, 64, 0, 0), (4, 512, 8, 1, 256, 0, 256),
         (1, 300, 4, 1, 64, 64, 100), (1, 130, 4, 2, 256, 48, 70), (4, 1500, 20, 20, 64, 0, 1500),
         (4, 448, 20, 20, 64, 0, 0), (2, 1500, 2, 1, 32, 300, 1500)]


def bind(lib: ctypes.CDLL, two_lengths: bool) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * (9 if two_lengths else 8) + [f, p]
    lib.swa_attention_fwd.argtypes = [p] * 5 + dims
    lib.swa_attention_bwd_dq.argtypes = [p] * 8 + dims
    lib.swa_attention_bwd_dkv.argtypes = [p] * 8 + dims
    for fn in (lib.swa_attention_fwd, lib.swa_attention_bwd_dq, lib.swa_attention_bwd_dkv):
        fn.restype = i
    return lib


def passes(lib, two_lengths: bool, q, k, v, do, W: int, P: int):
    """(o, lse, dq, delta, dk, dv) of one library's kernels."""
    import torch

    from repro_torch.kernels.swa_attention.ops import _DTYPES, effective_prefix, effective_window

    B, S, H, hd = q.shape
    K = k.shape[2]
    lengths = (S, S) if two_lengths else (S,)
    stream = torch.cuda.current_stream().cuda_stream
    d = (_DTYPES[q.dtype], B, *lengths, H, K, hd, effective_window(W, S), effective_prefix(P, S),
         1.0 / math.sqrt(hd), stream)
    o, dq = torch.empty_like(q), torch.empty_like(q)
    lse, delta = (torch.empty(B, H, S, dtype=torch.float32, device=q.device) for _ in range(2))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if lib.swa_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             lse.data_ptr(), *d):
        raise RuntimeError("forward launch failed")
    if lib.swa_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *d):
        raise RuntimeError("dq launch failed")
    if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 *d):
        raise RuntimeError("dk/dv launch failed")
    return o, lse, dq, delta, dk, dv


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not (Path(argv[0]) / REL).is_file():
        print("usage: chip_compare_parent.py PARENT_DIR (a checkout holding "
              f"{REL})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare_parent.py: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    ours, parent = ROOT / REL, Path(argv[0]).resolve() / REL
    build.build([ours, parent])
    libs = {"this tree": bind(ctypes.CDLL(str(build.library_path(ours))), True),
            "parent": bind(ctypes.CDLL(str(build.library_path(parent))), False)}
    dev = torch.device("cuda", 0)
    equal, differ = 0, []
    for case in CASES:
        B, S, H, K, hd, W, P = case
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(sum(case))
            q, do = (torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn(B, S, K, hd, generator=g, device=dev).to(dtype) for _ in range(2))
            a = passes(libs["this tree"], True, q, k, v, do, W, P)
            b = passes(libs["parent"], False, q, k, v, do, W, P)
            torch.cuda.synchronize()
            for name, x, y in zip(("o", "lse", "dq", "delta", "dk", "dv"), a, b):
                if torch.equal(x, y):
                    equal += 1
                else:
                    differ.append(f"{name} {case} {dtype}: {int((x != y).sum())} elements, max "
                                  f"{float((x.float() - y.float()).abs().max()):.3e}")
    for line in differ:
        print(f"[parent] DIFFERS {line}")
    # the summary last, where the tail of the output keeps it
    total = 6 * 2 * len(CASES)
    print(f"[parent] {equal} of {total} outputs of B4, B5 dq and B5 dk/dv equal the parent's "
          f"kernels bit for bit ({len(CASES)} shapes x f32, bf16; Sq = Sk); card {card}")
    return 0 if not differ else 1


if __name__ == "__main__":
    raise SystemExit(main())
