#!/usr/bin/env python3
"""Hold the attention kernels (B4, B5) of this tree against an earlier
tree's on one GPU: bit for bit, except what REDESIGNED_HD names (B4's o and
lse at head dims 32, 64 and 256, B5's dq, dk and dv at 128: this tree's
wgmma kernels there), within the tolerance; then time both trees' B4, and
B5's two passes at hd 128, in turns.

    python3 chip_compare_parent.py PARENT_DIR

PARENT_DIR holds a checkout of the earlier commit (``git archive`` of it,
unpacked).  Its ``csrc/swa_attention.cu`` is read for its C entries'
signatures: one sequence length S or Sq and Sk (dtype, B, S[, Sk], H, K,
hd, window, prefix, scale, stream), and whether the dk/dv entry takes a
workspace and a split count (ws, splits after dv).  Both sources are built
with the package's nvcc flags, in parallel; then B4, the dq pass and the
dk/dv pass of both run on the same inputs at every head dim, f32 and bf16,
causal, windowed, with a prefix and bidirectional (a prefix of S), at
ragged and tile-edge lengths, and with Sq != Sk where the parent takes it:
this tree's through the package's wrappers (which choose the dk/dv pass's
split count), the parent's through its C entries.  Both trees' B5 passes
read the parent's o and lse, so that they see the same inputs; the
parent's dk/dv pass runs in the split count its own wrapper would launch
(this tree's at hd 256, one below).  Every output (o, lse, dq, delta, dk,
dv) must be equal bit for bit, except those REDESIGNED_HD names: o and lse
at 32, 64 and 256, which this tree's B4 computes on wgmma (truncated TF32
parts, the scale after s; at 256 each score once, its two halves of hd
added in f32), and dq, dk and dv at 128, which its B5 computes on wgmma
(the same, the score products' halves of hd added in f32, dk and dv in
``dkv_splits`` ranges merged in f32): there they may differ within rtol =
atol ATTN_TOL of the parent's (bf16 one bf16 ulp of each value beyond it)
and are printed as changed by design.  Then both trees' B4 is timed with
CUDA events, in turns (parent, this tree, this tree, parent), at
smollm-135m's full-width shape, whisper-large-v3's encoder and
cross-attention, paligemma-3b's Engine-B shape (hd 256, prefix 256) and
qwen2-1.5b's (hd 128, causal), f32; and both trees' dq and dk/dv passes at
qwen2-1.5b's shape, in turns.  Prints the card, the counts, and exits
non-zero on any other difference.
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
REL = Path("src/repro_torch/kernels/swa_attention/csrc/swa_attention.cu")
ATTN_TOL = 2e-5  # chip_smoke.py's: the forward's rtol = atol
# head dim -> the outputs that this tree computes on kernels of another
# design than the parent's there: B4 on wgmma at 32, 64 and 256, B5's two
# passes on wgmma at 128 (delta as before, bit for bit)
REDESIGNED_HD = {32: ("o", "lse"), 64: ("o", "lse"), 256: ("o", "lse"),
                 128: ("dq", "dk", "dv")}
# B, Sq, Sk, H, K, hd, window, prefix: the shapes whose B4 is timed
TIMED = {"smollm-135m": (8, 1024, 1024, 9, 3, 64, 0, 0),
         "whisper-large-v3 encoder": (4, 1500, 1500, 20, 20, 64, 0, 1500),
         "whisper-large-v3 cross": (4, 448, 1500, 20, 20, 64, 0, 1500),
         "paligemma-3b": (4, 512, 512, 8, 1, 256, 0, 256),
         "qwen2-1.5b": (4, 1024, 1024, 12, 2, 128, 0, 0)}
# the shapes whose B5 passes are timed: qwen2-1.5b's Engine-B tiers
TIMED_BWD = {"qwen2-1.5b": (4, 1024, 1024, 12, 2, 128, 0, 0)}

# B, S, H, K, hd, window, prefix
CASES = [(8, 1024, 9, 3, 64, 0, 0), (8, 1024, 9, 3, 64, 128, 0), (1, 300, 4, 1, 64, 128, 0),
         (2, 384, 4, 4, 128, 256, 0), (1, 512, 8, 2, 80, 0, 0), (1, 256, 6, 3, 96, 128, 0),
         (8, 256, 8, 2, 32, 0, 0), (4, 512, 16, 8, 64, 0, 0), (4, 512, 8, 1, 256, 0, 256),
         (1, 300, 4, 1, 64, 64, 100), (1, 130, 4, 2, 256, 48, 70), (4, 1500, 20, 20, 64, 0, 1500),
         (4, 448, 20, 20, 64, 0, 0), (2, 1500, 2, 1, 32, 300, 1500),
         (4, 1024, 12, 2, 128, 0, 0), (1, 300, 8, 2, 128, 100, 0), (1, 256, 6, 1, 128, 0, 65),
         (2, 333, 4, 4, 128, 0, 333)]
# as B, Sq, Sk, H, K, hd, window, prefix; then Sq != Sk: whisper's
# cross-attention, hd 32 and 256 under a prefix of Sk, causal Sq > Sk
CASES = [(B, S, S, H, K, hd, W, P) for B, S, H, K, hd, W, P in CASES]
CROSS_CASES = [(4, 448, 1500, 20, 20, 64, 0, 1500), (2, 130, 301, 4, 2, 32, 0, 301),
               (1, 65, 200, 8, 1, 256, 0, 200), (1, 130, 60, 4, 2, 64, 0, 0),
               (2, 130, 301, 12, 2, 128, 0, 301), (2, 301, 130, 6, 1, 128, 0, 0)]


def signature(source: Path):
    """(two lengths, a workspace) of a source's C entries: whether they take
    Sq and Sk, and whether swa_attention_bwd_dkv takes ws and splits."""
    text = source.read_text()
    entry = re.search(r"int swa_attention_bwd_dkv\(([^)]*)\)", text).group(1)
    return bool(re.search(r"\bint Sk\b", entry)), bool(re.search(r"\bint splits\b", entry))


def bind(lib: ctypes.CDLL, two_lengths: bool, workspace: bool) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [i] * (9 if two_lengths else 8) + [f, p]
    lib.swa_attention_fwd.argtypes = [p] * 5 + dims
    lib.swa_attention_bwd_dq.argtypes = [p] * 8 + dims
    lib.swa_attention_bwd_dkv.argtypes = [p] * 8 + ([p, i] if workspace else []) + dims
    for fn in (lib.swa_attention_fwd, lib.swa_attention_bwd_dq, lib.swa_attention_bwd_dkv):
        fn.restype = i
    return lib


def dims(two_lengths: bool, q, k, W: int, P: int):
    """The parent's C entries' arguments after the pointers."""
    import torch

    from repro_torch.kernels.swa_attention.ops import _DTYPES, effective_prefix, effective_window

    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    lengths = (Sq, Sk) if two_lengths else (Sq,)
    return (_DTYPES[q.dtype], B, *lengths, H, K, hd, effective_window(W, Sq),
            effective_prefix(P, Sk), 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)


def parent_passes(lib, two_lengths: bool, workspace: bool, q, k, v, do, W: int, P: int):
    """(o, lse, dq, delta, dk, dv) of the parent's kernels through its C
    entries (a workspace entry at hd 256 in the split count that this
    tree's wrapper launches, so that both sum in one order; one split below
    256, where the parent splits nothing)."""
    import torch

    from repro_torch.kernels.swa_attention.ops import _dkv_workspace, dkv_launch_splits

    B, Sq, H, hd = q.shape
    d = dims(two_lengths, q, k, W, P)
    o, dq = torch.empty_like(q), torch.empty_like(q)
    lse, delta = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) for _ in range(2))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    splits = dkv_launch_splits(q, k, W, P) if workspace and hd > 128 else 1
    ws = _dkv_workspace(k, splits)
    if lib.swa_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             lse.data_ptr(), *d):
        raise RuntimeError("forward launch failed")
    if lib.swa_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *d):
        raise RuntimeError("dq launch failed")
    if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 *((None if ws is None else ws.data_ptr(), splits)
                                   if workspace else ()), *d):
        raise RuntimeError("dk/dv launch failed")
    return o, lse, dq, delta, dk, dv


def passes(q, k, v, do, W: int, P: int, o_in, lse_in):
    """(o, lse, dq, delta, dk, dv) of this tree's kernels, as the package's
    wrappers launch them; the B5 passes read o_in and lse_in (the parent's
    forward's)."""
    from repro_torch.kernels.swa_attention import (
        swa_attention_bwd_dkv, swa_attention_bwd_dq, swa_attention_fwd,
    )

    o, lse = swa_attention_fwd(q, k, v, W, P)
    dq, delta = swa_attention_bwd_dq(q, k, v, o_in, lse_in, do, W, P)
    dk, dv = swa_attention_bwd_dkv(q, k, v, lse_in, delta, do, W, P)
    return o, lse, dq, delta, dk, dv


def within_tolerance(x, y):
    """The worst |x - y| / (ATTN_TOL + ATTN_TOL |y|) if every element of x
    lies within rtol = atol ATTN_TOL of y (bf16: one bf16 ulp of each value
    beyond it), else None."""
    import torch

    bf16 = x.dtype == torch.bfloat16
    x, y = x.float(), y.float()
    err = (x - y).abs()
    tol = ATTN_TOL + ATTN_TOL * y.abs()
    ulp = 0.0
    if bf16:
        _, exp = torch.frexp(y)
        ulp = torch.ldexp(torch.ones_like(y), exp - 8)
    if bool((err > tol + ulp).any()):
        return None
    return float(((err - ulp).clamp(min=0) / tol).max())


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
    two_lengths, workspace = signature(parent)
    lib = bind(ctypes.CDLL(str(build.library_path(parent))), two_lengths, workspace)
    dev = torch.device("cuda", 0)
    equal, by_design, differ = 0, [], []
    cases = CASES + (CROSS_CASES if two_lengths else [])
    for case in cases:
        B, Sq, Sk, H, K, hd, W, P = case
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(sum(case))
            q, do = (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, Sk, K, hd, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            b = parent_passes(lib, two_lengths, workspace, q, k, v, do, W, P)
            a = passes(q, k, v, do, W, P, b[0], b[1])
            torch.cuda.synchronize()
            for name, x, y in zip(("o", "lse", "dq", "delta", "dk", "dv"), a, b):
                if torch.equal(x, y):
                    equal += 1
                    continue
                line = (f"{name} {case} {dtype}: {int((x != y).sum())} elements, max "
                        f"{float((x.float() - y.float()).abs().max()):.3e}")
                rel = (within_tolerance(x, y) if name in REDESIGNED_HD.get(hd, ())
                       else None)
                if rel is None:
                    differ.append(line)
                else:
                    by_design.append(f"{line} ({rel:.3f} of the tolerance)")
    for line in by_design:
        print(f"[parent] changed by design ({REDESIGNED_HD}, within rtol = atol {ATTN_TOL} of "
              f"the parent's, bf16 one ulp beyond) {line}")
    for line in differ:
        print(f"[parent] DIFFERS {line}")
    timed = time_forward(lib, two_lengths, card)
    timed.update(time_backward(lib, two_lengths, workspace, card))
    # the summary last, where the tail of the output keeps it
    total = 6 * 2 * len(cases)
    print(f"[parent] {equal} of {total} outputs of B4, B5 dq and B5 dk/dv equal the parent's "
          f"kernels bit for bit (B5 fed the parent's o and lse), {len(by_design)} changed by "
          f"design ({REDESIGNED_HD}) within tolerance, {len(differ)} differ "
          f"({len(cases)} shapes x f32, bf16; {len(cases) - len(CASES)} with Sq != Sk); "
          f"card {card}")
    print(json.dumps({"parent_timings": timed}))
    return 0 if not differ else 1


def cuda_ms(fn, iters: int = 20) -> float:
    """ms a call of ``fn`` by CUDA events, 20 launches after 3 warm-up ones."""
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


def time_forward(lib, two_lengths: bool, card: str) -> dict:
    """ms of the parent's and this tree's B4 at TIMED's shapes, f32, in turns
    (parent, this tree, this tree, parent) with CUDA events."""
    import torch

    from repro_torch.kernels.swa_attention import swa_attention_fwd

    dev = torch.device("cuda", 0)
    out = {}
    for label, (B, Sq, Sk, H, K, hd, W, P) in TIMED.items():
        if Sq != Sk and not two_lengths:
            continue
        g = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn(B, Sq, H, hd, generator=g, device=dev)
        k, v = (torch.randn(B, Sk, K, hd, generator=g, device=dev) for _ in range(2))
        o, lse = torch.empty_like(q), torch.empty(B, H, Sq, device=dev)
        d = dims(two_lengths, q, k, W, P)

        def parent():
            if lib.swa_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                     lse.data_ptr(), *d):
                raise RuntimeError("forward launch failed")

        def ours():
            swa_attention_fwd(q, k, v, W, P)

        p1, o1, o2, p2 = cuda_ms(parent), cuda_ms(ours), cuda_ms(ours), cuda_ms(parent)
        out[label] = {"parent_ms": [p1, p2], "ms": [o1, o2]}
        print(f"[parent] timing B4 at {label} [{B}, {Sq}, {Sk}, {H}, {K}, {hd}] prefix {P} f32: "
              f"parent {p1:.4f}, {p2:.4f} ms; this tree {o1:.4f}, {o2:.4f} ms; card {card}")
        del q, k, v, o, lse
    return out



def time_backward(lib, two_lengths: bool, workspace: bool, card: str) -> dict:
    """ms of the parent's and this tree's B5 dq and dk/dv passes at
    TIMED_BWD's shapes, f32, each pass in turns (parent, this tree, this
    tree, parent) with CUDA events, both reading one forward's o and lse and
    one dq pass's delta; the parent's dk/dv in one split (at hd 128 it
    splits nothing), this tree's in the split count its wrapper launches."""
    import torch

    from repro_torch.kernels.swa_attention import (
        dkv_launch_splits, swa_attention_bwd_dkv, swa_attention_bwd_dq, swa_attention_fwd,
    )

    dev = torch.device("cuda", 0)
    out = {}
    for label, (B, Sq, Sk, H, K, hd, W, P) in TIMED_BWD.items():
        g = torch.Generator(device=dev).manual_seed(8)
        q, do = (torch.randn(B, Sq, H, hd, generator=g, device=dev) for _ in range(2))
        k, v = (torch.randn(B, Sk, K, hd, generator=g, device=dev) for _ in range(2))
        o, lse = swa_attention_fwd(q, k, v, W, P)
        _, delta = swa_attention_bwd_dq(q, k, v, o, lse, do, W, P)
        dq, dl = torch.empty_like(q), torch.empty_like(lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        d = dims(two_lengths, q, k, W, P)

        def parent_dq():
            if lib.swa_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        do.data_ptr(), lse.data_ptr(), dl.data_ptr(),
                                        dq.data_ptr(), *d):
                raise RuntimeError("dq launch failed")

        def parent_dkv():
            if lib.swa_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                         dv.data_ptr(), *((None, 1) if workspace else ()), *d):
                raise RuntimeError("dk/dv launch failed")

        passes = {"swa_attention_bwd_dq": (parent_dq, lambda: swa_attention_bwd_dq(
                      q, k, v, o, lse, do, W, P)),
                  "swa_attention_bwd_dkv": (parent_dkv, lambda: swa_attention_bwd_dkv(
                      q, k, v, lse, delta, do, W, P))}
        for name, (parent, ours) in passes.items():
            p1, o1, o2, p2 = cuda_ms(parent), cuda_ms(ours), cuda_ms(ours), cuda_ms(parent)
            out[f"{label} {name}"] = {"parent_ms": [p1, p2], "ms": [o1, o2]}
            extra = (f", this tree's in {dkv_launch_splits(q, k, W, P)} splits and the merge"
                     if name == "swa_attention_bwd_dkv" else "")
            print(f"[parent] timing {name} at {label} [{B}, {Sq}, {Sk}, {H}, {K}, {hd}] window "
                  f"{W} prefix {P} f32{extra}: parent {p1:.4f}, {p2:.4f} ms; this tree {o1:.4f}, "
                  f"{o2:.4f} ms ({(p1 + p2) / (o1 + o2):.2f}x); card {card}")
        del q, do, k, v, o, lse, delta, dq, dl, dk, dv
    return out


if __name__ == "__main__":
    raise SystemExit(main())
