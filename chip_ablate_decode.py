#!/usr/bin/env python3
"""Time decode attention (B4d) against edited copies of its source, on one
GPU, and price its host overhead at a short cache.

    python3 chip_ablate_decode.py

Each variant is ``csrc/swa_decode.cu`` with one edit, built with the
package's nvcc flags into ``build/ablation_decode/`` (all builds started
together) and loaded through ctypes.  Every variant is timed with CUDA
events at qwen2-1.5b's heads over a full long cache, [8, 8192, 12, 2, 128]
f32 and bf16, over that cache filled to 1023, and over the same bytes with
one kv head, at several split counts S, in turns (the variants in order,
then in reverse, one card), and held against the plain version.  Each
timed call reads the next of n copies of the cache, n such that the bytes
read by n calls exceed twice the 50 MB L2, as a decode step's layers find
their caches.  The split kernel's blocks an SM (the occupancy calculator)
and ptxas's registers and spills of <128, 2, f32> are printed beside them.  A variant that changes
the arithmetic says so: it prices a part of the kernel, it is no kernel.

  as built          the package's source, unedited;
  contiguous tiles  split s takes ceil(tiles / S) tiles from s * ceil(tiles
                    / S), where the package's takes tiles s, s + S, ...;
  one head a warp   one query head a warp up to G = 8 (the package: up to
                    G = 4, then two heads a warp);
  3 stages          a ring of three stages instead of two;
  no q.k            the scores' products dropped (wrong: prices q.k);
  no p.v            the p.v products dropped (wrong: prices p.v);
  loads only        both dropped: the ring, the positions, the softmax's
                    shuffles and the merge are what is left (wrong).

Beside them, as yardsticks of the card's read rate over the same copies:
torch.sum over k and over v, and scaled_dot_product_attention on the
transposed cache (enable_gqa, the mask as a float bias).

Then, at the smollm-135m serve shape [8, 128, 9, 3, 64] f32 (one split),
the same work three ways: ``swa_decode`` called eagerly (the wrapper's
checks, allocation and the ctypes call each time), the library's C entry
called directly with its outputs allocated once, and 20 wrapper calls
captured in a CUDA graph and replayed (the device's time alone).
The timers are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CU = "swa_decode.cu"
QK = "        for (int j = 0; j < 4; ++j) part[h][j] = fmaf(qf[j], kf[e + j], part[h][j]);\n"
PV = ("        for (int i = 0; i < NPL; ++i) a[h][j % U][i] = fmaf(p4[h][j], vv[i], "
      "a[h][j % U][i]);\n")
NO_QK = "        for (int j = 0; j < 4; ++j) part[h][j] += 0.0f;\n"
NO_PV = "        for (int i = 0; i < NPL; ++i) a[h][j % U][i] += 0.0f;\n"
# name -> ([(edited text, replacement)], whether the numerics hold)
VARIANTS = {
    "as built": ([], True),
    "contiguous tiles": ([(
        "  const int t0 = split, step = sh.splits;\n"
        "  const int n = (tiles - split + sh.splits - 1) / sh.splits;",
        "  const int tps = (tiles + sh.splits - 1) / sh.splits;\n"
        "  const int t0 = split * tps, step = 1;\n"
        "  const int n = max(0, min(tps, tiles - t0));")], True),
    "one head a warp": ([("constexpr int kOneHeadWarps = 4;", "constexpr int kOneHeadWarps = 8;")],
                        True),
    "3 stages": ([("constexpr int kStages = 2;", "constexpr int kStages = 3;")], True),
    "no q.k": ([(QK, NO_QK)], False),
    "no p.v": ([(PV, NO_PV)], False),
    "loads only": ([(QK, NO_QK), (PV, NO_PV)], False),
}
# (B, C, H, K, hd), q_pos of a partly filled cache (None: every slot
# visible), split counts: qwen2-1.5b's heads over a full long cache, over
# the long cache filled to 1023 (an eighth of its tiles visible), and the
# same bytes with one kv head (rows not interleaved)
SHAPES = (((8, 8192, 12, 2, 128), None, (24, 32, 64)),
          ((8, 8192, 12, 2, 128), 1023, (24, 64)),
          ((16, 8192, 6, 1, 128), None, (24,)))


def build_report(log: str, key: str = "swa_decode_kernelILi128ELi2EfEE") -> dict:
    """ptxas's registers and spills of one split-kernel instantiation."""
    out, inside = {}, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inside = key in m.group(1)
        elif inside and "Used" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif inside and "spill stores" in line:
            out["spill_bytes"] = [int(x) for x in re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()]
    return out


def build_variants(out: Path):
    """{variant: (loaded library, build report)}; one nvcc per variant, all
    started together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.swa_attention.ops import DECODE_SOURCE, bind_decode

    jobs = {}
    for n, (name, (edits, _)) in enumerate(VARIANTS.items()):
        d = out / f"v{n}"
        d.mkdir(parents=True, exist_ok=True)
        text = DECODE_SOURCE.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name!r}: its edit no longer applies")
            text = text.replace(old, new)
        (d / CU).write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / CU)]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        libs[name] = (bind_decode(ctypes.CDLL(str(d / "lib.so"))), build_report(log))
    return libs


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_ablate_decode.py: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_ablate_decode.py: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import cuda_ms, graph_ms
    from repro_torch.kernels.swa_attention import (
        decode_splits, swa_decode, swa_decode_ref,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants(ROOT / "build" / "ablation_decode")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, filled, shape_splits in SHAPES:
        B, C, H, K, hd = shape
        q32 = torch.randn(B, 1, H, hd, generator=gen, device=dev)
        k32, v32 = (torch.randn(B, C, K, hd, generator=gen, device=dev) for _ in range(2))
        q_pos = C - 1 if filled is None else filled
        pos = torch.where(torch.arange(C, device=dev) <= q_pos, torch.arange(C, device=dev), -1)
        pos = pos.to(torch.int32)
        qp = torch.tensor([q_pos], dtype=torch.int32, device=dev)
        label = f"{shape}" + ("" if filled is None else f" filled to {filled}")
        data = {}
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            ref = swa_decode_ref(q.float(), k.float(), v.float(), pos, qp)
            code = 0 if dtype == torch.float32 else 1
            occ = libs["as built"][0].swa_decode_blocks_per_sm(code, hd, H // K)
            # S that fills the SMs' resident blocks once
            read = 2 * B * K * hd * (C if filled is None else filled + 1) * k.element_size()
            n = max(1, math.ceil(2 * 50e6 / read))
            copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(n - 1)]
            data[dname] = (q, copies, ref, code,
                           sorted({decode_splits(B, K, C, sms, occ), *shape_splits}))
            if filled is None:  # yardsticks of the card's read rate
                ring = itertools.cycle(copies)
                ts = [cuda_ms(lambda: next(ring)[0].sum(dtype=torch.float32)),
                      cuda_ms(lambda: next(ring)[1].sum(dtype=torch.float32))]
                trans = itertools.cycle([tuple(x.transpose(1, 2).contiguous() for x in kv)
                                         for kv in copies])
                qt = q.transpose(1, 2).contiguous()
                bias = torch.zeros(B, 1, 1, C, dtype=dtype, device=dev)
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, *next(trans), attn_mask=bias, enable_gqa=True))
                del trans
                nbytes = 2 * k.numel() * k.element_size()
                print(f"[ablation] yardstick {label} {dname} ({n} copies): torch.sum over k "
                      f"and over v {sum(ts):.4f} ms ({nbytes / sum(ts) / 1e9:.3f} TB/s), "
                      f"scaled_dot_product_attention {lib_ms:.4f} ms; card {card}")

        def call(lib, dname, S):
            q, copies, _, code, _ = data[dname]
            ring = itertools.cycle(copies)
            o = torch.empty_like(q)
            ws = torch.empty(B * H * S * (hd + 2), device=dev)

            def run():
                k, v = next(ring)
                if lib.swa_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                                  qp.data_ptr(), o.data_ptr(), ws.data_ptr(), code, B, C, H, K,
                                  hd, 0, 1.0 / math.sqrt(hd), S, stream):
                    raise RuntimeError("launch failed")
            return run, o

        times = {(name, d, S): [] for name in libs for d in data for S in data[d][4]}
        errs = {}
        for name in list(libs) + list(libs)[::-1]:
            lib, _ = libs[name]
            for dname in data:
                for S in data[dname][4]:
                    run, o = call(lib, dname, S)
                    times[(name, dname, S)].append(cuda_ms(run))
                    ref = data[dname][2]
                    errs[(name, dname, S)] = float(((o.float() - ref).abs()
                                                    / (2e-5 + 2e-5 * ref.abs())).max())
        for name, (lib, rep) in libs.items():
            keeps = VARIANTS[name][1]
            for dname, (_, _, _, code, splits) in data.items():
                occ = lib.swa_decode_blocks_per_sm(code, hd, H // K)
                for S in splits:
                    ts = times[(name, dname, S)]
                    e = errs[(name, dname, S)]
                    rows.append({"variant": name, "shape": list(shape), "q_pos": q_pos,
                                 "dtype": dname,
                                 "splits": S, "ms": ts, "blocks_per_sm": occ,
                                 "build_128_2_f32": rep, "err_of_f32_tolerance": e,
                                 "keeps_numerics": keeps})
                    print(f"[ablation] {name:17s} {label} {dname:4s} S={S:3d} "
                          f"({B * K * S} blocks, {occ} an SM): {ts[0]:.4f}, {ts[1]:.4f} ms; "
                          f"<128, 2, f32> {rep.get('registers')} registers, spills "
                          f"{rep.get('spill_bytes')}; |err| / (2e-5 + 2e-5 |ref|) {e:.2e}"
                          + ("" if keeps else " (changes the arithmetic: timing only)")
                          + f"; card {card}")
            if keeps and any(errs[(name, "f32", S)] > 1.0 for S in data["f32"][4]):
                raise AssertionError(f"variant {name!r} misses the f32 tolerance")
        del data, k32, v32

    # the host's share at the serve shape
    Bs, Cs, Hs, Ks, hds = 8, 128, 9, 3, 64
    q = torch.randn(Bs, 1, Hs, hds, generator=gen, device=dev)
    k, v = (torch.randn(Bs, Cs, Ks, hds, generator=gen, device=dev) for _ in range(2))
    ps = torch.arange(Cs, dtype=torch.int32, device=dev)
    qps = torch.tensor([Cs - 1], dtype=torch.int32, device=dev)
    lib = libs["as built"][0]
    o = torch.empty_like(q)

    def raw():
        if lib.swa_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), ps.data_ptr(),
                          qps.data_ptr(), o.data_ptr(), None, 0, Bs, Cs, Hs, Ks, hds, 0,
                          1.0 / math.sqrt(hds), 1, stream):
            raise RuntimeError("launch failed")

    def wrapped():
        return swa_decode(q, k, v, ps, qps)

    host = {"eager wrapper": [cuda_ms(wrapped)], "raw C entry": [cuda_ms(raw)],
            "graph replay": [graph_ms(wrapped)]}
    for name in list(host)[::-1]:
        host[name].append(graph_ms(wrapped) if name == "graph replay"
                          else cuda_ms(wrapped if name == "eager wrapper" else raw))
    print(f"[ablation] serve shape [{Bs}, {Cs}, {Hs}, {Ks}, {hds}] f32, one split: "
          + "; ".join(f"{n} {t[0]:.4f}, {t[1]:.4f} ms" for n, t in host.items())
          + f"; card {card}")
    print(json.dumps({"ablation": rows, "serve_host": host}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
