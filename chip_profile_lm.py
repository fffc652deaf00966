#!/usr/bin/env python3
"""Trace where smollm-135m's full-width per-client forward+backward spends
the card's time, on one GPU.

    python3 chip_profile_lm.py

Sets up the full-width smollm-135m path as ``chip_smoke.py`` drives it
(N=8, J2=4, batch 1, seq 1024, random weights from seed 0), runs the
per-client ``vmap(grad_and_value(loss))`` once to warm up, then traces
``REPEATS`` more with ``torch.profiler`` (CPU and CUDA activities).
Prints, per call: the host-clock time (ending in a synchronize) of
``REPEATS`` calls untraced and of the traced ones, the device time summed
over every kernel of the trace and its share of the untraced host time
(the device's busy share: one stream, so kernels do not overlap; the
traced host time also holds the profiler's own cost), and the kernels that
took the most device time, and the attention kernels (B4, B5), with their
launches.  The last line is one JSON object with the same numbers.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPEATS = 3
TOP = 12


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_profile_lm.py: src/repro_torch is missing beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_profile_lm.py: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.func import grad_and_value, vmap
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_spec
    from repro_torch.core import init_state_a
    from repro_torch.launch import train

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    args = train.parse_args(["--arch", "smollm-135m", "--clients", "8", "--edges", "4",
                             "--batch", "1"])
    device, spec, model, plan, opt, loader = train.setup(
        args, spec=get_spec("smollm-135m"), seq=1024)
    state = init_state_a(model, plan, opt, torch.Generator().manual_seed(args.seed), device)
    batch = train.to_device(loader.next_round(), device)
    per_client = vmap(grad_and_value(model.loss_fn))
    per_client(state.params, batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REPEATS):
        per_client(state.params, batch)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t) * 1e3 / REPEATS

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            per_client(state.params, batch)
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / REPEATS

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    if not by_name:
        raise AssertionError("the trace holds no device time: the profiler did not see the card")
    device_ms = sum(ms for ms, _ in by_name.values()) / REPEATS
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    shown = rows[:TOP] + [kv for kv in rows[TOP:] if "swa_" in kv[0]]  # B4, B5 always
    print(f"[profile] smollm-135m full-width per-client forward+backward (N=8, batch 1, seq "
          f"1024): host clock {untraced_ms:.2f} ms a call untraced, {host_ms:.2f} traced; "
          f"device time {device_ms:.2f} ms a call over {len(kernels) // REPEATS} kernel "
          f"launches = {100 * device_ms / untraced_ms:.1f}% of the untraced host clock (the "
          f"device's busy share; the traced clock includes the profiler's own cost; "
          f"{REPEATS} calls each); card {card}")
    for name, (ms, n) in shown:
        print(f"[profile]   {ms / REPEATS:9.3f} ms a call, {n // REPEATS:5d} launches: {name[:150]}")
    print(json.dumps({"untraced_ms": untraced_ms, "traced_ms": host_ms, "device_ms": device_ms,
                      "launches": len(kernels) // REPEATS,
                      "kernels": [{"name": k, "ms": ms / REPEATS, "launches": n // REPEATS}
                                  for k, (ms, n) in shown]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
