"""Intra-op threads of the port's tests under pytest-xdist.

Each xdist worker is a process, and PyTorch gives every process one
intra-op thread per core, so W workers on a C-core host run W·C threads
that preempt one another.  The port's test modules import this module,
which gives each worker C // W threads (at least one); a run without
xdist keeps PyTorch's default.  Ranks that a test spawns
(``repro_torch.launch.mesh.run_on_ranks``) share their parent's threads.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
