"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every kernel source is one ``csrc/*.cu`` file with a plain C interface,
which may include the ``*.cuh`` headers beside it.  It is compiled for
Hopper (``sm_90a``) into a shared library under ``build/repro_torch/`` at
the root of the checkout, named after a hash of the source and those
headers, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  ``ptxas``'s report of each kernel's registers, shared
memory and spills is kept beside the library (``<library>.log``).
Nothing is compiled when a module is imported: the first launch builds its
source, or ``build`` builds every source at once, one ``nvcc`` process per
source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[Path, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """Every kernel source of the package."""
    return sorted(PACKAGE_DIR.glob("kernels/*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with the "
        "CUDA toolkit (on PATH or under CUDA_HOME)"
    )


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_log(source: Path) -> Path:
    """nvcc's output (ptxas's per-kernel report) for ``source``'s library."""
    return library_path(source).with_suffix(".log")


def _start(source: Path):
    """Start one nvcc into a temporary name; returns (process, tmp, final)
    or None when the library is already built."""
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, Path(tmp), out


def _finish(job, source: Path) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader sees no half-written library
    finally:
        if tmp.exists():
            tmp.unlink()


def build(srcs: Optional[List[Path]] = None) -> List[Path]:
    """Build every source of ``srcs`` (default: all of the package's) that
    is not built yet, one nvcc process each, all started together."""
    srcs = sources() if srcs is None else srcs
    jobs = [(s, _start(s)) for s in srcs]
    errors = []
    for s, job in jobs:
        if job is None:
            continue
        try:
            _finish(job, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(s) for s in srcs]


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        (path,) = build([source])
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib
