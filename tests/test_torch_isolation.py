"""The port stands alone: it imports neither JAX, nor Triton, nor the JAX
package, and every module imports with those blocked."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|triton|repro)\b(?!_)", re.M)

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "triton", "repro"):
    sys.modules[name] = None  # any import of these now raises ImportError
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
for attr in repro_torch.__all__:
    getattr(repro_torch, attr)
import chip_smoke
import chip_ablate_attention
import chip_profile_lm
print(len(names))
"""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_ablate_attention.py", ROOT / "chip_profile_lm.py"]


def test_every_module_imports_without_jax_triton_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 40


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro.data",
                 "from repro.core import x", "  import triton", "from repro import a"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "from .tiers import x", "# import jax"):
        assert not FORBIDDEN.search(line), line


def test_every_jax_module_of_the_slice_has_its_counterpart():
    slice_modules = [
        "data/synthetic.py", "data/partition.py", "data/loader.py",
        "models/layers.py", "models/vgg.py", "configs/vgg16_cifar10.py",
        "optim/optimizers.py", "compress/quantize.py",
        "kernels/tiered_aggregate/ref.py", "kernels/tiered_aggregate/ops.py",
        "core/tiers.py", "core/engine.py", "checkpoint/npz.py", "launch/train.py",
        "models/spec.py", "models/model.py", "configs/__init__.py",
        "configs/smollm_135m.py", "configs/qwen2_1_5b.py", "configs/qwen2_5_14b.py",
        "configs/qwen3_32b.py", "kernels/swa_attention/ref.py",
        "kernels/swa_attention/ops.py",
        "compress/base.py", "compress/identity.py", "compress/topk.py",
        "core/latency.py", "core/convergence.py", "core/problem.py", "core/batched.py",
        "core/ma_solver.py", "core/ms_solver.py", "core/bcd.py", "core/classes.py",
        "core/estimator.py", "sim/__init__.py", "sim/scenarios.py", "sim/events.py",
        "sim/fleet.py", "sim/robust.py", "sim/participation.py", "api/__init__.py",
        "api/spec.py", "api/registry.py", "api/presets.py", "api/result.py",
        "api/build.py", "api/run.py",
    ]
    for rel in slice_modules:
        assert (ROOT / "src" / "repro" / rel).exists(), rel
        assert (PORT / rel).exists(), rel
    assert (PORT / "kernels/tiered_aggregate/csrc/tiered_aggregate.cu").exists()
    assert (PORT / "kernels/swa_attention/csrc/swa_attention.cu").exists()
