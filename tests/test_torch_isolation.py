"""The port stands alone: it imports neither JAX, nor Triton, nor the JAX
package, and every module imports with those blocked."""
import torch_threads  # noqa: F401  (intra-op threads under xdist)
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
        "privacy/__init__.py", "privacy/accountant.py", "privacy/mechanism.py",
        "energy/__init__.py", "energy/pricing.py", "faults/__init__.py", "faults/spec.py",
        "faults/accounting.py", "faults/inject.py", "faults/reroute.py",
        "core/async_agg.py", "control/__init__.py", "control/migrate.py",
        "control/drift.py", "control/telemetry.py", "control/window.py", "control/bound.py",
        "control/controller.py", "control/replay.py",
        "core/sharded.py", "launch/mesh.py", "launch/sharding.py",
        "configs/granite_moe_1b_a400m.py", "configs/phi3_5_moe_42b_a6_6b.py",
        "configs/mamba2_1_3b.py", "configs/jamba_1_5_large_398b.py",
        "launch/serve.py", "launch/dryrun.py", "launch/dryrun_lib.py",
        "kernels/tiered_aggregate/check.py",
    ]
    for rel in slice_modules:
        assert (ROOT / "src" / "repro" / rel).exists(), rel
        assert (PORT / rel).exists(), rel
    assert (PORT / "kernels/tiered_aggregate/csrc/tiered_aggregate.cu").exists()
    assert (PORT / "kernels/swa_attention/csrc/swa_attention.cu").exists()
    assert (PORT / "kernels/swa_attention/csrc/swa_decode.cu").exists()


# the two Pallas kernel files: their counterparts are the .cu sources
PALLAS = {"kernels/swa_attention/swa_attention.py": "kernels/swa_attention/csrc/swa_attention.cu",
          "kernels/tiered_aggregate/tiered_aggregate.py":
              "kernels/tiered_aggregate/csrc/tiered_aggregate.cu"}


def test_every_jax_module_has_its_counterpart():
    """Every ``.py`` file of the JAX package has one at its relative path in
    the port; the two Pallas kernel files have their CUDA sources."""
    jax_pkg = ROOT / "src" / "repro"
    rels = sorted(str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py"))
    assert len(rels) >= 93
    missing = [r for r in rels if not (PORT / PALLAS.get(r, r)).exists()]
    assert not missing, missing


_PROBE_SLICE = """
import sys
for name in ("jax", "jaxlib", "triton", "repro"):
    sys.modules[name] = None
from repro_torch.privacy import Accountant, DPMechanism, PrivacySpec
from repro_torch.energy import EnergySpec, split_energy_lattice
from repro_torch.faults import FaultSpec, apply_corruption, reroute_entity_sync
from repro_torch.core.async_agg import AsyncTrainer, fed_level_apply
from repro_torch.control import migrate_state_a, resume_with_migration
from repro_torch.core.tiers import GuardSpec, guard_health
from repro_torch.kernels.tiered_aggregate import masked_ragged_tiered_aggregate
import repro_torch.control as control
assert hasattr(control, "Controller")
from repro_torch.control.drift import DriftReport, detect_drift
from repro_torch.control.telemetry import RoundObservation, observe_round, reconstruct_state
from repro_torch.control.window import WindowedLatency
from repro_torch.control.bound import BoundSegment, piecewise_bound
from repro_torch.control.controller import ControlDecision, Controller
from repro_torch.control.replay import ReplayResult, replay
from repro_torch.core import build_train_step_b, init_state_b
from repro_torch.core.engine import engine_b_to_full
from repro_torch.control.migrate import migrate_params_b, migrate_state_b
from repro_torch.api.run import _make_step
from repro_torch.api.build import check_capabilities
from repro_torch.models.convert import params_from_numpy
from repro_torch.kernels.tiered_aggregate import masked_tiered_aggregate_ref
from repro_torch.core.sharded import (
    build_sharded_train_step_a, init_sharded_state_a, sharded_guard_health,
    sharded_synchronize,
)
from repro_torch.core import build_sharded_train_step_a as exported
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, run_on_ranks
from repro_torch.launch.sharding import PartitionSpec, param_pspecs, to_placements
from repro_torch.launch import make_debug_mesh as exported_mesh
from repro_torch.models.layers import init_mamba, init_moe, mamba_block, moe, moe_route, ssd_scan
from repro_torch.configs import get_reduced, get_spec
for arch in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
             "jamba-1.5-large-398b"):
    get_spec(arch), get_reduced(arch)
from repro_torch.launch.serve import generate, load_serving_params, main
from repro_torch.kernels.swa_attention import decode_launches, swa_decode, swa_decode_ref
from repro_torch.kernels.swa_attention.ops import DECODE_SOURCE
from repro_torch.models.layers import init_attn_cache, init_mamba_cache
assert DECODE_SOURCE.name == "swa_decode.cu" and decode_launches == {"swa_decode": 0}
from repro_torch.models.remat import POLICIES, remat
from repro_torch.kernels.tiered_aggregate.check import assert_q8_matches_oracle
from repro_torch.launch.dryrun_lib import DryrunCase, count_train_step, run_case
from repro_torch.launch.dryrun import main as dryrun_main
assert POLICIES == ("full", "outs", "dots")
print("ok")
"""


def test_the_costs_and_robustness_modules_import_alone():
    """privacy/, energy/, faults/, core/async_agg.py, every control/
    module (the migration and the control loop), Engine B (the engine,
    its migration, the API's step choice, B1m's weights), the sharded
    engine, the MoE / Mamba layers and the four zoo configs, and serving
    (``launch/serve.py``, the caches, B4d's wrapper) import with jax,
    triton and repro blocked; control exports its ``Controller``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE_SLICE], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
