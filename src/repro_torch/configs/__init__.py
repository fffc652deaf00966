"""Architecture registry: ``--arch <id>`` resolution — port of
``repro.configs``.

The dense, MoE, SSM, hybrid and VLM transformer configs and VGG-16 are
ported, each copied from its JAX counterpart; ``shapes`` holds the input
shapes and batch factories.  The one other id of the zoo is registered
under its name and raises ``NotImplementedError`` naming its ROADMAP item:
``whisper-large-v3`` (A14.5: encoder-decoder).
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

_MODULES: Dict[str, str] = {
    "qwen2.5-14b": "qwen2_5_14b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-32b": "qwen3_32b",
    "qwen2-1.5b": "qwen2_1_5b",
    "paligemma-3b": "paligemma_3b",
    "smollm-135m": "smollm_135m",
    "whisper-large-v3": "whisper_large_v3",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "mamba2-1.3b": "mamba2_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "vgg16-cifar10": "vgg16_cifar10",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "vgg16-cifar10"]

# the dense, MoE, SSM, hybrid and VLM families; every attention layer runs
# the flash-attention kernels
PORTED_ARCH_IDS: List[str] = [
    "qwen2.5-14b", "qwen3-32b", "qwen2-1.5b", "smollm-135m",
    "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b", "jamba-1.5-large-398b",
    "paligemma-3b",
]
# the family still to port, by ROADMAP item, and the arch that waits on it
UNPORTED_FAMILY_ITEMS: Dict[str, str] = {"audio": "A14.5"}
UNPORTED_ARCH_ITEMS: Dict[str, str] = {"whisper-large-v3": UNPORTED_FAMILY_ITEMS["audio"]}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    if name != "vgg16-cifar10" and name not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{name}: the dense, MoE, SSM, hybrid and VLM configs are ported so far; "
            f"this arch comes with ROADMAP {UNPORTED_ARCH_ITEMS[name]}"
        )
    return import_module(f".{_MODULES[name]}", __package__)


def get_spec(name: str):
    return _mod(name).SPEC


def get_reduced(name: str):
    return _mod(name).REDUCED
