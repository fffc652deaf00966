"""Architecture registry: ``--arch <id>`` resolution — port of
``repro.configs``.

Every config of the zoo is ported, each copied from its JAX counterpart:
the dense, MoE, SSM, hybrid, VLM and audio transformers and VGG-16;
``shapes`` holds the input shapes and batch factories.
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


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f".{_MODULES[name]}", __package__)


def get_spec(name: str):
    return _mod(name).SPEC


def get_reduced(name: str):
    return _mod(name).REDUCED
