"""Architecture registry: ``--arch <id>`` resolution — port of
``repro.configs``.

The dense transformer configs and VGG-16 are ported, each copied from its
JAX counterpart.  The other ids of the zoo are registered under the same
names and raise ``NotImplementedError`` naming ROADMAP A14: the MoE, SSM
and hybrid families, ``paligemma-3b`` (its prefix-LM mask is not causal)
and ``whisper-large-v3`` (encoder-decoder).
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

# the dense family, trained through the flash-attention kernels
PORTED_ARCH_IDS: List[str] = ["qwen2.5-14b", "qwen3-32b", "qwen2-1.5b", "smollm-135m"]


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    if name != "vgg16-cifar10" and name not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{name}: only the dense transformer configs are ported so far; "
            "the MoE, SSM, hybrid, VLM and audio archs come with ROADMAP A14"
        )
    return import_module(f".{_MODULES[name]}", __package__)


def get_spec(name: str):
    return _mod(name).SPEC


def get_reduced(name: str):
    return _mod(name).REDUCED
