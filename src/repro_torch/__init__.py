"""repro_torch — the HSFL system ported to PyTorch and CUDA (NVIDIA Hopper).

The package mirrors the JAX package ``repro`` module for module, so every
module here has its counterpart at the same relative path there; the JAX
package is the reference each part of the port is tested against.  Nothing
here imports ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller asks for the CPU.  The
aggregation kernels (``kernels/tiered_aggregate``) and the flash-attention
kernels of the dense transformers (``kernels/swa_attention``) are
hand-written CUDA for ``sm_90a``, built with ``nvcc`` into
``build/repro_torch/`` on first use.

Submodules are imported lazily so ``import repro_torch`` stays cheap.
"""
from importlib import import_module

_SUBMODULES = (
    "api",
    "checkpoint",
    "compress",
    "configs",
    "core",
    "data",
    "kernels",
    "launch",
    "models",
    "optim",
    "sim",
)

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        mod = import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
