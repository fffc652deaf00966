"""The no-op codec: full-precision wire, zero error — port of
``repro.compress.identity``.

Exists so every compression code path (engines, kernel wrapper, sweeps)
can be exercised with a ``Compressor`` whose output is bit-identical to
the uncompressed path.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Identity:
    name: str = "identity"
    ratio: float = 1.0
    omega: float = 0.0

    def transform(self, x, generator=None):
        return x
