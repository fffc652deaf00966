"""Synthetic datasets standing in for CIFAR-10 / MNIST (offline container).

``SyntheticImageDataset`` draws class-conditional *structured* images: each
class owns a fixed random template filtered through a shared random conv
bank, plus per-sample noise — learnable by a CNN but not trivially (noise
floor keeps single-step accuracy < 100%), with the same dimensions as the
originals (32×32×3 CIFAR-like, 28×28×1 MNIST-like).

``SyntheticLmDataset`` emits token streams from a sparse random bigram
chain so that LM losses are reducible below the uniform floor — used for
the 10 assigned transformer architectures' smoke training runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class SyntheticImageDataset:
    images: np.ndarray  # [K, H, W, C] float32
    labels: np.ndarray  # [K] int32
    num_classes: int

    def __len__(self) -> int:
        return len(self.labels)


def _conv2d_same(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Tiny valid 3x3 conv with zero padding (numpy, dataset-gen only)."""
    H, W, Cin = x.shape
    Cout = k.shape[-1]
    xp = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    out = np.zeros((H, W, Cout), np.float32)
    for dy in range(3):
        for dx in range(3):
            out += np.einsum(
                "hwc,co->hwo", xp[dy : dy + H, dx : dx + W], k[dy, dx]
            )
    return out


def _make_images(
    n: int,
    num_classes: int,
    hw: int,
    channels: int,
    noise: float,
    seed: int,
    template_seed: int | None = None,
) -> SyntheticImageDataset:
    # Class templates define the *distribution*; `seed` only drives sampling.
    # Held-out sets must share template_seed with the train set or they come
    # from a different task entirely.
    trng = np.random.default_rng(seed if template_seed is None else template_seed)
    rng = np.random.default_rng(seed)
    templates = trng.normal(0, 1, (num_classes, hw, hw, channels)).astype(np.float32)
    conv = trng.normal(0, 0.3, (3, 3, channels, channels)).astype(np.float32)
    templates = np.stack([_conv2d_same(t, conv) for t in templates])
    templates /= np.abs(templates).max() + 1e-6
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    imgs = templates[labels] + noise * rng.normal(0, 1, (n, hw, hw, channels)).astype(
        np.float32
    )
    return SyntheticImageDataset(imgs.astype(np.float32), labels, num_classes)


def make_cifar10_like(
    n: int = 4096, noise: float = 0.6, seed: int = 0,
    template_seed: int | None = None,
) -> SyntheticImageDataset:
    """32×32×3, 10 classes (matched to the paper's CIFAR-10 setting)."""
    return _make_images(n, 10, 32, 3, noise, seed, template_seed)


def make_mnist_like(
    n: int = 4096, noise: float = 0.5, seed: int = 1,
    template_seed: int | None = None,
) -> SyntheticImageDataset:
    """28×28×1, 10 classes (matched to the paper's MNIST setting)."""
    return _make_images(n, 10, 28, 1, noise, seed, template_seed)


@dataclass
class SyntheticLmDataset:
    tokens: np.ndarray  # [K, S+1] int32 (inputs=x[:, :-1], labels=x[:, 1:])
    vocab_size: int

    def __len__(self) -> int:
        return len(self.tokens)

    def batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        t = self.tokens[idx]
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def make_lm_stream(
    n: int = 2048,
    seq: int = 64,
    vocab: int = 512,
    branching: int = 4,
    seed: int = 0,
) -> SyntheticLmDataset:
    """Sparse random bigram chain: every token has `branching` successors."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, (vocab, branching)).astype(np.int32)
    toks = np.zeros((n, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n)
    choices = rng.integers(0, branching, (n, seq))
    for s in range(seq):
        toks[:, s + 1] = succ[toks[:, s], choices[:, s]]
    return SyntheticLmDataset(toks, vocab)
