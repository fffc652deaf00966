"""Client partitioners: IID shuffle-split and sort-and-shard non-IID.

Sort-and-shard follows the paper's Sec. VII protocol exactly: sort samples
by label, slice into ``shards_per_client × num_clients`` contiguous shards,
deal ``shards_per_client`` shards to each client (2 shards per client for 20
clients in the paper ⇒ most clients see only 1–2 classes).
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(
    num_samples: int, num_clients: int, seed: int = 0
) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_samples)
    return [np.sort(chunk) for chunk in np.array_split(perm, num_clients)]


def partition_sort_and_shard(
    labels: np.ndarray,
    num_clients: int,
    shards_per_client: int = 2,
    seed: int = 0,
) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, num_clients * shards_per_client)
    assign = rng.permutation(len(shards))
    out = []
    for c in range(num_clients):
        ids = np.concatenate(
            [shards[assign[c * shards_per_client + s]] for s in range(shards_per_client)]
        )
        out.append(np.sort(ids))
    return out


def label_skew(labels: np.ndarray, parts: List[np.ndarray]) -> float:
    """Mean TV-distance of per-client label histograms from the global one
    (0 = perfectly IID; →1 = maximal skew). Used by tests/benchmarks."""
    num_classes = int(labels.max()) + 1
    glob = np.bincount(labels, minlength=num_classes) / len(labels)
    tv = []
    for idx in parts:
        h = np.bincount(labels[idx], minlength=num_classes) / max(len(idx), 1)
        tv.append(0.5 * np.abs(h - glob).sum())
    return float(np.mean(tv))
