"""FederatedLoader: per-round client-stacked mini-batches for Engine A/B.

Every round, each client draws a size-b mini-batch from its own partition
(with replacement across epochs, matching the paper's per-round sampling
ξ_n^t); the loader emits batches whose leaves carry a leading client axis
[N, b, ...], the layout both engines and the pjit data sharding consume.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


class FederatedLoader:
    def __init__(
        self,
        arrays: Dict[str, np.ndarray],  # sample-major arrays, same length K
        partitions: List[np.ndarray],
        batch: int,
        seed: int = 0,
    ):
        self.arrays = arrays
        self.partitions = partitions
        self.batch = batch
        self.num_clients = len(partitions)
        self._rng = np.random.default_rng(seed)
        k = len(next(iter(arrays.values())))
        for v in arrays.values():
            assert len(v) == k

    def next_round(self) -> Dict[str, np.ndarray]:
        """One client-stacked batch {key: [N, b, ...]}."""
        idx = np.stack(
            [
                self._rng.choice(part, size=self.batch, replace=len(part) < self.batch)
                for part in self.partitions
            ]
        )  # [N, b]
        return {k: v[idx] for k, v in self.arrays.items()}

    def rounds(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n):
            yield self.next_round()


def image_loader(dataset, partitions, batch: int, seed: int = 0) -> FederatedLoader:
    return FederatedLoader(
        {"images": dataset.images, "labels": dataset.labels.astype(np.int32)},
        partitions,
        batch,
        seed,
    )


def lm_loader(dataset, partitions, batch: int, seed: int = 0) -> FederatedLoader:
    return FederatedLoader(
        {
            "tokens": dataset.tokens[:, :-1],
            "labels": dataset.tokens[:, 1:].astype(np.int32),
        },
        partitions,
        batch,
        seed,
    )
