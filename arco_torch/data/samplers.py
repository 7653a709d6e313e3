"""Batch samplers (counterpart of arco_tpu/data/samplers.py, a copy).

- TwoStreamBatchSampler (dataloaders/dataset.py:456-500): labeled indices
  iterate once per epoch, unlabeled iterate eternally; each batch is
  [primary..., secondary...].
- replacement_batches: the ARCO-stage RandomSampler(replacement=True) pair
  (train_arco_2d.py:199-215).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int],
                 secondary_indices: Sequence[int], batch_size: int,
                 secondary_batch_size: int, seed: int = 0):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        if not len(self.primary_indices) >= self.primary_batch_size > 0:
            raise ValueError("primary batch size must be in "
                             f"(0, {len(self.primary_indices)}]")
        if not len(self.secondary_indices) >= self.secondary_batch_size > 0:
            raise ValueError("secondary batch size must be in "
                             f"(0, {len(self.secondary_indices)}]")
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.primary_indices) // self.primary_batch_size

    def __iter__(self) -> Iterator[List[int]]:
        primary = self.rng.permutation(self.primary_indices)

        def eternal_secondary():
            while True:
                yield from self.rng.permutation(self.secondary_indices)

        sec = eternal_secondary()
        for i in range(len(self)):
            p = primary[i * self.primary_batch_size:
                        (i + 1) * self.primary_batch_size]
            s = [next(sec) for _ in range(self.secondary_batch_size)]
            yield list(p) + s


def replacement_batches(n_items: int, batch_size: int,
                        seed: int = 0) -> Iterator[List[int]]:
    """Endless uniform-with-replacement batches (RandomSampler(replacement=
    True), train_arco_2d.py:203-215)."""
    rng = np.random.RandomState(seed)
    while True:
        yield rng.randint(0, n_items, size=batch_size).tolist()
