"""Deterministic (index, seed) sampling.

The port's copy of ``nbss_tpu/data/sampler.py``: each epoch derives a
permutation from (seed, epoch) and a fresh random seed per item, yielding
(index, seed) tuples; datasets build their per-item RNG from the seed alone,
so any sample is reproducible given (epoch, index). Sharding is rank-strided
after padding to a multiple of the replica count. For the same seed and epoch
the order is the JAX package's.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


class DistributedSampler:
    def __init__(
        self,
        dataset_len: int,
        seed: int = 0,
        shuffle: bool = True,
        num_replicas: int = 1,
        rank: int = 0,
        last_epoch: int = -1,
    ):
        assert 0 <= rank < num_replicas, (rank, num_replicas)
        self.dataset_len = dataset_len
        self.seed = seed
        self.shuffle = shuffle
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = last_epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return -(-self.dataset_len // self.num_replicas)

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        g = np.random.default_rng(np.random.PCG64(self.seed + max(self.epoch, 0)))
        if self.shuffle:
            indices = g.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        # a fresh seed per item (drawn after the permutation so item seeds
        # differ across epochs even without shuffling)
        seeds = g.integers(0, np.iinfo(np.int64).max, size=self.dataset_len)
        # pad to a multiple of num_replicas by wrapping
        total = len(self) * self.num_replicas
        if total > self.dataset_len:
            extra = total - self.dataset_len
            indices = np.concatenate([indices, indices[:extra]])
            seeds = np.concatenate([seeds, seeds[:extra]])
        for i in range(self.rank, total, self.num_replicas):
            yield int(indices[i]), int(seeds[i])


class BatchLoader:
    """Map-style batcher: dataset[(index, seed)] -> (x, ys, paras); collates
    by stacking arrays and listing the paras dicts. Single-process."""

    def __init__(self, dataset, batch_size: int, sampler: DistributedSampler,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        buf: List = []
        for item in self.sampler:
            buf.append(self.dataset[item])
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)

    @staticmethod
    def _collate(items):
        xs = np.stack([it[0] for it in items])
        ys = np.stack([it[1] for it in items]) if items[0][1] is not None else None
        paras = [it[2] for it in items]
        return xs, ys, paras
