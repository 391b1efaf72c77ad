"""Deterministic (index, seed) sampling.

The port's copy of ``nbss_tpu/data/sampler.py``: each epoch derives a
permutation from (seed, epoch) and a fresh random seed per item, yielding
(index, seed) tuples; datasets build their per-item RNG from the seed alone,
so any sample is reproducible given (epoch, index). Sharding is rank-strided
after padding to a multiple of the replica count. For the same seed and epoch
the order is the JAX package's.

With several ranks on a host (``ranks`` > 1) the loaders form the host's
batches and take this rank's contiguous rows of each (``rank_batches``), so
that a rank loads only its own items; a batch that does not split into equal
rows is taken whole by every rank and marked replicated
(``parallel.Shard``).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Tuple

import numpy as np

from nbss_tpu_torch.parallel.mesh import Shard, rows


class DistributedSampler:
    def __init__(
        self,
        dataset_len: int,
        seed: int = 0,
        shuffle: bool = True,
        num_replicas: int = 1,
        rank: int = 0,
        last_epoch: int = -1,
        pad: bool = True,
    ):
        """``pad=False`` leaves out the wrapped copies that pad the order to a
        multiple of ``num_replicas`` (ranks then differ in length by one):
        for test and predict, where every item is taken once."""
        assert 0 <= rank < num_replicas, (rank, num_replicas)
        self.dataset_len = dataset_len
        self.seed = seed
        self.shuffle = shuffle
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = last_epoch
        self.pad = pad

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if not self.pad:
            return len(range(self.rank, self.dataset_len, self.num_replicas))
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
        total = (-(-self.dataset_len // self.num_replicas) * self.num_replicas if self.pad
                 else self.dataset_len)
        if total > self.dataset_len:
            extra = total - self.dataset_len
            indices = np.concatenate([indices, indices[:extra]])
            seeds = np.concatenate([seeds, seeds[:extra]])
        for i in range(self.rank, total, self.num_replicas):
            yield int(indices[i]), int(seeds[i])


def rank_batches(samples: Iterable, batch_size: int, drop_last: bool = True, ranks: int = 1,
                 rank: int = 0) -> Iterator[Tuple[List, bool]]:
    """(items, replicated) of each batch one rank takes: the host's samples in
    batches of ``batch_size`` (a short last one kept unless ``drop_last``),
    then this rank's contiguous rows of each, or the whole batch, replicated,
    when it does not split into ``ranks`` equal blocks."""
    def take(buf):
        if ranks == 1:
            return buf, False
        sl = rows(len(buf), ranks, rank)
        return (buf, True) if sl is None else (buf[sl], False)

    buf: List = []
    for item in samples:
        buf.append(item)
        if len(buf) == batch_size:
            yield take(buf)
            buf = []
    if buf and not drop_last:
        yield take(buf)


class BatchLoader:
    """Map-style batcher: dataset[(index, seed)] -> (x, ys, paras); collates
    by stacking arrays and listing the paras dicts. ``ranks`` = (ranks on the
    host, this rank): with more than one, each batch is this rank's rows of
    the host batch, a ``parallel.Shard``."""

    def __init__(self, dataset, batch_size: int, sampler: DistributedSampler,
                 drop_last: bool = True, ranks: Tuple[int, int] = (1, 0)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.drop_last = drop_last
        self.ranks = tuple(ranks)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> Iterator[Tuple[List, bool]]:
        return rank_batches(self.sampler, self.batch_size, self.drop_last, *self.ranks)

    def _wrap(self, batch, replicated: bool):
        return Shard(batch, replicated) if self.ranks[0] > 1 else batch

    def __iter__(self):
        for items, replicated in self._batches():
            yield self._wrap(self._collate([self.dataset[it] for it in items]), replicated)

    @staticmethod
    def _collate(items):
        xs = np.stack([it[0] for it in items])
        ys = np.stack([it[1] for it in items]) if items[0][1] is not None else None
        paras = [it[2] for it in items]
        return xs, ys, paras
