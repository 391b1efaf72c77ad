"""DataModule base: stage-wise loaders over (index, seed) samplers.

Counterpart of ``nbss_tpu/data/loader.py``: four stages (train, val, test,
predict) with per-stage datasets, batch sizes and seeds. The default stage
seeds are ``(None, 2, 3, 3)``, None meaning fresh randomness per run.

Sharding follows the process group (``parallel.current_mesh()``), as the JAX
package's follows ``jax.process_count``/``process_index``: ``num_replicas``
and ``rank`` default to the host count and this host's index, so a host's
sampler yields its rank-strided share; each rank on the host then loads only
its contiguous rows of every host batch (train and validation). Test and
predict items are strided over every rank instead, without the wrapped
padding, so each item is evaluated and written once.

With ``num_workers`` > 0 (2 by default, as in the JAX package) items are
made on worker threads and batches prefetched (``data/prefetch.py``); 0
fetches them in the calling thread. The batches are the same either way.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

from nbss_tpu_torch.data.prefetch import ThreadedLoader
from nbss_tpu_torch.data.sampler import BatchLoader, DistributedSampler
from nbss_tpu_torch.parallel.mesh import current_mesh

STAGES = ("train", "val", "test", "predict")


@dataclass
class DataModule:
    batch_size: Tuple[int, ...] = (2, 1)
    seeds: Tuple[Optional[int], ...] = (None, 2, 3, 3)
    num_replicas: Optional[int] = None  # default: the host count
    rank: Optional[int] = None  # default: this host's index
    num_workers: int = 2

    def _make_dataset(self, stage_idx: int):
        raise NotImplementedError

    def _stage_batch_size(self, stage_idx: int) -> int:
        if stage_idx < len(self.batch_size):
            return self.batch_size[stage_idx]
        return 1  # test / predict default to batch 1 (full-length utterances)

    def _loader(self, stage_idx: int, epoch: int = 0, shuffle: Optional[bool] = None):
        ds = self._make_dataset(stage_idx)
        seed = self.seeds[stage_idx] if stage_idx < len(self.seeds) else 2
        mesh = current_mesh()
        if seed is None:  # drawn by rank 0, so that every rank splits the same order
            seed = mesh.broadcast_object(secrets.randbits(31))
        hosts = self.num_replicas or mesh.hosts
        host = self.rank if self.rank is not None else mesh.host
        ranks = (mesh.local_size, mesh.local_rank)
        shuffle = (stage_idx == 0) if shuffle is None else shuffle
        if stage_idx >= 2:  # test / predict: every rank its own items, each item once
            sampler = DistributedSampler(
                len(ds), seed=seed, shuffle=shuffle, num_replicas=hosts * ranks[0],
                rank=host * ranks[0] + ranks[1], last_epoch=epoch, pad=False)
            ranks = (1, 0)
        else:
            sampler = DistributedSampler(len(ds), seed=seed, shuffle=shuffle,
                                         num_replicas=hosts, rank=host, last_epoch=epoch)
        bs, drop_last = self._stage_batch_size(stage_idx), stage_idx == 0
        if self.num_workers > 0:
            return ThreadedLoader(ds, bs, sampler, num_workers=self.num_workers,
                                  drop_last=drop_last, ranks=ranks)
        return BatchLoader(ds, bs, sampler, drop_last=drop_last, ranks=ranks)

    def train_dataloader(self, epoch: int = 0):
        return self._loader(0, epoch)

    def val_dataloader(self, epoch: int = 0):
        return self._loader(1, epoch)

    def test_dataloader(self):
        return self._loader(2)

    def predict_dataloader(self):
        return self._loader(3)
