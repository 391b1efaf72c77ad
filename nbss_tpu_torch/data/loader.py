"""DataModule base: stage-wise loaders over (index, seed) samplers.

Counterpart of ``nbss_tpu/data/loader.py``: four stages (train, val, test,
predict) with per-stage datasets, batch sizes and seeds. The default stage
seeds are ``(None, 2, 3, 3)``, None meaning fresh randomness per run. One
process loads one replica's shard (``num_replicas`` 1 and ``rank`` 0 unless
given). With ``num_workers`` > 0 (2 by default, as in the JAX package)
items are made on worker threads and batches prefetched
(``data/prefetch.py``); 0 fetches them in the calling thread. The batches
are the same either way.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Optional, Tuple

from nbss_tpu_torch.data.prefetch import ThreadedLoader
from nbss_tpu_torch.data.sampler import BatchLoader, DistributedSampler

STAGES = ("train", "val", "test", "predict")


@dataclass
class DataModule:
    batch_size: Tuple[int, ...] = (2, 1)
    seeds: Tuple[Optional[int], ...] = (None, 2, 3, 3)
    num_replicas: int = 1
    rank: int = 0
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
        if seed is None:
            seed = secrets.randbits(31)
        sampler = DistributedSampler(
            len(ds), seed=seed, shuffle=(stage_idx == 0) if shuffle is None else shuffle,
            num_replicas=self.num_replicas, rank=self.rank, last_epoch=epoch)
        if self.num_workers > 0:
            return ThreadedLoader(ds, self._stage_batch_size(stage_idx), sampler,
                                  num_workers=self.num_workers, drop_last=(stage_idx == 0))
        return BatchLoader(ds, self._stage_batch_size(stage_idx), sampler,
                           drop_last=(stage_idx == 0))

    def train_dataloader(self, epoch: int = 0):
        return self._loader(0, epoch)

    def val_dataloader(self, epoch: int = 0):
        return self._loader(1, epoch)

    def test_dataloader(self):
        return self._loader(2)

    def predict_dataloader(self):
        return self._loader(3)
