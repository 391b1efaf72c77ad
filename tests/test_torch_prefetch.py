"""The port's threaded loader (nbss_tpu_torch/data/prefetch.py) and the
``num_workers`` field of its DataModules, on the CPU.

At 0, 1 and 4 workers the batches equal ``BatchLoader``'s, in the sampler's
order, with and without ``drop_last``; an exception raised while making an
item, of any kind, reaches the consumer; a consumer that stops early, by ``break`` or by
``Trainer.fit``'s ``steps_per_epoch``, leaves no thread running; the JAX
package's ``ThreadedLoader`` gives the same batches; ``DeviceSyntheticDataModule``
takes a ``num_workers`` key and its batches do not change.
"""

import threading
import time

import numpy as np
import pytest

from nbss_tpu.data.prefetch import ThreadedLoader as JaxThreadedLoader
from nbss_tpu_torch.data.prefetch import ThreadedLoader
from nbss_tpu_torch.data.sampler import BatchLoader, DistributedSampler
from nbss_tpu_torch.data.synthetic import SyntheticDataModule, SyntheticDataset


class Jittery:
    """Items that finish out of order: item i sleeps a seeded 0-3 ms."""

    def __init__(self, n=23, fail_at=None, error=ValueError):
        self.n, self.fail_at, self.error = n, fail_at, error

    def __len__(self):
        return self.n

    def __getitem__(self, index_seed):
        index, seed = index_seed
        time.sleep(np.random.default_rng(seed % 1000).uniform(0, 3e-3))
        if index == self.fail_at:
            raise self.error(f"item {index} is broken")
        x = np.full((2, 5), index, np.float32)
        return x, x[None] + np.float32(seed % 97), {"index": index, "seed": seed}


def _loader_threads():
    return [t for t in threading.enumerate() if t.name.startswith("ThreadedLoader")]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (x, ys, paras), (x2, ys2, paras2) in zip(got, want):
        np.testing.assert_array_equal(x, x2)
        np.testing.assert_array_equal(ys, ys2)
        assert paras == paras2


@pytest.mark.parametrize("num_workers", [0, 1, 4])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_equal_the_serial_loader_in_order(num_workers, drop_last):
    ds = Jittery()
    sampler = DistributedSampler(len(ds), seed=3, shuffle=True)
    want = list(BatchLoader(ds, 4, sampler, drop_last=drop_last))
    loader = (ThreadedLoader(ds, 4, sampler, num_workers=num_workers, drop_last=drop_last)
              if num_workers else BatchLoader(ds, 4, sampler, drop_last=drop_last))
    got = list(loader)
    assert len(got) == len(loader) == (5 if drop_last else 6)
    assert got[-1][0].shape[0] == (4 if drop_last else 3)  # 23 items: a partial last batch
    _assert_same_batches(got, want)
    assert not _loader_threads()


def test_batches_equal_the_jax_threaded_loader():
    ds = SyntheticDataset(num_items=6, num_spk=2, num_channels=2, sample_rate=8000,
                          audio_time_len=0.25)
    sampler = DistributedSampler(len(ds), seed=7, shuffle=True)
    got = list(ThreadedLoader(ds, 2, sampler, num_workers=2))
    want = list(JaxThreadedLoader(ds, 2, sampler, num_workers=2))
    _assert_same_batches(got, want)


@pytest.mark.parametrize("error", [ValueError, SystemExit])  # SystemExit: not an Exception
def test_a_worker_exception_reaches_the_consumer(error):
    ds = Jittery(fail_at=9, error=error)
    sampler = DistributedSampler(len(ds), seed=0, shuffle=False)
    seen = []
    with pytest.raises(error, match="item 9 is broken"):
        for _, _, paras in ThreadedLoader(ds, 4, sampler, num_workers=3):
            seen.append([p["index"] for p in paras])
    assert seen == [[0, 1, 2, 3], [4, 5, 6, 7]]  # the batches before the broken item's
    assert not _loader_threads()


def test_an_early_break_leaves_no_thread():
    ds = Jittery(n=200)
    loader = ThreadedLoader(ds, 2, DistributedSampler(len(ds), seed=1), num_workers=4,
                            prefetch=1)
    for i, _ in enumerate(loader):
        if i == 1:
            time.sleep(0.05)  # the producer fills the queue and blocks on it
            break
    assert not _loader_threads()
    it = iter(loader)
    next(it)
    it.close()
    assert not _loader_threads()


def test_trainer_steps_per_epoch_closes_the_loader():
    from pathlib import Path

    from nbss_tpu_torch.cli.config import load_configs
    from nbss_tpu_torch.cli.main import build_module
    from nbss_tpu_torch.train.loop import Trainer

    configs = Path(__file__).resolve().parents[1] / "configs"
    cfg = load_configs([str(configs / "SpatialNet.yaml")], {
        "model.arch.init_args.num_layers": 1, "model.arch.init_args.dim_hidden": 16,
        "model.arch.init_args.dim_ffn": 32, "model.arch.init_args.dim_squeeze": 4,
        "model.arch.init_args.num_freqs": 33, "model.stft.init_args.n_fft": 64,
        "model.stft.init_args.n_hop": 32, "model.channels": [0, 1], "trainer.precision": "32"})
    module = build_module(cfg, device="cpu")
    data = SyntheticDataModule(num_items=12, num_channels=2, audio_time_len=0.25,
                               batch_size=(2, 2), seeds=(1, 2, 3, 3))
    assert data.num_workers == 2
    trainer = Trainer(module, device="cpu", seed=0)
    history = trainer.fit(lambda: data.train_dataloader(trainer.epoch), data.val_dataloader,
                          steps_per_epoch=2, val_batches=1)
    assert np.isfinite(history["train_loss"]) and np.isfinite(history["val/metric"])
    assert not _loader_threads()


@pytest.mark.parametrize("stage", ["train_dataloader", "val_dataloader", "test_dataloader"])
def test_datamodule_batches_at_any_worker_count(stage):
    kw = dict(num_items=10, num_channels=2, audio_time_len=0.25, batch_size=(3, 2),
              seeds=(4, 2, 3, 3))
    want = list(getattr(SyntheticDataModule(**kw, num_workers=0), stage)())
    for n in (1, 3):
        loader = getattr(SyntheticDataModule(**kw, num_workers=n), stage)()
        assert isinstance(loader, ThreadedLoader)
        _assert_same_batches(list(loader), want)


def test_device_synthetic_datamodule_takes_num_workers(tmp_path):
    from nbss_tpu_torch.cli.config import instantiate
    from nbss_tpu_torch.data.device_mix import DeviceSyntheticDataModule
    from nbss_tpu_torch.sim.config import RirConfigSampler
    from nbss_tpu_torch.sim.generate import generate_rir_files

    sampler = RirConfigSampler(spk_num=2, noise_num=0, RT60_lim=(0.1, 0.12), mic_num=2,
                               arr_geometry="circular", fs=8000, seed=1)
    generate_rir_files(sampler, str(tmp_path), (3, 1, 1), length_round=2048, device="cpu")
    node = {"class_path": "nbss_tpu.data.device_mix.DeviceSyntheticDataModule",
            "init_args": {"rir_dir": str(tmp_path), "num_items": [6, 2, 2, 2], "rir_len": 2048,
                          "audio_time_len": [0.5, 0.5, 0.5, 0.5], "batch_size": [2, 2],
                          "seeds": [5, 2, 3, 3], "device": "cpu"}}
    default = instantiate(node)
    assert isinstance(default, DeviceSyntheticDataModule) and default.num_workers == 0
    threaded = instantiate({**node, "init_args": {**node["init_args"], "num_workers": 2}})
    assert threaded.num_workers == 2
    for stage in ("train_dataloader", "val_dataloader"):
        want = list(getattr(default, stage)())
        got = list(getattr(threaded, stage)())
        assert len(got) == len(want) > 0
        for (x, ys, p), (x2, ys2, p2) in zip(got, want):
            assert [q["seed"] for q in p] == [q["seed"] for q in p2]
            np.testing.assert_array_equal(x.numpy(), x2.numpy())
            np.testing.assert_array_equal(ys.numpy(), ys2.numpy())
    assert not _loader_threads()
