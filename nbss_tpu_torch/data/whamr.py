"""WHAMR! reader (2-speaker noisy reverberant WSJ0-mix).

Counterpart of ``nbss_tpu/data/whamr.py``: the pre-rendered
``mix_both_reverb`` and the s1/s2 anechoic or reverb targets, with a
seed-deterministic random crop (or zero pad) to ``audio_time_len``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.utils.audio_io import read_audio


class WHAMRDataset:
    def __init__(
        self,
        whamr_dir: str,
        dataset: str,
        version: str = "min",
        target: str = "anechoic",
        audio_time_len: Optional[float] = None,
        sample_rate: int = 8000,
    ):
        assert target in ("anechoic", "reverb"), target
        assert dataset in ("tr", "cv", "tt"), dataset
        assert version in ("min", "max"), version
        assert sample_rate in (8000, 16000), sample_rate
        self.wav_dir = (Path(whamr_dir).expanduser()
                        / {8000: "wav8k", 16000: "wav16k"}[sample_rate] / version / dataset)
        self.files = sorted(p.name for p in (self.wav_dir / "mix_both_reverb").rglob("*.wav"))
        assert self.files, f"{self.wav_dir} has no mixtures"
        self.dataset = dataset
        self.version = version
        self.target = target
        self.audio_time_len = audio_time_len
        self.sr = sample_rate

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index_seed: Tuple[int, int]):
        index, seed = index_seed
        rng = np.random.default_rng(np.random.PCG64(seed))
        name = self.files[index]
        mix, sr = read_audio(str(self.wav_dir / "mix_both_reverb" / name), always_2d=True)
        s1, _ = read_audio(str(self.wav_dir / f"s1_{self.target}" / name), always_2d=True)
        s2, _ = read_audio(str(self.wav_dir / f"s2_{self.target}" / name), always_2d=True)
        assert sr == self.sr, (sr, self.sr)
        mix = mix.T  # [C, T]
        target = np.stack([s1.T, s2.T])  # [spk, C, T]

        T = mix.shape[-1]
        start = 0
        if self.audio_time_len:
            frames = int(sr * self.audio_time_len)
            if T < frames:
                mix = np.pad(mix, ((0, 0), (0, frames - T)))
                target = np.pad(target, ((0, 0), (0, 0), (0, frames - T)))
            elif T > frames:
                start = int(rng.integers(0, T - frames))
                mix = mix[:, start:start + frames]
                target = target[:, :, start:start + frames]

        paras = {
            "index": index, "seed": seed, "wavname": name,
            "wavdir": str(self.wav_dir), "sample_rate": self.sr,
            "dataset": self.dataset, "target": self.target,
            "version": self.version, "audio_time_len": self.audio_time_len,
            "start": start,
        }
        return mix.astype(np.float32), target.astype(np.float32), paras


@dataclass
class WHAMRDataModule(DataModule):
    whamr_dir: str = "~/datasets/whamr"
    version: str = "min"
    target: str = "anechoic"
    sample_rate: int = 8000
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    test_set: str = "tt"

    def _make_dataset(self, stage_idx: int):
        ds = ("tr", "cv", self.test_set, self.test_set)[stage_idx]
        atl = self.audio_time_len[stage_idx] if stage_idx < len(self.audio_time_len) else None
        return WHAMRDataset(
            whamr_dir=self.whamr_dir, dataset=ds, version=self.version,
            target=self.target, audio_time_len=atl, sample_rate=self.sample_rate)
