"""Spatialized WSJ0-2/3mix reader.

Counterpart of ``nbss_tpu/data/spatialized_wsj0_mix.py``: the pre-rendered
8-channel mix and s1..sN (anechoic or reverb), with a seed-deterministic
random crop or zero pad to ``audio_time_len``. Which channels the network
takes is the model's ``channels`` (``configs/NBC2.yaml`` takes six).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.utils.audio_io import read_audio


class SpatializedWSJMixDataset:
    def __init__(
        self,
        sp_wsj0_dir: str,
        dataset: str,
        version: str = "min",
        target: str = "reverb",
        audio_time_len: Optional[float] = None,
        sample_rate: int = 8000,
        num_speakers: int = 2,
    ):
        assert target in ("anechoic", "reverb"), target
        assert dataset in ("tr", "cv", "tt"), dataset
        assert version in ("min", "max"), version
        assert num_speakers in (2, 3), num_speakers
        self.wav_dir = (Path(sp_wsj0_dir).expanduser()
                        / f"{num_speakers}speakers_{target}"
                        / {8000: "wav8k", 16000: "wav16k"}[sample_rate]
                        / version / dataset)
        self.files = sorted(p.name for p in (self.wav_dir / "mix").rglob("*.wav"))
        assert self.files, f"{self.wav_dir} has no mixtures"
        self.dataset = dataset
        self.version = version
        self.target = target
        self.audio_time_len = audio_time_len
        self.sr = sample_rate
        self.num_speakers = num_speakers

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index_seed: Tuple[int, int]):
        index, seed = index_seed
        rng = np.random.default_rng(np.random.PCG64(seed))
        name = self.files[index]
        mix, sr = read_audio(str(self.wav_dir / "mix" / name), always_2d=True)
        assert sr == self.sr, (sr, self.sr)
        srcs = []
        for s in range(self.num_speakers):
            wav, _ = read_audio(str(self.wav_dir / f"s{s + 1}" / name), always_2d=True)
            srcs.append(wav.T)
        mix = mix.T  # [C, T]
        target = np.stack(srcs)  # [spk, C, T]

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
class SpatializedWSJ0MixDataModule(DataModule):
    sp_wsj0_dir: str = "~/datasets/spatialized-wsj0-mix"
    version: str = "min"
    target: str = "reverb"
    sample_rate: int = 8000
    num_speakers: int = 2
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    test_set: str = "tt"

    def _make_dataset(self, stage_idx: int):
        ds = ("tr", "cv", self.test_set, self.test_set)[stage_idx]
        atl = self.audio_time_len[stage_idx] if stage_idx < len(self.audio_time_len) else None
        return SpatializedWSJMixDataset(
            sp_wsj0_dir=self.sp_wsj0_dir, dataset=ds, version=self.version,
            target=self.target, audio_time_len=atl,
            sample_rate=self.sample_rate, num_speakers=self.num_speakers)
