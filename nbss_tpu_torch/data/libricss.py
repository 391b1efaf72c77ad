"""LibriCSS: LibriSpeech mixtures simulated for training, real LibriCSS to test.

Counterpart of ``nbss_tpu/data/libricss.py`` (numpy and scipy only):

- The simulated sets (SimTrain/SimVal/SimTest): 1 speaker with
  ``spk1_prob``, else 2 with ``spk2_prob``, else 3; three speakers packed
  into 2 output streams ('startend3' placement with 0.1-1 s of silence), one
  speaker padded with a zero second stream; SIR scaling; diffuse recorded
  noise through the coherence matrices of the LibriCSS array
  (``geometry.libricss_array``); a degenerate mix retried with a fresh seed.
- The real sets ('utterances'/'segments'[, '/session0']) return
  (mix, None, paras) with the transcriptions for ASR scoring.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nbss_tpu_torch.data import mixing as mx
from nbss_tpu_torch.data.diffuse import gen_diffuse_noise, spatial_coherence_mixing_matrices
from nbss_tpu_torch.data.geometry import libricss_array
from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.utils.audio_io import read_audio

REAL_SETS = ("utterances", "segments", "utterances/session0", "segments/session0")


class LibriCSSDataset:
    def __init__(
        self,
        libricss_dir: str = None,
        librispeech_dir: str = None,
        rir_dir: str = None,
        noise_dir: str = None,
        target: str = "direct_path",
        dataset: str = "SimTrain",
        ovlp: str = "fhms",
        speech_overlap_ratio: Tuple[float, float] = (0.1, 1.0),
        sir: Optional[Tuple[float, float]] = (-5, 5),
        snr: Optional[Tuple[float, float]] = (5, 20),
        spk1_prob: float = 0.1,
        spk2_prob: float = 0.7,
        audio_time_len: Optional[float] = None,
        sample_rate: int = 16000,
    ):
        self.dataset = dataset
        self.target = target
        self.ovlp = ovlp
        self.speech_overlap_ratio = tuple(speech_overlap_ratio)
        self.sir = tuple(sir) if sir else None
        self.snr = tuple(snr) if snr else None
        self.spk1_prob = spk1_prob
        self.spk2_prob = spk2_prob
        self.audio_time_len = audio_time_len
        self.sample_rate = sample_rate

        if dataset in REAL_SETS:
            self.libricss_dir = (Path(libricss_dir).expanduser()
                                 / f"exp/data/7ch/{dataset.split('/')[0]}")
            uttrs = sorted(self.libricss_dir.rglob("*.wav"))
            if "session0" in dataset:
                uttrs = [u for u in uttrs if "session0" in u.parent.name]
            self.uttrs = uttrs
            self.transcription = {}
            tpath = self.libricss_dir / "utterance_transcription.txt"
            if dataset.startswith("utterances") and tpath.exists():
                for line in open(tpath):
                    key = line.split("\t")[0]
                    self.transcription[key] = line.replace(key, "").strip()
            return

        assert dataset in ("SimTrain", "SimVal", "SimTest"), dataset
        assert target in ("direct_path", "revb_image"), target
        sub = {"SimTrain": "train-clean-100", "SimVal": "dev-clean",
               "SimTest": "test-clean"}[dataset]
        self.uttrs = sorted(Path(librispeech_dir).expanduser().joinpath(sub).rglob("*.flac")) \
            or sorted(Path(librispeech_dir).expanduser().joinpath(sub).rglob("*.wav"))
        self.rirs = sorted(str(p) for p in
                           (Path(rir_dir).expanduser() /
                            {"SimTrain": "train", "SimVal": "validation",
                             "SimTest": "test"}[dataset]).rglob("*.npz"))
        self.noises = sorted(Path(noise_dir).expanduser().rglob("*.wav")) if noise_dir else []
        assert self.uttrs and self.rirs, (librispeech_dir, rir_dir)
        _, self.Cs = spatial_coherence_mixing_matrices(
            pos_mics=libricss_array(), fs=sample_rate, noise_field="spherical", nfft=256)

    def __len__(self) -> int:
        if self.dataset in REAL_SETS:
            return len(self.uttrs)
        return {"SimTrain": 20000, "SimVal": 3000, "SimTest": 3000}[self.dataset]

    def __getitem__(self, index_seed: Tuple[int, int]):
        index, seed = index_seed
        if self.dataset in REAL_SETS:
            mix, sr = read_audio(str(self.uttrs[index]), always_2d=True)
            short = str(self.uttrs[index]).replace(str(self.libricss_dir) + os.sep, "")
            key = short.replace(os.sep, "_").replace(".wav", "")
            paras = {
                "index": index, "sample_rate": sr,
                "dataset": f"LibriCSS/{self.dataset}",
                "saveto": [short.replace(".wav", f"_{x}.wav") for x in (0, 1)],
                "transcription": [self.transcription[key]] * 2
                if key in self.transcription else None,
            }
            return mix.T.astype(np.float32), None, paras

        rng = np.random.default_rng(np.random.PCG64(seed))
        num_spk = 1 if rng.uniform() < self.spk1_prob else \
            (2 if rng.uniform() < self.spk2_prob else 3)

        cleans = []
        for _ in range(num_spk):
            wav, sr = read_audio(str(self.uttrs[rng.integers(0, len(self.uttrs))]))
            cleans.append(wav)
        rir_dict = np.load(self.rirs[rng.integers(0, len(self.rirs))], allow_pickle=True)
        rir = rir_dict["rir"]
        spk_idx = rng.choice(rir.shape[0], size=num_spk, replace=False).tolist()
        rir = rir[spk_idx]
        rir_target = rir_dict["rir_dp"][spk_idx] if self.target == "direct_path" else rir

        if num_spk <= 2:
            ovlp_type = mx.sample_overlap_type(self.ovlp, num_spk, rng)
            target_len = None if self.audio_time_len is None \
                else int(self.audio_time_len * self.sample_rate)
            ovlp_ratio, lens, mix_frames = mx.sample_overlap_ratio_and_lengths(
                ovlp_type, self.speech_overlap_ratio, target_len,
                [c.shape[0] for c in cleans], rng)
        else:
            assert self.audio_time_len is not None
            mix_frames = int(self.audio_time_len * self.sample_rate)
            sil = int(rng.uniform(0.1, 1.0) * self.sample_rate)
            lens = [mix_frames, (mix_frames - sil) // 2,
                    mix_frames - sil - (mix_frames - sil) // 2]
            ovlp_ratio = (mix_frames - sil) / mix_frames
            ovlp_type = "startend3"

        cleans = mx.repeat_crop(cleans, lens, rng)
        pairs = [mx.spatialize(w, r, rt, ref_channel=0, align=True)
                 for w, r, rt in zip(cleans, rir, rir_target)]
        if num_spk <= 2:
            rvbts, targets = mx.place_overlap_2spk(
                [p[0] for p in pairs], [p[1] for p in pairs], ovlp_type, mix_frames, rng)
        else:
            rvbts, targets = mx.place_overlap_3spk_2stream(
                [p[0] for p in pairs], [p[1] for p in pairs], mix_frames)

        def retry():
            return self[(int(rng.integers(0, len(self))), int(rng.integers(0, 2**31)))]

        if self.sir is not None and num_spk >= 2:
            sir_this = rng.uniform(*self.sir)
            coeff = mx.energy_ratio_coeff(rvbts[0], rvbts[1], sir_this)
            if coeff is None:
                return retry()
            rvbts[1] *= coeff
            targets[1] *= coeff

        mix = rvbts.sum(axis=0)
        snr_real = None
        if self.snr is not None and self.noises:
            noise_wav, sr_n = read_audio(str(self.noises[rng.integers(0, len(self.noises))]),
                                         always_2d=True)
            noise_src = noise_wav.T.reshape(-1)
            M = self.Cs.shape[-1]
            if noise_src.shape[-1] < M * mix_frames:
                noise_src = np.tile(noise_src, -(-M * mix_frames // len(noise_src)))
            noise = gen_diffuse_noise(noise_src, mix_frames, self.Cs, nfft=256, rng=rng)
            snr_this = rng.uniform(*self.snr)
            coeff = mx.energy_ratio_coeff(mix, noise, snr_this)
            if coeff is None:
                return retry()
            noise *= coeff
            snr_real = float(10 * np.log10(np.sum(mix**2) / np.sum(noise**2)))
            if not np.isclose(snr_this, snr_real, atol=0.1):
                warnings.warn(f"skip LibriCSS/{self.dataset} item ({index},{seed})")
                return retry()
            mix = mix + noise

        scale = 0.9 / max(np.max(np.abs(mix)), np.max(np.abs(targets)))
        mix *= scale
        targets *= scale
        if num_spk == 1:
            targets = np.concatenate([targets, np.zeros_like(targets)], axis=0)

        paras = {
            "index": index, "seed": seed, "sample_rate": self.sample_rate,
            "dataset": f"LibriCSS/{self.dataset}",
            "saveto": [f"{index}_1.wav", f"{index}_2.wav"],
            "snr": snr_real, "ovlp_type": ovlp_type,
            "ovlp_ratio": float(ovlp_ratio), "audio_time_len": self.audio_time_len,
            "num_spk": num_spk, "num_stream": 1 if num_spk == 1 else 2,
        }
        return mix.astype(np.float32), targets.astype(np.float32), paras


@dataclass
class LibriCSSDataModule(DataModule):
    libricss_dir: Optional[str] = None
    librispeech_dir: Optional[str] = None
    rir_dir: Optional[str] = None
    noise_dir: Optional[str] = None
    target: str = "direct_path"
    datasets: Tuple[str, ...] = ("SimTrain", "SimVal", "SimTest", "utterances")
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    ovlp: str = "fhms"
    sir: Tuple[float, float] = (-5, 5)
    snr: Tuple[float, float] = (5, 20)
    spk1_prob: float = 0.1
    spk2_prob: float = 0.7
    sample_rate: int = 16000

    def _make_dataset(self, stage_idx: int):
        return LibriCSSDataset(
            libricss_dir=self.libricss_dir, librispeech_dir=self.librispeech_dir,
            rir_dir=self.rir_dir, noise_dir=self.noise_dir, target=self.target,
            dataset=self.datasets[stage_idx], ovlp=self.ovlp, sir=self.sir,
            snr=self.snr, spk1_prob=self.spk1_prob, spk2_prob=self.spk2_prob,
            audio_time_len=self.audio_time_len[stage_idx],
            sample_rate=self.sample_rate)
