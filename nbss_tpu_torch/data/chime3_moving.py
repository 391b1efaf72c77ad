"""CHiME3-moving: moving or static single-speaker enhancement.

Counterpart of ``nbss_tpu/data/chime3_moving.py`` (numpy and scipy only):
WSJ0 clean speech, trajectory RIRs rendered by ``nbss_tpu_torch.sim``, and
the real CHiME-3 backgrounds (16 kHz, ``resample_poly`` to 8 kHz), with

- dataset names that encode the motion, e.g. ``train_moving(0.12,0.4,0.5)``:
  speeds 0.12-0.4 m/s, moving with probability 0.5; the trajectory's point
  spacing from ``rir_dir/rir_cfg.npz``, 0.05 m when it is missing;
- static items that pick one point of a trajectory, moving items
  cross-fade-convolved along it at the drawn speed;
- utterances extended with the same speaker's other utterances;
- the backgrounds split 80/10/10 in time across train/val/test, one or two
  of them summed in training, at an SNR drawn from ``snr``.

For the same files and (index, seed) an item equals the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.signal import resample_poly

from nbss_tpu_torch.data import mixing as mx
from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.utils.audio_io import read_audio


class CHiME3MovingDataset:
    def __init__(
        self,
        wsj0_dir: str,
        chime3_dir: str,
        rir_dir: str,
        target: str,
        dataset: str,
        snr: Tuple[float, float] = (-5, 10),
        audio_time_len: Optional[float] = None,
        sample_rate: int = 8000,
        return_noise: bool = False,
        return_rvbt: bool = False,
    ):
        assert target in ("revb_image", "direct_path"), target
        stage = dataset.split("_")[0]
        assert stage in ("train", "val", "test"), dataset

        self.speed = None
        self.prob_moving = 0.0
        self.adjacent_points_distance = None
        if "moving" in dataset:
            spec = dataset.split("_")[-1].replace("moving(", "").replace(")", "").split(",")
            self.speed = [float(s) for s in spec[:2]]
            self.prob_moving = float(spec[2]) if len(spec) == 3 else 1.0
            cfg_path = Path(rir_dir).expanduser() / "rir_cfg.npz"
            if cfg_path.exists():
                cfg = dict(np.load(cfg_path, allow_pickle=True))
                self.adjacent_points_distance = cfg["args"].item()["trajectory"][1]
            else:  # fall back to the generator default spacing
                self.adjacent_points_distance = 0.05

        self.dataset0 = dataset
        self.dataset = stage
        self.target = target
        self.audio_time_len = audio_time_len
        self.sample_rate = sample_rate
        self.return_noise = return_noise
        self.return_rvbt = return_rvbt
        self.snr = tuple(snr)

        # clean speech: wsj0 speaker -> utterances
        self.wsj0_dir = Path(wsj0_dir).expanduser()
        subdirs = {"train": ["si_tr_s"], "val": ["si_dt_05", "si_dt_20"],
                   "test": ["si_et_05", "si_et_20"]}[stage]
        self.spk2uttrs = {}
        self.uttrs = []
        for sub in subdirs:
            for spk_dir in sorted((self.wsj0_dir / sub).glob("*")):
                uttrs = sorted(spk_dir.glob("*.wav"))
                self.spk2uttrs.setdefault(spk_dir.name, []).extend(uttrs)
                self.uttrs += uttrs
        self.uttrs.sort()
        assert self.uttrs, f"no wsj0 wavs under {self.wsj0_dir}"
        self.length = {"train": 20000, "val": 2000, "test": 2000}[stage]

        # CHiME-3 backgrounds (multi-channel .CH{n}.wav files)
        noise_dir = Path(chime3_dir).expanduser() / "data" / "audio" / "16kHz" / "backgrounds"
        self.noises = sorted(noise_dir.rglob("*.CH1.wav"))
        assert self.noises, f"no CHiME3 backgrounds under {noise_dir}"
        self.noise_time_range = {"train": (0.0, 0.8), "val": (0.8, 0.9),
                                 "test": (0.9, 1.0)}[stage]

        self.rir_dir = Path(rir_dir).expanduser() / {
            "train": "train", "val": "validation", "test": "test"}[stage]
        self.rirs = sorted(str(r) for r in self.rir_dir.rglob("*.npz")
                           if not r.name.startswith("rir_cfg")
                           and "_rir_dp_" not in r.name)
        assert self.rirs, f"{self.rir_dir} is empty"
        self.shuffle_rir = stage == "train"

    def __len__(self) -> int:
        return self.length

    def _read_resampled(self, path) -> np.ndarray:
        wav, sr = read_audio(str(path))
        if sr != self.sample_rate:
            g = np.gcd(sr, self.sample_rate)
            wav = resample_poly(wav, self.sample_rate // g, sr // g, axis=0)
        return wav.astype(np.float32)

    def _load_rir_entry(self, entry):
        """RIR entries may be inline arrays or paths to fp16 stacks."""
        if isinstance(entry, str):
            p = self.rir_dir / entry
            if p.suffix == ".npy":
                return np.load(p, mmap_mode="r")
            return np.load(p)["arr"]
        return entry

    def __getitem__(self, index_seed: Tuple[int, int]):
        index, seed = index_seed
        rng = np.random.default_rng(np.random.PCG64(seed))
        fs = self.sample_rate

        # clean speech
        uttr_path = self.uttrs[rng.choice(len(self.uttrs))]
        cands = self.spk2uttrs[Path(uttr_path).parent.name]
        clean = self._read_resampled(uttr_path)

        # room
        rir_path = (self.rirs[rng.integers(0, len(self.rirs))]
                    if self.shuffle_rir else self.rirs[index % len(self.rirs)])
        rir_dict = np.load(rir_path, allow_pickle=True)
        assert int(rir_dict["fs"]) == fs
        num_mic = rir_dict["pos_rcv"].shape[0]
        spk_idx = int(rng.choice(len(rir_dict["rir"]), size=1)[0])
        rir = self._load_rir_entry(rir_dict["rir"][spk_idx]).astype(np.float32)
        if self.target == "direct_path":
            rir_target = self._load_rir_entry(rir_dict["rir_dp"][spk_idx]).astype(np.float32)
        else:
            rir_target = rir

        # length handling: extend with same-speaker utterances, random crop
        if self.audio_time_len is None:
            mix_frames = clean.shape[0]
        else:
            mix_frames = int(self.audio_time_len * fs)
        while len(clean) < mix_frames:
            extra = self._read_resampled(cands[int(rng.choice(len(cands)))])
            clean = np.concatenate([clean, extra])
        if len(clean) > mix_frames:
            start = rng.integers(0, len(clean) - mix_frames + 1)
            clean = clean[start:start + mix_frames]

        # moving or static
        if 0.0 < self.prob_moving < 1.0:
            moving = bool(rng.uniform() > self.prob_moving)
        else:
            moving = self.speed is not None
        if not moving:
            if rir.ndim == 3:  # trajectory: pick one point
                which = rng.integers(0, rir.shape[0])
                rir, rir_target = rir[which], rir_target[which]
            rvbt, target = mx.spatialize(clean, rir, rir_target, ref_channel=0,
                                         align=True, align_by_target=True)
        else:
            speed = float(rng.uniform(*self.speed))
            nsamp = int(round(self.adjacent_points_distance / speed * fs))
            num_rirs = int(np.ceil(mix_frames / nsamp)) + 1
            cand_idx = list(range(rir.shape[0]))
            if rng.integers(0, 2) == 0:
                cand_idx.reverse()
            start = rng.integers(0, len(cand_idx))
            sel = cand_idx[start:]
            while len(sel) < num_rirs:
                sel += cand_idx
            sel = sel[:num_rirs]
            rvbt = mx.convolve_trajectory_windowed(clean, rir[sel], nsamp, "trapezium20")
            target = mx.convolve_trajectory_windowed(clean, rir_target[sel], nsamp, "trapezium20")
            delay = int(np.argmax(rir_target[sel][0, 0]))
            rvbt = rvbt[:, delay:delay + mix_frames]
            target = target[:, delay:delay + mix_frames]
        rvbts = rvbt[None].astype(np.float32)
        targets = target[None].astype(np.float32)

        # CHiME-3 background noise with train-time augmentation
        mix = rvbts.sum(axis=0)
        noise_path = self.noises[rng.integers(0, len(self.noises))]
        first, nsr = read_audio(str(noise_path))
        noise_frames = len(first)
        n0 = int(self.noise_time_range[0] * noise_frames)
        n1 = int(self.noise_time_range[1] * noise_frames)
        up = nsr // np.gcd(nsr, fs)
        needed16 = mix_frames * (nsr // fs) * 2

        noise = np.zeros((num_mic, mix_frames), np.float32)
        n_aug = 1 if self.dataset != "train" else int(rng.integers(1, 3))
        for _ in range(n_aug):
            seg_start = (rng.integers(n0, n1 - needed16)
                         if (n1 - n0) > needed16 else n0)
            for m in range(num_mic):
                path_m = str(noise_path).replace(".CH1.wav", f".CH{m + 1}.wav")
                wav, sr = read_audio(path_m)
                seg = wav[seg_start:seg_start + needed16]
                if len(seg) < needed16:
                    seg = np.tile(seg, -(-needed16 // max(len(seg), 1)))[:needed16]
                g = np.gcd(sr, fs)
                seg = resample_poly(seg, fs // g, sr // g, axis=0)
                noise[m] += seg[:mix_frames].astype(np.float32)

        snr_this = float(rng.uniform(*self.snr))
        coeff = mx.energy_ratio_coeff(mix, noise, snr_this)
        assert coeff is not None
        noise *= coeff
        snr_real = float(10 * np.log10(np.sum(mix**2) / (np.sum(noise**2) + 1e-12)))
        mix = mix + noise

        scale = 0.9 / max(np.max(np.abs(mix)), np.max(np.abs(targets)))
        mix *= scale
        targets *= scale

        paras = {
            "index": index, "seed": seed,
            "saveto": [str(uttr_path.name)],
            "target": self.target, "sample_rate": fs,
            "dataset": f"CHiME3_moving/{self.dataset0}",
            "snr": snr_real, "audio_time_len": self.audio_time_len,
            "num_spk": 1, "moving": moving,
            "rir": {"RT60": rir_dict["RT60"], "pos_rcv": rir_dict["pos_rcv"]},
            "noise": noise * scale if self.return_noise else None,
            "rvbt": rvbts * scale if self.return_rvbt else None,
        }
        return mix.astype(np.float32), targets.astype(np.float32), paras


@dataclass
class CHiME3MovingDataModule(DataModule):
    wsj0_dir: str = "~/datasets/wsj0"
    chime3_dir: str = "~/datasets/CHiME3"
    rir_dir: str = "~/datasets/CHiME3_moving_rirs"
    target: str = "direct_path"
    datasets: Tuple[str, ...] = ("train_moving(0.12,0.4,0.5)", "val_moving(0.12,0.4,0.5)",
                                 "test_moving(0.12,0.4,0.5)", "test_moving(0.12,0.4,0.5)")
    snr: Tuple[float, float] = (-5, 10)
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    sample_rate: int = 8000

    def _make_dataset(self, stage_idx: int):
        return CHiME3MovingDataset(
            wsj0_dir=self.wsj0_dir, chime3_dir=self.chime3_dir, rir_dir=self.rir_dir,
            target=self.target, dataset=self.datasets[stage_idx], snr=self.snr,
            audio_time_len=self.audio_time_len[stage_idx],
            sample_rate=self.sample_rate)
