"""SMS-WSJ-Plus: spatialized WSJ mixtures made on the fly on the host.

Counterpart of ``nbss_tpu/data/sms_wsj_plus.py`` (numpy and scipy only), the
corpus SpatialNet trains on. Per (index, seed), deterministically:

1. load two clean WSJ utterances,
2. pick a simulated room: drawn for train, the index's room for validation
   and test, from the sorted files of the split (train/validation/test, as
   ``python -m nbss_tpu_torch.sim.generate`` writes them),
3. choose the training target: reverberant image / direct path / RTS-windowed,
4. sample the overlap type and ratio, tile or crop the sources,
5. convolve with the RIRs (aligned on the direct-path peak) and place them
   on the timeline,
6. scale speaker 2 to a random SIR,
7. add diffuse babble (the sum of 10 in-corpus utterances a channel) or
   white noise at a random SNR through the spatial-coherence mixing
   matrices, cached as ``diffuse.npz`` in ``rir_dir``,
8. peak-normalize mixture and targets to 0.9.

Returns (mix [C, T], targets [spk, C, T], paras). For the same files and
(index, seed) an item equals the JAX package's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from nbss_tpu_torch.data import mixing as mx
from nbss_tpu_torch.data.diffuse import gen_diffuse_noise, spatial_coherence_mixing_matrices
from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.data.windows import rts_window
from nbss_tpu_torch.utils.audio_io import read_audio


class SmsWsjPlusDataset:
    def __init__(
        self,
        sms_wsj_dir: str,
        rir_dir: str,
        target: str,
        dataset: str,
        ovlp: str,
        speech_overlap_ratio: Tuple[float, float] = (0.1, 1.0),
        sir: Optional[Tuple[float, float]] = (-5, 5),
        snr: Tuple[float, float] = (10, 20),
        audio_time_len: Optional[float] = None,
        sample_rate: int = 8000,
        num_spk: int = 2,
        noise_type: Tuple[str, ...] = ("babble", "white"),
        return_noise: bool = False,
        return_rvbt: bool = False,
    ):
        assert target in ("revb_image", "direct_path") or target.startswith("RTS"), target
        assert dataset in ("train_si284", "cv_dev93", "test_eval92"), dataset
        assert ovlp in mx.OVLP_TYPES, ovlp
        assert num_spk == 2, num_spk
        assert set(noise_type) <= {"babble", "white"}, noise_type
        if ovlp == "full" and audio_time_len is None:
            ovlp = "hms"  # full overlap impossible without a fixed length

        self.sms_wsj_dir = Path(sms_wsj_dir).expanduser()
        self.target = target
        self.dataset = dataset
        self.ovlp = ovlp
        self.speech_overlap_ratio = tuple(speech_overlap_ratio)
        self.sir = tuple(sir) if sir is not None else None
        self.snr = tuple(snr)
        self.audio_time_len = audio_time_len
        self.sample_rate = sample_rate
        self.num_spk = num_spk
        self.noise_type = tuple(noise_type)
        self.return_noise = return_noise
        self.return_rvbt = return_rvbt

        with open(self.sms_wsj_dir / "sms_wsj.json") as f:
            self.dataset_info = json.load(f)["datasets"][dataset]
        self.keys = list(self.dataset_info.keys())
        originals: List[str] = []
        for k, v in self.dataset_info.items():
            srcs = [
                str(self.sms_wsj_dir / ("wsj_8k_zeromean" + p.split("wsj_8k_zeromean")[-1]))
                for p in v["audio_path"]["original_source"]
            ]
            v["original_source"] = srcs
            v["wavname"] = k + ".wav"
            v["saveto"] = [f"{k}_0.wav", f"{k}_1.wav"]
            originals += srcs
        self.noises = sorted(set(originals))  # in-corpus speech as babble source

        sub = {"train_si284": "train", "cv_dev93": "validation", "test_eval92": "test"}[dataset]
        self.rir_dir = Path(rir_dir).expanduser() / sub
        self.rirs = sorted(str(r) for r in self.rir_dir.rglob("*.npz"))
        assert self.rirs, f"{self.rir_dir} is empty or missing"
        self.shuffle_rir = dataset == "train_si284"

        # cached per-geometry diffuse mixing matrices
        cache = Path(rir_dir).expanduser() / "diffuse.npz"
        if cache.exists():
            self.Cs = np.load(cache, allow_pickle=True)["Cs"]
        else:
            pos_mics = np.load(self.rirs[0], allow_pickle=True)["pos_rcv"]
            _, self.Cs = spatial_coherence_mixing_matrices(
                pos_mics=pos_mics, fs=sample_rate, noise_field="spherical", nfft=256)
            try:
                np.savez(cache, Cs=self.Cs)
            except OSError:
                pass

    def __len__(self) -> int:
        return len(self.dataset_info)

    def __getitem__(self, index_seed: Tuple[int, int]):
        index, seed = index_seed
        rng = np.random.default_rng(np.random.PCG64(seed))
        info = self.dataset_info[self.keys[index]]
        fs = self.sample_rate

        cleans = []
        for i in range(self.num_spk):
            wav, sr = read_audio(info["original_source"][i])
            assert sr == fs, (sr, fs)
            cleans.append(wav)

        rir_path = (self.rirs[rng.integers(0, len(self.rirs))]
                    if self.shuffle_rir else self.rirs[index % len(self.rirs)])
        rir_dict = np.load(rir_path, allow_pickle=True)
        assert int(rir_dict["fs"]) == fs
        rir = rir_dict["rir"]  # [nsrc, nmic, L]
        spk_idx = rng.choice(rir.shape[0], size=self.num_spk, replace=False).tolist()
        rir = rir[spk_idx]
        if self.target == "direct_path":
            rir_target = rir_dict["rir_dp"][spk_idx]
        elif self.target == "revb_image":
            rir_target = rir
        else:  # RTS_0.1s style
            rts_time = float(self.target.replace("RTS_", "").replace("s", ""))
            rir_target = rts_window(rir, float(rir_dict["RT60"]), rts_time, sr=fs) * rir
        num_mic = rir.shape[1]

        ovlp_type = mx.sample_overlap_type(self.ovlp, self.num_spk, rng)
        target_len = None if self.audio_time_len is None else int(self.audio_time_len * fs)
        ovlp_ratio, lens, mix_frames = mx.sample_overlap_ratio_and_lengths(
            ovlp_type, self.speech_overlap_ratio, target_len,
            [c.shape[0] for c in cleans], rng)
        cleans = mx.repeat_crop(cleans, lens, rng)

        pairs = [mx.spatialize(w, r, rt, ref_channel=0, align=True)
                 for w, r, rt in zip(cleans, rir, rir_target)]
        rvbts, targets = mx.place_overlap_2spk(
            [p[0] for p in pairs], [p[1] for p in pairs], ovlp_type, mix_frames, rng)

        sir_this = None
        if self.sir is not None and self.num_spk == 2:
            sir_this = float(rng.uniform(*self.sir))
            coeff = mx.energy_ratio_coeff(rvbts[0], rvbts[1], sir_this)
            assert coeff is not None
            rvbts[1] *= coeff
            targets[1] *= coeff

        noise_type = self.noise_type[rng.integers(0, len(self.noise_type))]
        mix = rvbts.sum(axis=0)
        if noise_type == "babble":
            chans = []
            for _ in range(num_mic):
                acc = np.zeros(mix_frames, np.float32)
                for _ in range(10):
                    noise_ij, sr_n = read_audio(self.noises[rng.integers(0, len(self.noises))])
                    assert sr_n == fs
                    acc += mx.repeat_crop([noise_ij], [mix_frames], rng)[0]
                chans.append(acc)
            noise_src = np.stack(chans).reshape(-1)
        else:
            noise_src = rng.normal(size=mix.shape[0] * mix.shape[1])
        noise = gen_diffuse_noise(noise_src, mix_frames, self.Cs, nfft=256, rng=rng)

        snr_this = float(rng.uniform(*self.snr))
        coeff = mx.energy_ratio_coeff(mix, noise, snr_this)
        assert coeff is not None
        noise *= coeff
        snr_real = float(10 * np.log10(np.sum(mix**2) / np.sum(noise**2)))
        assert np.isclose(snr_this, snr_real, atol=0.5), (snr_this, snr_real)
        mix = mix + noise

        scale = 0.9 / max(np.max(np.abs(mix)), np.max(np.abs(targets)))
        mix *= scale
        targets *= scale

        paras = {
            "index": index, "seed": seed, "saveto": info["saveto"],
            "target": self.target, "sample_rate": fs,
            "dataset": f"SMS-WSJ-Plus/{self.dataset}",
            "noise_type": noise_type,
            "noise": noise if self.return_noise else None,
            "rvbt": rvbts if self.return_rvbt else None,
            "sir": sir_this, "snr": snr_real,
            "ovlp_type": ovlp_type, "ovlp_ratio": float(ovlp_ratio),
            "audio_time_len": self.audio_time_len, "num_spk": self.num_spk,
            "rir": {"RT60": rir_dict["RT60"], "pos_src": rir_dict["pos_src"],
                    "pos_rcv": rir_dict["pos_rcv"]},
        }
        return mix.astype(np.float32), targets.astype(np.float32), paras


@dataclass
class SmsWsjPlusDataModule(DataModule):
    """train/val/test/predict loaders over SmsWsjPlusDataset (the reference's
    sms_wsj_plus.py:254-413; datasets train_si284/cv_dev93/test_eval92,
    4 s train/val clips, full-length test, fixed val/test seeds)."""

    sms_wsj_dir: str = "~/datasets/sms_wsj"
    rir_dir: str = "~/datasets/SMS_WSJ_Plus_rirs"
    target: str = "direct_path"
    datasets: Tuple[str, ...] = ("train_si284", "cv_dev93", "test_eval92", "test_eval92")
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    ovlp: str = "mid"
    speech_overlap_ratio: Tuple[float, float] = (0.1, 1.0)
    sir: Tuple[float, float] = (-5, 5)
    snr: Tuple[float, float] = (0, 20)
    num_spk: int = 2
    noise_type: Tuple[str, ...] = ("babble", "white")
    return_noise: bool = False
    return_rvbt: bool = False

    def _make_dataset(self, stage_idx: int):
        return SmsWsjPlusDataset(
            sms_wsj_dir=self.sms_wsj_dir,
            rir_dir=self.rir_dir,
            target=self.target,
            dataset=self.datasets[stage_idx],
            ovlp=self.ovlp,
            speech_overlap_ratio=self.speech_overlap_ratio,
            sir=self.sir,
            snr=self.snr,
            audio_time_len=self.audio_time_len[stage_idx],
            num_spk=self.num_spk,
            noise_type=self.noise_type,
            return_noise=self.return_noise,
            return_rvbt=self.return_rvbt,
        )
