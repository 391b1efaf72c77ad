"""SMS-WSJ (the official corpus) reader.

Counterpart of ``nbss_tpu/data/sms_wsj.py`` (numpy and scipy only): either
read the precomputed target wavs ('early' / 'speech_source' /
'image-from-file') or regenerate the observation from the clean sources and
RIRs (``scenario_map``) with

- the invasive-SIR scaling from the json's log_weights, divided by 71 to
  bound |values| < 1,
- white noise at 20-30 dB SNR from a ``RandomState`` seeded by the md5 of
  the example id (``example_id_rng``), as the shipped corpus was made,
- targets from the direct-path RIRs (``fftconvolve``), rectangular-windowed
  RIRs ('direct_path_Xms'), RTS-windowed RIRs ('RTS_Ys') or the full image,

then an overlap-aware random crop to ``audio_time_len``, and optional FUSS
non-speech replacement for the 0- and 1-speaker tests. For the same files
and (index, seed) an item equals the JAX package's.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass
from hashlib import md5
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from scipy.signal import fftconvolve

from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.data.windows import rectangular_window, rts_window
from nbss_tpu_torch.utils.audio_io import read_audio


def rir_start_sample(h: np.ndarray, level_ratio: float = 1e-1) -> int:
    """Time of flight: first sample above level_ratio * max (min over chans)."""
    if h.ndim > 1:
        return int(min(rir_start_sample(h_, level_ratio) for h_ in h.reshape(-1, h.shape[-1])))
    abs_h = np.abs(h)
    imax = int(np.argmax(abs_h))
    return int(np.argmax(abs_h[: imax + 1] > level_ratio * abs_h[imax]))


def example_id_rng(example_id: str) -> np.random.RandomState:
    """Legacy md5-seeded RandomState (sms_wsj.py:479-488)."""
    hash_value = int(md5(example_id.encode()).hexdigest(), 16)
    return np.random.RandomState((hash_value - 1) % 2**32)


def extract_piece(x: np.ndarray, offset: int, target_length: int) -> np.ndarray:
    if offset < 0:
        x = x[..., -offset:]
    else:
        pad = [(0, 0)] * (x.ndim - 1) + [(offset, 0)]
        x = np.pad(x, pad)
    if x.shape[-1] < target_length:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, target_length - x.shape[-1])]
        x = np.pad(x, pad)
    return x[..., :target_length]


def white_noise_for_signal(signal: np.ndarray, snr: float,
                           rng: np.random.RandomState) -> np.ndarray:
    noise = rng.normal(size=signal.shape)
    p_sig = np.mean(signal**2, keepdims=True)
    p_noise = np.mean(noise**2, keepdims=True)
    current_snr = 10 * np.log10(p_sig / p_noise)
    return noise * 10 ** (-(snr - current_snr) / 20)


def scenario_map(
    example: Dict[str, Any],
    snr_range: Tuple[float, float] = (20, 30),
    rir_target: Optional[np.ndarray] = None,
    add_speech_image: bool = False,
    early_rir_samples: int = int(8000 * 0.05),
) -> Dict[str, Any]:
    """Regenerate observation (+ optional targets) from sources and RIRs."""
    h = example["audio_data"]["rir"]  # [spk, C, L]
    starts = np.array([rir_start_sample(h_k) for h_k in h])
    K = h.shape[0]
    T = example["num_samples"]["observation"]
    s = example["audio_data"]["original_source"]
    log_weights = example["log_weights"]

    def convolved(h_):
        xs = [fftconvolve(s_[None, :], hk, axes=-1) for s_, hk in zip(s, h_)]
        offs = [o - st for o, st in zip(example["offset"], starts)]
        return np.stack([extract_piece(x_, o, T) for x_, o in zip(xs, offs)])

    x = convolved(h)  # [spk, C, T]
    std = np.maximum(np.std(x, axis=(-2, -1), keepdims=True), np.finfo(x.dtype).tiny)
    scale = (10 ** (np.asarray(log_weights)[:, None, None] / 20)) / std
    scale /= 71  # bound |values| < 1 (fgnt convention)
    x *= scale
    if add_speech_image:
        example["audio_data"]["speech_image"] = x

    clean_mix = np.sum(x, axis=0)

    if rir_target is not None:
        if rir_target.ndim == 2:
            rir_target = rir_target[:, None, :]
        xt = convolved(rir_target)
        example["audio_data"]["speech_target"] = xt * scale

    rng = example_id_rng(example["example_id"])
    snr = rng.uniform(*snr_range)
    example["snr"] = snr
    rng = example_id_rng(example["example_id"])
    n = white_noise_for_signal(clean_mix, snr=snr, rng=rng)
    example["audio_data"]["observation"] = clean_mix + n
    return example


class SmsWsjDataset:
    def __init__(
        self,
        sms_wsj_dir: str,
        target: str,
        dataset: str,
        audio_time_len: Optional[float] = None,
        ref_channel: int = 0,
        num_spk: int = 2,
        fuss_dir: Optional[str] = None,
        check_regenerated: bool = False,
    ):
        ok = target in ("early", "image", "image-from-file", "speech_source", "direct_path")
        assert ok or target.startswith("direct_path") or target.startswith("RTS"), target
        assert dataset in ("train_si284", "cv_dev93", "test_eval92"), dataset
        assert num_spk in (0, 1, 2), num_spk
        self.sms_wsj_dir = Path(sms_wsj_dir).expanduser()
        self.target = target
        self.dataset = dataset
        self.audio_time_len = audio_time_len
        self.ref_channel = ref_channel
        self.num_spk = num_spk
        self.check_regenerated = check_regenerated

        with open(self.sms_wsj_dir / "sms_wsj.json") as f:
            self.dataset_info = json.load(f)["datasets"][dataset]
        self.observations = sorted((self.sms_wsj_dir / "observation" / dataset).rglob("*.wav"))
        assert self.observations, f"no observations in {self.sms_wsj_dir}"

        self.non_speeches: List[Path] = []
        if num_spk != 2:
            assert target == "direct_path", target
            assert fuss_dir is not None
            sub = {"train_si284": "train", "cv_dev93": "validation",
                   "test_eval92": "eval"}[dataset]
            with open(Path(fuss_dir).expanduser() / "fsd_data" / f"{sub}_foreground.txt") as f:
                lines = [l.strip() for l in f.readlines()]
            self.non_speeches = [Path(fuss_dir).expanduser() / "fsd_data" / l for l in lines]
            if len(self.observations) == len(self.non_speeches):
                self.non_speeches = self.non_speeches[:-1]
            assert self.non_speeches

    def __len__(self) -> int:
        return len(self.observations)

    def _local(self, path: str, sub: str) -> Path:
        return self.sms_wsj_dir / (sub + path.split(sub)[-1])

    def __getitem__(self, index_seed):
        index, seed = index_seed if isinstance(index_seed, tuple) else (index_seed, index_seed)
        rng = np.random.default_rng(np.random.PCG64(seed))
        name = self.observations[index % len(self.observations)].name
        info = copy.deepcopy(self.dataset_info[name.removesuffix(".wav")])
        target_name = [name.replace(".wav", "_0.wav"), name.replace(".wav", "_1.wav")]

        if self.target in ("early", "speech_source"):
            mix, sr = read_audio(str(self.observations[index]), always_2d=True)
            mix = mix.T
            tgt = []
            for tn in target_name:
                w, _ = read_audio(str(self.sms_wsj_dir / self.target / self.dataset / tn),
                                  always_2d=True)
                tgt.append(w.T)
            target = np.stack(tgt)
        elif self.target == "image-from-file":
            mix, sr = read_audio(str(self.observations[index]), always_2d=True)
            mix = mix.T
            tgt = []
            for tn in target_name:
                e, _ = read_audio(str(self.sms_wsj_dir / "early" / self.dataset / tn), always_2d=True)
                t_, _ = read_audio(str(self.sms_wsj_dir / "tail" / self.dataset / tn), always_2d=True)
                tgt.append((e + t_).T)
            target = np.stack(tgt)
        else:
            sources, rirs = [], []
            for os_path, rir_path in zip(info["audio_path"]["original_source"],
                                         info["audio_path"]["rir"]):
                w, _ = read_audio(str(self._local(os_path, "wsj_8k_zeromean")))
                sources.append(w.astype(np.float64))
                r, _ = read_audio(str(self._local(rir_path, "rirs")), always_2d=True)
                rirs.append(r.T.astype(np.float64))
            if self.num_spk != 2:
                sources, target_name = self._replace_with_non_speech(
                    rng, sources, target_name, info)
            rirs = np.stack(rirs)
            info["audio_data"] = {"original_source": sources, "rir": rirs}
            info["num_samples"]["original_source"] = [len(s_) for s_ in sources]

            if self.target == "direct_path":
                dp = []
                for rir_path in info["audio_path"]["rir"]:
                    p = self.sms_wsj_dir / ("rirs_direct_path" + rir_path.split("rirs")[-1])
                    r, _ = read_audio(str(p), always_2d=True)
                    dp.append(r.T.astype(np.float64))
                info = scenario_map(info, rir_target=np.stack(dp))
                target = info["audio_data"]["speech_target"]
            elif self.target.startswith("direct_path") and self.target.endswith("ms"):
                tb = float(self.target.split("_")[-1].replace("ms", "")) / 1000
                win = np.stack([rectangular_window(r, sr=8000, time_before_after_max=tb)
                                for r in rirs[:, self.ref_channel]])
                info = scenario_map(info, rir_target=rirs[:, self.ref_channel] * win)
                target = info["audio_data"]["speech_target"]
            elif self.target.startswith("RTS"):
                t60 = float(self.target.split("_")[-1].replace("s", ""))
                win = np.stack([rts_window(r, info["sound_decay_time"], t60, sr=8000)
                                for r in rirs[:, self.ref_channel]])
                info = scenario_map(info, rir_target=rirs[:, self.ref_channel] * win)
                target = info["audio_data"]["speech_target"]
            else:  # image
                info = scenario_map(info, add_speech_image=True)
                target = info["audio_data"]["speech_image"]
            mix = info["audio_data"]["observation"]
            if self.num_spk == 2 and self.check_regenerated:
                shipped, _ = read_audio(str(self.observations[index]), always_2d=True)
                assert np.allclose(shipped.T, mix, atol=1e-6), \
                    "regenerated observation differs from the shipped SMS-WSJ wav"

        # overlap-aware cropping (the reference's sms_wsj.py:200-223)
        if self.audio_time_len:
            needed = int(self.audio_time_len * 8000)
            if mix.shape[-1] < needed:
                left = rng.integers(0, needed - mix.shape[-1] + 1)
                right = needed - mix.shape[-1] - left
                mix = np.pad(mix, ((0, 0), (left, right)))
                target = np.pad(target, ((0, 0), (0, 0), (left, right)))
            elif mix.shape[-1] > needed:
                a_start = info["offset"]
                a_end = [info["offset"][i] + info["num_samples"]["original_source"][i]
                         for i in range(len(a_start))]
                rand_min, rand_max = 0, mix.shape[-1] - needed
                for sec in (1, 1.5, 2, 2.5, 3):
                    lo = max(0, max(a_start) - int(sec * 8000))
                    hi = min(mix.shape[-1] - needed,
                             min(a_end) - int((self.audio_time_len - sec) * 8000))
                    if lo < hi:
                        rand_min, rand_max = lo, hi
                        break
                left = rng.integers(rand_min, max(rand_max, rand_min + 1))
                mix = mix[:, left:left + needed]
                target = target[:, :, left:left + needed]

        paras = {
            "index": index, "seed": seed, "wavname": name,
            "saveto": target_name, "target": self.target,
            "sample_rate": 8000, "dataset": f"SMS-WSJ/{self.dataset}",
            "audio_time_len": self.audio_time_len, "num_spk": self.num_spk,
        }
        return mix.astype(np.float32), target.astype(np.float32), paras

    def _replace_with_non_speech(self, rng, sources, target_name, info):
        """Replace 1 or 2 sources with FUSS non-speech (sms_wsj.py:247-298)."""
        n_replace = 2 - self.num_spk
        replace_idx = rng.choice(2, size=n_replace, replace=False)
        for ri in replace_idx:
            path = self.non_speeches[rng.integers(0, len(self.non_speeches))]
            w, sr = read_audio(str(path))
            if w.ndim > 1:
                w = w[:, 0]
            need = len(sources[ri])
            if len(w) < need:
                w = np.tile(w, -(-need // max(len(w), 1)))
            start = rng.integers(0, len(w) - need + 1)
            sources[int(ri)] = w[start:start + need].astype(np.float64)
            target_name[int(ri)] = f"nonspeech_{Path(path).stem}.wav"
        return sources, target_name


@dataclass
class SmsWsjDataModule(DataModule):
    sms_wsj_dir: str = "~/datasets/sms_wsj"
    target: str = "direct_path"
    datasets: Tuple[str, ...] = ("train_si284", "cv_dev93", "test_eval92", "test_eval92")
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    num_spk: int = 2
    ref_channel: int = 0
    fuss_dir: Optional[str] = None
    # which split the test/predict loaders evaluate: 'test'/'val'/'train'
    # (the reference's sms_wsj.py:316,416-421)
    test_set: str = "test"

    def _make_dataset(self, stage_idx: int):
        if stage_idx >= 2:
            stage_idx = {"test": stage_idx, "val": 1, "train": 0}[self.test_set]
        return SmsWsjDataset(
            sms_wsj_dir=self.sms_wsj_dir, target=self.target,
            dataset=self.datasets[stage_idx],
            audio_time_len=self.audio_time_len[stage_idx],
            ref_channel=self.ref_channel, num_spk=self.num_spk,
            fuss_dir=self.fuss_dir)
