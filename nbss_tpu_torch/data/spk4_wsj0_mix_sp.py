"""Speaker-specific WSJ0 mixtures of 4 speakers, taken in pairs.

Counterpart of ``nbss_tpu/data/spk4_wsj0_mix_sp.py``: a fixed set of 4 WSJ0
speakers expanded into all ordered speaker pairs (``get_clean_wavs``,
``gen_pairs``); items are indexed by a dict {speech_index, rir_index, seed}
so that a given (pair, room) is addressable. The overlap comes from
``audio_time_len`` strings ('nmix 4', 'mix 5', 'all-mix 5', 'frontend 5',
'mid 5', 'headtail 5', 'min', 'max', or a float, meaning headtail); speaker
2 is scaled into ``speech_scale`` dB of speaker 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from nbss_tpu_torch.data import mixing as mx
from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.utils.audio_io import read_audio


def get_clean_wavs(spk_dir: str, min_duration: float = 4.0,
                   wsj0_dir: str = "~/datasets/wsj0", max_num: int = 120,
                   sample_rate: int = 16000) -> List[str]:
    p = Path(wsj0_dir).expanduser() / spk_dir
    wavs = []
    for f in sorted(p.glob("*.wav")):
        if len(wavs) >= max_num:
            break
        data, sr = read_audio(str(f))
        if len(data) / sr >= min_duration:
            wavs.append(str(f))
    return wavs


def gen_pairs(wavs_a: Sequence[str], wavs_b: Sequence[str]) -> List[Tuple[str, str]]:
    pairs = []
    for idx, a in enumerate(wavs_a):
        for b in wavs_b:
            pairs.append((a, b) if idx % 2 == 0 else (b, a))
    return pairs


class Spk4Wsj0MixSpDataset:
    def __init__(
        self,
        spks: Sequence[str] = ("si_tr_s/024", "si_tr_s/01y", "si_tr_s/401", "si_tr_s/02a"),
        audio_time_len: Union[str, float] = "nmix 4",
        speech_overlap_ratio: Tuple[float, float] = (0.1, 1.0),
        speech_scale: Tuple[float, float] = (-5, 5),
        sample_rate: int = 16000,
        wsj0_dir: str = "~/datasets/wsj0",
        rir_dir: str = "~/datasets/rir_cfg_4/train",
        min_duration: float = 4.0,
    ):
        wavs = [get_clean_wavs(s, min_duration, wsj0_dir, sample_rate=sample_rate)
                for s in spks]
        self.pairs: List[Tuple[str, str]] = []
        for i in range(len(wavs)):
            for j in range(i + 1, len(wavs)):
                self.pairs += gen_pairs(wavs[i], wavs[j])
        assert self.pairs, (wsj0_dir, spks)
        self.rirs = sorted(str(p) for p in Path(rir_dir).expanduser().glob("*.npz"))
        assert self.rirs, rir_dir
        self.audio_time_len = audio_time_len
        self.speech_overlap_ratio = tuple(speech_overlap_ratio)
        self.speech_scale = tuple(speech_scale)
        self.sr = sample_rate

    def __len__(self) -> int:
        return len(self.pairs)

    def _overlap_spec(self, rng, lens) -> Tuple[str, float, List[int], int]:
        atl = self.audio_time_len
        ratio = float(rng.uniform(*self.speech_overlap_ratio))

        def spec_len(s):
            return int(float(str(s).split(" ")[1]) * self.sr)

        if atl in (None, "max"):
            mixlen = max(lens)
            return "mid", min(lens) / max(lens), list(lens), mixlen
        if atl == "min":
            return "full", 1.0, [min(lens)] * 2, min(lens)
        if isinstance(atl, str) and atl.split(" ")[0] in ("nmix", "mix", "mix3", "all-mix",
                                                          "frontend", "mid", "headtail"):
            kind = atl.split(" ")[0]
            mixlen = spec_len(atl)
            if kind == "nmix":
                ovlp = ("mid", "headtail", ("start", "end"))[rng.integers(0, 3)]
                if isinstance(ovlp, tuple):
                    ovlp = ovlp[rng.integers(0, 2)]
            elif kind in ("mix", "mix3"):
                ovlp = ("mid", "headtail", "full")[rng.integers(0, 3 if kind == "mix3" else 2)]
            elif kind == "all-mix":
                ovlp = ("full", "mid", "headtail", ("start", "end"))[rng.integers(0, 4)]
                if isinstance(ovlp, tuple):
                    ovlp = ovlp[rng.integers(0, 2)]
            elif kind == "frontend":
                ovlp = ("start", "end")[rng.integers(0, 2)]
            else:
                ovlp = kind  # mid / headtail
            if ovlp == "full":
                ratio = 1.0
            if ovlp == "headtail":
                needed = [int(mixlen * (0.5 + ratio / 2))] * 2
            elif ovlp == "full":
                needed = [mixlen] * 2
            else:  # mid / start / end
                needed = list(lens)
                imax, imin = int(np.argmax(needed)), int(np.argmin(needed))
                if imax == imin:
                    imax = 1 - imax
                needed[imax] = mixlen
                needed[imin] = int(mixlen * ratio)
            return ovlp, ratio, needed, mixlen
        # plain float seconds = headtail
        mixlen = int(float(atl) * self.sr)
        return "headtail", ratio, [int(mixlen * (0.5 + ratio / 2))] * 2, mixlen

    def __getitem__(self, index: Dict[str, int]):
        sidx, ridx, seed = index["speech_index"], index["rir_index"], index["seed"]
        rng = np.random.default_rng(np.random.PCG64(seed))

        cleans = []
        for path in self.pairs[sidx % len(self.pairs)]:
            wav, sr = read_audio(path)
            assert sr == self.sr, (sr, self.sr)
            cleans.append(wav)

        rir_dict = np.load(self.rirs[ridx % len(self.rirs)], allow_pickle=True)
        rir = rir_dict["speech_rir"] if "speech_rir" in rir_dict else rir_dict["rir"]

        ovlp, ratio, needed, mixlen = self._overlap_spec(rng, [len(c) for c in cleans])
        cleans = mx.repeat_crop(cleans, needed, rng)

        pairs = [mx.spatialize(w, r, r, ref_channel=0, align=True)
                 for w, r in zip(cleans, rir[:2])]
        rvbts, targets = mx.place_overlap_2spk(
            [p[0] for p in pairs], [p[1] for p in pairs], ovlp, mixlen, rng)

        scale_db = float(rng.uniform(*self.speech_scale))
        coeff = mx.energy_ratio_coeff(rvbts[0], rvbts[1], scale_db)
        if coeff is not None:
            rvbts[1] *= coeff
            targets[1] *= coeff
        mix = rvbts.sum(axis=0)

        norm = 0.9 / max(np.max(np.abs(mix)), np.max(np.abs(targets)))
        mix *= norm
        targets *= norm

        paras = {
            "index": index, "seed": seed, "sample_rate": self.sr,
            "dataset": "Spk4Wsj0mixSp", "ovlp_type": ovlp,
            "ovlp_ratio": float(ratio), "speech_scale": scale_db,
            "num_spk": 2, "saveto": [f"{sidx}_{ridx}_{s}.wav" for s in (0, 1)],
        }
        return mix.astype(np.float32), targets.astype(np.float32), paras


@dataclass
class Spk4Wsj0MixSpDataModule(DataModule):
    """Loader yielding dict-indexed items: iterates (pair x rir) with
    per-item seeds from the stage sampler."""

    spks: Tuple[str, ...] = ("si_tr_s/024", "si_tr_s/01y", "si_tr_s/401", "si_tr_s/02a")
    wsj0_dir: str = "~/datasets/wsj0"
    rir_dir: str = "~/datasets/rir_cfg_4/train"
    audio_time_len: Union[str, float] = "nmix 4"
    speech_overlap_ratio: Tuple[float, float] = (0.1, 1.0)
    speech_scale: Tuple[float, float] = (-5, 5)
    sample_rate: int = 16000

    def _make_dataset(self, stage_idx: int):
        base = Spk4Wsj0MixSpDataset(
            spks=self.spks, audio_time_len=self.audio_time_len,
            speech_overlap_ratio=self.speech_overlap_ratio,
            speech_scale=self.speech_scale, sample_rate=self.sample_rate,
            wsj0_dir=self.wsj0_dir, rir_dir=self.rir_dir)

        class _Adapter:
            def __len__(self_inner):
                return len(base)

            def __getitem__(self_inner, index_seed):
                i, seed = index_seed
                return base[{"speech_index": i, "rir_index": i, "seed": seed}]

        return _Adapter()
