"""REVERB challenge dereverberation sets.

Counterpart of ``nbss_tpu/data/reverb.py`` (numpy and scipy only):

- ``gen_obs``: the Matlab recipe's observation, with the SNR defined against
  the direct and early (-1 ms to +50 ms) part of the reference channel's RIR.
- ``ReverbTrainValDataset``: WSJCAM0 clean sources, simulated (or, with
  ``use_real_rir_prop``, the released measured) RIRs and the measured REVERB
  noise with a random gain, channel shift and count, mixed at an SNR against
  the reverberant image; direct-path or dry-source targets.
- ``ReverbEtDataset``: the released real/sim evaluation sets
  (returns (mix, None, paras)); ``ReverbSimDtEtMCDataset``: SimDt/SimEt
  synthesized with multichannel direct-path targets.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from scipy.signal import fftconvolve

from nbss_tpu_torch.data.loader import DataModule
from nbss_tpu_torch.data.windows import rectangular_window
from nbss_tpu_torch.utils.audio_io import read_audio


def gen_obs(x: np.ndarray, RIR: np.ndarray, NOISE: np.ndarray, SNRdB: float) -> np.ndarray:
    """x [T]; RIR [T_rir, C]; NOISE [T_n, C] -> noisy reverberant [C, T]."""
    RIR = RIR.T
    delay = int(np.argmax(RIR[0]))
    before = math.floor(16000 * 0.001)
    after = math.floor(16000 * 0.05)
    rir_de = RIR[0, delay - before:delay + after]
    direct = fftconvolve(x, rir_de, mode="full", axes=-1)

    rev = fftconvolve(x[None], RIR, mode="full", axes=-1)
    T = rev.shape[-1]
    NOISE = NOISE[:T, :]
    iPn = 1.0 / np.mean(NOISE[:, 0] ** 2)
    Px = np.mean(direct**2)
    msnr = np.sqrt(10 ** (-SNRdB / 10) * iPn * Px)
    y = rev + (NOISE * msnr).T
    return y[:, delay:]


class ReverbTrainValDataset:
    def __init__(
        self,
        wsjcam0_dir: str,
        reverb_dir: str,
        dataset: str,
        rir_dir: str,
        num_noises: int = 1,
        snr: Tuple[float, float] = (5, 20),
        audio_time_len: Optional[float] = None,
        sample_rate: int = 16000,
        target: str = "direct_path",
        source_lists: Optional[List[str]] = None,
        use_real_rir_prop: float = 0.0,
        noise_room_match: bool = False,
    ):
        """use_real_rir_prop: probability of drawing a released measured RIR
        (reverb_tools_for_Generate_*/RIR/*.wav) instead of a simulated one
        (the reference's reverb.py:76/145 — the reference builds this path too but
        force-asserts it to 0). noise_room_match: select the measured noise
        by room size matched to the simulated RIR's T60 (<0.35 SmallRoom,
        <0.6 MediumRoom, else LargeRoom; reference reverb.py:116-121 builds
        these groups; its __getitem__ uses the combined list, which is the
        default here too)."""
        assert dataset in ("train_with_simulated_rir", "val_with_simulated_rir"), dataset
        assert target in ("direct_path", "dry_source"), target
        assert 0.0 <= use_real_rir_prop <= 1.0, use_real_rir_prop
        self.dataset = dataset
        self.target = target
        self.num_noises = num_noises
        self.snr = tuple(snr)
        self.audio_time_len = audio_time_len
        self.sr = sample_rate
        self.use_real_rir_prop = use_real_rir_prop
        self.noise_room_match = noise_room_match

        wsjcam0 = Path(wsjcam0_dir).expanduser()
        if source_lists:  # explicit .lst files of WSJCAM0 relative paths
            rels: List[str] = []
            for lst in source_lists:
                with open(lst) as f:
                    rels += [l.strip() for l in f if l.strip()]
            self.sources = [str(wsjcam0 / "data") + r + ".wav" for r in rels]
        else:  # scan
            self.sources = sorted(str(p) for p in (wsjcam0 / "data").rglob("*.wav"))
        assert self.sources, wsjcam0
        if dataset.startswith("val"):
            self.sources = self.sources * 2  # far + near conditions

        sub = "train" if dataset.startswith("train") else "validation"
        self.simu_rirs = sorted(str(p) for p in (Path(rir_dir).expanduser() / sub).rglob("*.npz"))
        assert self.simu_rirs, rir_dir
        tools = Path(reverb_dir).expanduser() / (
            "reverb_tools_for_Generate_mcTrainData" if sub == "train"
            else "reverb_tools_for_Generate_SimData")
        if sub == "train":
            # noise grouped by recording room size; index by the simulated
            # T60: <0.35 -> SmallRoom (T60 0.25), <0.6 -> MediumRoom (0.5),
            # else LargeRoom (0.7) (the reference's reverb.py:116-121)
            self.noise_groups = [
                sorted(str(p) for p in tools.rglob("NOISE/*SmallRoom*.wav")),
                sorted(str(p) for p in tools.rglob("NOISE/*MediumRoom*.wav")),
                sorted(str(p) for p in tools.rglob("NOISE/*LargeRoom*.wav")),
            ]
            self.real_rirs = sorted(str(p) for p in (tools / "RIR").glob("*.wav"))
        else:
            # Generate_dtData.m uses Noise_SimRoom[123]* and *AnglA.wav RIRs
            self.noise_groups = [sorted(
                str(p) for p in tools.rglob("NOISE/Noise_SimRoom[123]*.wav"))]
            self.real_rirs = sorted(str(p) for p in (tools / "RIR").glob("*AnglA.wav"))
        self.noise_groups.append(sorted(set(sum(self.noise_groups, []))))
        self.noises = self.noise_groups[-1]  # combined (T60-unknown) list
        assert self.noises, tools
        if use_real_rir_prop > 0:
            assert self.real_rirs, tools / "RIR"

    def __len__(self) -> int:
        return 20000 if self.dataset.startswith("train") else len(self.sources)

    def __getitem__(self, index_seed: Tuple[int, int]):
        index, seed = index_seed
        rng = np.random.default_rng(np.random.PCG64(seed))

        src_idx = int(rng.integers(0, len(self.sources))) \
            if self.dataset.startswith("train") else index % len(self.sources)
        source, srs = read_audio(self.sources[src_idx])
        assert srs == self.sr, (srs, self.sr)

        rt60 = None
        if rng.uniform(0, 1) < self.use_real_rir_prop:
            # released measured RIR with a random circular channel shift;
            # direct path = +-2 ms rectangular window (reverb.py:184-196)
            rir_path = self.real_rirs[rng.integers(0, len(self.real_rirs))]
            rir2d, sr_rir = read_audio(rir_path, always_2d=True)
            assert sr_rir == self.sr, (sr_rir, self.sr)
            rir = rir2d.T  # [nmic, time]
            shift = int(rng.integers(0, rir.shape[0]))
            rir = np.roll(rir, -shift, axis=0)
            rir_dp = np.stack([rir[c] * rectangular_window(rir[c], self.sr, 0.002)
                               for c in range(rir.shape[0])])
            spk_index = 0
        else:
            rir_path = self.simu_rirs[rng.integers(0, len(self.simu_rirs))]
            rir_dict = np.load(rir_path, allow_pickle=True)
            rir_all = rir_dict["rir"]
            spk_index = int(rng.integers(0, rir_all.shape[0]))
            rir = rir_all[spk_index]
            rir_dp = rir_dict["rir_dp"][spk_index]
            if "RT60" in rir_dict:
                rt60 = float(rir_dict["RT60"])

        delay = int(np.argmax(rir[0]))
        rvbt = fftconvolve(source[None], rir, mode="full", axes=-1)[:, delay:]
        if self.target == "direct_path":
            dp = fftconvolve(source[None], rir_dp, mode="full", axes=-1)[:, delay:]
        else:
            dp = source[None]
        T = dp.shape[-1]
        rvbt = rvbt[:, :T]

        start = 0
        if self.audio_time_len:
            frames = int(self.sr * self.audio_time_len)
            if T < frames:
                rvbt = np.pad(rvbt, ((0, 0), (0, frames - T)))
                dp = np.pad(dp, ((0, 0), (0, frames - T)))
            elif T > frames:
                start = int(rng.integers(0, T - frames))
                rvbt = rvbt[:, start:start + frames]
                dp = dp[:, start:start + frames]
        frames = rvbt.shape[-1]
        C = rvbt.shape[0]

        pool = self.noises
        if self.noise_room_match and rt60 is not None and len(self.noise_groups) == 4:
            pool = self.noise_groups[0 if rt60 < 0.35 else 1 if rt60 < 0.6 else 2]
        noise = np.zeros((C, frames), np.float64)
        for _ in range(self.num_noises):
            nwav, srn = read_audio(pool[rng.integers(0, len(pool))],
                                   always_2d=True)
            assert srn == self.sr, srn
            nwav = nwav.T  # [C_n, T_n]
            if nwav.shape[-1] < frames:
                nwav = np.tile(nwav, (1, -(-frames // nwav.shape[-1])))
            nstart = rng.integers(0, nwav.shape[-1] - frames + 1)
            nwav = nwav[:, nstart:nstart + frames] * rng.uniform(0.1, 10)
            shift = int(rng.integers(0, nwav.shape[0]))
            nwav = np.roll(nwav, -shift, axis=0)
            noise += nwav[:C] if nwav.shape[0] >= C else np.tile(nwav, (C, 1))[:C]

        snr_this = float(rng.uniform(*self.snr))
        iPn = 1.0 / np.mean(noise[0] ** 2)
        Px = np.mean(rvbt[0] ** 2)
        noise *= np.sqrt(10 ** (-snr_this / 10) * iPn * Px)
        noisy = rvbt + noise

        paras = {
            "index": index, "seed": seed, "sample_rate": self.sr,
            "dataset": f"Reverb_{self.dataset}", "snr": snr_this,
            "audio_time_len": self.audio_time_len, "start": start,
            "rir": (str(rir_path), spk_index), "num_spk": 1,
        }
        return (noisy.astype(np.float32), dp[None].astype(np.float32), paras)


class ReverbEtDataset:
    """Real/sim REVERB evaluation sets: reads the released 8-ch wavs
    (near/far rooms); targets unavailable -> (mix, None, paras)."""

    def __init__(self, reverb_dir: str, dataset: str = "Et_real",
                 sample_rate: int = 16000):
        root = Path(reverb_dir).expanduser()
        sub = {
            "Et_real": "MC_WSJ_AV_Eval",
            "Dt_real": "MC_WSJ_AV_Dev",
            "Et_simu": "REVERB_WSJCAM0/data/far_test",
            "Dt_simu": "REVERB_WSJCAM0/data/near_test",
        }[dataset]
        self.uttrs = sorted((root / sub).rglob("*.wav"))
        assert self.uttrs, root / sub
        self.dataset = dataset
        self.sr = sample_rate

    def __len__(self) -> int:
        return len(self.uttrs)

    def __getitem__(self, index_seed):
        index, _ = index_seed if isinstance(index_seed, tuple) else (index_seed, 0)
        mix, sr = read_audio(str(self.uttrs[index]), always_2d=True)
        paras = {
            "index": index, "sample_rate": sr,
            "dataset": f"Reverb_{self.dataset}",
            "wavname": self.uttrs[index].name,
            "saveto": [self.uttrs[index].name],
        }
        return mix.T.astype(np.float32), None, paras


class ReverbSimDtEtMCDataset:
    """Synthesized SimDt/SimEt with MULTICHANNEL direct-path references
    (the reference's reverb.py:365-527): WSJCAM0 dev/eval sources convolved with
    the released measured RIRs (*AnglA.wav for dt, *AnglB.wav for et, far +
    near, repeated to cover the source list) + SimRoom noise at a fixed SNR.
    Unlike ReverbEtDataset (the released noisy wavs, no reference), this set
    has targets, so metrics can be computed."""

    def __init__(self, wsjcam0_dir: str, reverb_dir: str, dataset: str,
                 snr: Tuple[float, float] = (20, 20), sample_rate: int = 16000,
                 source_lists: Optional[List[str]] = None):
        assert dataset in ("SimDtMC", "SimEtMC"), dataset
        self.dataset = dataset
        self.snr = tuple(snr)
        self.sr = sample_rate
        root = Path(reverb_dir).expanduser()
        tools = root / "reverb_tools_for_Generate_SimData"
        wsjcam0 = Path(wsjcam0_dir).expanduser()

        if source_lists:
            rels: List[str] = []
            for lst in source_lists:
                with open(lst) as f:
                    rels += [l.strip() for l in f if l.strip()]
            self.sources = [str(wsjcam0 / "data") + r + ".wav" for r in rels]
        else:
            sub = "si_dt" if dataset == "SimDtMC" else "si_et"
            self.sources = sorted(str(p) for p in (wsjcam0 / "data").rglob("*.wav")
                                  if sub in str(p))
        assert self.sources, wsjcam0
        self.sources = self.sources * 2  # far + near conditions

        angl = "*AnglA.wav" if dataset == "SimDtMC" else "*AnglB.wav"
        rirs_near = sorted(str(p) for p in (tools / "RIR").glob("*near" + angl))
        rirs_far = sorted(str(p) for p in (tools / "RIR").glob("*far" + angl))
        assert rirs_near and rirs_far, tools / "RIR"
        n = len(self.sources) // 2
        rirs_near = (rirs_near * math.ceil(n / len(rirs_near)))[:n]
        rirs_far = (rirs_far * math.ceil(n / len(rirs_far)))[:n]
        self.real_rirs = rirs_near + rirs_far
        self.noises = sorted(str(p)
                             for p in tools.rglob("NOISE/Noise_SimRoom[123]*.wav"))
        assert self.noises, tools

    def __len__(self) -> int:
        return len(self.sources)

    def __getitem__(self, index_seed):
        index, seed = (index_seed if isinstance(index_seed, tuple)
                       else (index_seed, index_seed))
        rng = np.random.default_rng(np.random.PCG64(seed))
        source, srs = read_audio(self.sources[index])
        assert srs == self.sr, (srs, self.sr)

        rir2d, sr_rir = read_audio(self.real_rirs[index], always_2d=True)
        assert sr_rir == self.sr
        rir = rir2d.T
        shift = int(rng.integers(0, rir.shape[0]))
        rir = np.roll(rir, -shift, axis=0)
        delay = int(np.argmax(rir[0]))
        rvbt = fftconvolve(source[None], rir, mode="full", axes=-1)[:, delay:]
        rir_dp = np.stack([rir[c] * rectangular_window(rir[c], self.sr, 0.002)
                           for c in range(rir.shape[0])])
        dp = fftconvolve(source[None], rir_dp, mode="full", axes=-1)[:, delay:]
        frames = rvbt.shape[-1]

        nwav, srn = read_audio(self.noises[rng.integers(0, len(self.noises))],
                               always_2d=True)
        assert srn == self.sr
        nwav = nwav.T
        if nwav.shape[-1] < frames:
            nwav = np.tile(nwav, (1, -(-frames // nwav.shape[-1])))
        nstart = rng.integers(0, nwav.shape[-1] - frames + 1)
        noise = nwav[:, nstart:nstart + frames].astype(np.float64)
        shift = int(rng.integers(0, noise.shape[0]))
        noise = np.roll(noise, -shift, axis=0)[: rvbt.shape[0]]

        snr_this = float(rng.uniform(*self.snr))
        iPn = 1.0 / np.mean(noise[0] ** 2)
        Px = np.mean(rvbt[0] ** 2)
        noise *= np.sqrt(10 ** (-snr_this / 10) * iPn * Px)
        noisy = rvbt + noise

        name = Path(self.sources[index]).stem
        paras = {
            "index": index, "seed": seed, "sample_rate": self.sr,
            "dataset": f"Reverb_{self.dataset}", "SNR": snr_this,
            "wavname": f"{name}_{index}.wav",
            "saveto": [f"{name}_{index}_ch1.wav"],
            "rir": (self.real_rirs[index], 0), "num_spk": 1,
        }
        return noisy.astype(np.float32), dp[None].astype(np.float32), paras


@dataclass
class ReverbDataModule(DataModule):
    wsjcam0_dir: str = "~/datasets/wsjcam0"
    reverb_dir: str = "~/datasets/Reverb"
    rir_dir: str = "~/datasets/Reverb_rirs"
    target: str = "direct_path"
    snr: Tuple[float, float] = (5, 20)
    audio_time_len: Tuple[Optional[float], ...] = (4.0, 4.0, None, None)
    test_set: str = "Et_real"  # Et/Dt_real, Et/Dt_simu, SimDtMC, SimEtMC
    source_lists: Optional[Tuple[str, ...]] = None
    use_real_rir_prop: float = 0.0
    noise_room_match: bool = False

    def _make_dataset(self, stage_idx: int):
        if stage_idx <= 1:
            return ReverbTrainValDataset(
                wsjcam0_dir=self.wsjcam0_dir, reverb_dir=self.reverb_dir,
                dataset=("train_with_simulated_rir", "val_with_simulated_rir")[stage_idx],
                rir_dir=self.rir_dir, snr=self.snr,
                audio_time_len=self.audio_time_len[stage_idx], target=self.target,
                source_lists=list(self.source_lists) if self.source_lists else None,
                use_real_rir_prop=self.use_real_rir_prop,
                noise_room_match=self.noise_room_match)
        if self.test_set in ("SimDtMC", "SimEtMC"):
            return ReverbSimDtEtMCDataset(
                wsjcam0_dir=self.wsjcam0_dir, reverb_dir=self.reverb_dir,
                dataset=self.test_set,
                source_lists=list(self.source_lists) if self.source_lists else None)
        return ReverbEtDataset(reverb_dir=self.reverb_dir, dataset=self.test_set)
