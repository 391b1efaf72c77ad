"""The port's copy of ``nbss_tpu/data/mixing.py`` (numpy only).

Overlap/spatialization algebra for on-the-fly mixture synthesis.

Behavior-equivalent rebuild of the reference's data_loaders/utils/mix.py
(overlap types, length algebra, RIR convolution with direct-path alignment,
trajectory convolution with cross-fade windows, SIR/SNR scaling). All host
numpy: this feeds the input pipeline, not the device compute path.

Overlap types (mix.py:7-22): 'mid' (short inside long), 'headtail' (tail of
A over head of B), 'start'/'end' (short at the start/end), 'full'
(fully overlapped); 'hms' / 'fhms' sample among them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy.signal import fftconvolve

OVLP_TYPES = ("mid", "headtail", "startend", "full", "hms", "fhms")


def sample_overlap_type(ovlp: str, num_spk: int, rng: np.random.Generator) -> str:
    """Resolve an overlap spec to a concrete type (mix.py:34-58)."""
    assert ovlp in OVLP_TYPES, ovlp
    assert num_spk in (1, 2), num_spk
    if num_spk == 1:
        ovlp = "full"
    elif ovlp == "fhms":
        ovlp = ("full", "headtail", "mid", "startend")[rng.integers(0, 4)]
    elif ovlp == "hms":
        ovlp = ("headtail", "mid", "startend")[rng.integers(0, 3)]
    if ovlp == "startend":
        ovlp = ("start", "end")[rng.integers(0, 2)]
    return ovlp


def sample_overlap_ratio_and_lengths(
    ovlp: str,
    ratio_range: Tuple[float, float],
    target_len: Optional[int],
    lens: List[int],
    rng: np.random.Generator,
) -> Tuple[float, List[int], int]:
    """Sample an overlap ratio and compute per-source lengths + mixture length
    (mix.py:61-104)."""
    lo, hi = ratio_range
    assert 0 <= lo <= hi <= 1, ratio_range
    lens = list(lens)
    if target_len is None:
        mix_frames = max(lens)
        if ovlp == "full":
            ratio = 1.0
        elif ovlp == "headtail":
            high = min(lens) / max(lens)
            ratio = high if lo > high else float(rng.uniform(lo, high))
            mix_frames = round((min(lens) + max(lens)) / (1 + ratio))
        else:  # mid / start / end
            ratio = min(lens) / max(lens)
    else:
        mix_frames = target_len
        ratio = float(rng.uniform(lo, hi))
        if ovlp == "full":
            lens = [mix_frames] * len(lens)
            ratio = 1.0
        elif ovlp == "headtail":
            lens = [int(mix_frames * (0.5 + ratio / 2))] * len(lens)
        else:
            assert ovlp in ("mid", "start", "end"), ovlp
            imax = lens.index(max(lens))
            imin = lens.index(min(lens))
            if imax == imin:
                imax = 1 - imax
            lens[imax] = mix_frames
            lens[imin] = int(mix_frames * ratio)
    return ratio, lens, mix_frames


def repeat_crop(wavs: Sequence[np.ndarray], lens: Sequence[int],
                rng: np.random.Generator) -> List[np.ndarray]:
    """Tile short signals then randomly crop to the needed length (mix.py:107-119)."""
    out = []
    for wav, L in zip(wavs, lens):
        if len(wav) < L:
            wav = np.tile(wav, -(-L // len(wav)))
        if len(wav) > L:
            start = rng.integers(0, len(wav) - L + 1)
            wav = wav[start:start + L]
        out.append(wav)
    return out


def spatialize(
    wav: np.ndarray,
    rir: np.ndarray,
    rir_target: Optional[np.ndarray] = None,
    ref_channel: int = 0,
    align: bool = True,
    align_by_target: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convolve a dry source with mixture/target RIRs and align by the
    direct-path peak of the reference channel (mix.py:122-148;
    align_by_target=True gives the convolve_v2 variant).

    Returns (reverberant [C, T], target [C, T])."""
    assert wav.ndim == 1 and rir.ndim == 2, (wav.shape, rir.shape)
    rvbt = fftconvolve(wav[None, :], rir, mode="full", axes=-1)
    if rir_target is None or rir_target is rir:
        target = rvbt
    else:
        target = fftconvolve(wav[None, :], rir_target, mode="full", axes=-1)
    if align:
        ref_rir = (rir_target if align_by_target else rir)[ref_channel]
        delay = int(np.argmax(ref_rir))
        rvbt = rvbt[:, delay:delay + wav.shape[-1]]
        target = target[:, delay:delay + wav.shape[-1]]
    return rvbt.astype(np.float32), target.astype(np.float32)


def convolve_trajectory(
    wav: np.ndarray,
    traj_rirs: np.ndarray,
    traj_rirs_tar: np.ndarray,
    samples_per_rir: Union[int, np.ndarray],
    ref_channel: int = 0,
    align: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Piecewise convolution with per-segment RIRs (mix.py:151-194). Plain
    segment stitching — may click; prefer `convolve_trajectory_windowed`."""
    assert wav.ndim == 1
    T = wav.shape[0]
    if isinstance(samples_per_rir, np.ndarray):
        seg_lens = samples_per_rir.tolist()
        assert sum(seg_lens) == T
    else:
        n = T // samples_per_rir
        seg_lens = [samples_per_rir] * n + ([T % samples_per_rir] if T % samples_per_rir else [])
    num_rirs, C, Lr = traj_rirs.shape
    Lt = traj_rirs_tar.shape[-1]
    assert num_rirs == len(seg_lens), (num_rirs, len(seg_lens))

    rvbt = np.zeros((C, Lr + T - 1), np.float32)
    target = np.zeros((C, Lt + T - 1), np.float32)
    s = 0
    for i, n_s in enumerate(seg_lens):
        seg = wav[s:s + n_s][None]
        rvbt[:, s:s + n_s + Lr - 1] += fftconvolve(seg, traj_rirs[i], axes=-1)
        target[:, s:s + n_s + Lt - 1] += fftconvolve(seg, traj_rirs_tar[i], axes=-1)
        s += n_s
    if align:
        delay = int(np.argmax(traj_rirs_tar[0, ref_channel]))
        rvbt = rvbt[:, delay:delay + T]
        target = target[:, delay:delay + T]
    return rvbt, target


def _crossfade_window(samples_per_rir: int, wintype: str) -> np.ndarray:
    hop = samples_per_rir
    L = 2 * hop
    if wintype == "hann":
        return np.hanning(L)
    if wintype.startswith("trapezium"):
        n = int(wintype.replace("trapezium", ""))
        assert hop - n > 0, (hop, n)
        up = np.arange(0, n) / (n - 1)
        down = np.arange(n - 1, -1, -1) / (n - 1)
        zlen = (hop - n) // 2
        onelen = hop - n - zlen
        return np.concatenate([np.zeros(zlen), up, np.ones(2 * onelen), down, np.zeros(zlen)])
    assert wintype == "tri", wintype
    return np.concatenate([np.arange(0, hop), np.arange(hop - 1, -1, -1)]) / (hop - 1)


def convolve_trajectory_windowed(
    wav: np.ndarray,
    traj_rirs: np.ndarray,
    samples_per_rir: int,
    wintype: str = "trapezium20",
) -> np.ndarray:
    """Cross-faded trajectory convolution (mix.py:197-244): 50%-overlapped
    windows of 2*samples_per_rir select each RIR's contribution, removing the
    segment-boundary clicks. Returns [C, rir_len + T - 1]."""
    assert wav.ndim == 1
    T = wav.shape[0]
    hop = samples_per_rir
    win = _crossfade_window(hop, wintype)
    num_rirs, C, Lr = traj_rirs.shape

    out = np.zeros((C, Lr + T - 1), np.float32)
    for i, start in enumerate(range(0, T + hop - 1, hop)):
        rir_i = traj_rirs[i]
        if start == 0:
            seg = wav[:hop] * win[hop:]
            out[:, :hop + Lr - 1] += fftconvolve(seg[None], rir_i, axes=-1)
        elif T >= start + hop:
            seg = wav[start - hop:start + hop] * win
            out[:, start - hop:start + hop + Lr - 1] += fftconvolve(seg[None], rir_i, axes=-1)
        else:
            seg = wav[start - hop:] * win[:T - start + hop]
            out[:, start - hop:] += fftconvolve(seg[None], rir_i, axes=-1)
    return out


def place_overlap_2spk(
    rvbts: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    ovlp: str,
    mix_frames: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Place 1-2 spatialized sources on the mixture timeline (mix.py:269-303).
    Returns (rvbt [spk, C, T], target [spk, C, T])."""
    num_spk, C = len(rvbts), rvbts[0].shape[0]
    rvbt = np.zeros((num_spk, C, mix_frames), np.float32)
    target = np.zeros((num_spk, C, mix_frames), np.float32)
    for i, (r, t) in enumerate(zip(rvbts, targets)):
        Ti = r.shape[-1]
        if ovlp == "full":
            shift = 0
        elif ovlp == "mid":
            shift = 0 if Ti == mix_frames else int(rng.integers(0, mix_frames - Ti + 1))
        elif ovlp in ("start", "end"):
            shift = 0 if Ti == mix_frames else {"start": 0, "end": mix_frames - Ti}[ovlp]
        else:
            assert ovlp == "headtail", ovlp
            shift = 0 if i == 0 else mix_frames - Ti
        rvbt[i, :, shift:shift + Ti] = r
        target[i, :, shift:shift + Ti] = t
    return rvbt, target


def place_overlap_3spk_2stream(
    rvbts: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    mix_frames: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack 3 sources into 2 output streams: src0 alone, src1 at the start +
    src2 at the end of stream 1 (mix.py:306-325)."""
    assert len(rvbts) == 3
    C = rvbts[0].shape[0]
    rvbt = np.zeros((2, C, mix_frames), np.float32)
    target = np.zeros((2, C, mix_frames), np.float32)
    rvbt[0] = rvbts[0]
    rvbt[1, :, :rvbts[1].shape[-1]] = rvbts[1]
    rvbt[1, :, -rvbts[2].shape[-1]:] = rvbts[2]
    target[0] = targets[0]
    target[1, :, :targets[1].shape[-1]] = targets[1]
    target[1, :, -targets[2].shape[-1]:] = targets[2]
    return rvbt, target


def energy_ratio_coeff(wav1: np.ndarray, wav2: np.ndarray, target_dB: float) -> Optional[float]:
    """Coefficient c so that 10*log10(E[wav1^2] / E[(c*wav2)^2]) = target_dB
    (mix.py:328-346). None when either signal is silent / non-finite."""
    ae1 = np.sum(wav1**2) / wav1.size
    ae2 = np.sum(wav2**2) / wav2.size
    if ae1 == 0 or ae2 == 0 or not np.isfinite(ae1) or not np.isfinite(ae2):
        return None
    return float(np.sqrt(ae1 / ae2 * 10 ** (-target_dB / 10)))
