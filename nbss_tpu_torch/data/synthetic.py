"""Synthetic multichannel mixture dataset (no external audio needed).

The port's own copy of ``nbss_tpu/data/synthetic.py`` (numpy and scipy only):
per (index, seed) it deterministically synthesizes speech-like sources
(band-limited modulated noise), spatializes them with random sparse
multi-tap room impulse responses per channel, mixes at a random SIR, and adds
white noise at a random SNR. For the same (index, seed) an item is
bit-identical to the JAX package's. ``SyntheticDataModule`` wraps it in the
stage loaders of ``data/loader.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
from scipy.signal import fftconvolve, lfilter

from nbss_tpu_torch.data.loader import DataModule


def _speechlike(rng: np.random.Generator, n: int, fs: int) -> np.ndarray:
    """Amplitude-modulated low-pass noise with pauses — crude speech proxy."""
    x = rng.standard_normal(n).astype(np.float32)
    a = 0.9  # one-pole low-pass for a speech-ish spectral tilt
    y = lfilter([1 - a], [1, -a], x).astype(np.float32)
    # syllabic-rate (≈4 Hz) envelope with silences
    t = np.arange(n) / fs
    env = 0.5 * (1 + np.sin(2 * np.pi * (3 + 2 * rng.random()) * t + rng.random() * 6.28))
    env = env.astype(np.float32) ** 1.5
    gate = (rng.random(max(1, n // (fs // 2)) + 1) > 0.2).astype(np.float32)
    gate[0] = 1.0  # never a fully-silent utterance
    gate = np.repeat(gate, fs // 2)[:n]
    return y * env * gate


def _sparse_rir(rng: np.random.Generator, n_ch: int, fs: int, n_taps: int = 12,
                rt60: float = 0.3) -> np.ndarray:
    """Random sparse RIR per channel: direct path + exponentially decaying taps."""
    L = int(rt60 * fs)
    rir = np.zeros((n_ch, L), np.float32)
    d0 = rng.integers(8, 40)
    for c in range(n_ch):
        d = d0 + rng.integers(0, 4)  # small inter-channel delay (direction cue)
        rir[c, d] = 1.0
        taps = rng.integers(d + 5, L, size=n_taps)
        amps = np.exp(-3.0 * np.log(10) * taps / (rt60 * fs)) * rng.standard_normal(n_taps)
        rir[c, taps] += 0.5 * amps.astype(np.float32)
    return rir


@dataclass
class SyntheticDataset:
    """dataset[(index, seed)] -> (x [C,T], ys [Spk,C,T], paras)."""

    num_items: int = 1000
    num_spk: int = 2
    num_channels: int = 6
    sample_rate: int = 8000
    audio_time_len: float = 4.0
    snr_range: Tuple[float, float] = (5.0, 20.0)
    sir_range: Tuple[float, float] = (-5.0, 5.0)

    def __len__(self) -> int:
        return self.num_items

    def __getitem__(self, item) -> Tuple[np.ndarray, np.ndarray, Dict]:
        index, seed = item if isinstance(item, tuple) else (item, item)
        rng = np.random.default_rng(np.random.PCG64(seed))
        fs = self.sample_rate
        T = int(self.audio_time_len * fs)

        srcs, echoes = [], []
        for s in range(self.num_spk):
            dry = _speechlike(rng, T, fs)
            rir = _sparse_rir(rng, self.num_channels, fs)
            wet = fftconvolve(dry[None, :], rir, axes=-1)[:, :T].astype(np.float32)
            srcs.append(wet)
        # SIR scaling of source 1..n relative to source 0
        scaled = [srcs[0]]
        p0 = np.mean(srcs[0] ** 2) + 1e-12
        for s in range(1, self.num_spk):
            sir = rng.uniform(*self.sir_range)
            ps = np.mean(srcs[s] ** 2) + 1e-12
            scaled.append(srcs[s] * np.sqrt(p0 / ps * 10 ** (-sir / 10)).astype(np.float32))
        ys = np.stack(scaled)  # [Spk, C, T]
        mix = ys.sum(axis=0)

        snr = rng.uniform(*self.snr_range)
        pm = np.mean(mix**2) + 1e-12
        noise = rng.standard_normal(mix.shape).astype(np.float32)
        noise *= np.sqrt(pm / np.mean(noise**2) * 10 ** (-snr / 10)).astype(np.float32)
        x = mix + noise

        # normalize the mixture peak to 0.9
        peak = np.abs(x).max() + 1e-9
        g = 0.9 / peak
        x, ys = x * g, ys * g

        paras = {"index": index, "seed": seed, "sample_rate": fs, "snr": float(snr)}
        return x.astype(np.float32), ys.astype(np.float32), paras


@dataclass
class SyntheticDataModule(DataModule):
    """Stage loaders over SyntheticDataset, for smoke runs and benchmarks
    without any corpus on disk."""

    num_items: int = 64
    num_spk: int = 2
    num_channels: int = 6
    sample_rate: int = 8000
    audio_time_len: float = 4.0

    def _make_dataset(self, stage_idx: int):
        return SyntheticDataset(
            num_items=self.num_items, num_spk=self.num_spk,
            num_channels=self.num_channels, sample_rate=self.sample_rate,
            audio_time_len=self.audio_time_len)
