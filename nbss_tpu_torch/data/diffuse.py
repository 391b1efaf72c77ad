"""The port's copy of ``nbss_tpu/data/diffuse.py`` (numpy only).

Diffuse (spatially-coherent) noise generation — Habets ANF method.

Rebuild of the reference's data_loaders/utils/diffuse_noise.py:19-93:
per-frequency mixing matrices realizing a desired spatial coherence
(spherical sinc / cylindrical Bessel), applied to independent noise channels
in the STFT domain. Host-side numpy/scipy; the SMS-WSJ-Plus pipeline caches
the mixing matrices per array geometry.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.signal import istft, stft
from scipy.special import jv


def spatial_coherence_mixing_matrices(
    pos_mics: np.ndarray,
    fs: int,
    noise_field: str = "spherical",
    c: float = 343.0,
    nfft: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (DSC [M, M, F], Cs [F, M, M]) — desired spatial coherence and
    its per-frequency eigen mixing matrices."""
    assert pos_mics.shape[1] == 3, pos_mics.shape
    M = pos_mics.shape[0]
    F = nfft // 2 + 1
    ww = 2 * math.pi * fs * np.arange(F) / nfft
    dist = np.linalg.norm(pos_mics[:, None, :] - pos_mics[None, :, :], axis=-1, keepdims=True)
    if noise_field == "spherical":
        DSC = np.sinc(ww * dist / (c * math.pi))
    elif noise_field == "cylindrical":
        DSC = jv(0, ww * dist / c)
    else:
        raise KeyError(noise_field)

    Cs = np.zeros((F, M, M), np.complex128)
    for k in range(1, F):
        D, V = np.linalg.eig(DSC[:, :, k])
        Cs[k] = V.T * np.sqrt(D.astype(np.complex128))[:, None]
    return DSC, Cs


def gen_diffuse_noise(
    noise: np.ndarray,
    L: int,
    Cs: np.ndarray,
    nfft: int = 256,
    rng: np.random.Generator = None,
) -> np.ndarray:
    """Slice M*L mono noise samples, mix in the STFT domain by conj(Cs).

    Returns [M, L] float32."""
    rng = rng or np.random.default_rng()
    M = Cs.shape[-1]
    assert noise.shape[-1] >= M * L, (noise.shape, M, L)
    start = rng.integers(0, noise.shape[-1] - M * L + 1)
    x = noise[start:start + M * L].reshape(M, L)
    x = x - np.mean(x, axis=-1, keepdims=True)
    _, _, N = stft(x, window="hann", nperseg=nfft, noverlap=int(0.75 * nfft), nfft=nfft)
    X = np.einsum("fmn,mft->nft", np.conj(Cs), N)
    _, y = istft(X, window="hann", nperseg=nfft, noverlap=int(0.75 * nfft), nfft=nfft)
    return y[:, :L].astype(np.float32)
