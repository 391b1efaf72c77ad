"""The port's copy of ``nbss_tpu/eval/stoi.py`` (numpy only).

STOI / extended STOI (eSTOI) intelligibility metrics, pure numpy.

Implements C. Taal et al., "An Algorithm for Intelligibility Prediction of
Time-Frequency Weighted Noisy Speech" (2011) and J. Jensen, C. Taal,
"An Algorithm for Predicting the Intelligibility of Speech Masked by
Modulated Noise Maskers" (2016). Replaces the external pystoi dependency the
reference uses via torchmetrics (models/utils/metrics.py:17-23).

Host-side, eval-only.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS = 10000          # internal sample rate
N_FRAME = 256       # 25.6 ms frames
NFFT = 512
NUM_BANDS = 15      # third-octave bands
MIN_FREQ = 150.0
N = 30              # analysis segment length in frames (384 ms)
BETA = -15.0        # lower SDR bound (dB)
DYN_RANGE = 40.0    # VAD dynamic range (dB)


def _thirdoct(fs: int = FS, nfft: int = NFFT, num_bands: int = NUM_BANDS,
              min_freq: float = MIN_FREQ) -> np.ndarray:
    """[num_bands, nfft//2+1] third-octave band matrix."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_i = np.argmin(np.square(f - lo[i]))
        hi_i = np.argmin(np.square(f - hi[i]))
        obm[i, lo_i:hi_i] = 1.0
    return obm


_OBM = None


def _stft_frames(x: np.ndarray) -> np.ndarray:
    hop = N_FRAME // 2
    n_frames = (len(x) - N_FRAME) // hop + 1
    if n_frames <= 0:
        return np.zeros((0, NFFT // 2 + 1))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(N_FRAME)[None, :]
    frames = x[idx] * np.hanning(N_FRAME + 2)[1:-1]
    return np.fft.rfft(frames, NFFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    n_frames = (len(x) - N_FRAME) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(N_FRAME)[None, :]
    xf = x[idx] * w
    yf = y[idx] * w
    energy = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-20)
    mask = energy > (np.max(energy) - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    out_len = (len(xf) - 1) * hop + N_FRAME if len(xf) else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(len(xf)):
        xs[i * hop:i * hop + N_FRAME] += xf[i]
        ys[i * hop:i * hop + N_FRAME] += yf[i]
    return xs, ys


def _band_env(x: np.ndarray) -> np.ndarray:
    """[T_frames, F] spectra -> [bands, T_frames] third-octave envelopes."""
    global _OBM
    if _OBM is None:
        _OBM = _thirdoct()
    X = np.abs(_stft_frames(x)) ** 2  # [T, F]
    return np.sqrt(_OBM @ X.T)  # [bands, T]


def stoi(clean: np.ndarray, processed: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """STOI / eSTOI in [~0, 1]. clean/processed: 1-D signals at ``fs``."""
    clean = np.asarray(clean, np.float64)
    processed = np.asarray(processed, np.float64)
    assert clean.shape == processed.shape, (clean.shape, processed.shape)
    if fs != FS:
        g = np.gcd(int(fs), FS)
        clean = resample_poly(clean, FS // g, fs // g)
        processed = resample_poly(processed, FS // g, fs // g)
    clean, processed = _remove_silent_frames(clean, processed)
    if len(clean) < N_FRAME * 2:
        return float("nan")

    X = _band_env(clean)  # [J, M]
    Y = _band_env(processed)
    M = X.shape[1]
    if M < N:
        return float("nan")

    if extended:
        vals = []
        for m in range(N, M + 1):
            Xs = X[:, m - N:m]
            Ys = Y[:, m - N:m]
            # row (temporal) normalization
            Xn = (Xs - Xs.mean(axis=1, keepdims=True))
            Xn = Xn / (np.linalg.norm(Xn, axis=1, keepdims=True) + 1e-20)
            Yn = (Ys - Ys.mean(axis=1, keepdims=True))
            Yn = Yn / (np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-20)
            # column (spectral) normalization
            Xn = Xn - Xn.mean(axis=0, keepdims=True)
            Xn = Xn / (np.linalg.norm(Xn, axis=0, keepdims=True) + 1e-20)
            Yn = Yn - Yn.mean(axis=0, keepdims=True)
            Yn = Yn / (np.linalg.norm(Yn, axis=0, keepdims=True) + 1e-20)
            vals.append(np.sum(Xn * Yn) / N)
        return float(np.mean(vals))

    c = 10 ** (-BETA / 20.0)
    vals = []
    for m in range(N, M + 1):
        Xs = X[:, m - N:m]  # [J, N]
        Ys = Y[:, m - N:m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-20)
        Yp = np.minimum(Ys * alpha, Xs * (1 + c))
        xn = Xs - Xs.mean(axis=1, keepdims=True)
        yn = Yp - Yp.mean(axis=1, keepdims=True)
        corr = np.sum(xn * yn, axis=1) / (
            np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-20)
        vals.append(np.mean(corr))
    return float(np.mean(vals))
