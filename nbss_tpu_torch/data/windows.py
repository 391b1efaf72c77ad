"""The port's copy of ``nbss_tpu/data/windows.py`` (numpy only).

Target-synthesis windows.

Rebuild of the reference's data_loaders/utils/window.py: the reverberation-
time-shortening (RTS) window exponentially attenuates the RIR after the
direct-path peak so the shortened RIR has a target T60; the rectangular
window keeps only +-time around the peak (direct-path target).
"""

from __future__ import annotations

import numpy as np


def rts_window(
    rir: np.ndarray,
    original_T60: float,
    target_T60: float,
    sr: int = 8000,
    time_after_max: float = 0.002,
    time_before_max: float = None,
) -> np.ndarray:
    """Per-channel RTS window, shape == rir.shape (window.py:4-36)."""
    if original_T60 <= target_T60:
        return np.ones_like(rir)
    shape = rir.shape
    flat = rir.reshape(-1, shape[-1])
    L = flat.shape[-1]
    q = 3 / (target_T60 * sr) - 3 / (original_T60 * sr)
    decay = 10.0 ** (-q * np.arange(L))
    win = np.empty_like(flat)
    idx_max = np.argmax(np.abs(flat), axis=-1)
    for i, im in enumerate(idx_max):
        n1 = im + int(time_after_max * sr)
        win[i, :n1] = 1.0
        win[i, n1:] = decay[: L - n1]
        if time_before_max:
            n0 = int(im - time_before_max * sr)
            if n0 > 0:
                win[i, :n0] = 0.0
    return win.reshape(shape)


def rectangular_window(rir: np.ndarray, sr: int = 8000,
                       time_before_after_max: float = 0.002) -> np.ndarray:
    """Keep only +-time_before_after_max around the peak (window.py:39-45)."""
    assert rir.ndim == 1, rir.ndim
    idx = int(np.argmax(np.abs(rir)))
    n = int(sr * time_before_after_max)
    win = np.zeros_like(rir)
    win[max(0, idx - n): idx + n + 1] = 1.0
    return win
