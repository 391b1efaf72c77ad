"""WAV file IO through ``scipy.io.wavfile``.

The port's copy of ``nbss_tpu/utils/audio_io.py`` without its soundfile
branch: PCM and float WAV files, read as float32 in [-1, 1] of shape [T] or
[T, C], written as float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile as _wavfile


def read_audio(path: str, always_2d: bool = False) -> Tuple[np.ndarray, int]:
    sr, data = _wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if always_2d and data.ndim == 1:
        data = data[:, None]
    return data, sr


def write_audio(path: str, data: np.ndarray, sr: int) -> None:
    data = np.asarray(data)
    if data.ndim == 2 and data.shape[0] < data.shape[1]:
        data = data.T  # [C, T] -> [T, C]
    _wavfile.write(path, sr, data.astype(np.float32))
