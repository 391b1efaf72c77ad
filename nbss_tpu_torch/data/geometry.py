"""The port's copy of ``nbss_tpu/data/geometry.py`` (numpy only).

Microphone array geometries (meters, array center at the origin).

Rebuild of the reference's data_loaders/utils/array_geometry.py:14-64.
"""

from __future__ import annotations

import numpy as np


def circular_array(radius: float, mic_num: int) -> np.ndarray:
    """Evenly spaced mics on a horizontal circle; mic 0 on the +x axis."""
    angles = np.arange(mic_num) * 2 * np.pi / mic_num
    pos = np.zeros((mic_num, 3))
    pos[:, 0] = np.cos(angles)
    pos[:, 1] = np.sin(angles)
    return pos * radius


def linear_array(spacing: float, mic_num: int) -> np.ndarray:
    """Uniform line on the x axis, centered at the origin."""
    xs = np.arange(mic_num, dtype=np.float64) * spacing
    xs -= xs.mean()
    pos = np.zeros((mic_num, 3))
    pos[:, 0] = xs
    return pos


def chime3_array() -> np.ndarray:
    """CHiME-3 tablet 2x3 rectangle (0.1 m x 0.19 m)."""
    pos = np.array([
        [-0.1, 0.095, 0.0], [0.0, 0.095, 0.0], [0.1, 0.095, 0.0],
        [-0.1, -0.095, 0.0], [0.0, -0.095, 0.0], [0.1, -0.095, 0.0],
    ])
    return pos


def libricss_array() -> np.ndarray:
    """LibriCSS: one center mic + 6-mic circle of radius 4.25 cm."""
    pos = np.zeros((7, 3))
    pos[1:] = circular_array(radius=0.0425, mic_num=6)
    return pos


def audiowu_high_array() -> np.ndarray:
    """Westlake audio-lab high-resolution 32-mic array: three concentric
    8-mic rings (3/6/9 cm), an x-axis arm, and a vertical z arm
    (generate_rirs.py:280-296)."""
    R = 0.03
    pos = np.zeros((32, 3))
    pos[:8] = circular_array(radius=R, mic_num=8)
    pos[8:16] = circular_array(radius=R * 2, mic_num=8)
    pos[16:24] = circular_array(radius=R * 3, mic_num=8)
    pos[25] = [R * 4, 0, 0]
    pos[26] = [R * 5, 0, 0]
    pos[27] = [-R * 4, 0, 0]
    L = 0.045
    pos[28] = [0, 0, L]
    pos[29] = [0, 0, L * 2]
    pos[30] = [0, 0, -L]
    pos[31] = [0, 0, -L * 2]
    return pos


def audiowu_low_array() -> np.ndarray:
    """Westlake audio-lab 16-mic planar array: 8-mic ring (3 cm) plus x/y
    arms (generate_rirs.py:299-313)."""
    R = L = 0.03
    pos = np.zeros((16, 3))
    pos[:8] = circular_array(radius=R, mic_num=8)
    pos[9] = [L * 2, 0, 0]
    pos[10] = [L * 3, 0, 0]
    pos[11] = [L * 4, 0, 0]
    pos[12] = [-L * 2, 0, 0]
    pos[13] = [-L * 3, 0, 0]
    pos[14] = [0, L * 2, 0]
    pos[15] = [0, -L * 2, 0]
    return pos
