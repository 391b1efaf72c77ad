"""The port's copy of ``nbss_tpu/sim/config.py`` (numpy only).

Room / array / source configuration sampling for RIR simulation.

Behavioral rebuild of the config stage of the reference's generate_rirs.py:
482-762: sample room size + RT60 (resampled until Sabine-feasible), wall
absorption weights with T60 error < 0.05, array geometry with random
rotation and optional mic jitter, static speaker positions or moving
'4points+sin' trajectories, and point-noise positions. Pure host numpy;
fully determined by (seed + index).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from nbss_tpu_torch.data.geometry import (
    audiowu_high_array,
    audiowu_low_array,
    chime3_array,
    circular_array,
    libricss_array,
    linear_array,
)
from nbss_tpu_torch.sim.ism import beta_from_t60
from nbss_tpu_torch.sim.trajectory import four_points_sin_trajectory


def is_valid_t60_for_room(room_sz, T60: float, tol: float = 0.05) -> bool:
    """Sabine feasibility: the room can achieve T60 within ``tol`` seconds."""
    _, err = beta_from_t60(room_sz, T60)
    return err <= tol


def rotate_positions(pos: np.ndarray, x_angle=None, y_angle=None, z_angle=None) -> np.ndarray:
    """Rotate origin-centered positions about the x/y/z axes (radians).
    Pairwise distances are preserved (asserted, generate_rirs.py:378-380)."""
    pos = np.asarray(pos, np.float64)
    for ang, dims in zip((x_angle, y_angle, z_angle), ((1, 2), (2, 0), (0, 1))):
        if ang is None:
            continue
        new = pos.copy()
        new[:, dims[0]] = pos[:, dims[0]] * np.cos(ang) - pos[:, dims[1]] * np.sin(ang)
        new[:, dims[1]] = pos[:, dims[0]] * np.sin(ang) + pos[:, dims[1]] * np.cos(ang)
        d_old = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        d_new = np.linalg.norm(new[:, None] - new[None], axis=-1)
        assert np.allclose(d_old, d_new, atol=1e-9), "rotation broke distances"
        pos = new
    return pos


def _make_geometry(name: str, radius: Optional[float], mic_num: int) -> np.ndarray:
    if name == "circular":
        return circular_array(radius, mic_num)
    if name == "circular+cm":  # circular plus center mic
        pos = np.zeros((mic_num, 3))
        pos[1:] = circular_array(radius, mic_num - 1)
        return pos
    if name == "linear":
        return linear_array(radius, mic_num)
    if name == "chime3":
        return chime3_array()
    if name == "libricss":
        return libricss_array()
    if name == "audiowu_high":
        return audiowu_high_array()
    if name == "audiowu_low":
        return audiowu_low_array()
    raise KeyError(name)


@dataclass
class RirConfigSampler:
    """Samples one room configuration per (seed + index)
    (generate_rir_cfg_list's per-index branch)."""

    spk_num: int = 1
    noise_num: int = 0
    room_size_lims: Tuple = ((3, 8), (3, 8), (3, 4))
    mic_zlim: Tuple[float, float] = (1.0, 1.5)
    spk_zlim: Tuple[float, float] = (1.0, 1.8)
    RT60_lim: Tuple[float, float] = (0.1, 0.6)
    arr_geometry: str = "circular+cm"
    arr_radius: Optional[Tuple[float, float]] = (0.1, 0.1)
    arr_rotate_lims: Union[str, Tuple] = "auto"
    arr_room_dist: Union[str, Tuple[float, float]] = "auto"
    wall_abs_weights_lims: Union[str, None, Sequence] = "auto"
    mic_num: int = 6
    sel_mic_num: Optional[int] = None
    mic_pos_var: float = 0.0
    spk_arr_dist: Union[str, Tuple[float, float]] = "auto"
    trajectory: Optional[Tuple[str, float]] = None
    fs: int = 8000
    seed: int = 0

    def __post_init__(self):
        g = self.arr_geometry
        if self.arr_rotate_lims == "auto":
            if g == "chime3":
                self.arr_rotate_lims = ((0, 2 * np.pi),) * 3
            else:
                self.arr_rotate_lims = (None, None, (0, 2 * np.pi))
        if self.spk_arr_dist == "auto":
            self.spk_arr_dist = {"chime3": (0.3, 0.5), "libricss": (0.5, 4.5)}.get(g, "random")
        if self.arr_room_dist == "auto":
            self.arr_room_dist = {"chime3": (2.0, 0.5), "libricss": (1.0, 0.5)}.get(g, (0.5, 0.5))
        if g == "libricss":
            self.arr_radius, self.mic_num = (0.0425, 0.0425), 7
        if g == "chime3":
            self.arr_radius, self.mic_num = None, 6
        if g == "audiowu_high":
            self.arr_radius, self.mic_num = None, 32
        if g == "audiowu_low":
            self.arr_radius, self.mic_num = None, 16
        if self.trajectory is not None:
            # moving sources keep at least this distance from the array
            if self.arr_radius is None:
                self.spk_arr_dist = (0.2, 0.2)
            elif self.spk_arr_dist == "random":
                self.spk_arr_dist = (max(self.arr_radius),) * 2
            else:
                self.spk_arr_dist = (min(self.spk_arr_dist),) * 2
        if self.wall_abs_weights_lims == "auto":
            self.wall_abs_weights_lims = ((0.5, 1.0),) * 6
        elif self.wall_abs_weights_lims is None:
            self.wall_abs_weights_lims = ((1.0, 1.0),) * 6
        if self.sel_mic_num is None:
            self.sel_mic_num = self.mic_num

    def sample(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed + index)
        u = rng.uniform
        xlim, ylim, zlim = self.room_size_lims

        # room + RT60 (resample until Sabine-feasible)
        RT60 = u(*self.RT60_lim)
        room_sz = [u(*xlim), u(*ylim), u(*zlim)]
        while not is_valid_t60_for_room(room_sz, RT60):
            room_sz = [u(*xlim), u(*ylim), u(*zlim)]
            RT60 = u(*self.RT60_lim)
        # wall absorption weights with T60 error < 0.05
        while True:
            abs_weights = [u(*lim) for lim in self.wall_abs_weights_lims]
            beta, err = beta_from_t60(room_sz, RT60, abs_weights)
            if err <= 0.05:
                break

        # array placement
        max_c, min_b = self.arr_room_dist
        while True:
            mic_center = np.array([
                u(room_sz[0] / 2 - max_c, room_sz[0] / 2 + max_c),
                u(room_sz[1] / 2 - max_c, room_sz[1] / 2 + max_c),
                u(*self.mic_zlim),
            ])
            if (mic_center[:2] >= min_b).all() and \
               (mic_center[:2] <= np.array(room_sz[:2]) - min_b).all():
                break

        radius = u(*self.arr_radius) if self.arr_radius is not None else None
        pos_rcv = _make_geometry(self.arr_geometry, radius, self.mic_num)
        if self.sel_mic_num < self.mic_num:
            sel = rng.choice(self.mic_num, size=self.sel_mic_num, replace=False)
            pos_rcv = pos_rcv[sel]
        else:
            sel = np.arange(self.mic_num)
        angles = [None if lim is None else u(*lim) for lim in self.arr_rotate_lims]
        pos_rcv = rotate_positions(pos_rcv, *angles) + mic_center[None]
        if self.mic_pos_var > 0:
            pos_rcv = pos_rcv + u(-self.mic_pos_var, self.mic_pos_var, pos_rcv.shape)

        # sources: static points or moving trajectories
        if self.trajectory is None:
            pos_src = []
            for _ in range(self.spk_num):
                while True:
                    p = np.array([u(0.5, room_sz[0] - 0.5), u(0.5, room_sz[1] - 0.5),
                                  u(*self.spk_zlim)])
                    if self.spk_arr_dist == "random":
                        break
                    dist = np.linalg.norm(p - mic_center)
                    if self.spk_arr_dist[0] <= dist <= self.spk_arr_dist[1]:
                        break
                pos_src.append(p)
            pos_src = np.asarray(pos_src, np.float32)
        else:
            kind, spacing = self.trajectory
            assert kind in ("4points+sin", "4points+sin+eqdist"), kind
            min_dist = np.array([self.spk_arr_dist[0], self.spk_arr_dist[1], 0.0])
            pos_src = []
            for _ in range(self.spk_num):
                while True:
                    traj = four_points_sin_trajectory(
                        room_sz, pos_rcv, min_src_array_dist=min_dist,
                        min_src_boundary_dist=np.array([0.5, 0.5, 0.0]),
                        src_z=u(*self.spk_zlim), desired_dist_pts=spacing,
                        equal_dist=kind.endswith("eqdist"), rng=rng)
                    if traj is not None:
                        break
                pos_src.append(traj.astype(np.float32))

        pos_noise = np.asarray(
            [[u(0.1, sz - 0.1) for sz in room_sz] for _ in range(self.noise_num)],
            np.float32).reshape(self.noise_num, 3)

        return {
            "index": index,
            "RT60": float(RT60),
            "arr_geometry": f"{self.arr_geometry}({self.mic_num},{radius})",
            "selected_channels": sel.tolist(),
            "room_sz": [float(v) for v in room_sz],
            "pos_src": pos_src,
            "pos_rcv": pos_rcv.astype(np.float32),
            "pos_noise": pos_noise,
            "beta": beta,
        }
