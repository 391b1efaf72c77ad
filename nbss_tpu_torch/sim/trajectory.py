"""The port's copy of ``nbss_tpu/sim/trajectory.py`` (numpy only).

Moving-source trajectories: '4points+sin' paths.

Behavioral rebuild of the reference's generate_rirs.py:389-479: sample one
waypoint in each quadrant of the room (outside a protective box around the
array), join consecutive waypoints with sinusoid-perturbed segments sampled
every ``desired_dist_pts`` meters; the ``equal_dist`` variant steps along
the curve so neighbouring points are (numerically) equidistant. Returns
None when the perturbed path leaves the room (caller resamples).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _segment(src_ini, src_end, osc_mag, desired, max_ratio, rng):
    """Sinusoid-perturbed straight segment with ~desired point spacing."""
    dist = float(np.linalg.norm(src_end - src_ini))
    nb = max(int(dist / desired), 1)
    for _ in range(50):
        A = rng.random(3) * osc_mag
        w = 2 * np.pi / nb * rng.random(3) * 2  # 0..2 oscillations per axis
        vec = ((src_end - src_ini) - A * np.sin(w * nb)) / nb
        n = np.arange(nb)[:, None]
        pts = src_ini + vec * n + A * np.sin(w * n)
        if len(pts) <= 1 or np.max(np.linalg.norm(np.diff(pts, axis=0), axis=-1)) \
                <= max_ratio * desired:
            return pts
    return pts  # best effort after retries


def _segment_eqdist(src_ini, src_end, osc_mag, desired, rng):
    """Equal-spacing variant: arc-length stepping along the perturbed curve
    (bisection instead of the reference's scipy.minimize inner loop)."""
    dist = float(np.linalg.norm(src_end - src_ini))
    unit = (src_end - src_ini) / dist
    A = rng.random(3) * osc_mag
    w = 2 * np.pi * rng.integers(1, 4, size=3)

    def point(x):
        return src_ini + unit * x + A * np.sin(w * (x / dist))

    pts = []
    x = 0.0
    while x < dist:
        p0 = point(x)
        pts.append(p0)
        lo, hi = 0.0, 3.0 * desired
        for _ in range(40):  # bisection on step length
            mid = (lo + hi) / 2
            if np.linalg.norm(point(x + mid) - p0) < desired:
                lo = mid
            else:
                hi = mid
        step = (lo + hi) / 2
        x += max(step, desired / 10)
    return np.asarray(pts)


def four_points_sin_trajectory(
    room_sz,
    rcv_pos: np.ndarray,
    min_src_array_dist: np.ndarray,
    min_src_boundary_dist: np.ndarray,
    src_z: float,
    desired_dist_pts: float = 0.1,
    equal_dist: bool = False,
    max_ratio: float = 3.0,
    rng: Optional[np.random.Generator] = None,
) -> Optional[np.ndarray]:
    """Returns trajectory points [N, 3] (or None if it exits the room)."""
    rng = rng or np.random.default_rng()
    room_sz = np.asarray(room_sz, np.float64)
    xr, yr, _ = room_sz
    xa, ya, _ = min_src_array_dist
    xb, yb, _ = min_src_boundary_dist
    center = rcv_pos.mean(axis=0)

    def sample_between(lo, hi):
        p = lo + rng.random(3) * (hi - lo)
        p[2] = src_z
        return p

    # quadrant waypoints (min corner -> max corner boxes)
    ld = sample_between(np.array([xb, yb, 0.0]), center + np.array([-xa, -ya, 0.0]))
    rd_lo = np.array([center[0] + xa, yb, 0.0])
    rd_hi = np.array([xr - xb, center[1] - ya, 0.0])
    rd = sample_between(np.minimum(rd_lo, rd_hi), np.maximum(rd_lo, rd_hi))
    rt = sample_between(center + np.array([xa, ya, 0.0]),
                        np.array([xr - xb, yr - yb, 0.0]))
    lt_lo = np.array([xb, center[1] + ya, 0.0])
    lt_hi = np.array([center[0] - xa, yr - yb, 0.0])
    lt = sample_between(np.minimum(lt_lo, lt_hi), np.maximum(lt_lo, lt_hi))

    osc_mag = np.array([xb, yb, 0.0])
    segs = []
    for a, b in ((ld, rd), (rd, rt), (rt, lt), (lt, ld)):
        if equal_dist:
            segs.append(_segment_eqdist(a, b, osc_mag, desired_dist_pts, rng))
        else:
            segs.append(_segment(a, b, osc_mag, desired_dist_pts, max_ratio, rng))
    pts = np.concatenate(segs, axis=0)
    if (pts >= 0).all() and (pts <= room_sz[None]).all():
        return pts
    return None
