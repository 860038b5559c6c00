"""Host-side world constants and generators of the synthetic route bank.

numpy copies of what the device env's bank builder reads from the JAX
package's host modules (route_fig, sim_env, traffic_lights, scenarios), so
that `make_route_bank` draws the same numbers from the same seed.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

# route-figure canvas (env_wrapper.py _draw_route): 144 wide, 256 high
SIZE_X = 144
SIZE_Y = 256
PIXELS_PER_METER = 3.66
LINE_WIDTH = 15.0

# OutsideRouteLanesTest envelope (atomic_criteria.py:1045)
LANE_WIDTH = 3.5
ALLOWED_OUT_DISTANCE = 1.3
OUT_LEFT = 1.5 * LANE_WIDTH + ALLOWED_OUT_DISTANCE     # 6.55 m
OUT_RIGHT = 0.5 * LANE_WIDTH + ALLOWED_OUT_DISTANCE    # 3.05 m

# forced traffic-light cycle (atomic_criteria.py:1869-1871)
GREEN_TIME = 5.0
RED_TIME = 0.5
YELLOW_TIME = 3.0
CYCLE = GREEN_TIME + YELLOW_TIME + RED_TIME

# renderer weather presets: (sky RGB, ground brightness, noise std)
WEATHER_PRESETS = {
    "ClearNoon": ((135, 180, 235), 1.00, 0.0),
    "CloudyNoon": ((160, 165, 175), 0.90, 0.0),
    "WetNoon": ((120, 140, 165), 0.85, 2.0),
    "WetCloudyNoon": ((140, 145, 155), 0.80, 2.0),
    "MidRainyNoon": ((110, 120, 135), 0.70, 5.0),
    "HardRainNoon": ((90, 100, 115), 0.60, 8.0),
    "SoftRainNoon": ((125, 135, 150), 0.80, 3.0),
    "ClearSunset": ((230, 150, 90), 0.85, 0.0),
    "CloudySunset": ((190, 140, 110), 0.75, 0.0),
    "WetSunset": ((180, 130, 100), 0.70, 2.0),
    "WetCloudySunset": ((165, 125, 105), 0.65, 2.0),
    "MidRainSunset": ((140, 110, 95), 0.60, 5.0),
    "HardRainSunset": ((120, 95, 85), 0.50, 8.0),
    "SoftRainSunset": ((170, 125, 100), 0.70, 3.0),
    "ClearNight": ((25, 30, 50), 0.35, 1.0),
    "HardRainNight": ((15, 20, 35), 0.25, 8.0),
}

PROP_BUILDING = 4.0
PROP_POLE = 5.0
PROP_VEGETATION = 6.0


def synthetic_route(rng: np.random.RandomState, n_legs: int = 3,
                    leg_len: Tuple[float, float] = (40.0, 90.0)
                    ) -> np.ndarray:
    """Axis-aligned multi-leg route keypoints with 90-degree corners."""
    pos = np.zeros(2)
    heading = np.array([1.0, 0.0])
    pts = [pos.copy()]
    for _ in range(n_legs):
        length = rng.uniform(*leg_len)
        pos = pos + heading * length
        pts.append(pos.copy())
        turn = rng.choice([-1, 1])
        heading = np.array([-heading[1] * turn, heading[0] * turn])
    return np.asarray(pts)


def roadside_props(dense: np.ndarray, rng: np.random.RandomState,
                   spacing: float = 22.0,
                   lateral: Tuple[float, float] = (8.0, 14.0),
                   max_props: int = 40) -> np.ndarray:
    """[P, 6] roadside scenery (x, y, half_w, height, kind, shade) every
    about `spacing` m along the dense route at a random lateral offset."""
    out = []
    step = max(int(spacing), 2)
    for i in range(step, len(dense) - 1, step):
        d = dense[i + 1] - dense[i - 1]
        n = float(np.hypot(*d))
        if n < 1e-6:
            continue
        u = d / n
        perp = np.array([-u[1], u[0]])
        side = 1.0 if rng.rand() < 0.5 else -1.0
        p = dense[i] + side * rng.uniform(*lateral) * perp
        k = rng.rand()
        if k < 0.5:
            kind, half_w = PROP_BUILDING, rng.uniform(2.5, 5.5)
            height = rng.uniform(5.0, 11.0)
        elif k < 0.85:
            kind, half_w = PROP_VEGETATION, rng.uniform(1.2, 2.8)
            height = rng.uniform(2.0, 4.0)
        else:
            kind, half_w = PROP_POLE, 0.15
            height = rng.uniform(2.5, 3.5)
        out.append([p[0], p[1], half_w, height, kind, rng.rand()])
        if len(out) >= max_props:
            break
    return np.asarray(out, np.float32).reshape(-1, 6)


def lights_at_route_corners(keypoints: np.ndarray,
                            rng: np.random.RandomState,
                            setback: float = 8.0,
                            min_turn_deg: float = 30.0
                            ) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """One light per interior keypoint where the heading turns by more than
    `min_turn_deg`: (stop-line centre [2], lane direction [2], cycle phase),
    the stop line `setback` m before the corner."""
    lights = []
    kp = np.asarray(keypoints, float)
    for i in range(1, len(kp) - 1):
        d_in = kp[i] - kp[i - 1]
        d_out = kp[i + 1] - kp[i]
        n_in = float(np.hypot(*d_in))
        n_out = float(np.hypot(*d_out))
        if n_in < 1e-6 or n_out < 1e-6:
            continue
        cosang = float(np.clip((d_in @ d_out) / (n_in * n_out), -1, 1))
        if math.degrees(math.acos(cosang)) < min_turn_deg:
            continue
        u_in = d_in / n_in
        stop_pos = kp[i] - u_in * min(setback, 0.7 * n_in)
        lights.append((stop_pos, u_in, float(rng.uniform(0, CYCLE))))
    return lights


def _route_corners(dense: np.ndarray, angle_deg: float = 30.0) -> np.ndarray:
    """Corner points of a dense polyline (direction change > angle over
    5 m either side), one per run of corner points: the keypoints a traced
    route's lights are placed at."""
    if len(dense) < 12:
        return np.zeros((0, 2))
    a = dense[5:-5] - dense[:-10]
    b = dense[10:] - dense[5:-5]
    na = np.hypot(a[:, 0], a[:, 1])
    nb = np.hypot(b[:, 0], b[:, 1])
    cos = (a * b).sum(axis=1) / np.maximum(na * nb, 1e-9)
    corner = cos < math.cos(math.radians(angle_deg))
    out = []
    i = 0
    while i < len(corner):
        if corner[i]:
            j = i
            while j + 1 < len(corner) and corner[j + 1]:
                j += 1
            out.append(dense[5 + (i + j) // 2])
            i = j + 1
        else:
            i += 1
    return np.asarray(out) if out else np.zeros((0, 2))
