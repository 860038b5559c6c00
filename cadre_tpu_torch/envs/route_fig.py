"""Route-figure rasterization, deviation distance, heading error, and the
turn-detection state machine of the host env.

numpy copy of the JAX package's host route figure (env_wrapper.py
contracts):
  - _draw_route (:240-344): the next <=50 m of route as a width-15 ribbon
    on a 256x144 canvas in the ego frame rotated by compass+pi/2; turn
    segments tracked by the axis change of consecutive waypoints; the
    perpendicular distance from the ego to the first route segment.
  - get_theta (:484-561): the heading error between the vehicle's forward
    vector and the route vector, arccos of the normalised dot product,
    with the route_len == 2 supplementary-angle case.

The rasterizer is native (runtime/raster.cpp), held bit-equal to the
numpy ribbon kept beside it as its plain version; the canvas and
lane-envelope constants are `envs.synthetic`'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from cadre_tpu_torch.envs.synthetic import (
    LINE_WIDTH,
    OUT_LEFT,
    OUT_RIGHT,
    PIXELS_PER_METER,
    SIZE_X,
    SIZE_Y,
)
from cadre_tpu_torch.runtime.native_raster import rasterize_polyline_native


@dataclasses.dataclass
class TurnState:
    """Turn-detection state carried across steps (env_wrapper.py:302-343)."""

    in_turn: bool = False
    turn_first_node: Optional[np.ndarray] = None
    turn_last_node: Optional[np.ndarray] = None
    first_direction: int = 0
    last_direction: int = 0
    pre_theta: float = 0.0


def _rotation(compass: float) -> np.ndarray:
    c = 0.0 if math.isnan(compass) else compass
    c = c + np.pi / 2
    return np.array([[np.cos(c), -np.sin(c)], [np.sin(c), np.cos(c)]])


def rasterize_polyline(points_px: np.ndarray, height: int = SIZE_Y,
                       width: int = SIZE_X,
                       line_width: float = LINE_WIDTH) -> np.ndarray:
    """Ribbon raster: uint8 {0,255} [height, width] of the polyline
    points_px ([N,2] (x, y) pixel coordinates), drawn by the native
    rasterizer (runtime/raster.cpp), which gives the numpy version's
    image bit for bit."""
    return rasterize_polyline_native(points_px, height, width, line_width)


def rasterize_polyline_numpy(points_px: np.ndarray, height: int = SIZE_Y,
                             width: int = SIZE_X,
                             line_width: float = LINE_WIDTH) -> np.ndarray:
    """The plain version of `rasterize_polyline`: a disk of the line's
    width stamped at centres sampled every ~1.5 px along the polyline."""
    fig = np.zeros((height, width), np.uint8)
    pts = np.asarray(points_px, np.float64)
    if len(pts) < 2:
        return fig
    half = line_width / 2.0

    seg = np.diff(pts, axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    centers = [pts[:1]]
    for a, d, l in zip(pts[:-1], seg, seg_len):
        n = max(1, int(l / 1.5))
        ts = (np.arange(1, n + 1) / n)[:, None]
        centers.append(a + ts * d)
    c = np.concatenate(centers)

    r = int(math.ceil(half))
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disk = (dx * dx + dy * dy) <= half * half
    offs = np.stack([dx[disk], dy[disk]], axis=-1)  # [K, 2] (x, y)
    pix = np.rint(c[:, None, :] + offs[None, :, :]).astype(np.int64)
    pix = pix.reshape(-1, 2)
    valid = ((pix[:, 0] >= 0) & (pix[:, 0] < width)
             & (pix[:, 1] >= 0) & (pix[:, 1] < height))
    pix = pix[valid]
    fig[pix[:, 1], pix[:, 0]] = 255
    return fig


def ego_frame_px(points: Sequence[np.ndarray], pos: np.ndarray,
                 compass: float,
                 pixels_per_meter: float = PIXELS_PER_METER) -> np.ndarray:
    """World meter points -> ego-frame pixel coords centred on the canvas."""
    r = _rotation(compass)
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    out = pixels_per_meter * ((pts - pos) @ r)  # (R.T @ v) == v @ R
    out[:, 0] += SIZE_X / 2
    out[:, 1] += SIZE_Y / 2
    return out


def perpendicular_distance(route_list: Sequence[np.ndarray],
                           pos: np.ndarray) -> float:
    """Ego distance to the first distinct route segment (env_wrapper:287-296)."""
    p0 = np.asarray(route_list[0], np.float64)
    for i in range(1, len(route_list)):
        cur = np.asarray(route_list[i], np.float64)
        seg = cur - p0
        norm = math.hypot(seg[0], seg[1])
        if norm > 1e-3:
            d = abs((cur[1] - p0[1]) * (pos[0] - p0[0])
                    - (cur[0] - p0[0]) * (pos[1] - p0[1])) / norm
            return 0.0 if (math.isinf(d) or math.isnan(d)) else d
    return 0.0


def signed_route_lateral(dense_route: np.ndarray, pos: np.ndarray) -> float:
    """Signed lateral offset of `pos` from the nearest dense-route segment:
    positive to the LEFT of the direction of travel (toward the oncoming
    lane)."""
    pts = np.asarray(dense_route, np.float64)
    if len(pts) < 2:
        return 0.0
    p = np.asarray(pos, np.float64)
    i = int(np.argmin(((pts - p) ** 2).sum(axis=-1)))
    i = min(i, len(pts) - 2)
    seg = pts[i + 1] - pts[i]
    n = math.hypot(seg[0], seg[1])
    if n < 1e-6:
        return 0.0
    rel = p - pts[i]
    return float(seg[0] * rel[1] - seg[1] * rel[0]) / n


def outside_route_lanes(lateral: float) -> bool:
    """True when the signed lateral is outside the two-lane road envelope."""
    return lateral > OUT_LEFT or lateral < -OUT_RIGHT


def heading_error(far_node: Optional[np.ndarray], near_node: np.ndarray,
                  pos: np.ndarray, forward: np.ndarray, route_len: int,
                  state: TurnState, compass: float) -> Tuple[float, float]:
    """(theta, distance-to-near-node) (env_wrapper.py:484-561): theta is
    the arccos angle between the ego's unit heading `forward` and
    (far_node - ego), with the two-waypoint supplementary-angle case."""
    if far_node is None:
        return 0.0, 0.0
    distance = float(np.hypot(*(np.asarray(near_node) - pos)))

    vector1 = np.asarray(forward, np.float64)
    vector2 = np.asarray(far_node) - pos
    n1 = math.hypot(*vector1)
    n2 = math.hypot(*vector2)
    if n1 < 1e-12 or n2 < 1e-12:
        theta = state.pre_theta
    else:
        cosang = float(vector1 @ vector2) / (n1 * n2)
        cosang = max(-1.0, min(1.0, cosang))
        theta = math.acos(cosang)
        if route_len == 2:
            r = _rotation(compass)
            _, y4 = PIXELS_PER_METER * (r.T @ vector2)
            if y4 > 0:
                theta = math.pi - theta
    state.pre_theta = theta
    if distance < 0.5:
        distance = 0.0
    if math.isnan(theta):
        return 0.0, distance
    return theta, distance


def update_turn_state(state: TurnState, route_list: Sequence[np.ndarray],
                      pos: np.ndarray) -> TurnState:
    """Axis-change turn detector (env_wrapper.py:302-343): consecutive
    waypoints moving mostly along x then mostly along y (or vice versa)
    bracket a turn; `in_turn` holds while the ego is within max(corner
    radius) + 6 m of the inferred corner point."""
    turn_pre = np.asarray(route_list[0], np.float64)
    for i in range(1, len(route_list)):
        cur = np.asarray(route_list[i], np.float64)
        if not state.in_turn:
            dx = abs(cur[0] - turn_pre[0])
            dy = abs(cur[1] - turn_pre[1])
            if dx < 1 or dy < 1:
                continue
            direction = 0 if dx < dy else 1
            if state.turn_first_node is None:
                state.first_direction = direction
                state.turn_first_node = cur
            else:
                state.last_direction = direction
                state.turn_last_node = cur
            turn_pre = cur

    if state.turn_first_node is not None and state.turn_last_node is not None:
        if state.first_direction == 0:
            middle = np.array([state.turn_last_node[0],
                               state.turn_first_node[1]])
        else:
            middle = np.array([state.turn_first_node[0],
                               state.turn_last_node[1]])
        turn_dis = float(np.hypot(*(middle - pos)))
        max_dis = max(float(np.hypot(*(middle - state.turn_first_node))),
                      float(np.hypot(*(middle - state.turn_last_node))))
        if turn_dis < max_dis + 6:
            state.in_turn = True
        elif state.in_turn:
            state.in_turn = False
            state.turn_first_node = None
            state.turn_last_node = None
            state.first_direction = 0
            state.last_direction = 0
    return state


def draw_route(route_list: Sequence[np.ndarray], pos: np.ndarray,
               compass: float, forward: np.ndarray, state: TurnState
               ) -> Tuple[np.ndarray, float, float, TurnState]:
    """The whole _draw_route: `forward` is the ego's unit heading in route
    coordinates. Returns (route_fig [256,144] uint8, deviation distance,
    theta, state)."""
    px = ego_frame_px(route_list, pos, compass)
    fig = rasterize_polyline(px)

    # the first node distinct from route_list[0] drives the heading error
    far_node = None
    p0 = np.asarray(route_list[0])
    for i in range(1, len(route_list)):
        p = np.asarray(route_list[i])
        if abs(p[0] - p0[0]) + abs(p[1] - p0[1]) > 1e-3:
            far_node = p
            break

    pep_dis = perpendicular_distance(route_list, pos)
    theta, distance = heading_error(far_node, p0, pos, forward,
                                    len(route_list), state, compass)
    if len(route_list) == 2:
        distance = pep_dis
    state = update_turn_state(state, route_list, pos)
    return fig, distance, theta, state
