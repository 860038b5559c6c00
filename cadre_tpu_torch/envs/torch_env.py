"""Device-resident batched driving environment (PyTorch).

Counterpart of cadre_tpu.envs.jax_env: bicycle dynamics, the GPS
route-planner window, route-completion, turn, red-light and stop-sign
state, route-driving NPC vehicles and wandering walkers, Scenario-3
crossing hazards and Scenario-4 junction crossers, the per-env priority
route curriculum, the decomposed
steer/throttle reward with termination and auto-reset, and the two
observation canvases (route figure and synthetic camera) painted through
`ops.paint` -- all on [N, ...] tensors on one device. The JAX package's
per-env functions under vmap become functions over the batch axis here, and
its `lax.scan`s become Python loops.

Randomness comes through one seam: `draw_reset` and `draw_step` make the
`ResetDraws` / `StepDraws` bundles from a torch.Generator, and
`reset_from_draws` / `DrivingEnv.step` consume them, so a test can hand in
the JAX package's own numbers instead.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cadre_tpu_torch.envs.route_parser import (
    interpolate_route,
    parse_routes_file,
)
from cadre_tpu_torch.envs.synthetic import (
    CYCLE,
    GREEN_TIME,
    LINE_WIDTH,
    OUT_LEFT,
    OUT_RIGHT,
    PIXELS_PER_METER,
    SIZE_X,
    SIZE_Y,
    WEATHER_PRESETS,
    YELLOW_TIME,
    _route_corners,
    lights_at_route_corners,
    roadside_props,
    synthetic_route,
)
from cadre_tpu_torch.envs.town_maps import town_map, trace_dense_route
from cadre_tpu_torch.ops import paint
from cadre_tpu_torch.utils.device import resolve_device
from cadre_tpu_torch.utils.profiling import span

# ---------------------------------------------------------------- constants

_H, _W = SIZE_X, SIZE_Y            # camera 144 x 256
_FH, _FW = SIZE_Y, SIZE_X          # route figure 256 x 144
_FOCAL = 128.0
_CAM_H = 1.3
_EGO_RADIUS = 1.2
_MAX_WHEEL = math.radians(35.0)
_WHEELBASE = 2.9
_VEH_EXTENT = 2.45
_LANE_WIDTH = 3.5

_WNAMES = list(WEATHER_PRESETS)
_SKY = np.asarray([WEATHER_PRESETS[n][0] for n in _WNAMES], np.float32)
_BRIGHT = np.asarray([WEATHER_PRESETS[n][1] for n in _WNAMES], np.float32)
_NOISE = np.asarray([WEATHER_PRESETS[n][2] for n in _WNAMES], np.float32)
_LIGHT_COLORS = np.asarray([[40.0, 255.0, 60.0], [255.0, 220.0, 40.0],
                            [255.0, 30.0, 30.0]], np.float32)
_FAR = 1.0e8                       # padding sentinel for bank entries

# bank geometry: the JAX make_route_bank defaults
_ROUTE_LEGS = 3
_LEG_LEN = (40.0, 90.0)
_MAX_LIGHTS = 8
_MAX_STOP_SIGNS = 2
_MAX_PROPS = 40
_PAD = 80          # endpoint copies past the longest route, so windows at
#                    the head never clip

# hazards: the JAX env config's defaults
_HAZARD_TRIGGER = 12.0             # m from the ego at which one springs
_HAZARD_OFFSET = 5.0               # m beside the route or light it waits at
_JUNCTION_HAZARD_SPEED = (2.5, 4.0)

ERROR_CODES = {
    0: "", 1: "collision static", 2: "collision vehicles!",
    3: "collision pedestrians!", 4: "vehicle blocked", 5: "route deviation",
    6: "success", 7: "exceed speed", 8: "route timeout",
    9: "outside route!",
}


# ---------------------------------------------------------------- config

@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (the JAX package's JaxEnvConfig)."""

    dt: float = 0.1
    training: bool = True
    max_block_steps: int = 400
    route_timeout: bool = True
    window: int = 52               # planner lookahead entries (1 m dense)
    rgb_window: int = 64           # camera route-marker lookahead entries
    n_vehicles: int = 6
    npc_cruise: Tuple[float, float] = (3.0, 6.5)
    npc_gap: float = 8.0
    npc_accel: float = 3.0
    n_walkers: int = 6
    min_speed: float = 5.0
    max_speed: float = 9.0
    target_speed: float = 7.0
    max_degree: float = 90.0
    d_max_straight: float = 2.5
    d_max_turn: float = 5.0
    d_max_eval: float = 10.0
    max_offroad: float = 30.0
    randomize_weather: bool = True
    render: bool = True
    blind_route: bool = False
    # Scenario-3 crossing pedestrians armed _HAZARD_OFFSET m beside the
    # route, springing into a straight crossing walk when the ego comes
    # within _HAZARD_TRIGGER m (DynamicObjectCrossing)
    n_hazards: int = 0
    # Scenario-4 cyclist-class crossers armed beside a corner light
    # (VehicleTurningRoute), springing the same way
    n_junction_hazards: int = 0
    # per-env route curriculum (PriorityRouteIndexer): at episode end
    # priority[route] = 100 - completion%; a reset draws uniformly 20% of
    # the time, else from softmax(priority)
    priority_routes: bool = False

    @property
    def n_actors(self) -> int:
        return (self.n_vehicles + self.n_walkers + self.n_hazards
                + self.n_junction_hazards)

    @property
    def n_obstacles(self) -> int:
        # at least one (inert) row so the obstacle reductions never run
        # over an empty axis
        return max(self.n_actors, 1)


class RouteBank(NamedTuple):
    """K padded routes with their lights, stop signs and props."""

    routes: torch.Tensor           # [K, R, 2] f32, padded with the endpoint
    route_len: torch.Tensor        # [K] int64
    route_cum: torch.Tensor        # [K, R] f32 normalised arc length
    lights: torch.Tensor           # [K, L, 5] (x, y, phase, dir_x, dir_y)
    stop_signs: torch.Tensor       # [K, S, 5] (x, y, ext_x, ext_y, yaw_deg)
    props: torch.Tensor            # [K, P, 6] (x, y, half_w, height, kind,
    #                                shade); x = _FAR pads


class EnvState(NamedTuple):
    """Per-env episode state, every field batched on a leading [N] axis."""

    route_id: torch.Tensor         # int64
    head: torch.Tensor             # int64 planner head index
    progress: torch.Tensor         # int64 route-completion index
    pos: torch.Tensor              # [N, 2] f32
    yaw: torch.Tensor              # f32 degrees
    speed: torch.Tensor            # f32 m/s
    step: torch.Tensor             # int64 steps since reset
    last_event_t: torch.Tensor     # int64 block-timeout bookkeeping
    begin: torch.Tensor            # int64, 1 on the first post-reset step
    obstacles: torch.Tensor        # [N, M, 6] x, y, radius, kind, speed,
    #                                heading
    hazard_speed: torch.Tensor     # [N, M] latent crossing speed of an
    #                                armed hazard; 0 for other rows
    npc_s: torch.Tensor            # [N, M] route arc position; -1 unbound
    npc_cruise: torch.Tensor       # [N, M] cruise speed of route vehicles
    weather: torch.Tensor          # int64 preset index
    turn: torch.Tensor             # [N, 8] first_xy, last_xy, first_dir,
    #                                has_first, has_last, in_turn
    last_red: torch.Tensor         # int64 debounced red-light index
    stop_state: torch.Tensor       # [N, 3] target, stop_completed, affected
    infractions: torch.Tensor      # [N, 2] int64 episode (red, stop) counts
    route_prio: torch.Tensor       # [N, K] f32 curriculum priority per route


class StepOutput(NamedTuple):
    rgb: torch.Tensor              # [N, 144, 256, 3] f32 0..255
    route_fig: torch.Tensor        # [N, 256, 144] f32 {0, 255}
    measurements: torch.Tensor     # [N, 3] (speed/max, dis/3, |deg|/90)
    command: torch.Tensor          # [N] int64, always 3 = LANEFOLLOW
    rewards: torch.Tensor          # [N, 2] (steer, throttle)
    done: torch.Tensor             # [N] bool
    action_done: torch.Tensor      # [N, 2] int64
    completion: torch.Tensor       # [N] f32 route completion
    error_code: torch.Tensor       # [N] int64, see ERROR_CODES
    infractions: torch.Tensor      # [N, 2] int64


class ResetDraws(NamedTuple):
    """Every random number of one episode reset, batched over N envs. The
    four hazard fields are None in a configuration without hazards, and
    the last two without priority routes."""

    route: torch.Tensor            # [N] int64 uniform in [0, K)
    spawn: torch.Tensor            # [N, M] int64 in [0, 2**30)
    lateral: torch.Tensor          # [N, M, 2] uniform [-3, 3)
    walker_speed: torch.Tensor     # [N, M] uniform [0.3, 1.2)
    heading: torch.Tensor          # [N, M] uniform [0, 2 pi)
    cruise: torch.Tensor           # [N, M] uniform over cfg.npc_cruise
    weather: torch.Tensor          # [N] int64 in [0, 16)
    side: Optional[torch.Tensor]            # [N, M] bool, hazard on the left
    hazard_speed: Optional[torch.Tensor]    # [N, M] uniform [1.2, 2.0)
    junction_light: Optional[torch.Tensor]  # [N, M] int64 in [0, 2**30)
    junction_speed: Optional[torch.Tensor]  # [N, M] uniform over
    #                                         _JUNCTION_HAZARD_SPEED
    prio_eps: Optional[torch.Tensor]        # [N] uniform [0, 1)
    prio_gumbel: Optional[torch.Tensor]     # [N, K] standard Gumbel


class StepDraws(NamedTuple):
    reset: ResetDraws              # for the envs that finish this step
    noise: torch.Tensor            # [N, 144, 256, 3] standard normal


# ---------------------------------------------------------------- bank

def make_route_bank(n_routes: int, seed: int = 0,
                    route_legs: int = _ROUTE_LEGS,
                    route_leg_len: Tuple[float, float] = _LEG_LEN,
                    routes_file: Optional[str] = None,
                    stop_sign_prob: float = 0.0,
                    map_name: Optional[str] = None,
                    dense_routes: Optional[Sequence[np.ndarray]] = None,
                    device="cuda") -> RouteBank:
    """Episode bank with its corner lights, stop signs and roadside props:
    the same numbers as the JAX package's make_route_bank from the same
    seed.

    Synthetic axis-aligned routes by default; with `routes_file`, the
    route XML's keypoints (at most `n_routes`), densified in straight
    lines, or traced over the town grid of `map_name` so that they turn at
    its junctions; `dense_routes` takes pre-traced [R, 2] polylines as
    they are. Lights go at the keypoint corners (of a traced route: the
    corners of its trace); `stop_sign_prob` > 0 turns that share of them
    into stop signs, a lane-wide trigger box straddling the stop line."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    pre_traced = dense_routes is not None
    if pre_traced:
        keypoints = [np.asarray(d, np.float64) for d in dense_routes[:n_routes]]
    elif routes_file is not None:
        keypoints = [np.asarray([w.xy for w in cfg.trajectory])
                     for cfg in parse_routes_file(routes_file)[:n_routes]]
        if not keypoints:
            raise ValueError(f"no routes in {routes_file}")
        if map_name is not None:
            town = town_map(map_name)
            keypoints = [trace_dense_route(town, kp) for kp in keypoints]
            pre_traced = True
    else:
        keypoints = [synthetic_route(rng, n_legs=route_legs,
                                     leg_len=route_leg_len)
                     for _ in range(n_routes)]
    n_routes = len(keypoints)

    dense_list, lights_list, signs_list, props_list = [], [], [], []
    for pts in keypoints:
        dense = interpolate_route(pts, resolution=1.0)
        dense_list.append(dense)
        if pre_traced:
            # lights need the leg corners, not the per-meter trace
            corners = _route_corners(dense)
            pts = np.concatenate([dense[:1], corners, dense[-1:]]) \
                if len(corners) else np.stack([dense[0], dense[-1]])
        arr = np.full((_MAX_LIGHTS, 5), _FAR, np.float32)
        signs = np.full((_MAX_STOP_SIGNS, 5), _FAR, np.float32)
        n_li = n_si = 0
        # every light's phase is drawn first, then one stop-sign draw per
        # light while stop signs are on
        for center, direction, phase in lights_at_route_corners(pts, rng):
            if stop_sign_prob > 0 and rng.rand() < stop_sign_prob \
                    and n_si < _MAX_STOP_SIGNS:
                yaw = math.degrees(math.atan2(direction[1], direction[0]))
                signs[n_si] = [center[0], center[1], 2.0,
                               0.5 * _LANE_WIDTH, yaw]
                n_si += 1
            elif n_li < _MAX_LIGHTS:
                arr[n_li] = [center[0], center[1], phase, direction[0],
                             direction[1]]
                n_li += 1
        lights_list.append(arr)
        signs_list.append(signs)
        pr = np.full((_MAX_PROPS, 6), _FAR, np.float32)
        gen = roadside_props(dense, rng, max_props=_MAX_PROPS)
        pr[:len(gen)] = gen
        props_list.append(pr)
    r_max = max(len(d) for d in dense_list) + _PAD
    routes = np.zeros((n_routes, r_max, 2), np.float32)
    cums = np.ones((n_routes, r_max), np.float32)
    lens = np.zeros((n_routes,), np.int64)
    for i, d in enumerate(dense_list):
        routes[i, :len(d)] = d
        routes[i, len(d):] = d[-1]
        seg = np.hypot(*(np.diff(d, axis=0).T))
        cum = np.concatenate([[0.0], np.cumsum(seg)])
        cums[i, :len(d)] = cum / max(cum[-1], 1e-6)
        lens[i] = len(d)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return RouteBank(t(routes), t(lens), t(cums), t(np.stack(lights_list)),
                     t(np.stack(signs_list)), t(np.stack(props_list)))


# ---------------------------------------------------------------- core math

def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _heading(yaw_deg: torch.Tensor) -> torch.Tensor:
    yaw = torch.deg2rad(yaw_deg)
    return torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _route_window(bank: RouteBank, state: EnvState, length: int):
    """[N, length, 2] route window at the planner head, its validity mask
    and the route lengths."""
    rlen = bank.route_len[state.route_id]
    start = state.head.clamp(0, bank.routes.shape[1] - length)
    idx = start[:, None] + torch.arange(length, device=start.device)
    w = bank.routes[state.route_id[:, None], idx]
    return w, idx < rlen[:, None], rlen


def _cum_ahead(w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    seg = _norm(w[:, 1:] - w[:, :-1])
    seg = torch.where(valid[:, 1:], seg, torch.zeros_like(seg))
    return torch.cumsum(seg, dim=1)


def _n_within_50m(cum: torch.Tensor) -> torch.Tensor:
    """Entries of the route list up to 50 m ahead (planner.py:341-350)."""
    fifty = torch.full((cum.shape[0], 1), 50.0, device=cum.device)
    return torch.searchsorted(cum.contiguous(), fifty)[:, 0] + 2


def _plan_pop(cfg: EnvConfig, bank: RouteBank, state: EnvState) -> EnvState:
    """RoutePlanner.run_step pop semantics, including the reference's quirk
    of popping up to the farthest in-range node."""
    w, valid, rlen = _route_window(bank, state, cfg.window)
    n_ahead = _n_within_50m(_cum_ahead(w, valid))
    idx = torch.arange(1, cfg.window, device=w.device)
    dist = _norm(w[:, 1:] - state.pos[:, None])
    in_range = (dist <= 4.0) & (idx < n_ahead[:, None]) & valid[:, 1:]
    far = torch.argmax(torch.where(in_range, dist, torch.full_like(dist, -1.0)),
                       dim=1) + 1
    to_pop = torch.where(in_range.any(1), far, torch.zeros_like(far))
    return state._replace(head=torch.minimum(state.head + to_pop, rlen - 2))


def _scalars(cfg: EnvConfig, bank: RouteBank, state: EnvState) -> dict:
    """Per-step geometry: dis, theta, off-route distance, the lane test and
    the planner window (reused by the renderers)."""
    w, valid, _ = _route_window(bank, state, cfg.window)
    n_list = _n_within_50m(_cum_ahead(w, valid))
    list_mask = (torch.arange(cfg.window, device=w.device)[None]
                 < n_list[:, None]) & valid
    pos = state.pos
    p0, p1 = w[:, 0], w[:, 1]
    endgame = list_mask.sum(1) == 2
    seg01 = p1 - p0
    nseg = _norm(seg01)
    relp = pos - p0
    pep = torch.abs(seg01[:, 0] * relp[:, 1] - seg01[:, 1] * relp[:, 0]) \
        / nseg.clamp_min(1e-9)
    zero = torch.zeros_like(pep)
    pep = torch.where(nseg > 1e-3, pep, zero)
    dis = _norm(p0 - pos)
    dis = torch.where(dis < 0.5, zero, dis)
    dis = torch.where(endgame, pep, dis)

    fwd = _heading(state.yaw)
    v2 = p1 - pos
    n2 = _norm(v2)
    cosang = torch.clamp((fwd * v2).sum(-1) / n2.clamp_min(1e-9), -1.0, 1.0)
    theta = torch.where(n2 > 1e-9, torch.arccos(cosang), zero)
    c = torch.deg2rad(state.yaw) + math.pi / 2
    y4 = -torch.sin(c) * v2[:, 0] + torch.cos(c) * v2[:, 1]
    theta = torch.where(endgame & (y4 > 0), math.pi - theta, theta)

    d_all = _norm(w - pos[:, None])
    d_valid = torch.where(valid, d_all, torch.full_like(d_all, math.inf))
    off_route = d_valid.amin(1)
    i_seg = torch.argmin(d_valid, dim=1).clamp_max(cfg.window - 2)
    rows = _rows(w.shape[0], w.device)
    sp0 = w[rows, i_seg]
    sseg = w[rows, i_seg + 1] - sp0
    snrm = _norm(sseg)
    srel = pos - sp0
    lat = (sseg[:, 0] * srel[:, 1] - sseg[:, 1] * srel[:, 0]) \
        / snrm.clamp_min(1e-9)
    seg_ok = valid[rows, i_seg + 1] & (snrm > 1e-6)
    off_lane = seg_ok & ((lat > OUT_LEFT) | (lat < -OUT_RIGHT))
    return dict(w=w, list_mask=list_mask, dis=dis, theta=theta,
                off_route=off_route, off_lane=off_lane)


def _update_progress(bank: RouteBank, state: EnvState,
                     terminate_pct: float = 99.0):
    """RouteCompletionCriterion: advance the farthest dense-route index
    within 10 m over a 50-entry lookahead."""
    rlen = bank.route_len[state.route_id]
    start = state.progress
    look = torch.arange(50, device=start.device)
    s0 = start.clamp(0, bank.routes.shape[1] - 50)
    w = bank.routes[state.route_id[:, None], s0[:, None] + look]
    valid = (start[:, None] + look) < rlen[:, None]
    close = (_norm(w - state.pos[:, None]) < 10.0) & valid
    last = 49 - torch.argmax(close.flip(1).to(torch.uint8), dim=1)
    last_close = torch.where(close.any(1), last, torch.zeros_like(last))
    progress = torch.minimum(start + last_close, rlen - 1)
    completion = bank.route_cum[state.route_id, progress]
    completed = completion >= terminate_pct / 100.0
    completion = torch.where(completed, torch.ones_like(completion),
                             completion)
    return state._replace(progress=progress), completion, completed


def _update_turn(state: EnvState, w: torch.Tensor,
                 list_mask: torch.Tensor) -> EnvState:
    """route_fig.update_turn_state: walk the window nodes advancing the
    last significant node (|dx| >= 1 and |dy| >= 1); corner nodes and the
    in_turn flag persist in state.turn."""
    t = state.turn
    first, last = t[:, 0:2], t[:, 2:4]
    first_dir, has_first, has_last, in_turn = t[:, 4], t[:, 5], t[:, 6], t[:, 7]
    turn_pre = w[:, 0]
    for i in range(w.shape[1]):
        cur = w[:, i]
        d = torch.abs(cur - turn_pre)
        sig = list_mask[:, i] & (d[:, 0] >= 1.0) & (d[:, 1] >= 1.0)
        take_first = sig & (has_first < 0.5)
        take_last = sig & (has_first >= 0.5)
        first = torch.where(take_first[:, None], cur, first)
        first_dir = torch.where(take_first, (d[:, 0] >= d[:, 1]).float(),
                                first_dir)
        has_first = torch.maximum(has_first, take_first.float())
        last = torch.where(take_last[:, None], cur, last)
        has_last = torch.maximum(has_last, take_last.float())
        turn_pre = torch.where(sig[:, None], cur, turn_pre)

    has_both = (has_first >= 0.5) & (has_last >= 0.5)
    middle = torch.where((first_dir < 0.5)[:, None],
                         torch.stack([last[:, 0], first[:, 1]], -1),
                         torch.stack([first[:, 0], last[:, 1]], -1))
    turn_dis = _norm(middle - state.pos)
    max_dis = torch.maximum(_norm(middle - first), _norm(middle - last))
    near = turn_dis < max_dis + 6.0
    enter = has_both & near
    leave = has_both & ~near & (in_turn >= 0.5)
    zero = torch.zeros_like(in_turn)
    new_in = torch.where(enter, torch.ones_like(in_turn),
                         torch.where(leave, zero, in_turn))
    first = torch.where(leave[:, None], torch.zeros_like(first), first)
    last = torch.where(leave[:, None], torch.zeros_like(last), last)
    first_dir = torch.where(leave, zero, first_dir)
    has_first = torch.where(leave, zero, has_first)
    has_last = torch.where(leave, zero, has_last)
    turn = torch.cat([first, last, torch.stack(
        [first_dir, has_first, has_last, new_in], -1)], dim=-1)
    return state._replace(turn=turn)


def _nearest_obstacle_ahead(state: EnvState) -> torch.Tensor:
    """Forward obstacle distance within the 11 m cone, else -1."""
    fwd = _heading(state.yaw)[:, None]
    rel = state.obstacles[..., :2] - state.pos[:, None]
    dist = _norm(rel)
    ahead = (rel * fwd).sum(-1)
    lateral = torch.abs(rel[..., 0] * fwd[..., 1] - rel[..., 1] * fwd[..., 0])
    ok = (dist <= 11.0) & (dist > 1e-6) & (ahead > 0.0) & (lateral < 1.5)
    best = torch.where(ok, dist, torch.full_like(dist, math.inf)).amin(1)
    return torch.where(torch.isfinite(best), best, torch.full_like(best, -1.0))


def _light_phases(cfg: EnvConfig, lights: torch.Tensor,
                  step: torch.Tensor) -> torch.Tensor:
    """[N, L] phase per light (0 green, 1 yellow, 2 red) at `step`."""
    t = step.float() * cfg.dt
    u = torch.remainder(t[:, None] + lights[..., 2], CYCLE)
    return torch.where(u < GREEN_TIME, 0,
                       torch.where(u < GREEN_TIME + YELLOW_TIME, 1, 2))


def _red_light_check(cfg: EnvConfig, bank: RouteBank,
                     state: EnvState) -> EnvState:
    """RunningRedLightCriterion: the ego tail segment crossing a red
    light's stop line in its lane and direction within 10 m counts one
    infraction, debounced per light through `last_red`."""
    lights = bank.lights[state.route_id]                  # [N, L, 5]
    is_red = (_light_phases(cfg, lights, state.step) == 2) & \
        (lights[..., 0] < _FAR / 2)
    fwd = _heading(state.yaw)
    tail_close = state.pos - 0.8 * _VEH_EXTENT * fwd
    tail_far = state.pos - (_VEH_EXTENT + 1.0) * fwd
    center = lights[..., :2]
    near = _norm(center - state.pos[:, None]) <= 10.0
    ldir = lights[..., 3:5]
    same_dir = (ldir * fwd[:, None]).sum(-1) > 0.0
    rel = tail_far[:, None] - center
    lateral = torch.abs(rel[..., 0] * ldir[..., 1] - rel[..., 1] * ldir[..., 0])
    lane_ok = same_dir & (lateral <= 0.8 * _LANE_WIDTH)
    perp = torch.stack([-ldir[..., 1], ldir[..., 0]], dim=-1)
    half = 0.4 * _LANE_WIDTH
    lft = center + half * perp
    rgt = center - half * perp

    def orient(a, b, c):
        v = ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
             - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))
        return torch.sign(torch.where(torch.abs(v) < 1e-12,
                                      torch.zeros_like(v), v))

    p1, p2 = tail_close[:, None], tail_far[:, None]
    crossed = (orient(p1, p2, lft) != orient(p1, p2, rgt)) & \
        (orient(lft, rgt, p1) != orient(lft, rgt, p2))
    idx = torch.arange(lights.shape[1], device=lights.device)
    fire = is_red & near & lane_ok & crossed & \
        (idx[None] != state.last_red[:, None])
    any_fire = fire.any(1)
    last_red = torch.where(any_fire, torch.argmax(fire.to(torch.uint8), 1),
                           state.last_red)
    infr = state.infractions.clone()
    infr[:, 0] += any_fire.long()
    return state._replace(last_red=last_red, infractions=infr)


def _point_in_bb(p, center, ext, yaw_deg):
    """Oriented-box containment of points `p` [..., 2] in boxes broadcast
    against them (traffic_lights._point_inside_bb)."""
    c = torch.cos(torch.deg2rad(yaw_deg))
    s = torch.sin(torch.deg2rad(yaw_deg))
    rel = p - center
    lx = c * rel[..., 0] + s * rel[..., 1]
    ly = -s * rel[..., 0] + c * rel[..., 1]
    return (torch.abs(lx) < ext[..., 0]) & (torch.abs(ly) < ext[..., 1])


def _stop_sign_check(cfg: EnvConfig, bank: RouteBank,
                     state: EnvState) -> EnvState:
    """RunningStopCriterion: acquire a sign when the 20 m forward horizon
    enters its trigger box; leaving the box without having stopped
    (speed < 0.1) counts one infraction."""
    signs = bank.stop_signs[state.route_id]                # [N, S, 5]
    if signs.shape[1] == 0:
        return state
    svalid = signs[..., 0] < _FAR / 2
    center, ext, yaw = signs[..., :2], signs[..., 2:4], signs[..., 4]
    fwd = _heading(state.yaw)
    d = _norm(center - state.pos[:, None])
    ks = torch.arange(21, dtype=torch.float32, device=fwd.device)
    pts = state.pos[:, None] + ks[None, :, None] * fwd[:, None]   # [N, 21, 2]
    inside = _point_in_bb(pts[:, :, None], center[:, None], ext[:, None],
                          yaw[:, None])                           # [N, 21, S]
    affected_now = svalid & (d <= 50.0) & inside.any(1)

    ss = state.stop_state
    target, stopped, affected = ss[:, 0], ss[:, 1], ss[:, 2]
    no_target = target < 0
    acquired = no_target & affected_now.any(1)
    target_i = torch.where(acquired,
                           torch.argmax(affected_now.to(torch.uint8), 1),
                           target.long())
    has_target = ~no_target
    rows = _rows(signs.shape[0], signs.device)
    ti = target_i.clamp(0, signs.shape[1] - 1)
    one, zero = torch.ones_like(stopped), torch.zeros_like(stopped)
    stopped = torch.where(has_target & (state.speed < 0.1), one, stopped)
    ego_in = _point_in_bb(state.pos, center[rows, ti], ext[rows, ti],
                          yaw[rows, ti])
    affected = torch.where(has_target & ego_in, one, affected)
    leaving = has_target & ~affected_now[rows, ti]
    infraction = leaving & (affected >= 0.5) & (stopped < 0.5)
    target_o = torch.where(leaving, torch.full_like(target_i, -1), target_i)
    stopped = torch.where(leaving | acquired, zero, stopped)
    affected = torch.where(leaving | acquired, zero, affected)
    infr = state.infractions.clone()
    infr[:, 1] += infraction.long()
    return state._replace(
        stop_state=torch.stack([target_o.float(), stopped, affected], -1),
        infractions=infr)


def _on_route(route: torch.Tensor, s: torch.Tensor):
    """Point at arc position `s` [N, M] along routes [N, R, 2] and the unit
    direction of its segment."""
    rows = _rows(route.shape[0], route.device)[:, None]
    i0 = s.long().clamp(0, route.shape[1] - 2)
    a, b = route[rows, i0], route[rows, i0 + 1]
    return a + (s - i0.float())[..., None] * (b - a), b - a


def _physics(cfg: EnvConfig, bank: RouteBank, state: EnvState,
             control: torch.Tensor):
    """One dynamics tick: the ego's bicycle model, wandering walkers and
    route-driving NPC car-followers. Returns (state, collision [N, 3] bool:
    static, vehicle, walker)."""
    dt = cfg.dt
    steer = control[:, 0].clamp(-1.0, 1.0)
    throttle = control[:, 1].clamp(0.0, 1.0)
    brake = control[:, 2].clamp(0.0, 1.0)
    accel = 3.5 * throttle - 8.0 * brake - 0.08 * state.speed
    speed = (state.speed + accel * dt).clamp_min(0.0)
    yaw_rate = speed / _WHEELBASE * torch.tan(steer * _MAX_WHEEL)
    yaw = state.yaw + torch.rad2deg(yaw_rate * dt)
    pos = state.pos + _heading(yaw) * speed[:, None] * dt

    obs = state.obstacles
    bound = state.npc_s >= 0.0
    mover = (obs[..., 4] > 0) & ~bound
    delta = obs[..., 4:5] * dt * torch.stack(
        [torch.cos(obs[..., 5]), torch.sin(obs[..., 5])], dim=-1)
    new_xy = torch.where(mover[..., None], obs[..., :2] + delta, obs[..., :2])

    route = bank.routes[state.route_id]                  # [N, R, 2]
    rlen = bank.route_len[state.route_id].float()
    s = state.npc_s.clamp_min(0.0)
    pcur, seg = _on_route(route, s)
    dirn = seg / _norm(seg)[..., None].clamp_min(1e-6)
    others = torch.cat([obs[..., :2], pos[:, None]], dim=1)   # [N, M+1, 2]
    relo = others[:, None] - pcur[:, :, None]                # [N, M, M+1, 2]
    fwd_d = (relo * dirn[:, :, None]).sum(-1)
    lat_d = torch.abs(relo[..., 0] * dirn[:, :, None, 1]
                      - relo[..., 1] * dirn[:, :, None, 0])
    m = obs.shape[1]
    not_self = ~torch.eye(m, m + 1, dtype=torch.bool, device=obs.device)
    held = ((fwd_d > 0.1) & (fwd_d < cfg.npc_gap) & (lat_d < 2.5)
            & not_self).any(-1)
    lights = bank.lights[state.route_id]
    red = (_light_phases(cfg, lights, state.step) == 2) & \
        (lights[..., 0] < _FAR / 2)
    rell = lights[:, None, :, :2] - pcur[:, :, None]          # [N, M, L, 2]
    lfwd = (rell * dirn[:, :, None]).sum(-1)
    llat = torch.abs(rell[..., 0] * dirn[:, :, None, 1]
                     - rell[..., 1] * dirn[:, :, None, 0])
    same = (lights[:, None, :, 3:5] * dirn[:, :, None]).sum(-1) > 0.0
    held = held | (red[:, None] & (lfwd > 0.0) & (lfwd < 10.0)
                   & (llat < 0.8 * _LANE_WIDTH) & same).any(-1)
    target = torch.where(held, torch.zeros_like(state.npc_cruise),
                         state.npc_cruise)
    v = torch.clamp(target, obs[..., 4] - cfg.npc_accel * dt,
                    obs[..., 4] + cfg.npc_accel * dt).clamp_min(0.0)
    s_new = s + v * dt
    # past the route end: recycle to the start unless the ego is near it
    near_start = _norm(route[:, 1] - pos) < 25.0
    end = (rlen - 2.0)[:, None].expand_as(s_new)
    s_new = torch.where(s_new >= end,
                        torch.where(near_start[:, None], end,
                                    torch.ones_like(s_new)), s_new)
    pnew, _ = _on_route(route, s_new)
    obs = obs.clone()
    obs[..., :2] = torch.where(bound[..., None], pnew, new_xy)
    obs[..., 4] = torch.where(bound, v, obs[..., 4])
    obs[..., 5] = torch.where(bound, torch.atan2(dirn[..., 1], dirn[..., 0]),
                              obs[..., 5])
    npc_s = torch.where(bound, s_new, state.npc_s)

    hit = _norm(obs[..., :2] - pos[:, None]) < obs[..., 2] + _EGO_RADIUS
    kind = obs[..., 3].long()
    collision = torch.stack([(hit & (kind == 2)).any(1),
                             (hit & (kind == 0)).any(1),
                             (hit & (kind == 1)).any(1)], dim=-1)
    return state._replace(pos=pos, yaw=yaw, speed=speed, obstacles=obs,
                          npc_s=npc_s, step=state.step + 1), collision


def _reward_step(cfg: EnvConfig, state: EnvState, scal: dict,
                 collision: torch.Tensor, obstacle: torch.Tensor,
                 route_completed: torch.Tensor, route_m: torch.Tensor):
    """compute_reward (env_wrapper.py:361-482) as branch-free tensor math."""
    speed = state.speed
    zero = torch.zeros_like(speed)
    one = torch.ones_like(speed)
    begin = state.begin > 0
    in_turn = state.turn[:, 7] >= 0.5
    coll_static = collision[:, 0] & ~begin
    coll_vehicle = collision[:, 1] & ~begin
    coll_walker = collision[:, 2] & ~begin
    deviation = (scal["off_route"] > cfg.max_offroad) & ~begin
    outside = scal["off_lane"] & ~begin & ~in_turn
    completed = route_completed & ~begin

    steer_ev = (-1.0 * coll_static.float()
                - 1.0 * (deviation | outside).float() + 5.0 * completed.float())
    throttle_ev = (-1.0 * (coll_vehicle | coll_walker).float()
                   + 5.0 * completed.float())
    done = (coll_vehicle | coll_walker | deviation | outside | completed
            | (coll_static & cfg.training))
    steer_done = coll_static | deviation | outside | completed
    throttle_done = coll_vehicle | coll_walker | completed

    # error codes, later writers win as in the sequential reference checks
    err = torch.zeros_like(state.step)
    for cond, code in ((coll_static, 1), (coll_vehicle, 2), (coll_walker, 3),
                       (outside, 9), (deviation, 5), (completed, 6)):
        err = torch.where(cond, code, err)

    degree = torch.abs(torch.rad2deg(scal["theta"]))
    degree = torch.where(in_turn, torch.maximum(zero, degree - 30.0), degree)
    theta_r = torch.maximum(zero, 1.0 - degree / cfg.max_degree)

    over = speed > cfg.max_speed
    throttle_ev = throttle_ev - over.float()
    throttle_done = throttle_done | over
    done = done | (over & cfg.training)
    err = torch.where(over & cfg.training & (err == 0), 7, err)

    detect = (obstacle > -1.0) & (obstacle < 12.0)
    tgt = torch.maximum(zero, obstacle - 5.0)
    shaped = 1.0 - torch.maximum(speed - tgt, zero) / \
        torch.clamp_min(cfg.max_speed - tgt, 1e-9)
    shaped = torch.where(obstacle < 5.0, torch.where(speed > 0.1, -one, one),
                         shaped)
    slow = speed / cfg.min_speed
    fast = torch.maximum(zero, 1.0 - (speed - cfg.target_speed)
                         / (cfg.max_speed - cfg.target_speed))
    speed_r = torch.where(
        detect, shaped,
        torch.where(speed < cfg.min_speed, slow,
                    torch.where(speed > cfg.target_speed, fast, one)))

    if cfg.training:
        d_max = torch.where(in_turn, cfg.d_max_turn * one,
                            cfg.d_max_straight * one)
    else:
        d_max = cfg.d_max_eval * one
    deviation_r = torch.maximum(zero, 1.0 - scal["dis"] / d_max)

    last_t = torch.where(detect, state.step, state.last_event_t)
    blocked = (speed < 1.0) & ((state.step - last_t) > cfg.max_block_steps)
    done = done | blocked
    throttle_ev = throttle_ev - 2.0 * blocked.float()
    throttle_done = throttle_done | blocked
    err = torch.where(blocked & (err == 0), 4, err)
    had_event = coll_static | coll_vehicle | coll_walker | deviation \
        | completed | blocked
    last_t = torch.where(had_event | (speed > 1.0), state.step, last_t)

    if cfg.route_timeout:
        timeout_ticks = (0.8 * route_m + 5.0) / cfg.dt
        timed_out = state.step.float() >= timeout_ticks
        done = done | timed_out
        err = torch.where(timed_out & (err == 0), 8, err)

    rewards = torch.stack([(deviation_r + theta_r) / 2.0 + steer_ev,
                           speed_r + throttle_ev], dim=-1)
    action_done = torch.stack([steer_done, throttle_done], dim=-1).long()
    new_state = state._replace(last_event_t=last_t,
                               begin=torch.zeros_like(state.begin))
    return new_state, rewards, done, action_done, err


# ---------------------------------------------------------------- rendering
#
# Every primitive (route-figure ribbon disks, prop/obstacle/light rects,
# route markers) becomes a row of a shape table painted in order by one
# ops.paint call per canvas: the CUDA kernel on the GPU.

_CONSTANTS = {
    "sky": _SKY, "bright": _BRIGHT, "noise": _NOISE,
    "light": _LIGHT_COLORS, "fig_centre": [_FW / 2.0, _FH / 2.0],
    "white": [255.0] * 3, "ground": [90.0] * 3, "prop": [140.0] * 3,
    "sign": [200.0, 180.0, 40.0], "marker": [200.0] * 3,
    "walker": [40.0, 40.0, 200.0], "vehicle": [200.0, 40.0, 40.0],
    "pole": [60.0] * 3, "no_stop": [-1.0, 0.0, 0.0],
    "speed_only": [1.0, 0.0, 0.0],
}


@functools.lru_cache(maxsize=None)
def _device_constant(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(_CONSTANTS[name], np.float32),
                           device=device)


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    """A constant table on `like`'s device, copied there once."""
    return _device_constant(name, like.device)


def _fig_table(cfg: EnvConfig, bank: RouteBank, state: EnvState,
               scal: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(base [N, 256, 144, 1], shape table [N, S, 8]) of the route figure:
    the 50 m window as a ribbon of disks in the ego frame rotated by
    yaw + pi/2 at 3.66 px/m."""
    w_pts, mask = scal["w"], scal["list_mask"]
    c = torch.deg2rad(state.yaw) + math.pi / 2
    cos_c, sin_c = torch.cos(c)[:, None], torch.sin(c)[:, None]
    rel = w_pts - state.pos[:, None]
    px = torch.stack([
        PIXELS_PER_METER * (rel[..., 0] * cos_c + rel[..., 1] * sin_c),
        PIXELS_PER_METER * (rel[..., 0] * -sin_c + rel[..., 1] * cos_c)],
        dim=-1) + _const("fig_centre", rel)
    a, b = px[:, :-1], px[:, 1:]
    seg_ok = mask[:, :-1] & mask[:, 1:]
    centers = torch.cat([px[:, :1], (a + b) / 2.0, b], dim=1)
    ok = torch.cat([mask[:, :1], seg_ok, seg_ok], dim=1)
    far = torch.full_like(centers[..., 0], -1e6)
    cx = torch.where(ok, centers[..., 0], far)
    cy = torch.where(ok, centers[..., 1], far)
    r2 = torch.full_like(cx, (LINE_WIDTH / 2.0) ** 2)
    rows = paint.disk_rows(cx, cy, r2, _const("white", cx), ok)
    fig = torch.zeros((cx.shape[0], _FH, _FW, 1), device=cx.device)
    return fig, rows.contiguous()


def _render_fig(cfg: EnvConfig, bank: RouteBank, state: EnvState,
                scal: dict) -> torch.Tensor:
    """Route figure [N, 256, 144] (see `_fig_table`)."""
    return paint.paint_shapes(*_fig_table(cfg, bank, state, scal))[..., 0]


def _rgb_table(cfg: EnvConfig, bank: RouteBank, state: EnvState
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(base [N, 144, 256, 3], shape table [N, S, 8]) of the forward
    camera: sky/ground, then roadside props, route markers, obstacles and
    traffic lights as rows."""
    h, w = _H, _W
    horizon = h // 2
    dev = state.pos.device
    weather = state.weather
    sky = _const("sky", weather)[weather]
    n = weather.shape[0]

    yy = torch.arange(h, device=dev)[None, :, None, None]
    img = torch.where(yy < horizon, sky[:, None, None, :],
                      _const("ground", sky))
    img = img.expand(n, h, w, 3).contiguous()

    yawr = torch.deg2rad(state.yaw)
    cos_y, sin_y = torch.cos(yawr)[:, None], torch.sin(yawr)[:, None]

    def to_cam(p):
        rel = p - state.pos[:, None]
        xf = rel[..., 0] * cos_y + rel[..., 1] * sin_y
        yl = -rel[..., 0] * sin_y + rel[..., 1] * cos_y
        return xf, yl

    def project(p, near):
        xf, yl = to_cam(p)
        xf_s = xf.clamp_min(1e-3)
        u = w / 2.0 - _FOCAL * yl / xf_s
        vg = horizon + _FOCAL * _CAM_H / xf_s
        return (xf >= near) & (xf <= 60.0), xf_s, u, vg

    table = []

    # roadside props: interleaved (body, sign-head) rects per prop
    props = bank.props[state.route_id]                    # [N, P, 6]
    if props.shape[1]:
        okp, xf_s, u, vg = project(props[..., :2], 2.0)
        okp = okp & (props[..., 0] < _FAR / 2)
        vt = horizon - _FOCAL * (props[..., 3] - _CAM_H) / xf_s
        r = torch.floor(_FOCAL * props[..., 2] / xf_s).clamp_min(1.0)
        kind, shade = props[..., 4], props[..., 5]
        full = torch.full_like(shade, 1.0)
        col = torch.where(
            (kind == 4.0)[..., None],
            torch.stack([100.0 + 60.0 * shade, 95.0 + 55.0 * shade,
                         90.0 + 50.0 * shade], dim=-1),
            torch.where((kind == 6.0)[..., None],
                        torch.stack([30.0 * full, 110.0 + 70.0 * shade,
                                     35.0 * full], dim=-1),
                        _const("prop", shade)))
        rs = torch.floor(_FOCAL * 0.5 / xf_s).clamp_min(1.0)
        sign_col = _const("sign", shade).expand_as(col)

        def ileave(a, b):
            return torch.stack([a, b], dim=2).reshape(
                (n, 2 * props.shape[1]) + a.shape[2:])

        table.append(paint.rect_rows(
            ileave(u - r, u - rs), ileave(u + r, u + rs),
            ileave(vt, vt - rs), ileave(vg, vt + rs), ileave(col, sign_col),
            ileave(okp, okp & (kind == 5.0))))

    # route markers: every 2nd waypoint of the camera window
    wnd, valid, _ = _route_window(bank, state, cfg.rgb_window)
    vis, xf_s, us, vs = project(wnd[:, ::2], 1.0)
    rs = torch.floor(24.0 / xf_s).clamp_min(1.0)
    on = vis & valid[:, ::2] & (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
    table.append(paint.disk_rows(us, vs, rs * rs, _const("marker", us),
                                 on))

    # obstacle blobs: rect [v - 2r, v) x [u - r, u + r), colour by kind
    ob = state.obstacles
    okd, xf_s, u, v = project(ob[..., :2], 1.0)
    okd = okd & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    r = torch.floor(_FOCAL * ob[..., 2] / xf_s).clamp_min(2.0)
    col = torch.where((ob[..., 3].long() == 1)[..., None],
                      _const("walker", ob),
                      _const("vehicle", ob))
    table.append(paint.rect_rows(u - r, u + r, v - 2 * r, v, col, okd))

    # traffic lights: pole, then the head box on top of it
    lights = bank.lights[state.route_id]                  # [N, L, 5]
    phase = _light_phases(cfg, lights, state.step)
    okl, xf_s, u, vg = project(lights[..., :2], 1.5)
    okl = okl & (lights[..., 0] < _FAR / 2) & (u >= 0) & (u < w)
    v = horizon - _FOCAL * (5.0 - _CAM_H) / xf_s
    r = torch.floor(_FOCAL * 0.6 / xf_s).clamp_min(2.0)
    v = torch.maximum(v, r)           # canvas-top clamp for close lights
    lcol = _const("light", phase)[phase]
    table.append(paint.rect_rows(u - 1.0, u + 1.0, v + r, vg,
                                 _const("pole", u), okl))
    table.append(paint.rect_rows(u - r, u + r, v - r, v + r, lcol, okl))

    return img, torch.cat(table, dim=1).contiguous()


def _render_rgb(cfg: EnvConfig, bank: RouteBank, state: EnvState,
                noise: torch.Tensor) -> torch.Tensor:
    """Forward camera [N, 144, 256, 3] f32 0..255: the painted table of
    `_rgb_table`, then the weather's ground brightness and sensor noise."""
    weather = state.weather
    bright = _const("bright", weather)[weather]
    noise_std = _const("noise", weather)[weather]
    yy = torch.arange(_H, device=weather.device)[None, :, None, None]
    img = paint.paint_shapes(*_rgb_table(cfg, bank, state))
    img = torch.where(yy >= _H // 2, img * bright[:, None, None, None], img)
    return torch.clamp(img + noise * noise_std[:, None, None, None],
                       0.0, 255.0)


# ---------------------------------------------------------------- lifecycle

def draw_reset(cfg: EnvConfig, n_routes: int, n: int,
               gen: torch.Generator, device) -> ResetDraws:
    """The random numbers of `n` episode resets, from `gen`."""
    m = cfg.n_obstacles

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=device)

    draws = dict(
        route=randint(n_routes, (n,)), spawn=randint(1 << 30, (n, m)),
        lateral=uniform((n, m, 2), -3.0, 3.0),
        walker_speed=uniform((n, m), 0.3, 1.2),
        heading=uniform((n, m), 0.0, 2.0 * math.pi),
        cruise=uniform((n, m), *cfg.npc_cruise),
        weather=randint(len(_WNAMES), (n,)))
    # the options' draws come after the others, and only where an option
    # is on, so that a configuration without them draws what it always did
    draws.update(side=None, hazard_speed=None, junction_light=None,
                 junction_speed=None, prio_eps=None, prio_gumbel=None)
    if cfg.n_hazards or cfg.n_junction_hazards:
        draws.update(side=uniform((n, m), 0.0, 1.0) < 0.5,
                     hazard_speed=uniform((n, m), 1.2, 2.0),
                     junction_light=randint(1 << 30, (n, m)),
                     junction_speed=uniform((n, m), *_JUNCTION_HAZARD_SPEED))
    if cfg.priority_routes:
        u = uniform((n, n_routes), 0.0, 1.0)
        tiny = torch.finfo(torch.float32).tiny
        draws.update(prio_eps=uniform((n,), 0.0, 1.0),
                     prio_gumbel=-torch.log(-torch.log(u.clamp_min(tiny))))
    return ResetDraws(**draws)


def draw_step(cfg: EnvConfig, n_routes: int, n: int, gen: torch.Generator,
              device) -> StepDraws:
    """Reset draws plus the camera noise of one step of `n` envs (none
    where the env renders nothing)."""
    shape = (n, _H, _W, 3) if cfg.render else (n, 0, 0, 3)
    return StepDraws(draw_reset(cfg, n_routes, n, gen, device),
                     torch.randn(shape, generator=gen, device=device))


def reset_from_draws(cfg: EnvConfig, bank: RouteBank, draws: ResetDraws,
                     prio: Optional[torch.Tensor] = None,
                     route_ids: Optional[torch.Tensor] = None) -> EnvState:
    """Fresh episodes (SimDrivingEnv._world_reset over the bank): the ego
    at the route start facing along it, NPC vehicles on the route line
    beyond its first quarter, walkers beside it, armed hazards beside the
    route and beside a corner light. `prio` [N, K] is each env's route
    priority table (100 everywhere when None), which the fresh episode
    carries as it is; `route_ids` [N] pins each env to a route (the
    sequential RouteIndexer of the eval protocol)."""
    n = draws.route.shape[0]
    dev = bank.routes.device
    rows = _rows(n, dev)
    if prio is None:
        prio = torch.full((n, bank.routes.shape[0]), 100.0, device=dev)
    if route_ids is not None:
        route_id = route_ids.long()
    elif cfg.priority_routes:
        # jax.random.categorical(logits=prio) is argmax(gumbel + prio)
        soft = torch.argmax(draws.prio_gumbel + prio, dim=1)
        route_id = torch.where(draws.prio_eps > 0.8, draws.route.long(), soft)
    else:
        route_id = draws.route.long()
    route = bank.routes[route_id]
    rlen = bank.route_len[route_id]
    start = route[:, 0]
    d0 = route[rows, torch.clamp_max(rlen - 1, 3)] - start
    yaw = torch.rad2deg(torch.atan2(d0[:, 1], d0[:, 0]))

    m = cfg.n_obstacles
    lo = torch.div(rlen, 4, rounding_mode="floor")
    idx = draws.spawn.long() % torch.clamp_min(rlen - lo, 1)[:, None] \
        + lo[:, None]
    base = route[rows[:, None], idx]
    rank = torch.arange(m, device=dev)
    is_walker = rank >= cfg.n_vehicles
    zero = torch.zeros_like(draws.walker_speed)
    pos = base + torch.where(is_walker[None, :, None], draws.lateral,
                             torch.zeros_like(draws.lateral))
    radius = torch.where(is_walker, 0.4, 1.2).float().expand(n, m)
    kind = is_walker.float().expand(n, m)
    is_vehicle = ~is_walker & (rank < cfg.n_vehicles)
    speed = torch.where(is_walker, draws.walker_speed,
                        torch.where(is_vehicle, draws.cruise, zero))
    heading = draws.heading
    hazard_speed = zero

    # hazards, as (rows, where they are armed, the direction they cross,
    # their latent speed): crossing pedestrians beside a route point and
    # cyclist-class crossers beside a live corner light (with no live
    # light they stay on the far pad, never sprung and never seen)
    n_moving = cfg.n_vehicles + cfg.n_walkers
    hazards = []
    if cfg.n_hazards:
        is_hazard = (rank >= n_moving) & (rank < n_moving + cfg.n_hazards)
        dnext = route[rows[:, None], torch.minimum(idx + 2, rlen[:, None] - 1)
                      ] - base
        hazards.append((is_hazard.expand(n, m), base,
                        dnext / _norm(dnext).clamp_min(1e-6)[..., None],
                        draws.hazard_speed))
    if cfg.n_junction_hazards:
        is_jhazard = (rank >= n_moving + cfg.n_hazards).expand(n, m)
        jl = bank.lights[route_id]                          # [N, L, 5]
        n_live = (jl[..., 0] < _FAR / 2).sum(1)
        l_idx = draws.junction_light.long() % n_live.clamp_min(1)[:, None]
        jl = jl[rows[:, None], l_idx]                       # [N, M, 5]
        hazards.append((is_jhazard, jl[..., :2], jl[..., 3:5],
                        draws.junction_speed))
        kind = torch.where(is_jhazard, 0.0, kind)           # vehicle class
        radius = torch.where(is_jhazard, 0.6, radius)       # cyclist
    if hazards:
        side = torch.where(draws.side, 1.0, -1.0)
    for mask, xy, direction, latent in hazards:
        # _HAZARD_OFFSET m to one side, still until sprung, heading back
        # across the route
        perp = torch.stack([-direction[..., 1], direction[..., 0]], dim=-1)
        pos = torch.where(mask[..., None],
                          xy + (side * _HAZARD_OFFSET)[..., None] * perp,
                          pos)
        heading = torch.where(mask, torch.atan2(-side * perp[..., 1],
                                                -side * perp[..., 0]),
                              heading)
        speed = torch.where(mask, zero, speed)
        hazard_speed = torch.where(mask, latent, hazard_speed)

    real = rank < cfg.n_actors
    pos = torch.where(real[None, :, None], pos, torch.full_like(pos, 1.0e7))
    radius = torch.where(real, radius, zero)
    speed = torch.where(real, speed, zero)
    if hazards:
        hazard_speed = torch.where(real, hazard_speed, zero)
    npc = is_vehicle & real
    npc_s = torch.where(npc, idx.float(), torch.full_like(zero, -1.0))
    npc_cruise = torch.where(npc, draws.cruise, zero)
    obstacles = torch.stack([pos[..., 0], pos[..., 1], radius, kind, speed,
                             heading], dim=-1)
    weather = draws.weather.long() if cfg.randomize_weather else \
        torch.zeros_like(route_id)
    zeros_i = torch.zeros_like(route_id)
    return EnvState(
        route_id=route_id, head=zeros_i, progress=zeros_i, pos=start,
        yaw=yaw, speed=torch.zeros_like(yaw), step=zeros_i,
        last_event_t=zeros_i, begin=torch.ones_like(route_id),
        obstacles=obstacles, hazard_speed=hazard_speed, npc_s=npc_s,
        npc_cruise=npc_cruise, weather=weather,
        turn=torch.zeros((n, 8), device=dev),
        last_red=torch.full_like(route_id, -1),
        stop_state=_const("no_stop", yaw).repeat(n, 1),
        infractions=torch.zeros((n, 2), dtype=torch.long, device=dev),
        route_prio=prio)


def _observe(cfg: EnvConfig, bank: RouteBank, state: EnvState, scal: dict,
             noise: torch.Tensor):
    meas = torch.stack([state.speed / cfg.max_speed, scal["dis"] / 3.0,
                        torch.abs(torch.rad2deg(scal["theta"])) / 90.0], -1)
    if cfg.blind_route:
        meas = meas * _const("speed_only", meas)
    n = meas.shape[0]
    if not cfg.render:
        return (torch.zeros((n, _H, _W, 3), device=meas.device),
                torch.zeros((n, _FH, _FW), device=meas.device), meas)
    return (_render_rgb(cfg, bank, state, noise),
            _render_fig(cfg, bank, state, scal), meas)


def _spring_hazards(cfg: EnvConfig, state: EnvState) -> EnvState:
    """An armed (still) hazard within _HAZARD_TRIGGER m of the ego starts
    its crossing at its latent speed; once moving it never fires again."""
    if not (cfg.n_hazards or cfg.n_junction_hazards):
        return state
    obs = state.obstacles
    d = _norm(obs[..., :2] - state.pos[:, None])
    fire = (d < _HAZARD_TRIGGER) & (state.hazard_speed > 0.0) & \
        (obs[..., 4] == 0.0)
    obs = obs.clone()
    obs[..., 4] = torch.where(fire, state.hazard_speed, obs[..., 4])
    return state._replace(obstacles=obs)


def _select(done: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    # a field both states share (a table no option updates) is kept as is
    return EnvState(*(x if x is y else
                      torch.where(done.view((-1,) + (1,) * (x.dim() - 1)),
                                  x, y) for x, y in zip(a, b)))


def step_envs(cfg: EnvConfig, bank: RouteBank, state: EnvState,
              controls: torch.Tensor, draws: StepDraws
              ) -> Tuple[EnvState, StepOutput]:
    """One tick of every env with auto-reset; controls [N, 3] = steer,
    throttle, brake. A finished env's returned observation is the first
    frame of its fresh episode."""
    stepped, collision = _physics(cfg, bank, _spring_hazards(cfg, state),
                                  controls)
    stepped = _red_light_check(cfg, bank, stepped)
    stepped = _stop_sign_check(cfg, bank, stepped)
    stepped = _plan_pop(cfg, bank, stepped)
    scal = _scalars(cfg, bank, stepped)
    stepped = _update_turn(stepped, scal["w"], scal["list_mask"])
    stepped, completion, route_completed = _update_progress(bank, stepped)
    obstacle = _nearest_obstacle_ahead(stepped)
    route_m = bank.route_len[stepped.route_id].float()
    stepped, rewards, done, action_done, err = _reward_step(
        cfg, stepped, scal, collision, obstacle, route_completed, route_m)

    # curriculum bookkeeping: a finished route's priority becomes
    # 100 - completion%, before the fresh episode draws from the table.
    # Without priority routes nothing reads the table, and it stays as the
    # first reset made it (the JAX env updates it all the same).
    if cfg.priority_routes:
        rid = stepped.route_id[:, None]
        prio = stepped.route_prio.scatter(1, rid, torch.where(
            done[:, None], 100.0 * (1.0 - completion[:, None]),
            stepped.route_prio.gather(1, rid)))
        stepped = stepped._replace(route_prio=prio)
    fresh = _plan_pop(cfg, bank, reset_from_draws(cfg, bank, draws.reset,
                                                  stepped.route_prio))
    if not (cfg.n_hazards or cfg.n_junction_hazards):
        # every state's latent hazard speeds are zero
        fresh = fresh._replace(hazard_speed=stepped.hazard_speed)
    nxt = _select(done, fresh, stepped)
    rgb, fig, meas = _observe(cfg, bank, nxt, _scalars(cfg, bank, nxt),
                              draws.noise)
    return nxt, StepOutput(
        rgb=rgb, route_fig=fig, measurements=meas,
        command=torch.full_like(done, 3, dtype=torch.long), rewards=rewards,
        done=done, action_done=action_done, completion=completion,
        error_code=err, infractions=stepped.infractions)


# ---------------------------------------------------------------- public API

class DrivingEnv:
    """N device envs over a RouteBank (the JAX package's JaxDrivingEnv).

    reset() -> (state, obs dict); step(state, controls) -> (state,
    StepOutput), every field batched [N, ...]. Random numbers come from the
    env's own generator on its device unless the caller passes draws.
    """

    def __init__(self, bank: RouteBank, num_envs: int,
                 config: EnvConfig = EnvConfig(), seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if bank.routes.device.type != self.device.type:
            raise ValueError(f"bank on {bank.routes.device}, env on "
                             f"{self.device}")
        self.bank = bank
        self.num_envs = num_envs
        self.cfg = config
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def draw_step(self) -> StepDraws:
        return draw_step(self.cfg, self.bank.routes.shape[0], self.num_envs,
                         self.gen, self.device)

    def reset(self, draws: Optional[StepDraws] = None):
        """Fresh episodes for all envs and their first observation."""
        return self._reset(draws, None)

    def reset_routes(self, route_ids, draws: Optional[StepDraws] = None):
        """As `reset`, with env i pinned to route `route_ids[i]`."""
        return self._reset(draws, torch.as_tensor(route_ids,
                                                  device=self.device))

    def _reset(self, draws: Optional[StepDraws], route_ids):
        draws = draws if draws is not None else self.draw_step()
        cfg, bank = self.cfg, self.bank
        state = _plan_pop(cfg, bank, reset_from_draws(
            cfg, bank, draws.reset, route_ids=route_ids))
        rgb, fig, meas = _observe(cfg, bank, state,
                                  _scalars(cfg, bank, state), draws.noise)
        command = torch.full((self.num_envs,), 3, dtype=torch.long,
                             device=self.device)
        return state, dict(rgb=rgb, route_fig=fig, measurements=meas,
                           command=command)

    def step(self, state: EnvState, controls: torch.Tensor,
             draws: Optional[StepDraws] = None
             ) -> Tuple[EnvState, StepOutput]:
        with span("env"):
            draws = draws if draws is not None else self.draw_step()
            return step_envs(self.cfg, self.bank, state, controls, draws)
