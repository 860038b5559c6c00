"""Approximate town road grids and the grid-map implementation of the
CARLA map API subset the framework reads (`get_topology`, `get_waypoint`,
`waypoint.next`, `waypoint.get_right_lane`, `get_spawn_points`,
`transform_to_geolocation`).

numpy copy of the JAX package's host `envs/town_maps.py`: CARLA towns
01/02 are axis-aligned street grids whose road lines were clustered from
the reference data's on-road route endpoints and scenario triggers
(TOWN_GRIDS). `town_map("Town01")` builds right-hand roads of
`lanes_per_direction` lanes (one by default) along those lines with
junction connectors where they cross; `trace_dense_route` traces route
keypoints over it, so traced routes turn at the town's junctions, and
`AtRightmostLane` (envs/scenarios.py) asks its waypoints for their right
lane.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from cadre_tpu_torch.envs.map_router import MapRouter

# CARLA geo-reference scale (meters per degree at the towns' latitude)
GPS_SCALE = 111324.60662786

# road centerlines (x lines of vertical roads, y lines of horizontal roads)
TOWN_GRIDS = {
    "Town01": dict(xs=(0.0, 90.5, 157.0, 335.5, 393.0),
                   ys=(0.5, 57.5, 131.0, 197.0, 328.0)),
    "Town02": dict(xs=(-4.5, 45.0, 134.5, 192.0),
                   ys=(107.0, 188.0, 241.5, 304.0)),
}


class _Loc:
    __slots__ = ("x", "y", "z")

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)

    def distance(self, other) -> float:
        return math.dist((self.x, self.y, self.z),
                         (other.x, other.y, other.z))


class _Rot:
    __slots__ = ("pitch", "yaw", "roll")

    def __init__(self, pitch=0.0, yaw=0.0, roll=0.0):
        self.pitch, self.yaw, self.roll = pitch, yaw, roll


class _Tf:
    __slots__ = ("location", "rotation")

    def __init__(self, location, rotation):
        self.location, self.rotation = location, rotation

    def get_forward_vector(self):
        y = math.radians(self.rotation.yaw)
        return _Loc(math.cos(y), math.sin(y), 0.0)


class _Geo:
    __slots__ = ("latitude", "longitude", "altitude")

    def __init__(self, latitude, longitude, altitude=0.0):
        self.latitude, self.longitude, self.altitude = \
            latitude, longitude, altitude


class LaneEdge:
    """Dense directed lane polyline of the grid topology. `road_key` and
    `lane_index` identify the parallel lanes of one directed road (lane 0
    is innermost; higher indices sit further right of travel)."""

    def __init__(self, pts, junction: bool, road_key=None,
                 lane_index: int = 0):
        self.pts = np.asarray(pts, np.float64)
        seg = np.diff(self.pts, axis=0)
        self.cum = np.concatenate(
            [[0.0], np.cumsum(np.hypot(seg[:, 0], seg[:, 1]))])
        self.length = float(self.cum[-1])
        self.junction = junction
        self.road_key = road_key
        self.lane_index = lane_index
        self.successors: List["LaneEdge"] = []

    def point(self, s: float):
        s = min(max(s, 0.0), self.length)
        i = int(np.searchsorted(self.cum, s, side="right")) - 1
        i = min(max(i, 0), len(self.pts) - 2)
        seg = self.pts[i + 1] - self.pts[i]
        n = math.hypot(seg[0], seg[1])
        t = (s - self.cum[i]) / n if n > 1e-9 else 0.0
        pos = self.pts[i] + t * seg
        yaw = math.degrees(math.atan2(seg[1], seg[0]))
        return pos, yaw


class _ShoulderWaypoint:
    """The non-driving lane beyond the outermost driving lane: what
    carla.Waypoint.get_right_lane() returns at the road edge (lane_type
    Shoulder), AtRightmostLane's success condition
    (atomic_trigger_conditions.py:1253-1291)."""

    lane_type = "Shoulder"
    is_junction = False

    def __init__(self, transform):
        self.transform = transform


class GridWaypoint:
    """carla.Waypoint over a LaneEdge at arclength s."""

    lane_type = "Driving"

    def __init__(self, world_map, edge: LaneEdge, s: float):
        self._map = world_map
        self._edge = edge
        self._s = float(s)
        pos, yaw = edge.point(s)
        self.transform = _Tf(_Loc(pos[0], pos[1], 0.0), _Rot(yaw=yaw))
        self.road_id = id(edge) & 0xFFFF
        self.lane_id = -(edge.lane_index + 1)
        self.lane_width = 3.5
        self.is_junction = edge.junction
        self.is_intersection = edge.junction

    def next(self, dist: float) -> List["GridWaypoint"]:
        s2 = self._s + dist
        if s2 <= self._edge.length:
            return [GridWaypoint(self._map, self._edge, s2)]
        return [GridWaypoint(self._map, e2, 0.0)
                for e2 in self._edge.successors]

    def get_right_lane(self):
        """The waypoint one lane right of travel: a parallel driving lane
        where there is one, else the Shoulder beyond the outermost lane;
        None inside junctions (carla.Waypoint API)."""
        e = self._edge
        if e.junction or e.road_key is None:
            return None
        sib = self._map._lane_sibling(e, e.lane_index + 1)
        if sib is not None:
            return GridWaypoint(self._map, sib, min(self._s, sib.length))
        pos, yaw = e.point(self._s)
        h = math.radians(yaw)
        right = np.asarray([-math.sin(h), math.cos(h)])  # left-handed frame
        sp = pos + self.lane_width * right
        return _ShoulderWaypoint(_Tf(_Loc(sp[0], sp[1], 0.0), _Rot(yaw=yaw)))


class GridTownMap:
    """Grid-road town: right-hand roads of `lanes_per_direction` lanes
    along given x/y lines, junction connectors (straight / left / right
    quadratic arcs) where they cross."""

    LANE_OFF = 1.75            # lane-center offset right of travel

    def __init__(self, name: str = "GridTown",
                 xs: Sequence[float] = (0.0, 120.0),
                 ys: Sequence[float] = (0.0, 120.0),
                 half: float = 8.0, ext: float = 50.0,
                 lanes_per_direction: int = 1):
        self.name = name
        self.lanes_per_direction = int(lanes_per_direction)
        self._edges: List[LaneEdge] = []
        self._lane_groups = {}     # road_key -> {lane_index: LaneEdge}
        self.routers = {}          # resolution -> MapRouter

        def lane(p0, p1):
            p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
            d = p1 - p0
            d = d / math.hypot(d[0], d[1])
            # CARLA's frame is left-handed (+y to the right of +x seen from
            # above), so right of travel is (-dy, dx)
            right = np.asarray([-d[1], d[0]])
            key = (round(p0[0], 1), round(p0[1], 1),
                   round(d[0], 3), round(d[1], 3))
            for i in range(self.lanes_per_direction):
                off = self.LANE_OFF * (2 * i + 1) * right
                e = LaneEdge([p0 + off, p1 + off], False,
                             road_key=key, lane_index=i)
                self._edges.append(e)
                self._lane_groups.setdefault(key, {})[i] = e

        xs, ys = sorted(xs), sorted(ys)
        for y in ys:                                   # horizontal roads
            stops = [xs[0] - ext] + [v for x in xs
                                     for v in (x - half, x + half)] \
                + [xs[-1] + ext]
            for a, b in zip(stops[:-1], stops[1:]):
                if b - a < 1.0 or any(abs((a + b) / 2 - x) < half
                                      for x in xs):
                    continue                           # junction interior
                lane((a, y), (b, y))
                lane((b, y), (a, y))
        for x in xs:                                   # vertical roads
            stops = [ys[0] - ext] + [v for y in ys
                                     for v in (y - half, y + half)] \
                + [ys[-1] + ext]
            for a, b in zip(stops[:-1], stops[1:]):
                if b - a < 1.0 or any(abs((a + b) / 2 - y) < half
                                      for y in ys):
                    continue
                lane((x, a), (x, b))
                lane((x, b), (x, a))

        # junction connectors: join every lane ending on a junction edge to
        # every lane starting on it, except the U-turn
        bound = half + self.LANE_OFF * (2 * self.lanes_per_direction - 1) \
            + 0.5
        for cx in xs:
            for cy in ys:
                c = np.asarray([cx, cy])
                ins = [e for e in self._edges if not e.junction and
                       np.abs(e.pts[-1] - c).max() <= bound]
                outs = [e for e in self._edges if not e.junction and
                        np.abs(e.pts[0] - c).max() <= bound]
                for ei in ins:
                    de = ei.pts[-1] - ei.pts[-2]
                    de /= math.hypot(*de)
                    for eo in outs:
                        do = eo.pts[1] - eo.pts[0]
                        do /= math.hypot(*do)
                        if float(de @ do) < -0.9:
                            continue                   # no U-turns
                        self._edges.append(LaneEdge(
                            self._bezier(ei.pts[-1], de, eo.pts[0], do),
                            True))

        # successor wiring by endpoint coincidence
        for e in self._edges:
            e.successors = [e2 for e2 in self._edges if e2 is not e and
                            math.dist(e2.pts[0], e.pts[-1]) < 0.6]

    @staticmethod
    def _bezier(pe, de, px, dx, n: int = 12):
        """Quadratic bezier pe->px with the control point at the ray
        intersection (straight-through degenerates to the chord)."""
        cross = de[0] * dx[1] - de[1] * dx[0]
        if abs(cross) < 1e-6:
            ctrl = (pe + px) / 2.0
        else:
            rel = px - pe
            t = (rel[0] * dx[1] - rel[1] * dx[0]) / cross
            ctrl = pe + t * de
        ts = np.linspace(0.0, 1.0, n)[:, None]
        return (1 - ts) ** 2 * pe + 2 * ts * (1 - ts) * ctrl + ts ** 2 * px

    def _lane_sibling(self, edge: LaneEdge, lane_index: int):
        """The parallel lane of the same directed road, or None."""
        return self._lane_groups.get(edge.road_key, {}).get(lane_index)

    # -- carla.Map api --
    def get_topology(self):
        return [(GridWaypoint(self, e, 0.0), GridWaypoint(self, e, e.length))
                for e in self._edges]

    def get_waypoint(self, location, project_to_road=True, lane_type=None
                     ) -> Optional[GridWaypoint]:
        """The waypoint of the lane point nearest `location`; None off the
        road (beyond 5 m) unless `project_to_road`."""
        p = np.asarray([location.x, location.y])
        best, best_d, best_s = None, float("inf"), 0.0
        for e in self._edges:
            d2 = ((e.pts - p) ** 2).sum(axis=1)
            i = int(np.argmin(d2))
            d = math.sqrt(float(d2[i]))
            if d < best_d:
                best, best_d, best_s = e, d, float(e.cum[i])
        if best is None or (not project_to_road and best_d > 5.0):
            return None
        return GridWaypoint(self, best, best_s)

    def get_spawn_points(self):
        return [GridWaypoint(self, e, e.length / 2).transform
                for e in self._edges if not e.junction][:10]

    def transform_to_geolocation(self, location):
        return _Geo(49.0 - location.y / GPS_SCALE,
                    49.0 + location.x / GPS_SCALE, location.z)


def town_map(name: str, **kwargs) -> GridTownMap:
    """Approximate grid map for a known town name; `kwargs` go to
    GridTownMap (e.g. `lanes_per_direction`)."""
    if name not in TOWN_GRIDS:
        raise KeyError(f"no grid data for {name!r}; known: "
                       f"{sorted(TOWN_GRIDS)}")
    return GridTownMap(name=name, **TOWN_GRIDS[name], **kwargs)


def trace_dense_route(town: GridTownMap, keypoints: np.ndarray,
                      resolution: float = 1.0) -> np.ndarray:
    """Dense [N, 2] polyline through `keypoints` over the map topology,
    one MapRouter per (map, resolution)."""
    if resolution not in town.routers:
        town.routers[resolution] = MapRouter(town, resolution)
    router = town.routers[resolution]
    out: List[np.ndarray] = []
    for a, b in zip(keypoints[:-1], keypoints[1:]):
        seg = router.trace_route(_Loc(a[0], a[1]), _Loc(b[0], b[1]))
        pts = np.asarray([[w.transform.location.x, w.transform.location.y]
                          for w, _ in seg])
        if len(out) and len(pts):
            pts = pts[1:]
        out.append(pts)
    return np.concatenate([p for p in out if len(p)], axis=0)


def write_lane_routes(path: str, n_routes: int, n_short: int = 0) -> str:
    """Write a route XML of `n_routes` two-keypoint routes on the Town01
    lane centres to `path` and return it; lane centres are the
    TOWN_GRIDS road lines offset 1.75 m right of travel (CARLA's frame is
    left-handed: right of +x is +y). The first `n_routes - n_short` start
    on a horizontal road and end on a vertical one, between junctions, so
    that every trace turns; the last `n_short` run 12 m straight along one
    lane, so that an episode on them ends within 154 steps, its route
    timeout at the default 0.1 s step."""
    xs, ys = TOWN_GRIDS["Town01"]["xs"], TOWN_GRIDS["Town01"]["ys"]
    rng = np.random.RandomState(0)
    keypoints = []
    for i in range(n_routes):
        j, y = rng.randint(len(xs) - 1), ys[rng.randint(len(ys))]
        x0 = rng.uniform(xs[j] + 15.0, xs[j + 1] - 15.0)
        east = rng.rand() < 0.5
        y0 = y + (1.75 if east else -1.75)
        if i >= n_routes - n_short:
            keypoints.append(((x0, y0), (x0 + (12.0 if east else -12.0), y0)))
            continue
        k, x = rng.randint(len(ys) - 1), xs[rng.randint(len(xs))]
        y1 = rng.uniform(ys[k] + 15.0, ys[k + 1] - 15.0)
        x1 = x + (-1.75 if rng.rand() < 0.5 else 1.75)    # +y / -y bound
        keypoints.append(((x0, y0), (x1, y1)))
    lines = ["<routes>"]
    for i, pts in enumerate(keypoints):
        lines.append(f'  <route id="{i}" map="Town01">')
        lines += [f'    <waypoint x="{x:.2f}" y="{y:.2f}" z="0.0" />'
                  for x, y in pts]
        lines.append("  </route>")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["</routes>", ""]))
    return path
