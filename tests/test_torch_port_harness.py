"""The port's CARLA-free scenario harness against the JAX package, on the
CPU: the rest of GridTownMap and AtRightmostLane, the OpenSCENARIO reader,
the actor controllers, the autonomous-agent container and its agents, the
recorder and the scenario report.

Each case is a twin of one of the JAX package's tests
(tests/test_rightmost_lane.py, test_openscenario.py,
test_actor_controls.py, test_autoagents.py, test_recorder_and_misc.py,
test_result_writer.py): it runs the JAX module and the port's on the same
inputs, keeps the JAX test's own assertions on each, and holds the two
packages' outputs (positions, speeds, headings, controls, parsed specs,
report text) exactly equal.
"""
import hashlib
import math
import random
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from tabulate import tabulate

import cadre_tpu.envs.actor_controls as j_ac
import cadre_tpu.envs.autoagents as j_agents
import cadre_tpu.envs.autonomous_agent as j_auto
import cadre_tpu.envs.criteria as j_crit
import cadre_tpu.envs.expert as j_expert
import cadre_tpu.envs.openscenario as j_osc
import cadre_tpu.envs.recorder as j_rec
import cadre_tpu.envs.result_writer as j_rw
import cadre_tpu.envs.scenarios as j_scen
import cadre_tpu.envs.sim_env as j_sim
import cadre_tpu.envs.town_maps as j_maps
import cadre_tpu_torch.envs.actor_controls as p_ac
import cadre_tpu_torch.envs.autoagents as p_agents
import cadre_tpu_torch.envs.autonomous_agent as p_auto
import cadre_tpu_torch.envs.criteria as p_crit
import cadre_tpu_torch.envs.expert as p_expert
import cadre_tpu_torch.envs.openscenario as p_osc
import cadre_tpu_torch.envs.recorder as p_rec
import cadre_tpu_torch.envs.result_writer as p_rw
import cadre_tpu_torch.envs.scenarios as p_scen
import cadre_tpu_torch.envs.sim_env as p_sim
import cadre_tpu_torch.envs.town_maps as p_maps
from cadre_tpu.envs.carla_env import DEFAULT_SENSORS
from cadre_tpu_torch.envs.route_parser import parse_routes_file
from cadre_tpu_torch.envs.torch_env import make_route_bank
from test_openscenario import XOSC, XOSC_EXT

PKGS = {
    "jax": types.SimpleNamespace(
        name="cadre_tpu", ac=j_ac, agents=j_agents, auto=j_auto,
        crit=j_crit, expert=j_expert, osc=j_osc, rec=j_rec, rw=j_rw,
        scen=j_scen, sim=j_sim, maps=j_maps),
    "port": types.SimpleNamespace(
        name="cadre_tpu_torch", ac=p_ac, agents=p_agents, auto=p_auto,
        crit=p_crit, expert=p_expert, osc=p_osc, rec=p_rec, rw=p_rw,
        scen=p_scen, sim=p_sim, maps=p_maps),
}


def _twin(case, *args):
    """`case(pkg, *args)` for the JAX package and the port: equal outputs."""
    ref = case(PKGS["jax"], *args)
    ours = case(PKGS["port"], *args)
    assert ours == ref
    return ours


def _loc(x, y):
    return type("L", (), dict(x=float(x), y=float(y), z=0.0))()


class _PosEnv:
    def __init__(self, pos):
        self._pos = np.asarray(pos, float)


# ------------------------------------------------------------------ maps

def _wp(w):
    """A waypoint as plain numbers (None for none)."""
    if w is None:
        return None
    t = w.transform
    return (type(w).__name__, w.lane_type, t.location.x, t.location.y,
            t.rotation.yaw, bool(w.is_junction), getattr(w, "lane_id", None))


def _map_record(m):
    """Every edge's points, junction flag, lane and successors (by
    index), and for 40 edges spread over the map the waypoint nearest the
    edge's middle point with its right lane and that lane's right lane."""
    index = {id(e): i for i, e in enumerate(m._edges)}
    edges = [(e.pts.tolist(), e.junction, e.lane_index, e.road_key,
              [index[id(s)] for s in e.successors]) for e in m._edges]
    lanes = []
    for e in m._edges[::max(1, len(m._edges) // 40)]:
        w = m.get_waypoint(_loc(*e.pts[len(e.pts) // 2]))
        right = w.get_right_lane()
        lanes.append((_wp(w), _wp(right), _wp(
            right.get_right_lane() if isinstance(right, type(w)) else None)))
    spawns = [(t.location.x, t.location.y, t.rotation.yaw)
              for t in m.get_spawn_points()]
    geo = m.transform_to_geolocation(_loc(120.5, -33.25))
    return edges, lanes, spawns, (geo.latitude, geo.longitude, geo.altitude)


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_grid_town_map_equals_jax(lanes):
    """GridTownMap at 1-3 lanes per direction, on its own grid and (at
    one and two lanes) on Town02: topology, waypoints, right lanes, spawn
    points and geolocation equal to the JAX map's; off-road queries with
    and without project_to_road."""
    def case(pkg):
        out = [_map_record(pkg.maps.GridTownMap(
            xs=(0.0, 200.0), ys=(0.0, 200.0), lanes_per_direction=lanes))]
        if lanes > 2:          # Town02's 1,968 edges take seconds to wire
            return out
        town = pkg.maps.town_map("Town02", lanes_per_direction=lanes)
        out.append(_map_record(town))
        out.append([_wp(town.get_waypoint(_loc(x, 500.0), project_to_road=p))
                    for x in (-4.5, 60.0) for p in (True, False)])
        return out

    _twin(case)


# the pre-change port's one-lane Town01/Town02 edges, its traces of
# write_lane_routes(25, 3) over Town01 and the route bank made from them
ONE_LANE_SHA256 = dict(
    edges="4899283375030c3d7da1f972072cf75de1846a9d943fd9e4d5bc561ce42bc067",
    traces="5710ed2b28e39259fd22b9eaadd916f86915905b200651bf5815e033a604f1c6",
    bank="630c2ea136389298754dbf0740363496cce5468e30d0a9ee6e7d77a28dea34a4")


def test_one_lane_traces_are_unchanged(tmp_path):
    """With one lane per direction, the maps, the dense traces and the
    route bank are bit for bit those the port made before the lanes
    argument came (their SHA-256), and the traces equal the JAX map's."""
    h = hashlib.sha256()
    for name in ("Town01", "Town02"):
        for e in p_maps.town_map(name)._edges:
            h.update(np.ascontiguousarray(e.pts).tobytes())
    assert h.hexdigest() == ONE_LANE_SHA256["edges"]
    path = p_maps.write_lane_routes(str(tmp_path / "routes.xml"), 25, 3)
    ours, ref = p_maps.town_map("Town01"), j_maps.town_map("Town01")
    h = hashlib.sha256()
    for route in parse_routes_file(path):
        kp = np.asarray([w.xy for w in route.trajectory])
        trace = p_maps.trace_dense_route(ours, kp)
        np.testing.assert_array_equal(trace,
                                      j_maps.trace_dense_route(ref, kp))
        h.update(trace.tobytes())
    assert h.hexdigest() == ONE_LANE_SHA256["traces"]
    bank = make_route_bank(25, seed=0, routes_file=path, map_name="Town01",
                           device="cpu")
    h = hashlib.sha256()
    for f in bank._fields:
        h.update(getattr(bank, f).numpy().tobytes())
    assert h.hexdigest() == ONE_LANE_SHA256["bank"]


def _rightmost_two_lanes(pkg):
    m = pkg.maps.GridTownMap(xs=(0.0, 200.0), ys=(0.0, 200.0),
                             lanes_per_direction=2)
    inner = m.get_waypoint(_loc(60.0, 1.75))
    assert abs(inner.transform.location.y - 1.75) < 0.3
    right = inner.get_right_lane()
    assert right.lane_type == "Driving"
    assert abs(right.transform.location.y - 5.25) < 0.3
    shoulder = right.get_right_lane()
    assert shoulder.lane_type == "Shoulder"
    assert abs(shoulder.transform.location.y - 8.75) < 0.5
    return [_wp(inner), _wp(right), _wp(shoulder)]


def _rightmost_condition(pkg):
    m = pkg.maps.GridTownMap(xs=(0.0, 200.0), ys=(0.0, 200.0),
                             lanes_per_direction=2)
    cond = pkg.scen.AtRightmostLane("ego", m)
    out = [cond(_PosEnv((60.0, 1.75))), cond(_PosEnv((60.0, 5.25)))]
    assert out == [False, True]
    return out


def _rightmost_single_lane(pkg):
    cond = pkg.scen.AtRightmostLane("ego", pkg.maps.GridTownMap(
        xs=(0.0, 200.0), ys=(0.0, 200.0)))
    assert cond(_PosEnv((60.0, 1.75))) is True
    ob = pkg.sim.SimObstacle(pos=np.asarray([1.75, 60.0]))
    return [cond(_PosEnv((60.0, 1.75))),
            pkg.scen.AtRightmostLane(ob, cond._map)(_PosEnv((0.0, 0.0))),
            cond(_PosEnv((0.5, 0.5)))]


def _rightmost_junction(pkg):
    m = pkg.maps.GridTownMap(xs=(0.0, 200.0), ys=(0.0, 200.0),
                             lanes_per_direction=2)
    wp = m.get_waypoint(_loc(0.5, 0.5))
    if wp.is_junction:
        assert wp.get_right_lane() is None
    return _wp(wp)


def _rightmost_default_topology(pkg):
    m1 = pkg.maps.GridTownMap()
    n = len([e for e in m1._edges if not e.junction])
    assert n == len([e for e in pkg.maps.GridTownMap(
        lanes_per_direction=1)._edges if not e.junction])
    wp = m1.get_waypoint(_loc(60.0, 1.75))
    assert wp.get_right_lane().lane_type == "Shoulder"
    return n, _wp(wp.get_right_lane())


RIGHTMOST = {f.__name__[11:]: f for f in (
    _rightmost_two_lanes, _rightmost_condition, _rightmost_single_lane,
    _rightmost_junction, _rightmost_default_topology)}


@pytest.mark.parametrize("case", list(RIGHTMOST))
def test_rightmost_lane_twin(case):
    """tests/test_rightmost_lane.py on both packages' maps and
    conditions."""
    _twin(RIGHTMOST[case])


# ----------------------------------------------------------- openscenario

def _event_spec(ev):
    def plain(x):
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, list):
            return [plain(v) for v in x]
        return x

    return plain({k: getattr(ev, k) for k in (
        "entity", "action", "value", "at_time", "at_pos", "tolerance",
        "name", "cond", "stop", "extra", "act_cond")})


def _cfg_record(cfg, pkg):
    """The parsed entities and event specs; a controller module's package
    reads `{pkg}`."""
    ents = {n: (e.kind, None if e.pos is None else e.pos.tolist(),
                e.heading, e.speed) for n, e in cfg.entities.items()}
    events = [_event_spec(e) for e in cfg.events]
    for ev in events:
        module = (ev["extra"] or {}).get("module")
        if module:
            ev["extra"]["module"] = module.replace(pkg.name + ".", "{pkg}.",
                                                   1)
    return ents, events


class _StubEnv:
    """The JAX tests' bare env: a tick length, an ego pose and speed, the
    scenario actors."""

    def __init__(self):
        self.dt = 0.1
        self._pos = np.zeros(2)
        self._yaw = 0.0
        self._speed = 0.0
        self._obstacles = []


def _actor_state(ob):
    ctl = getattr(ob, "_control", None)
    return (ob.pos.tolist(), float(ob.speed), float(ob.heading),
            bool(ob.managed), ob.kind,
            None if ctl is None else (type(ctl.controller).__name__,
                                      ctl.controller.target_speed))


STOP = """<?xml version="1.0"?>
<OpenSCENARIO>
  <Entities>
    <ScenarioObject name="hero"><Vehicle name="ego"/></ScenarioObject>
    <ScenarioObject name="adversary"><Vehicle name="car"/></ScenarioObject>
  </Entities>
  <Storyboard>
    <Init><Actions><Private entityRef="adversary">
      <PrivateAction><TeleportAction><Position>
        <WorldPosition x="10" y="0" z="0" h="0"/>
      </Position></TeleportAction></PrivateAction>
    </Private></Actions></Init>
    <Story name="s"><Act name="a"><ManeuverGroup name="mg">
      <Actors><EntityRef entityRef="adversary"/></Actors>
      <Maneuver name="m"><Event name="swerve" priority="overwrite">
        <Action name="lane"><PrivateAction><LateralAction><LaneChangeAction>
          <LaneChangeTarget><RelativeTargetLane entityRef="adversary" value="1"/></LaneChangeTarget>
        </LaneChangeAction></LateralAction></PrivateAction></Action>
        <StartTrigger><ConditionGroup><Condition name="t"><ByValueCondition>
          <SimulationTimeCondition value="0.1" rule="greaterThan"/>
        </ByValueCondition></Condition></ConditionGroup></StartTrigger>
        <StopTrigger><ConditionGroup><Condition name="halt">
          <ByEntityCondition>
            <TriggeringEntities rule="any"><EntityRef entityRef="adversary"/></TriggeringEntities>
            <EntityCondition><StandStillCondition duration="0.2"/></EntityCondition>
          </ByEntityCondition>
        </Condition></ConditionGroup></StopTrigger>
      </Event></Maneuver>
    </ManeuverGroup></Act></Story>
  </Storyboard>
</OpenSCENARIO>
"""


def _speed_event(name, value, condition):
    return f"""
        <Event name="{name}" priority="overwrite">
          <Action name="a_{name}"><PrivateAction><LongitudinalAction><SpeedAction>
            <SpeedActionDynamics dynamicsShape="step"/>
            <SpeedActionTarget><AbsoluteTargetSpeed value="{value}"/></SpeedActionTarget>
          </SpeedAction></LongitudinalAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="c_{name}">
            {condition}
          </Condition></ConditionGroup></StartTrigger>
        </Event>"""


def _by_npc(cond):
    return ("<ByEntityCondition><TriggeringEntities rule=\"any\"><EntityRef "
            f"entityRef=\"npc\"/></TriggeringEntities><EntityCondition>{cond}"
            "</EntityCondition></ByEntityCondition>")


def _npc_doc(maneuver, x=10.0, y=0.0, h=0.0, speed=None, act_trigger=""):
    init_speed = "" if speed is None else f"""
        <PrivateAction><LongitudinalAction><SpeedAction>
          <SpeedActionDynamics dynamicsShape="step"/>
          <SpeedActionTarget><AbsoluteTargetSpeed value="{speed}"/></SpeedActionTarget>
        </SpeedAction></LongitudinalAction></PrivateAction>"""
    return f"""<?xml version="1.0"?>
<OpenSCENARIO>
  <Entities>
    <ScenarioObject name="hero"><Vehicle name="ego"/></ScenarioObject>
    <ScenarioObject name="npc"><Vehicle name="car"/></ScenarioObject>
  </Entities>
  <Storyboard>
    <Init><Actions><Private entityRef="npc">
      <PrivateAction><TeleportAction><Position>
        <WorldPosition x="{x}" y="{y}" h="{h}"/>
      </Position></TeleportAction></PrivateAction>{init_speed}
    </Private></Actions></Init>
    <Story name="s"><Act name="a"><ManeuverGroup name="mg">
      <Actors><EntityRef entityRef="npc"/></Actors>
      <Maneuver name="m">{maneuver}
      </Maneuver>
    </ManeuverGroup>{act_trigger}</Act></Story>
  </Storyboard>
</OpenSCENARIO>
"""


AT_ZERO = ("<ByValueCondition><SimulationTimeCondition value=\"0.0\" "
           "rule=\"greaterThan\"/></ByValueCondition>")
CONDS = _npc_doc("".join(_speed_event(*e) for e in (
    ("e_headway", 3, _by_npc('<TimeHeadwayCondition entityRef="hero" '
                             'value="2.0" rule="lessThan"/>')),
    ("e_relspeed", 4, _by_npc('<RelativeSpeedCondition entityRef="hero" '
                              'value="1.0" rule="greaterThan"/>')),
    ("e_accel", 5, _by_npc('<AccelerationCondition value="3.0" '
                           'rule="greaterThan"/>')),
    ("e_coll", 0, _by_npc('<CollisionCondition><EntityRef entityRef="hero"'
                          '/></CollisionCondition>')),
    ("e_offroad", 1, _by_npc('<OffroadCondition duration="1"/>')),
    ("e_signal", 2, '<ByValueCondition><TrafficSignalCondition name="id=0" '
                    'state="green"/></ByValueCondition>'),
    ("e_tod", 2, '<ByValueCondition><TimeOfDayCondition dateTime='
                 '"2020-01-01T00:00:05" rule="greaterThan"/>'
                 '</ByValueCondition>'),
    ("e_user", 2, '<ByValueCondition><UserDefinedValueCondition name="go" '
                  'value="true" rule="equalTo"/></ByValueCondition>'))))
ROUTE = _npc_doc(f"""
        <Event name="route" priority="overwrite">
          <Action name="r"><PrivateAction><RoutingAction>
            <AssignRouteAction><Route name="rt">
              <Waypoint routeStrategy="shortest"><Position>
                <WorldPosition x="10" y="5"/></Position></Waypoint>
              <Waypoint routeStrategy="shortest"><Position>
                <WorldPosition x="10" y="15"/></Position></Waypoint>
            </Route></AssignRouteAction>
          </RoutingAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="t">{AT_ZERO}
          </Condition></ConditionGroup></StartTrigger>
        </Event>
        <Event name="acquire" priority="parallel">
          <Action name="q"><PrivateAction><RoutingAction>
            <AcquirePositionAction><Position>
              <WorldPosition x="-20" y="15"/></Position>
            </AcquirePositionAction>
          </RoutingAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="d">{_by_npc(
              '<TraveledDistanceCondition value="12"/>')}
          </Condition></ConditionGroup></StartTrigger>
        </Event>""", x=0.0, y=5.0, speed=4)
REL = _npc_doc(f"""
        <Event name="tele_rel" priority="overwrite">
          <Action name="t1"><PrivateAction><TeleportAction><Position>
            <RelativeObjectPosition entityRef="npc" dx="5" dy="0"/>
          </Position></TeleportAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="t">{AT_ZERO}
          </Condition></ConditionGroup></StartTrigger>
        </Event>
        <Event name="tele_world" priority="overwrite">
          <Action name="t2"><PrivateAction><TeleportAction><Position>
            <RelativeWorldPosition entityRef="npc" dx="-3" dy="2"/>
          </Position></TeleportAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="e"><ByValueCondition>
            <StoryboardElementStateCondition storyboardElementType="event"
              storyboardElementRef="tele_rel" state="completeState"/>
          </ByValueCondition></Condition></ConditionGroup></StartTrigger>
        </Event>""", h=1.5707963, act_trigger="""
      <StartTrigger><ConditionGroup><Condition name="actstart">
        <ByValueCondition><SimulationTimeCondition value="0.5" rule="greaterThan"/></ByValueCondition>
      </Condition></ConditionGroup></StartTrigger>""")
DYN = _npc_doc(f"""
        <Event name="bounded" priority="overwrite">
          <Action name="sp"><PrivateAction><LongitudinalAction><SpeedAction>
            <SpeedActionDynamics dynamicsShape="step" dynamicsDimension="distance" value="8"/>
            <SpeedActionTarget><AbsoluteTargetSpeed value="4"/></SpeedActionTarget>
          </SpeedAction></LongitudinalAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="t">{AT_ZERO}
          </Condition></ConditionGroup></StartTrigger>
        </Event>
        <Event name="timed" priority="parallel">
          <Action name="sp2"><PrivateAction><LongitudinalAction><SpeedAction>
            <SpeedActionDynamics dynamicsShape="step" dynamicsDimension="time" value="1.5"/>
            <SpeedActionTarget><RelativeTargetSpeed entityRef="hero" value="3"/></SpeedActionTarget>
          </SpeedAction></LongitudinalAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="s">{_by_npc(
              '<StandStillCondition duration="0.5"/>')}
          </Condition></ConditionGroup></StartTrigger>
        </Event>""", x=0.0)


def _controller(module, speed):
    return f"""
        <Event name="ctrl" priority="overwrite">
          <Action name="assign"><PrivateAction><ControllerAction>
            <AssignControllerAction>
              <Controller name="long"><Properties>
                <Property name="module" value="{module}"/>
                <Property name="target_speed" value="{speed}"/>
              </Properties></Controller>
            </AssignControllerAction>
          </ControllerAction></PrivateAction></Action>
          <StartTrigger><ConditionGroup><Condition name="t">{AT_ZERO}
          </Condition></ConditionGroup></StartTrigger>
        </Event>"""


CATALOG = """<?xml version="1.0"?>
<OpenSCENARIO>
  <Catalog name="VehicleCatalog">
    <Vehicle name="sedan" vehicleCategory="car"/>
    <Pedestrian name="jaywalker"/>
  </Catalog>
  <Catalog name="ControllerCatalog">
    <Controller name="longctrl">
      <ParameterDeclarations>
        <ParameterDeclaration name="Speed" parameterType="double" value="2.0"/>
      </ParameterDeclarations>
      <Properties>
        <Property name="module"
 value="{pkg}.envs.actor_controls.VehicleLongitudinalControl"/>
        <Property name="target_speed" value="$Speed"/>
      </Properties>
    </Controller>
  </Catalog>
</OpenSCENARIO>
"""
CATALOG_MAIN = """<?xml version="1.0"?>
<OpenSCENARIO>
  <CatalogLocations>
    <VehicleCatalog><Directory path="catalogs"/></VehicleCatalog>
    <ControllerCatalog><Directory path="catalogs"/></ControllerCatalog>
  </CatalogLocations>
  <Entities>
    <ScenarioObject name="hero"><Vehicle name="ego"/></ScenarioObject>
    <ScenarioObject name="npc">
      <CatalogReference catalogName="VehicleCatalog" entryName="sedan"/>
    </ScenarioObject>
    <ScenarioObject name="walker1">
      <CatalogReference catalogName="VehicleCatalog" entryName="jaywalker"/>
    </ScenarioObject>
  </Entities>
  <Storyboard>
    <Init><Actions><Private entityRef="npc">
      <PrivateAction><TeleportAction><Position>
        <WorldPosition x="12" y="0" h="0"/>
      </Position></TeleportAction></PrivateAction>
    </Private></Actions></Init>
    <Story name="s"><Act name="a"><ManeuverGroup name="mg">
      <Actors><EntityRef entityRef="npc"/></Actors>
      <Maneuver name="m"><Event name="ctrl" priority="overwrite">
        <Action name="assign"><PrivateAction><ControllerAction>
          <AssignControllerAction>
            <CatalogReference catalogName="ControllerCatalog"
                              entryName="longctrl">
              <ParameterAssignments>
                <ParameterAssignment parameterRef="Speed" value="7.5"/>
              </ParameterAssignments>
            </CatalogReference>
          </AssignControllerAction>
        </ControllerAction></PrivateAction></Action>
        <StartTrigger><ConditionGroup><Condition name="t">
          <ByValueCondition>
            <SimulationTimeCondition value="0.0" rule="greaterThan"/>
          </ByValueCondition>
        </Condition></ConditionGroup></StartTrigger>
      </Event></Maneuver>
    </ManeuverGroup></Act></Story>
  </Storyboard>
</OpenSCENARIO>
"""

# name -> (document (`{pkg}` names the package), ticks, {tick: env edits})
XOSC_CASES = {
    "speed_and_lane_change": (XOSC, 45, {10: dict(_pos=[4.5, 0.0])}),
    "parameters_and_chaining": (XOSC_EXT, 11, {5: dict(_speed=5.0)}),
    "stop_trigger": (STOP, 30, {}),
    "condition_long_tail": (CONDS, 60, {20: dict(_pos=[9.0, 0.0],
                                                 _speed=6.0)}),
    "routing": (ROUTE, 400, {}),
    "relative_positions_and_act_trigger": (REL, 14, {}),
    "speed_action_dynamics": (DYN, 90, {}),
    "assign_controller": (_npc_doc(_controller(
        "{pkg}.envs.actor_controls.VehicleLongitudinalControl", 5.0)), 12,
        {}),
    "catalog_reference": (CATALOG_MAIN, 12, {}),
}


def _xosc_run(pkg, name, tmp_path):
    doc, ticks, edits = XOSC_CASES[name]
    d = tmp_path / pkg.name
    (d / "catalogs").mkdir(parents=True)
    (d / "catalogs" / "cat.xosc").write_text(CATALOG.replace("{pkg}",
                                                             pkg.name))
    path = d / "case.xosc"
    path.write_text(doc.replace("{pkg}", pkg.name))
    cfg = pkg.osc.load_openscenario(str(path))
    env = _StubEnv()
    mgr = pkg.osc.build_manager(cfg, env)
    trace = []
    for t in range(ticks):
        for k, v in edits.get(t, {}).items():
            setattr(env, k, np.asarray(v, float) if isinstance(v, list)
                    else v)
        mgr.tick(env)
        trace.append([_actor_state(ob) for ob in env._obstacles])
    board = sorted(getattr(env, "blackboard", {}).items())
    return _cfg_record(cfg, pkg), trace, board


@pytest.mark.parametrize("name", list(XOSC_CASES))
def test_openscenario_twin(name, tmp_path):
    """One storyboard read and run by both packages' load_openscenario and
    build_manager on the JAX tests' bare env: the parsed entities and
    event specs, every actor's pose, speed, ownership and controller on
    every tick, and the blackboard equal; then the JAX tests' checks."""
    (cfg, trace, board) = _twin(_xosc_run, name, tmp_path)
    ents, events = cfg
    last = trace[-1]
    if name == "speed_and_lane_change":
        assert ents["adversary"][1:] == ([20.0, 0.0], 0.0, 2.0)
        assert ents["crosser"][0] == "walker"
        assert trace[3][0][1] == 2.0 and trace[4][0][1] == 8.0
        np.testing.assert_allclose(last[0][0][1], 3.5, atol=1e-6)
    elif name == "parameters_and_chaining":
        assert ents["adversary"][1] == [25.0, 0.0]
        assert trace[4][0][1] == 3.0 and last[0][0] == [100.0, 7.0]
        assert dict(board)["xosc:teleport_after:done"]
    elif name == "stop_trigger":
        assert events[0]["stop"]["type"] == "standstill"
        assert abs(last[0][0][1]) < 3.0
    elif name == "condition_long_tail":
        specs = {e["name"]: e["cond"] for e in events}
        assert specs["e_headway"] == dict(type="headway", entity="npc",
                                          other="hero", value=2.0)
        assert specs["e_tod"] == dict(type="time_of_day", value=5.0)
        assert specs["e_user"] == dict(type="user_value", name="go",
                                       value="true")
    elif name == "routing":
        assert len(events[0]["extra"]["waypoints"]) == 2
        assert last[0][0][1] > 10.0
    elif name == "relative_positions_and_act_trigger":
        assert np.allclose(events[0]["extra"]["pos"], [10.0, 5.0],
                           atol=1e-4)
        assert trace[2][0][0][1] < 1.0
    elif name == "speed_action_dynamics":
        assert events[0]["extra"]["distance"] == 8.0
        assert 7.0 <= trace[59][0][0][0] <= 9.5
    elif name == "assign_controller":
        assert last[0][5] == ("VehicleLongitudinalControl", 5.0)
        assert last[0][0][0] > 10.0
    elif name == "catalog_reference":
        assert ents["walker1"][0] == "walker"
        assert events[0]["extra"]["args"]["target_speed"] == "7.5"


# ---------------------------------------------------------- actor controls

class _CtlEnv:
    dt = 0.1

    def __init__(self, obstacles=(), lights=()):
        self._obstacles = list(obstacles)
        self._lights = list(lights)


def _ob(pkg, kind="vehicle", pos=(0.0, 0.0), heading=0.0, speed=0.0):
    return pkg.sim.SimObstacle(pos=np.asarray(pos, float), kind=kind,
                               heading=heading, speed=speed)


def _state(ob):
    return (ob.pos.tolist(), float(ob.speed), float(ob.heading))


def _ctl_dispatch(pkg):
    ac = pkg.ac
    names = [type(ac.ActorControl(_ob(pkg, k)).controller).__name__
             for k in ("walker", "vehicle", "static", "cyclist")]
    assert names[:3] == ["PedestrianControl", "NpcVehicleControl",
                         "ExternalControl"]
    for cls, kind in ((ac.PedestrianControl, "vehicle"),
                      (ac.NpcVehicleControl, "walker")):
        with pytest.raises(RuntimeError):
            cls(_ob(pkg, kind))
    return names


def _ctl_pedestrian(pkg):
    env, ob = _CtlEnv(), _ob(pkg, "walker")
    c = pkg.ac.PedestrianControl(ob)
    c.update_target_speed(2.0)
    c.update_waypoints([[1.0, 0.0], [1.0, 1.0]])
    out = []
    for _ in range(40):
        c.run_step(env)
        out.append(_state(ob))
        if c.check_reached_waypoint_goal():
            break
    assert c.check_reached_waypoint_goal()
    c.run_step(env)
    assert ob.speed == 0.0
    return out


def _ctl_npc_vehicle(pkg):
    env, ob = _CtlEnv(), _ob(pkg, "vehicle")
    c = pkg.ac.NpcVehicleControl(ob)
    c.update_target_speed(5.0)
    c.update_waypoints([[0.0, 20.0]])
    c.run_step(env)
    assert 0.0 < ob.heading <= c.MAX_YAW_RATE * env.dt + 1e-9
    out = [_state(ob)]
    for _ in range(200):
        c.run_step(env)
        out.append(_state(ob))
        if c.check_reached_waypoint_goal():
            break
    c.run_step(env)
    assert ob.speed == 0.0
    ob2 = _ob(pkg, "vehicle")
    c2 = pkg.ac.NpcVehicleControl(ob2)
    c2.update_target_speed(7.0)
    c2.set_init_speed()
    c2.run_step(env)
    assert ob2.speed == 7.0
    return out


def _ctl_simple_vehicle(pkg):
    class _Light:
        state = "red"
        pos = (5.0, 0.0)

    ob = _ob(pkg, "vehicle")
    blocker = _ob(pkg, "vehicle", pos=(4.0, 0.0))
    env = _CtlEnv([ob, blocker])
    c = pkg.ac.SimpleVehicleControl(ob, args={
        "max_acceleration": "2.0", "consider_obstacles": "true",
        "proximity_threshold": "10.0"})
    c.update_target_speed(8.0)
    c.run_step(env)
    assert ob.speed == 0.0
    blocker.pos = np.array([0.0, 50.0])
    out = []
    for _ in range(10):
        c.run_step(env)
        out.append(_state(ob))
    assert out[0][1] == pytest.approx(2.0 * env.dt)
    light = _Light()
    env = _CtlEnv(lights=[light])
    ob = _ob(pkg, "vehicle", speed=3.0)
    c = pkg.ac.SimpleVehicleControl(ob, args={
        "consider_trafficlights": "true", "max_deceleration": "100"})
    c.update_target_speed(8.0)
    c.run_step(env)
    assert ob.speed == 0.0
    light.state = "green"
    c.run_step(env)
    assert ob.speed > 0.0
    return out + [_state(ob)]


def _ctl_longitudinal(pkg):
    env = _CtlEnv()
    ob = _ob(pkg, "vehicle", heading=math.pi / 2)
    c = pkg.ac.VehicleLongitudinalControl(ob)
    c.update_target_speed(4.0)
    c.update_waypoints([[100.0, 0.0]])
    out = []
    for _ in range(10):
        c.run_step(env)
        out.append(_state(ob))
    assert ob.heading == math.pi / 2
    np.testing.assert_allclose(ob.pos, [0.0, 4.0], atol=1e-6)
    return out


def _ctl_facade_and_modules(pkg):
    ac = pkg.ac.ActorControl(_ob(pkg, "vehicle"))
    ac.update_target_speed(5.0, start_time=1.0)
    ac.update_target_speed(9.0, start_time=1.0)
    assert ac.controller.target_speed == 5.0
    ac.update_target_speed(9.0, start_time=2.0)
    ac.update_waypoints([[1.0, 0.0]], start_time=3.0)
    ac.update_waypoints([[2.0, 0.0]], start_time=3.0)
    assert ac.controller.waypoints[0][0] == 1.0
    names = []
    for sep in (".", ":"):
        mod = pkg.ac.ActorControl(_ob(pkg, "static"), pkg.name
                                  + ".envs.actor_controls" + sep
                                  + "VehicleLongitudinalControl")
        assert isinstance(mod.controller, pkg.ac.VehicleLongitudinalControl)
        names.append(type(mod.controller).__module__)
    return ac.controller.target_speed, names[0] == pkg.ac.__name__


def _ctl_controlled_behavior(pkg):
    env = _CtlEnv()
    ob = _ob(pkg, "walker")
    b = pkg.ac.ControlledActorBehavior(ob, target_speed=2.0,
                                       waypoints=[[1.0, 0.0]])
    assert ob.managed and ob._control is b.control
    out = []
    for _ in range(20):
        alive = b.tick(env)
        out.append((_state(ob), alive))
        if not alive:
            break
    assert not alive and not ob.managed
    ob = _ob(pkg, "vehicle")
    b1 = pkg.ac.ControlledActorBehavior(ob, target_speed=3.0)
    first = ob._control
    b2 = pkg.ac.ControlledActorBehavior(
        ob, pkg.name + ".envs.actor_controls.ExternalControl")
    assert ob._control is not first
    assert b1.tick(env) is False and b2.tick(env) is True
    return out


def _ctl_change_behaviors(pkg):
    env = _CtlEnv()
    ob = _ob(pkg, "vehicle")
    b = pkg.ac.ChangeActorTargetSpeedBehavior(ob, 6.0, init_speed=True)
    assert b.tick(env) is True
    control = ob._control
    assert control.controller.target_speed == 6.0 and ob.speed == 6.0
    assert pkg.ac.ChangeActorWaypointsBehavior(
        ob, [[3.0, 0.0]]).tick(env) is False
    assert ob._control is control
    out = []
    for _ in range(5):
        out.append((b.tick(env), _state(ob)))
    pkg.ac.ChangeActorWaypointsToReachPositionBehavior(
        ob, (9.0, 0.0)).tick(env)
    np.testing.assert_allclose(control.controller.waypoints[0], [9.0, 0.0])
    # an actor without a controller: the waypoint behaviour owns it
    ob2 = _ob(pkg, "walker", speed=1.5)
    w = pkg.ac.ChangeActorWaypointsBehavior(ob2, [[0.0, 1.0]])
    for _ in range(12):
        out.append((w.tick(env), _state(ob2)))
    # UpdateAllActorControls steps controllers nobody owns
    ob3 = _ob(pkg, "vehicle")
    ob3._control = pkg.ac.ActorControl(ob3)
    ob3._control.update_target_speed(3.0)
    upd = pkg.ac.UpdateAllActorControlsBehavior()
    env3 = _CtlEnv([ob3])
    for _ in range(3):
        out.append((upd.tick(env3), _state(ob3), ob3.managed))
    return out


CONTROLS = {f.__name__[5:]: f for f in (
    _ctl_dispatch, _ctl_pedestrian, _ctl_npc_vehicle, _ctl_simple_vehicle,
    _ctl_longitudinal, _ctl_facade_and_modules, _ctl_controlled_behavior,
    _ctl_change_behaviors)}


@pytest.mark.parametrize("case", list(CONTROLS))
def test_actor_controls_twin(case):
    """tests/test_actor_controls.py's controllers and behaviours on both
    packages: every state they step through equal. Controllers named by
    module path name each package's own classes (`cadre_tpu.` for the
    JAX package, `cadre_tpu_torch.` for the port)."""
    _twin(CONTROLS[case])


# ------------------------------------------------------- autonomous agents

def _agents_sensors(pkg):
    agents = (pkg.agents.DummyAgent(), pkg.agents.NpcAgent(),
              pkg.agents.HumanAgent(input_source=set))
    for agent in agents:
        pkg.auto.validate_sensor_configuration(agent.sensors())
    pkg.auto.validate_sensor_configuration(DEFAULT_SENSORS)
    errors = []
    for sensors, track in (
            (DEFAULT_SENSORS + [DEFAULT_SENSORS[0]], None),
            ([{"id": "x", "type": "sensor.bogus"}], None),
            ([{"id": "c", "type": "sensor.camera.rgb", "x": 5.0}], None),
            ([{"id": "m", "type": "sensor.opendrive_map"}],
             pkg.auto.Track.SENSORS)):
        with pytest.raises(ValueError) as e:
            pkg.auto.validate_sensor_configuration(
                sensors, *(() if track is None else (track,)))
        errors.append(str(e.value))
    return [a.sensors() for a in agents], errors


def _agents_dummy_and_contract(pkg, capsys):
    agent = pkg.agents.DummyAgent()
    ctrl = agent.run_step({"Left": (3, np.zeros((200, 300, 3)))}, 0.0)
    agent.verbose = True
    agent.run_step({"Left": (3, np.zeros((200, 300, 3))), "speed": 2.0},
                   0.1)
    printed = capsys.readouterr().out
    assert ctrl == [0.0, 0.0, 0.0] and "shape (200, 300, 3)" in printed

    class MyAgent(pkg.auto.AutonomousAgent):
        def sensors(self):
            return [DEFAULT_SENSORS[0]]

        def run_step(self, input_data, timestamp):
            return [0.0, 0.5, 0.0]

    agent = MyAgent()
    plan = [({"lat": 49.0, "lon": 8.0 + i}, None) for i in range(7)]
    coords = [(np.array([float(i * 30), 0.0]), None) for i in range(7)]
    agent.set_global_plan(plan, coords)
    return (printed, agent._global_plan,
            [c[0].tolist() for c in agent._global_plan_world_coord])


def _agents_npc_plan(pkg):
    agent = pkg.agents.NpcAgent()
    assert agent.run_step({"GPS": (0, np.zeros(2))}, 0.0) == [0.0, 0.0, 0.0]
    plan = [((x, 0.0), 0) for x in (0.0, 20.0, 40.0, 60.0, 80.0)]
    agent.set_global_plan(plan, plan)
    pos, heading, speed, dt = np.array([0.0, 0.0]), 0.0, 0.0, 0.1
    out = []
    for _ in range(400):
        data = {"GPS": (0, pos.copy()),
                "IMU": (0, np.array([0.0, 0.0, heading])),
                "speed": (0, {"speed": speed})}
        steer, throttle, brake = agent.run_step(data, 0.0)
        out.append((steer, throttle, brake))
        speed = max(0.0, speed + (3.0 * throttle - 8.0 * brake) * dt)
        heading += steer * 1.0 * dt
        pos += speed * dt * np.array([np.cos(heading), np.sin(heading)])
    assert pos[0] > 70.0 and abs(pos[1]) < 5.0
    assert agent.run_step({"GPS": (0, pos), "speed": (0, {"speed": 0.0})},
                          0.0)[2] == 1.0
    return out


def _agents_human_keys(pkg):
    pressed = set()
    agent = pkg.agents.HumanAgent(input_source=lambda: pressed)
    out = [agent.run_step({}, 0.0)]
    pressed.update({"w"})
    out.append(agent.run_step({}, 0.0))
    pressed.update({"a"})
    for _ in range(31):
        out.append(agent.run_step({}, 0.0))
    assert out[-1][0] == -0.7
    pressed.clear()
    pressed.update({"space", "RIGHT"})
    for _ in range(3):
        out.append(agent.run_step({}, 0.0))
    assert out[1][1] == 0.6 and out[-1][2] == 1.0
    return out


def _agents_npc_live_route(pkg):
    env = pkg.sim.SimDrivingEnv(seed=7)
    env.reset()
    plan = [((float(x), float(y)), 0) for x, y in env._route_xy[::10]]
    agent = pkg.agents.NpcAgent()
    agent.set_global_plan(plan, plan)
    out, done, info = [], False, {}
    for i in range(3000):
        data = {"GPS": (i, env._pos.copy()),
                "IMU": (i, np.array([0.0, 0.0, math.radians(env._yaw)])),
                "speed": (i, {"speed": env._speed})}
        ctrl = agent.run_step(data, i * env.dt)
        _, reward, done, info = env.step(ctrl)
        out.append((ctrl, env._pos.tolist(), float(env._yaw)))
        if done:
            break
    assert done and info.get("error_message") == "success", info
    return out


def _agents_human_live_episode(pkg):
    env = pkg.sim.SimDrivingEnv(seed=3, seq_length=2, vehicle_num=(0, 0),
                                render_camera=False,
                                with_traffic_lights=False)
    env.reset()
    pressed = set()
    agent = pkg.agents.HumanAgent(input_source=lambda: set(pressed))
    out, done, info = [], False, {}
    for i in range(3000):
        route = env._route_xy
        d = np.hypot(*(route - env._pos).T)
        target = route[min(int(np.argmin(d)) + 8, len(route) - 1)]
        desired = math.degrees(math.atan2(*(target - env._pos)[::-1]))
        err = (desired - env._yaw + 180.0) % 360.0 - 180.0
        pressed.clear()
        if env._speed < 2.5:
            pressed.add("w")
        if err > 1.5:
            pressed.add("d")
        elif err < -1.5:
            pressed.add("a")
        ctrl = agent.run_step({}, i * env.dt)
        _, _, done, info = env.step(ctrl)
        out.append((ctrl, env._pos.tolist()))
        if done:
            break
    assert done and info.get("error_message") == "success", info
    return out


AGENTS = {f.__name__[8:]: f for f in (
    _agents_sensors, _agents_dummy_and_contract, _agents_npc_plan,
    _agents_human_keys, _agents_npc_live_route, _agents_human_live_episode)}


@pytest.mark.parametrize("case", list(AGENTS))
def test_autoagents_twin(case, capsys):
    """tests/test_autoagents.py and the autonomous-agent container cases
    of tests/test_recorder_and_misc.py on both packages (the JAX package's
    DEFAULT_SENSORS validated by both): sensor suites, validation errors,
    downsampled plans, printed feeds and every control on every tick
    equal, the live sim episodes driven to success."""
    fn = AGENTS[case]
    if case == "dummy_and_contract":
        _twin(fn, capsys)
    else:
        _twin(fn)


def test_pygame_stays_out_of_the_port():
    """HumanAgent without an input source: both packages fall back to
    pygame's scan or no input alike; the port names pygame only inside
    `_pygame_keys`."""
    import inspect

    src = inspect.getsource(p_agents)
    body = inspect.getsource(p_agents._pygame_keys)
    assert src.count("import pygame") == body.count("import pygame") == 1


# -------------------------------------------------------------- recorder

def _record(pkg, tmp_path):
    env = pkg.sim.SimDrivingEnv(seed=0, seq_length=3)
    path = str(tmp_path / pkg.name / "log.npz")
    pkg.rec.record_episodes(env, pkg.expert.OracleExpert().act, 12, path)
    log = pkg.rec.load_replay_log(path)
    assert len(log) == 12 and log[0]["rgb"].shape == (3, 144, 256, 3)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    replay = pkg.rec.make_replay_env(path, episode_length=10)
    ticks = [replay.reset()]
    for _ in range(10):
        tick, r, done, info = replay.step([0.0, 0.5, 0.0])
        ticks.append(tick)
    assert done
    return arrays, ticks


def test_recorder_twin(tmp_path):
    """tests/test_recorder_and_misc.py::test_record_and_replay on both
    packages: the recorded log arrays and every replayed tick equal."""
    (a_j, t_j), (a_p, t_p) = (_record(PKGS[k], tmp_path)
                              for k in ("jax", "port"))
    assert sorted(a_j) == sorted(a_p)
    for k in a_j:
        np.testing.assert_array_equal(a_p[k], a_j[k])
    for x, y in zip(t_p, t_j):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]),
                                          np.asarray(y[k]))


# ----------------------------------------------------------- result writer

def _report(pkg, tmp_path, monkeypatch):
    """The JAX tests' reports, and one with every criterion state, with
    the clock fixed."""
    monkeypatch.setattr(pkg.rw.time, "time", lambda: 1_700_000_000.0)

    class _Crit(pkg.crit.Criterion):
        def __init__(self, status, actual=0.0, expected=None):
            super().__init__()
            self.test_status = status
            self.actual_value = actual
            if expected is not None:
                self.expected = expected

        def update(self, snap):
            pass

    ok = pkg.rw.ResultOutputProvider(
        "s1", [_Crit("SUCCESS"), _Crit("INIT")], duration_game=10.0,
        duration_system=1.0, timeout=20.0)
    text = ok.create_output_text()
    assert ok.result() == "SUCCESS" and "INIT" not in text
    bad = pkg.rw.ResultOutputProvider(
        "s2", [_Crit("FAILURE", 3.0), _Crit("ACCEPTABLE", 0.25, 1),
               _Crit("RUNNING", 12, 2.5)],
        duration_game=25.123, duration_system=0.7, timeout=20.0,
        timed_out=True, other_actors=["adversary", "walker.1"])
    d = tmp_path / pkg.name
    d.mkdir()
    printed = bad.write(stdout=False, filename=str(d / "out.txt"),
                        junit=str(d / "out.xml"))
    suite = ET.parse(d / "out.xml").getroot()
    assert suite.get("failures") == "2" and bad.result() == "FAILURE"
    running = pkg.rw.ResultOutputProvider("s3", [_Crit("RUNNING")], 5.0, 1.0)
    return (text, printed, (d / "out.txt").read_text(),
            (d / "out.xml").read_text(), running.result(),
            running.create_output_text())


def test_result_writer_twin(tmp_path, monkeypatch):
    """tests/test_result_writer.py's reports (and one with ACCEPTABLE and
    RUNNING criteria, other actors and a timeout) on both packages: the
    terminal text, the file and the JUnit XML equal, character for
    character."""
    _twin(_report, tmp_path, monkeypatch)


def test_fancy_grid_equals_tabulate():
    """The port's table text equals tabulate's fancy_grid (with and
    without a header row) on 600 random ragged tables of strings, ints,
    floats, numpy scalars, bools, numeric strings, blanks and None."""
    rng = random.Random(0)
    values = [None, "", "abc", "Duration (Game Time)", 0, 17, -3, 0.5,
              1.25e-7, 123.456, True, False, "True", "1.5s", "-1e-5", "0x1",
              "2026-10-17 14:30:00", np.float64(2.5), np.int64(4), "12",
              "3.25", "1,000", "nan", float("inf"), 1e20, -0.0, "x y",
              "  pad ", round(0.1 * 3, 2)]
    for _ in range(600):
        rows = [[rng.choice(values) for _ in range(rng.randint(0, 5))]
                for _ in range(rng.randint(1, 5))]
        assert p_rw.fancy_grid(rows) == tabulate(rows, tablefmt="fancy_grid")
        assert p_rw.fancy_grid(rows, firstrow=True) == tabulate(
            rows, headers="firstrow", tablefmt="fancy_grid")
