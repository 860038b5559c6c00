"""OpenSCENARIO (.xosc) reader for the simulator (the port's copy of the
JAX package's host `envs/openscenario.py`, on the port's scenario runtime
and SimDrivingEnv).

The reference vendors a full OpenSCENARIO parser
(scenario_runner/srunner/tools/openscenario_parser.py, ~1,061 LoC) that
converts XOSC documents into CARLA py_trees behaviors; the CADRE training
path never uses it. This module provides the ASAM OpenSCENARIO 1.0 subset
that maps onto our tick-driven behavior primitives (envs/scenarios.py):

  ParameterDeclarations + $refs .......... attribute substitution
  CatalogLocations/CatalogReference ...... entry grafting + assignments
  Entities/ScenarioObject ................ actor roster
  Init TeleportAction .................... actor spawn pose
  World/RelativeWorld/RelativeObject pos . position forms (init-pose rel)
  Init/Event SpeedAction (abs/relative) .. KeepVelocityBehavior
  SpeedActionDynamics distance/time ...... bounded speed hold
  LateralAction/LaneChangeAction ......... LaneChangeBehavior
  TeleportAction (storyboard) ............ ActorTransformSetterBehavior
  RoutingAction/AssignRouteAction ........ ChangeActorWaypointsBehavior
  RoutingAction/AcquirePositionAction .... ...ToReachPositionBehavior
  ActivateControllerAction ............... ChangeAutoPilotBehavior
  AssignControllerAction ................. actor_controls plugin dispatch
  UserDefinedAction/CustomCommandAction .. RunScriptBehavior
  TrafficSignalStateAction (id=/pos=) .... TrafficLightStateSetterBehavior
  EnvironmentAction/Weather .............. env weather preset switch
  Act-level StartTrigger ................. gates every event in the act
  StartTrigger SimulationTimeCondition ... time trigger (at_tick)
  StartTrigger ReachPositionCondition .... distance trigger (pos)
  StandStillCondition .................... StandStill
  TraveledDistanceCondition .............. DriveDistance
  SpeedCondition ......................... TriggerVelocity
  (Relative)DistanceCondition ............ InTriggerDistanceToVehicle
  TimeToCollisionCondition ............... InTimeToArrivalToVehicle
  TimeHeadwayCondition ................... TimeHeadway
  RelativeSpeedCondition ................. RelativeVelocityToOtherActor
  AccelerationCondition .................. TriggerAcceleration
  CollisionCondition (entity/any) ........ CollisionCondition
  OffroadCondition ....................... Offroad (road envelope)
  TrafficSignalCondition ................. WaitForTrafficLightState
  TimeOfDayCondition ..................... TimeOfDayComparison
  UserDefinedValueCondition .............. blackboard compare
  StoryboardElementStateCondition ........ blackboard completion flags
  Event StopTrigger ...................... Parallel(success_on_one) wrap

Every fired event sets the blackboard flag `xosc:<event>:done` on
completion, which is what StoryboardElementStateCondition reads — the
py_trees OneShot/element-status machinery reduced to our blackboard.

Controller dispatch: AssignControllerAction instantiates an
`envs.actor_controls.ActorControl` plugin (user module via the
Controller's `module` property, else the kind default) wrapped in a
`ControlledActorBehavior` — the reference's openscenario_parser
controller path over srunner/scenariomanager/actorcontrols/.

Out of scope (openscenario_parser.py features with no synthetic-world
counterpart): road-network Lane/Road/RoutePosition
coordinates (no OpenDRIVE ids in the synthetic world), FollowTrajectory/
Synchronize/Visibility/LongitudinalDistance actions (reference raises
NotImplementedError for the latter three as well), and road-friction
changes.

`load_openscenario(path)` -> OpenScenarioConfig;
`build_manager(cfg, env)` spawns the actors into a SimDrivingEnv-compatible
env and returns a ScenarioManager whose triggers fire the mapped behaviors.
"""
from __future__ import annotations

import copy
import dataclasses
import glob
import math
import os
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional

import numpy as np

from cadre_tpu_torch.envs.scenarios import (
    ActorTransformSetterBehavior,
    ChangeAutoPilotBehavior,
    CollisionCondition,
    ConditionBehavior,
    DriveDistance,
    ElapsedSimTime,
    InTimeToArrivalToVehicle,
    InTriggerDistanceToLocation,
    InTriggerDistanceToVehicle,
    KeepVelocityBehavior,
    LaneChangeBehavior,
    Offroad,
    ParallelBehavior,
    RelativeVelocityToOtherActor,
    RunScriptBehavior,
    ScenarioManager,
    ScenarioTrigger,
    SequenceBehavior,
    SetBlackboardVariableBehavior,
    StandStill,
    TimeHeadway,
    TimeOfDayComparison,
    TrafficLightStateSetterBehavior,
    TriggerAcceleration,
    TriggerVelocity,
    WaitForBlackboardVariable,
    WaitForTrafficLightState,
)


@dataclasses.dataclass
class OscEntity:
    name: str
    kind: str = "vehicle"          # 'vehicle' | 'walker'
    pos: Optional[np.ndarray] = None
    heading: float = 0.0
    speed: float = 0.0             # Init SpeedAction


@dataclasses.dataclass
class OscEvent:
    entity: str
    action: str                    # 'speed' | 'lane_change' | 'teleport' |
    #                                'controller' | 'signal' | 'weather'
    value: float                   # target speed / lane offset (meters)
    at_time: Optional[float] = None      # SimulationTimeCondition (s)
    at_pos: Optional[np.ndarray] = None  # ReachPositionCondition
    tolerance: Optional[float] = None    # ReachPositionCondition tolerance
    name: str = ""
    cond: Optional[dict] = None          # generic start condition spec
    stop: Optional[dict] = None          # StopTrigger condition spec
    extra: Optional[dict] = None         # action-specific payload
    act_cond: Optional[dict] = None      # enclosing Act's StartTrigger


@dataclasses.dataclass
class OpenScenarioConfig:
    entities: Dict[str, OscEntity]
    events: List[OscEvent]
    path: str = ""                       # source .xosc (RunScript base dir)


def _apply_parameters(root) -> None:
    """ParameterDeclarations + $name attribute substitution (the reference
    parser's get_parameter handling, openscenario_parser.py)."""
    params: Dict[str, str] = {}
    for decl in root.iterfind(".//ParameterDeclarations/ParameterDeclaration"):
        name = decl.get("name", "")
        params[name.lstrip("$")] = decl.get("value", "")
    if not params:
        return
    for el in root.iter():
        for key, val in list(el.attrib.items()):
            if isinstance(val, str) and val.startswith("$"):
                ref = val[1:]
                if ref in params:
                    el.set(key, params[ref])


def _load_catalogs(root, base_dir: str) -> Dict[str, Dict[str, Any]]:
    """CatalogLocations -> {catalog_name: {entry_name: Element}}.

    Each `<XxxCatalog><Directory path=.../>` under CatalogLocations is
    scanned for .xosc files whose `<Catalog name=...>` entries (Vehicle,
    Pedestrian, Controller, Maneuver, ...) are indexed by their `name`
    attribute (openscenario_parser.py's CatalogLocations handling; paths
    resolve relative to the scenario file like the reference's)."""
    catalogs: Dict[str, Dict[str, Any]] = {}
    for locs in root.iter("CatalogLocations"):
        for loc in locs:
            directory = loc.find("Directory")
            if directory is None:
                continue
            cat_dir = directory.get("path", "")
            if not os.path.isabs(cat_dir):
                cat_dir = os.path.join(base_dir, cat_dir)
            for fname in sorted(glob.glob(os.path.join(cat_dir, "*.xosc"))):
                try:
                    cat_root = ET.parse(fname).getroot()
                except ET.ParseError:
                    continue
                for cat in cat_root.iter("Catalog"):
                    entries = catalogs.setdefault(cat.get("name", ""), {})
                    for entry in cat:
                        entries[entry.get("name", "")] = entry
    return catalogs


def _resolve_catalog_refs(root, catalogs: Dict[str, Dict[str, Any]]) -> None:
    """Graft every `<CatalogReference catalogName=... entryName=...>` with a
    deep copy of its catalog entry, applying ParameterAssignments over the
    entry's ParameterDeclarations defaults ($ref substitution scoped to
    the grafted subtree — the reference parser's
    get_catalog_entry/ParameterAssignments semantics)."""
    if not catalogs:
        return
    for parent in list(root.iter()):
        for i, child in enumerate(list(parent)):
            if child.tag != "CatalogReference":
                continue
            entry = catalogs.get(child.get("catalogName", ""), {}).get(
                child.get("entryName", ""))
            if entry is None:
                continue
            entry = copy.deepcopy(entry)
            assigns = {pa.get("parameterRef", "").lstrip("$"):
                       pa.get("value", "")
                       for pa in child.iter("ParameterAssignment")}
            for decl in entry.iter("ParameterDeclaration"):
                assigns.setdefault(decl.get("name", "").lstrip("$"),
                                   decl.get("value", ""))
            for el in entry.iter():
                for key, val in list(el.attrib.items()):
                    if isinstance(val, str) and val.startswith("$") and \
                            val[1:] in assigns:
                        el.set(key, assigns[val[1:]])
            parent.remove(child)
            parent.insert(i, entry)


def _world_position(node, entities: Optional[Dict[str, "OscEntity"]] = None
                    ) -> tuple:
    """Position subtree -> (xy, heading). WorldPosition plus the relative
    forms (openscenario_parser.py convert_position_to_transform:411-509):
    RelativeWorldPosition offsets in world axes, RelativeObjectPosition in
    the referenced entity's frame. Relative refs resolve against the
    entities' INIT poses (the reference resolves at behavior start — for
    Init/teleport targets, which is where these forms appear, the two
    coincide)."""
    wp = node.find(".//WorldPosition")
    if wp is not None:
        pos = np.array([float(wp.get("x", 0)), float(wp.get("y", 0))])
        return pos, float(wp.get("h", 0))
    for tag, in_frame in (("RelativeWorldPosition", False),
                          ("RelativeObjectPosition", True)):
        rel = node.find(f".//{tag}")
        if rel is None:
            continue
        ent = (entities or {}).get(rel.get("entityRef", ""))
        if ent is None or ent.pos is None:
            return None, 0.0
        dx, dy = float(rel.get("dx", 0)), float(rel.get("dy", 0))
        h = ent.heading
        if in_frame:
            c, s = math.cos(h), math.sin(h)
            dx, dy = c * dx - s * dy, s * dx + c * dy
        return ent.pos + np.array([dx, dy]), h
    return None, 0.0


def _speed_target(node):
    """(value, relative_entity or None)."""
    tgt = node.find(".//AbsoluteTargetSpeed")
    if tgt is not None:
        return float(tgt.get("value")), None
    rel = node.find(".//RelativeTargetSpeed")
    if rel is not None:
        return float(rel.get("value", 0)), rel.get("entityRef")
    return None, None


def _entity_condition(cond_node, entities=None) -> Optional[dict]:
    """ByEntityCondition subset -> condition spec dict."""
    ent_ref = cond_node.find(".//TriggeringEntities/EntityRef")
    who = ent_ref.get("entityRef") if ent_ref is not None else None
    ec = cond_node.find(".//EntityCondition")
    if ec is None:
        return None
    reach = ec.find("ReachPositionCondition")
    if reach is not None:
        pos, _ = _world_position(reach, entities)
        tol = reach.get("tolerance")
        return dict(type="reach", entity=who, pos=pos,
                    tolerance=float(tol) if tol else None)
    ss = ec.find("StandStillCondition")
    if ss is not None:
        return dict(type="standstill", entity=who,
                    duration=float(ss.get("duration", 1.0)))
    td = ec.find("TraveledDistanceCondition")
    if td is not None:
        return dict(type="traveled", entity=who,
                    value=float(td.get("value", 0)))
    sp = ec.find("SpeedCondition")
    if sp is not None:
        return dict(type="speed", entity=who,
                    value=float(sp.get("value", 0)))
    for tag in ("RelativeDistanceCondition", "DistanceCondition"):
        dc = ec.find(tag)
        if dc is not None:
            return dict(type="distance", entity=who,
                        other=dc.get("entityRef"),
                        value=float(dc.get("value", 0)))
    ttc = ec.find("TimeToCollisionCondition")
    if ttc is not None:
        other = ttc.find(".//EntityRef")
        return dict(type="ttc", entity=who,
                    other=other.get("entityRef") if other is not None
                    else None,
                    value=float(ttc.get("value", 0)))
    th = ec.find("TimeHeadwayCondition")
    if th is not None:
        return dict(type="headway", entity=who,
                    other=th.get("entityRef"),
                    value=float(th.get("value", 0)))
    rs = ec.find("RelativeSpeedCondition")
    if rs is not None:
        return dict(type="relative_speed", entity=who,
                    other=rs.get("entityRef"),
                    value=float(rs.get("value", 0)))
    acc = ec.find("AccelerationCondition")
    if acc is not None:
        return dict(type="acceleration", entity=who,
                    value=float(acc.get("value", 0)))
    col = ec.find("CollisionCondition")
    if col is not None:
        other = col.find(".//EntityRef")
        return dict(type="collision", entity=who,
                    other=other.get("entityRef") if other is not None
                    else None)
    if ec.find("OffroadCondition") is not None:
        return dict(type="offroad", entity=who)
    return None


def _parse_trigger(trigger_node, entities=None) -> Optional[dict]:
    """First supported Condition under a Start/StopTrigger -> spec dict."""
    if trigger_node is None:
        return None
    st = trigger_node.find(".//SimulationTimeCondition")
    if st is not None:
        return dict(type="time", value=float(st.get("value", 0)))
    el = trigger_node.find(".//StoryboardElementStateCondition")
    if el is not None:
        return dict(type="element_state",
                    ref=el.get("storyboardElementRef", ""),
                    state=el.get("state", "completeState"))
    ts = trigger_node.find(".//TrafficSignalCondition")
    if ts is not None:
        return dict(type="traffic_signal", name=ts.get("name", ""),
                    state=ts.get("state", "red").lower())
    uv = trigger_node.find(".//UserDefinedValueCondition")
    if uv is not None:
        return dict(type="user_value", name=uv.get("name", ""),
                    value=uv.get("value", "true"))
    tod = trigger_node.find(".//TimeOfDayCondition")
    if tod is not None:
        # dateTime HH:MM:SS -> seconds since the scenario's 00:00:00 sim
        # clock (the reference compares against WeatherBehavior's animated
        # blackboard Datetime; our sim clock starts the day at t=0)
        stamp = tod.get("dateTime", "00:00:00").split("T")[-1]
        try:
            h, m, s = (float(x) for x in stamp.split(":"))
            elapsed = h * 3600 + m * 60 + s
        except ValueError:
            elapsed = 0.0
        return dict(type="time_of_day", value=elapsed)
    for cond in trigger_node.iterfind(".//Condition"):
        by_ent = cond.find("ByEntityCondition")
        if by_ent is not None:
            spec = _entity_condition(by_ent, entities)
            if spec is not None:
                return spec
    return None


def _parse_action(action, default_entity, entities=None
                  ) -> Optional[OscEvent]:
    speed = action.find(".//SpeedAction")
    lane = action.find(".//LaneChangeAction")
    tele = action.find(".//TeleportAction")
    assign = action.find(".//AssignControllerAction")
    ctrl = action.find(".//ActivateControllerAction")
    sig = action.find(".//TrafficSignalStateAction")
    weather = action.find(".//EnvironmentAction//Weather")
    routing = action.find(".//RoutingAction")
    custom = action.find(".//CustomCommandAction")
    if speed is not None:
        v, rel = _speed_target(speed)
        if v is None:
            return None
        extra: Dict[str, Any] = dict(relative_to=rel) if rel else {}
        # SpeedActionDynamics dynamicsDimension: a 'distance'/'time' value
        # bounds how long the retargeted speed is held
        # (openscenario_parser.py:957-963 -> ChangeActorTargetSpeed)
        dyn = speed.find("SpeedActionDynamics")
        if dyn is not None and dyn.get("value") is not None:
            dim = dyn.get("dynamicsDimension", "time")
            key = "distance" if dim == "distance" else "duration"
            try:
                extra[key] = float(dyn.get("value"))
            except (TypeError, ValueError):
                pass
        return OscEvent(default_entity, "speed", v, extra=extra or None)
    if routing is not None:
        assign_route = routing.find(".//AssignRouteAction")
        if assign_route is not None:
            wps = []
            for wp in assign_route.iterfind(".//Waypoint"):
                pos, _ = _world_position(wp, entities)
                if pos is not None:
                    wps.append(pos)
            if wps:
                return OscEvent(default_entity, "route", 0.0,
                                extra=dict(waypoints=wps))
            return None
        acquire = routing.find(".//AcquirePositionAction")
        if acquire is not None:
            pos, _ = _world_position(acquire, entities)
            if pos is None:
                return None
            return OscEvent(default_entity, "acquire", 0.0,
                            extra=dict(pos=pos))
        return None
    if custom is not None:
        return OscEvent(default_entity, "run_script", 0.0,
                        extra=dict(command=custom.get("type", "")))
    if lane is not None:
        tgt = lane.find(".//RelativeTargetLane")
        if tgt is not None:
            lanes = int(tgt.get("value", 1))
        else:
            abs_tgt = lane.find(".//AbsoluteTargetLane")
            lanes = int(abs_tgt.get("value", 1)) if abs_tgt is not None else 1
        return OscEvent(default_entity, "lane_change", 3.5 * lanes)
    if tele is not None:
        pos, h = _world_position(tele, entities)
        if pos is None:
            return None
        return OscEvent(default_entity, "teleport", 0.0,
                        extra=dict(pos=pos, heading=h))
    if assign is not None:
        # Controller/Properties: `module` selects the plugin class, every
        # other property is passed through as a controller arg
        # (openscenario_parser's controller path over actorcontrols/)
        module, ctrl_args = None, {}
        for prop in assign.findall(".//Property"):
            if prop.get("name") == "module":
                module = prop.get("value")
            else:
                ctrl_args[prop.get("name")] = prop.get("value")
        return OscEvent(default_entity, "assign_controller", 0.0,
                        extra=dict(module=module, args=ctrl_args))
    if ctrl is not None:
        return OscEvent(default_entity, "controller",
                        1.0 if ctrl.get("longitudinal", "true") != "false"
                        else 0.0)
    if sig is not None:
        return OscEvent(default_entity, "signal", 0.0,
                        extra=dict(name=sig.get("name", ""),
                                   state=sig.get("state", "red").lower()))
    if weather is not None:
        sun = weather.find("Sun")
        preset = "ClearNoon"
        if weather.find("Precipitation") is not None and \
                float(weather.find("Precipitation").get("intensity", 0)) > 0:
            preset = "HardRainNoon"
        elif sun is not None and float(sun.get("elevation", 1.2)) < 0.2:
            preset = "ClearSunset"
        return OscEvent(default_entity, "weather", 0.0,
                        extra=dict(preset=preset))
    return None


def load_openscenario(path: str) -> OpenScenarioConfig:
    root = ET.parse(path).getroot()
    _resolve_catalog_refs(root, _load_catalogs(root, os.path.dirname(path)))
    _apply_parameters(root)

    entities: Dict[str, OscEntity] = {}
    for obj in root.iterfind(".//Entities/ScenarioObject"):
        name = obj.get("name")
        kind = "walker" if obj.find("Pedestrian") is not None else "vehicle"
        entities[name] = OscEntity(name=name, kind=kind)

    # Init: spawn poses + initial speeds
    for private in root.iterfind(".//Storyboard/Init/Actions/Private"):
        ent = entities.get(private.get("entityRef"))
        if ent is None:
            continue
        tele = private.find(".//TeleportAction")
        if tele is not None:
            ent.pos, ent.heading = _world_position(tele, entities)
        speed = private.find(".//SpeedAction")
        if speed is not None:
            v, _ = _speed_target(speed)
            if v is not None:
                ent.speed = v

    # Storyboard events (Act-level StartTriggers gate every event inside
    # the act, like the py_trees act subtree's idle decorator)
    events: List[OscEvent] = []
    seen: set = set()
    for act in root.iterfind(".//Act"):
        act_cond = _parse_trigger(act.find("StartTrigger"), entities)
        for group in act.iterfind(".//ManeuverGroup"):
            seen.add(id(group))
            _collect_group_events(group, act_cond, entities, events)
    for group in root.iterfind(".//ManeuverGroup"):
        if id(group) not in seen:       # tolerated subset: group w/o an Act
            _collect_group_events(group, None, entities, events)
    return OpenScenarioConfig(entities=entities, events=events, path=path)


def _collect_group_events(group, act_cond, entities,
                          events: List[OscEvent]) -> None:
    actor_ref = group.find(".//Actors/EntityRef")
    default_entity = actor_ref.get("entityRef") if actor_ref is not None \
        else None
    for event in group.iterfind(".//Event"):
        cond = _parse_trigger(event.find("StartTrigger"), entities)
        stop = _parse_trigger(event.find("StopTrigger"), entities)
        for action in event.iterfind("Action"):
            ev = _parse_action(action, default_entity, entities)
            if ev is None:
                continue
            ev.name = event.get("name", "") or action.get("name", "")
            ev.cond = cond
            ev.stop = stop
            ev.act_cond = act_cond
            if cond is not None:
                # legacy convenience fields for the two common cases
                if cond["type"] == "time":
                    ev.at_time = cond["value"]
                elif cond["type"] == "reach":
                    ev.at_pos = cond["pos"]
                    ev.tolerance = cond.get("tolerance")
            events.append(ev)


def _resolve(actors: Dict[str, Any], ref: Optional[str], ego_name: str):
    if ref is None or ref == ego_name:
        return "ego"
    return actors.get(ref)


def _find_light(env, name: str):
    """Resolve a traffic light from an OSC signal name — 'id=<n>' indexes
    the env's light list, 'pos=x,y' picks the nearest light (the
    reference's get_traffic_light_from_osc_name, openscenario_parser.py:98-128)."""
    lights = list(getattr(env, "_lights", []) or [])
    if not lights:
        return None
    if name.startswith("id="):
        try:
            return lights[int(name[3:]) % len(lights)]
        except ValueError:
            return lights[0]
    if name.startswith("pos="):
        try:
            x, y = (float(v) for v in name[4:].split(","))
        except ValueError:
            return lights[0]

        def _xy(li):
            return np.asarray(getattr(li, "center",
                                      getattr(li, "pos", (0, 0))), float)
        return min(lights, key=lambda li: float(
            np.hypot(*(_xy(li) - (x, y)))))
    return lights[0]


def _make_condition(spec: dict, actors: Dict[str, Any], ego_name: str,
                    env=None):
    """Condition spec -> scenarios.Condition (None when unmappable)."""
    who = _resolve(actors, spec.get("entity"), ego_name)
    if spec["type"] == "time":
        return ElapsedSimTime(spec["value"])
    if spec["type"] == "time_of_day":
        return TimeOfDayComparison(spec["value"])
    if spec["type"] == "reach":
        return InTriggerDistanceToLocation(
            who, spec["pos"], spec.get("tolerance") or 2.0)
    if spec["type"] == "headway":
        other = _resolve(actors, spec.get("other"), ego_name)
        if other is None:
            return None
        return TimeHeadway(who, other, spec["value"])
    if spec["type"] == "relative_speed":
        other = _resolve(actors, spec.get("other"), ego_name)
        if other is None:
            return None
        return RelativeVelocityToOtherActor(who, other, spec["value"])
    if spec["type"] == "acceleration":
        return TriggerAcceleration(who, spec["value"])
    if spec["type"] == "collision":
        other = spec.get("other")
        return CollisionCondition(
            who, _resolve(actors, other, ego_name) if other else None)
    if spec["type"] == "offroad":
        return Offroad(who)
    if spec["type"] == "traffic_signal":
        light = _find_light(env, spec.get("name", "")) if env is not None \
            else None
        if light is None:
            return None
        return WaitForTrafficLightState(light, spec["state"])
    if spec["type"] == "user_value":
        value: Any = spec.get("value", "true")
        if value in ("true", "false"):
            value = value == "true"
        return WaitForBlackboardVariable(spec["name"], value)
    if spec["type"] == "standstill":
        return StandStill(who, duration=spec["duration"])
    if spec["type"] == "traveled":
        return DriveDistance(who, spec["value"])
    if spec["type"] == "speed":
        return TriggerVelocity(who, spec["value"])
    if spec["type"] == "distance":
        other = _resolve(actors, spec.get("other"), ego_name)
        if other is None:
            return None
        return InTriggerDistanceToVehicle(who, other, spec["value"])
    if spec["type"] == "ttc":
        other = _resolve(actors, spec.get("other"), ego_name)
        if other is None:
            return None
        return InTimeToArrivalToVehicle(who, other, spec["value"])
    if spec["type"] == "element_state":
        return WaitForBlackboardVariable(f"xosc:{spec['ref']}:done")
    return None


def build_manager(cfg: OpenScenarioConfig, env,
                  dt: Optional[float] = None,
                  ego_name: str = "hero") -> ScenarioManager:
    """Spawn non-ego entities as sim obstacles and wire storyboard events as
    ScenarioManager triggers over the behavior primitives."""
    from cadre_tpu_torch.envs.sim_env import SimObstacle

    dt = dt if dt is not None else env.dt
    actors: Dict[str, Any] = {}
    triggers: List[ScenarioTrigger] = []
    for name, ent in cfg.entities.items():
        if name == ego_name or ent.pos is None:
            continue
        spawn = getattr(env, "spawn_scenario_actor", None)
        if spawn is not None:
            ob = spawn(ent.kind, ent.pos, heading=ent.heading,
                       speed=ent.speed)
        else:
            ob = SimObstacle(pos=ent.pos.astype(float).copy(),
                             radius=0.4 if ent.kind == "walker" else 1.2,
                             kind=ent.kind, speed=ent.speed,
                             heading=ent.heading)
            env._obstacles.append(ob)
        actors[name] = ob
        if ent.speed > 0:
            # OpenSCENARIO Init SpeedAction applies at scenario start: the
            # entity drives at its init speed until a storyboard event
            # retargets it (the reference parser does the same).
            def init_builder(ob=ob, v=ent.speed):
                def build(env, rng):
                    return KeepVelocityBehavior(ob, speed=v,
                                                distance=math.inf)
                return build
            triggers.append(ScenarioTrigger(
                kind="xosc:init_speed", at_tick=1, builder=init_builder()))

    def action_behavior(ev: OscEvent, ob, env):
        extra = ev.extra or {}
        if ev.action == "speed":
            v = ev.value
            rel = extra.get("relative_to")
            if rel is not None:
                base = _resolve(actors, rel, ego_name)
                base_v = env._speed if base == "ego" else \
                    getattr(base, "speed", 0.0)
                v = float(base_v) + v
            # SpeedActionDynamics bounds (ChangeActorTargetSpeed's
            # distance/duration): hold v for `distance` meters, or cut the
            # hold after `duration` seconds via a parallel timer
            distance = extra.get("distance", math.inf)
            keep = KeepVelocityBehavior(ob, speed=v, distance=distance)
            duration = extra.get("duration")
            if duration is not None and math.isfinite(duration):
                from cadre_tpu_torch.envs.scenarios import IdleBehavior
                ticks = max(1, int(round(duration / env.dt)))
                return ParallelBehavior([keep, IdleBehavior(ticks)],
                                        success_on_one=True)
            return keep
        if ev.action == "route":
            from cadre_tpu_torch.envs.actor_controls import \
                ChangeActorWaypointsBehavior
            return ChangeActorWaypointsBehavior(ob, extra["waypoints"])
        if ev.action == "acquire":
            from cadre_tpu_torch.envs.actor_controls import \
                ChangeActorWaypointsToReachPositionBehavior
            return ChangeActorWaypointsToReachPositionBehavior(
                ob, extra["pos"])
        if ev.action == "run_script":
            return RunScriptBehavior(extra["command"],
                                     base_path=cfg_base_path)
        if ev.action == "lane_change":
            return LaneChangeBehavior(ob, offset=ev.value)
        if ev.action == "teleport":
            return ActorTransformSetterBehavior(
                ob, extra["pos"], heading=extra.get("heading"))
        if ev.action == "controller":
            return ChangeAutoPilotBehavior(ob, enable=ev.value > 0)
        if ev.action == "assign_controller":
            from cadre_tpu_torch.envs.actor_controls import \
                ControlledActorBehavior
            return ControlledActorBehavior(
                ob, control_module=extra.get("module"),
                args=extra.get("args"),
                target_speed=getattr(ob, "speed", 0.0) or None,
                init_speed=True)
        if ev.action == "signal":
            light = _find_light(env, extra.get("name", ""))
            if light is None:
                return SequenceBehavior([])
            return TrafficLightStateSetterBehavior(light, extra["state"])
        if ev.action == "weather":
            class _SetWeather:
                def tick(self, env, _preset=extra["preset"]):
                    env.weather = _preset
                    return False
            return _SetWeather()
        raise ValueError(f"unknown xosc action {ev.action!r}")

    cfg_base_path = os.path.dirname(cfg.path) if cfg.path else None

    # the reference's OpenScenario tree runs UpdateAllActorControls in
    # parallel to the storyboard so retargeted controllers (route/speed
    # changes on actors without an owning behavior) actually drive
    def _update_controls_builder(env, rng):
        from cadre_tpu_torch.envs.actor_controls import \
            UpdateAllActorControlsBehavior
        return UpdateAllActorControlsBehavior()
    triggers.append(ScenarioTrigger(kind="xosc:update_controls", at_tick=1,
                                    builder=_update_controls_builder))

    for ev in cfg.events:
        ob = actors.get(ev.entity)
        if ob is None and ev.action not in ("signal", "weather",
                                            "run_script"):
            continue

        class _Lazy:
            """Defer inner-behavior construction to first tick (one-shot
            primitives like teleport act in __init__, which must not happen
            while an upstream gating condition is unmet) and raise the
            event's blackboard done-flag after the first applied tick —
            exact completion for instantaneous actions, 'applied' for hold
            actions like SpeedAction (which our KeepVelocity reaches on its
            first tick anyway, so StoryboardElementStateCondition chaining
            matches the reference's completeState timing)."""

            def __init__(self, factory, flag=None):
                self._factory = factory
                self._flag = flag
                self._inner = None

            def tick(self, env):
                if self._inner is None:
                    self._inner = self._factory(env)
                alive = self._inner.tick(env)
                if self._flag:
                    SetBlackboardVariableBehavior(self._flag).tick(env)
                    self._flag = None
                return alive

        def make_builder(ob=ob, ev=ev):
            def build(env, rng):
                behavior = _Lazy(lambda e, ev=ev, ob=ob:
                                 action_behavior(ev, ob, e),
                                 flag=f"xosc:{ev.name}:done"
                                 if ev.name else None)
                chain = [behavior]
                # generic (non time/reach) start conditions gate inside the
                # behavior; the trigger itself fires immediately
                if ev.cond is not None and \
                        ev.cond["type"] not in ("time", "reach"):
                    cond = _make_condition(ev.cond, actors, ego_name, env)
                    if cond is not None:
                        chain.insert(0, ConditionBehavior(cond))
                # the enclosing Act's StartTrigger gates ahead of the
                # event's own trigger (py_trees act-subtree ordering)
                if ev.act_cond is not None:
                    act_c = _make_condition(ev.act_cond, actors, ego_name,
                                            env)
                    if act_c is not None:
                        chain.insert(0, ConditionBehavior(act_c))
                seq: Any = SequenceBehavior(chain)
                if ev.stop is not None:
                    stop_cond = _make_condition(ev.stop, actors, ego_name,
                                                env)
                    if stop_cond is not None:
                        # StopTrigger: the event aborts when the stop
                        # condition fires first (SUCCESS_ON_ONE)
                        seq = ParallelBehavior(
                            [seq, ConditionBehavior(stop_cond)],
                            success_on_one=True)
                return seq
            return build

        at_tick = None if ev.at_time is None else max(
            1, int(round(ev.at_time / dt)))
        from cadre_tpu_torch.envs.scenarios import TRIGGER_RADIUS

        if at_tick is None and ev.at_pos is None:
            at_tick = 1               # condition-gated: fire immediately
        triggers.append(ScenarioTrigger(
            kind=f"xosc:{ev.action}", pos=ev.at_pos, at_tick=at_tick,
            builder=make_builder(),
            radius=ev.tolerance if ev.tolerance is not None
            else TRIGGER_RADIUS))
    return ScenarioManager(triggers)
