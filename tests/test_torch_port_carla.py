"""The port's CARLA env, its CLI paths and the last three CLIs against the
JAX package, on the CPU.

Neither machine has the `carla` package or a server: the in-process fake
of the client API stands in for both, `tests/carla_stub.py` for the JAX
package and its copy `tests/torch_carla_stub.py` (whose grid map is the
port's) for the port. The CARLA env is numpy in both packages, so the
port's is held to the JAX package's exactly: the same worlds, routes,
scenario files, seeds and controls give equal ticks (every key), rewards,
done flags, infos and criteria over reset + 60 steps. Two draws are
pinned on both sides for that: the speedometer, a thread that pushes a
reading every 50 ms (so the speed a tick sees, and the reward, depends on
timing), pushes one reading per world tick instead (`tick_speedometer`;
the thread itself has a test of its own), and Python's global `random`,
which shuffles the background traffic's spawn points, is seeded before
each reset. The contract cases of tests/test_carla_env_contract.py run on
the port with the pinned speedometer. The eval CLI is held to the JAX
`evaluate` with the same members and JAX's draws replayed; simple_test's
episode lines and run_scenario's report to the JAX scripts'.
"""
import dataclasses
import functools
import importlib.util
import json
import math
import os
import random
import re
import sys
import time

import numpy as np
import pytest

from cadre_tpu.configs.agent_config import EnvConfig as JaxEnvConfig
from cadre_tpu.configs.agent_config import EvalConfig as JaxEvalConfig
from cadre_tpu.envs import carla_env as jce
from cadre_tpu.envs import planner as jplanner
from cadre_tpu.envs.carla import sensors as jsensors
from cadre_tpu.rl import evaluate as jevaluate
from cadre_tpu.utils import checkpoint as jckpt
from cadre_tpu_torch.configs.agent_config import EnvConfig
from cadre_tpu_torch.envs import carla_env as pce
from cadre_tpu_torch.envs import planner as pplanner
from cadre_tpu_torch.envs.carla import sensors as psensors
from cadre_tpu_torch.envs.events import TrafficEventType
from cadre_tpu_torch.envs.road_option import RoadOption
from cadre_tpu_torch.envs.town_maps import write_lane_routes
from cadre_tpu_torch.perception.visualize import read_png
from cadre_tpu_torch.rl import evaluate as pevaluate
from test_torch_port_hostenv import SMALL, _events
from test_torch_port_scenarios import (  # noqa: F401 (module fixture)
    K,
    _replay_jax_eval_draws,
    ensemble,
)
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from tests import carla_stub, torch_carla_stub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_STEPS = 60


def tick_speedometer(sensors):
    """`sensors.SpeedometerReader` pinned to the world's clock: one
    reading per world.tick, pushed as the tick returns, in place of the
    thread's reading every 50 ms."""

    class TickSpeedometer(sensors.SpeedometerReader):
        def start(self):
            world = self._vehicle.get_world()
            tick = world.tick

            def ticked(*args):
                frame = tick(*args)
                self._interface.update_sensor(
                    self._tag, {"speed": self._speed()}, frame)
                return frame

            self._unpin = functools.partial(setattr, world, "tick", tick)
            world.tick = ticked
            self._running = True

        def stop(self):
            if self._running:
                self._unpin()
            self._running = False

    return TickSpeedometer


@pytest.fixture()
def stub(monkeypatch):
    """The port's stub installed as `carla`, with the pinned speedometer
    in the port's env."""
    mod = torch_carla_stub.make_module()
    monkeypatch.setitem(sys.modules, "carla", mod)
    monkeypatch.setattr(pce, "SpeedometerReader", tick_speedometer(psensors))
    torch_carla_stub.Client._worlds = {}
    yield mod
    torch_carla_stub.Client._worlds = {}


def _routes_xml(path, points):
    wps = "\n".join(f'<waypoint x="{x}" y="{y}" z="0"/>' for x, y in points)
    path.write_text(
        f'<routes><route id="0" map="Town01">{wps}</route></routes>')
    return str(path)


def _scenario_json(path, events):
    """A scenario JSON of (type, x, y) trigger events on Town01."""
    blob = {"available_scenarios": [{"Town01": [
        {"scenario_type": stype, "available_event_configurations": [
            {"transform": {"x": x, "y": y, "z": 0, "yaw": 0}}]}
        for stype, x, y in events]}]}
    path.write_text(json.dumps(blob))
    return str(path)


def _world(stub_mod, junction_x=None, light_state=None, grid=False):
    """A stub world (the straight road, or the grid town), with a light
    2 m before the junction when `light_state` is given."""
    if grid:
        return stub_mod.World("Town01", map_obj=stub_mod.GridTownMap())
    world = stub_mod.World("Town01", junction_x=junction_x)
    if light_state is not None:
        light = stub_mod.TrafficLight(world, stub_mod.Transform(
            stub_mod.Location(junction_x - 2.0, 0.0, 0.0)))
        light.set_state(getattr(stub_mod.TrafficLightState, light_state))
        world._actors.append(light)
    return world


def _make_env(tmp_path, points=((0.0, 0.0), (200.0, 0.0)),
              scenario_file=None, junction_x=None, port=8010,
              add_light=False):
    """tests/test_carla_env_contract.py's env, on the port."""
    world = _world(torch_carla_stub, junction_x,
                   "Green" if add_light else None)
    torch_carla_stub.Client._worlds = {port: world}
    env = pce.CarlaDrivingEnv(
        port=port, routes_file=_routes_xml(tmp_path / "routes.xml", points),
        scenario_file=scenario_file, training=True, client_timeout=5.0)
    return env, world


def _drive_events(env, steps, throttle):
    """Step at a constant throttle until done; every new event and the
    last step's rewards and done."""
    events, rewards, done = [], None, False
    for _ in range(steps):
        tick, rewards, done, _ = env.step([0.0, throttle, 0.0])
        events.extend(tick["new_event_list"])
        if done:
            break
    return [e.get_type() for e in events], rewards, done


# ------------------------------------------------- the contract cases

def test_reset_step_contract(tmp_path, stub):
    env, world = _make_env(tmp_path)
    tick = env.reset()
    assert tick["rgb"].shape == (8, 144, 256, 3)
    assert tick["route_fig"].shape[0] == 8
    assert len(tick["measurements"]) == 8
    assert "command" in tick and "new_event_list" in tick
    heroes = [a for a in world.get_actors()
              if a.attributes.get("role_name") == "hero"]
    assert len(heroes) == 1
    tick, rewards, done, info = env.step([0.0, 0.6, 0.0])
    assert len(rewards) == 2 and not done
    for _ in range(10):
        env.step([0.0, 0.6, 0.0])
    assert heroes[0].get_location().x > 0.5
    env.close()
    assert not world.get_settings().synchronous_mode     # restored


def test_synchronous_mode_and_light_times(tmp_path, stub):
    env, world = _make_env(tmp_path, junction_x=100.0, add_light=True)
    assert world.get_settings().synchronous_mode
    assert abs(world.get_settings().fixed_delta_seconds - 0.1) < 1e-9
    env.reset()
    light = world.get_actors().filter("*traffic_light*")[0]
    assert light.times == {"green": 5.0, "red": 0.5, "yellow": 3.0}
    assert len(env._light_infos) == 1
    info = env._light_infos[0]
    assert info.stop_lines, "trigger-volume discretization found no lanes"
    # plane space is (-y, x): the stop line lies near lon=98 (x), lat=0
    np.testing.assert_allclose(info.center[0], 0.0, atol=1e-6)
    assert 90.0 < info.center[1] < 102.0
    # the world-frame twin of the same light, for the behaviours
    assert env._light_infos_world[0].actor is info.actor
    np.testing.assert_allclose(env._light_infos_world[0].center,
                               [98.0, 0.0], atol=1e-6)
    env.close()


@pytest.mark.parametrize("state,infractions", [("Red", 1), ("Green", 0)])
def test_light_infraction_end_to_end(state, infractions, tmp_path, stub):
    """Through a red light: one infraction after the approach event;
    through a green one: none."""
    env, world = _make_env(tmp_path, junction_x=60.0, add_light=True)
    env.reset()
    light = world.get_actors().filter("*traffic_light*")[0]
    light.set_state(getattr(stub.TrafficLightState, state))
    types, _, _ = _drive_events(env, 250, 0.18)
    assert TrafficEventType.APPROACH_LIGHT in types
    assert types.count(TrafficEventType.TRAFFIC_LIGHT_INFRACTION) == \
        infractions
    env.close()


def test_scenario_trigger_spawns_real_actor(tmp_path, stub):
    scen = _scenario_json(tmp_path / "s.json", [("Scenario3", 40.0, 0.0)])
    env, world = _make_env(tmp_path, scenario_file=scen)
    env.reset()
    assert env._scenario_manager is not None
    assert len(env._scenario_manager.triggers) == 1

    def walkers():
        return [a for a in world.get_actors()
                if a.type_id.startswith("walker")]

    assert not walkers()
    spawned = False
    for _ in range(300):
        _, _, done, _ = env.step([0.0, 0.18, 0.0])
        spawned = bool(walkers())
        if spawned or done:
            break
    assert spawned, "crossing walker never spawned"
    w = walkers()[0]
    p0 = np.array([w.get_location().x, w.get_location().y])
    for _ in range(10):
        env.step([0.0, 0.3, 0.0])
    p1 = np.array([w.get_location().x, w.get_location().y])
    assert float(np.hypot(*(p1 - p0))) > 0.5, "walker did not move"
    env.close()


def test_collision_with_scenario_vehicle_terminates(tmp_path, stub):
    scen = _scenario_json(tmp_path / "s.json", [("Scenario2", 5.0, 0.0)])
    env, world = _make_env(tmp_path, scenario_file=scen)
    env.reset()
    types, rewards, done = _drive_events(env, 300, 0.22)
    assert TrafficEventType.COLLISION_VEHICLE in types
    assert done
    assert rewards[1] <= -1.0            # throttle event reward
    env.close()


def test_control_loss_scenario_injects_noise(tmp_path, stub):
    scen = _scenario_json(tmp_path / "s.json", [("Scenario1", 3.0, 0.0)])
    env, world = _make_env(tmp_path, scenario_file=scen)
    env.reset()
    saw_noise = False
    for _ in range(30):
        env.step([0.0, 0.4, 0.0])
        if abs(env._control_noise) > 1e-9:
            saw_noise = True
            break
    assert saw_noise
    env.close()


def test_route_completion_event(tmp_path, stub):
    env, world = _make_env(tmp_path, points=((0.0, 0.0), (40.0, 0.0)))
    env.reset()
    types, _, _ = _drive_events(env, 400, 0.18)
    assert TrafficEventType.ROUTE_COMPLETED in types
    assert env.completion_ratio == 100.0
    env.close()


def test_light_state_setter_forces_server_light(tmp_path, stub):
    """TrafficLightStateSetterBehavior pushes the forced state to the
    server actor, and the per-tick refresh does not flicker a frozen light
    back."""
    from cadre_tpu_torch.envs.scenarios import (
        TrafficLightStateSetterBehavior,
    )
    from cadre_tpu_torch.envs.traffic_lights import RED

    env, world = _make_env(tmp_path, junction_x=40.0, add_light=True)
    env.reset()
    assert env._light_infos, "stub light not annotated"
    info = env._light_infos[0]
    TrafficLightStateSetterBehavior(info, RED)
    assert info.frozen == RED
    assert str(info.actor.get_state()) == "Red"
    assert info.actor.get_green_time() > 1e6
    env.step([0.0, 0.5, 0.0])
    assert info.state == RED
    env.close()


def test_update_light_states_round_trip_on_server(tmp_path, stub):
    from cadre_tpu_torch.envs.traffic_lights import (
        GREEN,
        RED,
        reset_lights,
        update_light_states,
    )

    env, world = _make_env(tmp_path, junction_x=40.0, add_light=True)
    env.reset()
    info = env._light_infos[0]
    info.actor.set_green_time(7.0)
    params = update_light_states(info, {}, {"ego": RED}, freeze=True)
    assert str(info.actor.get_state()) == "Red"
    assert info.actor.get_green_time() > 1e6
    reset_lights(params)
    assert info.frozen is None
    assert info.actor.get_green_time() == 7.0
    assert str(info.actor.get_state()) == str(
        getattr(sys.modules["carla"].TrafficLightState, GREEN.capitalize()))
    env.close()


def test_signal_junction_forces_server_light_world_frame(tmp_path, stub):
    """SignalJunctionBehavior finds the ego's light in world meters (the
    frame of env._pos/_yaw), then forces INT_CONF phase 1 on the server
    actor (Scenario7-9)."""
    scen = _scenario_json(tmp_path / "s.json", [("Scenario7", 20.0, 0.0)])
    env, world = _make_env(tmp_path, scenario_file=scen, junction_x=60.0,
                           add_light=True)
    env.reset()
    assert env._light_infos_world, "world-frame light records must exist"
    light_actor = world.get_actors().filter("*traffic_light*")[0]
    beh = None
    for _ in range(300):
        _, _, done, _ = env.step([0.0, 0.2, 0.0])
        for b in env._scenario_manager.active:
            if b.__class__.__name__ == "SignalJunctionBehavior":
                beh = b
        if beh is not None or done:
            break
    assert beh is not None, "Scenario7 behavior never fired"
    assert beh._ego_light is not None, "ego light not found"
    assert "Red" in str(light_actor.get_state())
    env.close()


def test_watchdog_trips_on_hung_tick(tmp_path, stub):
    """A world.tick slower than the client timeout raises instead of
    hanging the worker."""
    env, world = _make_env(tmp_path)
    env.reset()
    env._watchdog.stop()
    env._watchdog.timeout = 0.05
    env._watchdog.start()
    real_tick = world.tick

    def hung_tick(timeout=None):
        time.sleep(0.2)
        return real_tick(timeout)

    world.tick = hung_tick
    with pytest.raises(RuntimeError, match="watchdog"):
        env.step([0.0, 0.5, 0.0])
    world.tick = real_tick
    env.close()


def test_watchdog_brackets_only_the_tick(tmp_path, stub):
    """Healthy ticks leave the watchdog quiet, and time spent between
    steps (the agent's act: a first act builds the kernels) does not
    count against it."""
    env, world = _make_env(tmp_path)
    env.reset()
    env._watchdog.stop()
    env._watchdog.timeout = 0.1
    env._watchdog.start()
    for _ in range(3):
        env.step([0.0, 0.5, 0.0])
        time.sleep(0.15)
    assert not env._watchdog.failed
    env.close()


@pytest.mark.parametrize("stype,wanted", [
    # Scenario3's jaywalker comes with a vision-blocker prop
    # (object_crash_vehicle.py:228-248)
    ("Scenario3", ("walker.pedestrian.0001", "static.prop.vendingmachine")),
    # Scenario4's junction crosser is the cyclist blueprint
    # (object_crash_intersection.py:689)
    ("Scenario4", ("vehicle.diamondback.century",)),
])
def test_scenario_actor_blueprints(stype, wanted, tmp_path, stub):
    scen = _scenario_json(tmp_path / "s.json", [(stype, 40.0, 0.0)])
    env, world = _make_env(tmp_path, scenario_file=scen)
    env.reset()

    def kinds():
        return {a.type_id for a in world.get_actors()}

    for _ in range(300):
        _, _, done, _ = env.step([0.0, 0.2, 0.0])
        if set(wanted) <= kinds() or done:
            break
    assert set(wanted) <= kinds(), f"{stype} spawned {sorted(kinds())}"
    env.close()


def test_blocked_spawn_falls_back_to_a_ghost(tmp_path, stub, monkeypatch):
    """Where the server refuses a scenario actor, the behaviour gets a
    SimObstacle ghost and still runs."""
    from cadre_tpu_torch.envs.sim_env import SimObstacle

    env, world = _make_env(tmp_path)
    env.reset()
    monkeypatch.setattr(world, "try_spawn_actor", lambda *a, **k: None)
    handle = env.spawn_scenario_actor("walker", (10.0, 3.0), speed=1.0)
    assert isinstance(handle, SimObstacle) and handle.radius == 0.4
    assert env._obstacles[-1] is handle
    env.close()


def test_crossing_cyclist_variant_collision_is_vehicle():
    """The cyclist adversary variant scores as a vehicle collision (its
    blueprint is a vehicle.* either way)."""
    from cadre_tpu_torch.envs.scenarios import CrossingBehavior
    from cadre_tpu_torch.envs.sim_env import SimDrivingEnv

    env = SimDrivingEnv(seed=3, seq_length=2)
    env.reset()
    beh = CrossingBehavior(env, kind="cyclist", ahead=6.0, lateral=5.0)
    assert beh._ob.kind == "cyclist"
    types = []
    for _ in range(200):
        beh.tick(env)
        tick, rewards, done, info = env.step([0.0, 0.8, 0.0])
        types.extend(e.get_type() for e in tick["new_event_list"])
        if done:
            break
    assert TrafficEventType.COLLISION_VEHICLE in types


def test_carla_env_dense_branch_turns(tmp_path, stub):
    """Over GridTownMap the map-aware branch runs: the trace turns at the
    junction and carries a non-LANEFOLLOW command."""
    torch_carla_stub.Client._worlds = {8010: _world(torch_carla_stub,
                                                    grid=True)}
    routes = _routes_xml(tmp_path / "routes.xml",
                         [(-40.0, 1.75), (-1.75, 60.0)])
    env = pce.CarlaDrivingEnv(port=8010, routes_file=routes, training=True,
                              client_timeout=5.0)
    try:
        env.reset()
        pts = np.asarray([[tf.location.x, tf.location.y]
                          for tf, _ in env._route_transforms])
        opts = {opt for _, opt in env._route_transforms}
        assert RoadOption.RIGHT in opts   # east -> +y = RIGHT (CARLA frame)
        on_east = (np.abs(pts[:, 1] - 1.75) < 1.0) & (pts[:, 0] < -10.0)
        on_north = (np.abs(pts[:, 0] + 1.75) < 1.0) & (pts[:, 1] > 10.0)
        assert on_east.any() and on_north.any()
    finally:
        env.close()


def test_speedometer_thread_pushes_projected_speed(tmp_path, stub,
                                                   monkeypatch):
    """The real SpeedometerReader: a thread that pushes the velocity
    projected on the heading every 1 / reading_frequency s into the
    tick's queue, stopped with the sensors; an env on it steps, each
    tick waiting for a reading."""
    world = torch_carla_stub.World("Town01")
    car = world.spawn_actor(world.get_blueprint_library().find(
        "vehicle.lincoln.mkz2017"), torch_carla_stub.Transform(
        torch_carla_stub.Location(), torch_carla_stub.Rotation(yaw=30.0)))
    car._velocity = torch_carla_stub.Vector3D(3.0, 4.0, 0.0)
    iface = psensors.SensorInterface(timeout=5.0)
    reader = psensors.SpeedometerReader(car, 50, iface, tag="speed")
    reader.start()
    try:
        got = [iface._queue.get(timeout=5.0) for _ in range(3)]
    finally:
        reader.stop()
    want = 3.0 * math.cos(math.radians(30)) + 4.0 * math.sin(
        math.radians(30))
    assert [g[:2] for g in got] == [("speed", 1), ("speed", 2),
                                    ("speed", 3)]
    assert all(abs(g[2]["speed"] - want) < 1e-12 for g in got)
    time.sleep(0.1)
    assert not reader._thread.is_alive()

    monkeypatch.setattr(pce, "SpeedometerReader", psensors.SpeedometerReader)
    env, world = _make_env(tmp_path)
    env.reset()
    for _ in range(3):
        tick, _, done, _ = env.step([0.0, 0.6, 0.0])
    thread = env._speedometer._thread
    assert tick["speed"] >= 0.0 and not done and thread.is_alive()
    env.close()
    thread.join(timeout=5.0)
    assert not thread.is_alive()


# ------------------------------------------------- exact parity with JAX

PARITY_CASES = {
    # background vehicles on the spawn points Python's random shuffles
    "straight_traffic": dict(vehicles=(2, 0)),
    "grid_town": dict(grid=True, points=((-15.0, 1.75), (-1.75, 40.0))),
    "red_light": dict(junction_x=6.0, light="Red"),
    "scenario_trigger": dict(scenarios=[("Scenario1", 3.0, 0.0),
                                        ("Scenario3", 12.0, 0.0)]),
    "eval": dict(training=False, points=((0.0, 0.0), (40.0, 0.0)),
                 scenarios=[("Scenario2", 6.0, 0.0)]),
}


ON_BOTH_STUBS = ("grid_town", "red_light", "scenario_trigger")


def _criteria_state(env):
    return [(c.name, c.test_status, c.actual_value,
             [(e.get_type().name, e.get_message(), e.get_dict())
              for e in c.list_traffic_events]) for c in env._criteria]


def _record(env, tick, rewards=None, done=None, info=None):
    out = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
           for k, v in tick.items() if k != "new_event_list"}
    out["events"] = _events(tick)
    out["criteria"] = _criteria_state(env)
    out["step"] = (None if rewards is None else
                   (np.array(rewards), done, info))
    out["obstacles"] = [(type(o).__name__, o.kind, np.round(o.pos, 9).tolist())
                        for o in env._obstacles]
    return out


def _drive_parity(env_mod, stub_mod, case, tmp_path, monkeypatch):
    """Reset + PARITY_STEPS seeded steps (resetting on done) of
    `env_mod`'s CarlaDrivingEnv on `stub_mod`'s world for `case`; every
    tick's record."""
    monkeypatch.setitem(sys.modules, "carla", stub_mod.make_module())
    monkeypatch.setattr(stub_mod, "_NEXT_ID", [1])
    world = _world(stub_mod, case.get("junction_x"), case.get("light"),
                   case.get("grid", False))
    stub_mod.Client._worlds = {8010: world}
    points = case.get("points", ((0.0, 0.0), (200.0, 0.0)))
    scen = None
    if case.get("scenarios"):
        scen = _scenario_json(tmp_path / "s.json", case["scenarios"])
    training = case.get("training", True)
    env = env_mod.CarlaDrivingEnv(
        port=8010, routes_file=_routes_xml(tmp_path / "r.xml", points),
        scenario_file=scen, training=training, client_timeout=5.0,
        vehicle_num=case.get("vehicles", (0, 0)))
    if training:
        env.route_indexer._rng = np.random.RandomState(0)
    try:
        random.seed(0)
        out = [_record(env, env.reset())]
        rng = np.random.RandomState(1)
        for t in range(PARITY_STEPS):
            control = [float(rng.uniform(-0.1, 0.1)),
                       float(rng.uniform(0.1, 0.7)), float(rng.rand() < 0.05)]
            tick, rewards, done, info = env.step(control)
            out.append(_record(env, tick, rewards, done, info))
            if done:
                random.seed(t + 1)
                out.append(_record(env, env.reset()))
    finally:
        env.close()
        stub_mod.Client._worlds = {}
    return out


def _assert_records_equal(ours, ref, what):
    assert len(ours) == len(ref), what
    for t, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys(), (what, t)
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, (what, t, k)
                np.testing.assert_array_equal(x, y, err_msg=f"{what} {t} {k}")
            elif k == "step" and x is not None:
                np.testing.assert_array_equal(x[0], y[0])
                assert x[0].dtype == y[0].dtype and x[1:] == y[1:], \
                    (what, t)
            else:
                assert x == y, (what, t, k, x, y)


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_carla_env_equals_jax(case, tmp_path, monkeypatch):
    """Reset + 60 steps of the JAX and the port CarlaDrivingEnv under the
    same seeded controls, both speedometers pinned: every tick key, the
    events, rewards, done, infos, criteria and scenario actors exactly
    equal; on the grid town (whose map class each stub takes from its
    own package) and with the light and the scenario actors, the port's
    env on the JAX package's stub gives the same ticks as on its own."""
    monkeypatch.setattr(jce, "SpeedometerReader", tick_speedometer(jsensors))
    monkeypatch.setattr(pce, "SpeedometerReader", tick_speedometer(psensors))
    cfg = PARITY_CASES[case]
    ref = _drive_parity(jce, carla_stub, cfg, tmp_path, monkeypatch)
    ours = _drive_parity(pce, torch_carla_stub, cfg, tmp_path, monkeypatch)
    _assert_records_equal(ours, ref, case)
    if case in ON_BOTH_STUBS:
        on_jax_stub = _drive_parity(pce, carla_stub, cfg, tmp_path,
                                    monkeypatch)
        _assert_records_equal(on_jax_stub, ours, f"{case} on carla_stub")
    # what each case is there for happened
    events = {e[0] for r in ours for e in r["events"]}
    kinds = {o[1] for r in ours for o in r["obstacles"]}
    if case == "red_light":
        assert "TRAFFIC_LIGHT_INFRACTION" in events, events
    elif case == "scenario_trigger":
        assert "walker" in kinds, kinds
    elif case == "eval":
        assert "vehicle" in kinds, kinds
    elif case == "grid_town":
        assert {r["command"] for r in ours} - {3}, "no turn command"


def test_env_config_and_gps_planner_equal_jax():
    """EnvConfig field by field; the GPS plan (set_route with gps=True,
    and its meters form) and run_step equal the JAX planner's, and
    set_route_meters resets mean and scale to 0 and 1 as it does."""
    assert dataclasses.asdict(EnvConfig()) == \
        dataclasses.asdict(JaxEnvConfig())
    np.testing.assert_array_equal(pplanner.GPS_MEAN, jplanner.GPS_MEAN)
    np.testing.assert_array_equal(pplanner.GPS_SCALE, jplanner.GPS_SCALE)
    rng = np.random.RandomState(0)
    xy = np.cumsum(rng.uniform(0.5, 1.5, (80, 2)), axis=0)
    gps = [({"lat": 49.0 - y / 111324.60662786,
             "lon": 49.0 + x / 111324.60662786, "z": 0.0}, RoadOption(3))
           for x, y in xy]
    for plan, flag in ((gps, True), ([(p, RoadOption(3)) for p in xy],
                                     False)):
        ours = pplanner.RoutePlanner(4.0, 50.0)
        ref = jplanner.RoutePlanner(4.0, 50.0)
        ours.set_route(plan, gps=flag)
        ref.set_route(plan, gps=flag)
        for p in np.asarray([r[0] for r in ref.route])[::7] + 0.3:
            a, b = ours.run_step(p), ref.run_step(p)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
            np.testing.assert_array_equal(np.asarray(a[2]),
                                          np.asarray(b[2]))
    ours.set_route_meters(xy, [RoadOption(3)] * len(xy))
    ref.set_route_meters(xy, [RoadOption(3)] * len(xy))
    for planner in (ours, ref):
        np.testing.assert_array_equal(planner.mean, np.zeros(2))
        np.testing.assert_array_equal(planner.scale, np.ones(2))


# ------------------------------------------------- main and eval --env carla

@pytest.mark.parametrize("flags,snapshot", [
    (["--num-envs", "2", "--iterations", "1"], ("models",)),
    (["--num-envs", "1", "--episodes", "1"], ("0", "models")),
])
def test_main_env_carla_trains(flags, snapshot, tmp_path, stub):
    """`main --env carla --town Town01` in process: env k connects to
    --carla-port + 10 k (one stub world per port, each with its hero),
    trains through train_vec (N=2) or train (N=1) and writes a snapshot
    that loads back."""
    from cadre_tpu_torch import main as pmain
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent

    n = int(flags[1])
    worlds = {8030 + 10 * k: torch_carla_stub.World("Town01")
              for k in range(n)}
    torch_carla_stub.Client._worlds = dict(worlds)
    routes = _routes_xml(tmp_path / "r.xml", ((0.0, 0.0), (60.0, 0.0)))
    work = tmp_path / "w"
    path = pmain.main(["--env", "carla", "--town", "Town01", "--small",
                       "--device", "cpu", "--carla-port", "8030",
                       "--num-steps", "4", "--routes", routes,
                       "--work-dir", str(work), *flags])
    assert path == str(work.joinpath(*snapshot, "ppo_model_0.pt"))
    for port, world in worlds.items():
        heroes = [a for a in world.get_actors()
                  if a.attributes.get("role_name") == "hero"]
        assert len(heroes) == 1, port
    agent = CadreAgent.create(danet_params(**SMALL), device="cpu")
    agent.load_snapshot(path)


def test_main_proc_envs_env_carla(tmp_path, monkeypatch):
    """`main --proc-envs --env carla`: the workers start from a fresh
    import (spawn), so the stub reaches them as a `carla.py` on the
    sys.path they inherit; two workers train one iteration."""
    from cadre_tpu_torch import main as pmain

    (tmp_path / "carla.py").write_text(
        "from torch_carla_stub import *  # noqa: F401,F403\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.syspath_prepend(os.path.dirname(os.path.abspath(__file__)))
    routes = _routes_xml(tmp_path / "r.xml", ((0.0, 0.0), (60.0, 0.0)))
    work = tmp_path / "w"
    path = pmain.main(["--env", "carla", "--small", "--device", "cpu",
                       "--num-envs", "2", "--proc-envs", "--num-steps", "4",
                       "--iterations", "1", "--routes", routes,
                       "--work-dir", str(work)])
    assert path == str(work / "models" / "ppo_model_0.pt")
    assert os.path.exists(path)


def test_main_env_carla_needs_the_carla_package(tmp_path, monkeypatch):
    """Without the `carla` package `--env carla` raises the
    ModuleNotFoundError the JAX CLI gives, on both training paths; it
    falls back to no other env."""
    from cadre_tpu_torch import main as pmain

    monkeypatch.setitem(sys.modules, "carla", None)
    routes = _routes_xml(tmp_path / "r.xml", ((0.0, 0.0), (60.0, 0.0)))
    for n in ("1", "2"):
        with pytest.raises(ModuleNotFoundError, match="carla") as err:
            pmain.main(["--env", "carla", "--small", "--device", "cpu",
                        "--num-envs", n, "--num-steps", "4", "--routes",
                        routes, "--work-dir", str(tmp_path / n)])
        assert err.value.name == "carla"
    assert "carla" not in {m.split(".")[0] for m in sys.modules
                           if sys.modules[m] is not None
                           and m.startswith("carla")}


def _parked_car_world(stub_mod):
    """The straight road with a parked car 4.1 m ahead of the route's
    start, which ends an eval episode in a collision once the ego rolls
    0.1 m."""
    world = stub_mod.World("Town01")
    bp = world.get_blueprint_library().find("vehicle.tesla.model3")
    world.try_spawn_actor(bp, stub_mod.Transform(stub_mod.Location(4.1)))
    return world


def test_eval_cli_carla_equals_jax(ensemble, tmp_path, monkeypatch):
    """`python -m cadre_tpu_torch.eval --env carla` (training=False, so a
    sequential RouteIndexer) of K=3 .msgpack members with the JAX
    encoder frozen in (--danet-checkpoint) against the JAX `evaluate` on
    the JAX env, JAX's draws replayed: equal results and criteria CSV
    rows, the same completion CSV."""
    from cadre_tpu_torch import eval as peval

    jagent, jens, _, _, msgs = ensemble
    monkeypatch.setattr(jevaluate, "EnsembleAgent", lambda a, p: jens)
    monkeypatch.setattr(jce, "SpeedometerReader", tick_speedometer(jsensors))
    monkeypatch.setattr(pce, "SpeedometerReader", tick_speedometer(psensors))
    routes = _routes_xml(tmp_path / "r.xml", ((0.0, 0.0), (20.0, 0.0)))
    encoder = str(tmp_path / "encoder.msgpack")
    jckpt.save_pytree(encoder, jagent.danet_vars)

    monkeypatch.setitem(sys.modules, "carla", carla_stub.make_module())
    carla_stub.Client._worlds = {8010: _parked_car_world(carla_stub)}
    env = jce.CarlaDrivingEnv(port=8010, routes_file=routes, training=False,
                              vehicle_num=(0, 0), client_timeout=5.0,
                              work_dir=str(tmp_path / "jax"))
    random.seed(0)
    ref = jevaluate.evaluate(env, jagent, msgs, JaxEvalConfig(eval_episode=1),
                             seed=7, result_file=str(tmp_path / "jax.csv"))
    env.close()
    carla_stub.Client._worlds = {}
    draws = _replay_jax_eval_draws(7, sum(r.steps for r in ref), K)

    monkeypatch.setitem(sys.modules, "carla", torch_carla_stub.make_module())
    torch_carla_stub.Client._worlds = {8010: _parked_car_world(
        torch_carla_stub)}
    monkeypatch.setattr(pevaluate, "evaluate", functools.partial(
        pevaluate.evaluate, draws=draws))
    work = tmp_path / "port"
    random.seed(0)
    ours = peval.main(["--env", "carla", "--small", "--device", "cpu",
                       "--snapshots", *msgs, "--episodes", "1", "--routes",
                       routes, "--vehicles", "0", "--walkers", "0",
                       "--seed", "7", "--danet-checkpoint", encoder,
                       "--town", "Town01", "--carla-port", "8010",
                       "--work-dir", str(work)])
    assert [vars(r) for r in ours] == [vars(r) for r in ref]
    assert (work / "criteria_results.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert (work / "eval_completion_ratio.csv").read_text() == \
        (tmp_path / "jax" / "eval_completion_ratio.csv").read_text()
    assert ours[0].steps > 1
    assert ours[0].error_message == "collision vehicles!"


# ------------------------------------------------- the three CLIs

def _load_script(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Idle:
    """Stands in for the JAX script's agent, whose act result the script
    discards: the episode lines depend on the scripted controls alone."""

    def act(self, tick, key):
        return None


def test_simple_test_equals_jax(tmp_path, monkeypatch, capsys):
    """simple_test's episode lines equal the JAX script's with `--env
    carla`, which drives the sim env in both (the JAX script's quirk),
    and the PNG reads back as the last tick's 8 frames side by side."""
    from cadre_tpu.rl.agent import CadreAgent as JaxAgent
    from cadre_tpu_torch import simple_test

    script = _load_script("jax_simple_test", "simple_test.py")
    monkeypatch.setattr(JaxAgent, "create", lambda *a, **k: _Idle())
    monkeypatch.setattr(sys, "argv", [
        "simple_test.py", "--small", "--env", "carla", "--steps", "5",
        "--out", str(tmp_path / "jax.png")])
    script.main()
    ref = capsys.readouterr().out
    out = tmp_path / "port.png"
    tick = simple_test.main(["--small", "--device", "cpu", "--env", "carla",
                             "--steps", "5", "--out", str(out)])
    ours = capsys.readouterr().out

    def episodes(text):
        return [x for x in text.splitlines() if x.startswith("episode")]

    assert episodes(ours) == episodes(ref) and len(episodes(ours)) == 2
    assert f"wrote {out}" in ours
    frames = read_png(str(out))
    assert frames.shape == (144, 8 * 256, 3)
    np.testing.assert_array_equal(
        frames, np.concatenate(list(tick["rgb"]), axis=1))


@pytest.mark.parametrize("argv", [
    ["--list"],
    ["--scenario", "dynamic_object_crossing", "--timeout", "8"],
    ["--scenario", "follow_leading_vehicle", "--agent", "npc", "--timeout",
     "6"],
    ["--openscenario", "XOSC", "--timeout", "6"],
    ["--scenario", "no_such_scenario"],
])
def test_run_scenario_equals_jax(argv, tmp_path, capsys):
    """run_scenario's exit code, stdout, report file and JUnit XML equal
    the JAX script's, apart from the wall-clock fields."""
    from cadre_tpu_torch import run_scenario
    from test_openscenario import XOSC

    script = _load_script("jax_run_scenario",
                          os.path.join("scripts", "run_scenario.py"))
    if "XOSC" in argv:
        (tmp_path / "s.xosc").write_text(XOSC)
        argv = [str(tmp_path / "s.xosc") if a == "XOSC" else a
                for a in argv]
    got = {}
    for name, run in (("jax", lambda a: script.run(
            script_args(script, a))), ("port", run_scenario.main)):
        files = ["--output-file", str(tmp_path / f"{name}.txt"),
                 "--junit", str(tmp_path / f"{name}.xml")]
        code = run([*argv, *files])
        texts = [capsys.readouterr().out]
        for ext in ("txt", "xml"):
            path = tmp_path / f"{name}.{ext}"
            texts.append(path.read_text() if path.exists() else None)
        got[name] = (code, [None if t is None else [
            re.sub(r' time="[^"]*"', "", x) for x in t.splitlines()
            if not WALL_CLOCK.search(x)] for t in texts])
    assert got["port"] == got["jax"]
    if argv[0] != "--list" and got["port"][0] != 2:
        assert "Results of Scenario" in "\n".join(got["port"][1][1])


# the report's wall-clock lines (the JUnit suite's time attribute is
# dropped from its line)
WALL_CLOCK = re.compile("Start Time|End Time|System Time")


def script_args(script, argv):
    """The JAX script's argparse namespace for `argv` (its main() parses
    sys.argv and exits)."""
    import argparse

    parser = argparse.ArgumentParser()
    for flag, kw in (("--scenario", {}), ("--openscenario", {}),
                     ("--list", dict(action="store_true")),
                     ("--agent", dict(default="oracle")),
                     ("--seed", dict(type=int, default=0)),
                     ("--timeout", dict(type=float)),
                     ("--trigger-dist", dict(type=float, default=25.0)),
                     ("--output-file", {}), ("--junit", {})):
        parser.add_argument(flag, **kw)
    return parser.parse_args(argv)


# the keys of scripts/run_nocrash_eval.py's artifact, level by level
NOCRASH_KEYS = {
    "": ["experiment", "protocol", "config", "train", "eval"],
    "protocol": ["train_routes", "eval_routes", "ensemble_members",
                 "reference", "geometry", "traffic"],
    "config": ["iterations", "num_envs", "steps", "encoder",
               "encoder_sha256", "code_rev", "tiers", "seed", "warm_start",
               "total_env_steps"],
    "train": ["wall_s", "rows"],
    "row": ["iteration", "env_steps", "env_steps_per_sec", "episodes_done",
            "mean_completion", "error_hist"],
    "tier": ["routes", "episodes", "amount_town_wide", "n_vehicles_onroute",
             "n_walkers_onroute", "mean_completion", "mean_driving_score",
             "errors", "rows", "csv"],
}


def test_run_nocrash_eval_small_on_cpu(tmp_path):
    """`run_nocrash_eval --small --device cpu` on write_lane_routes XMLs:
    two training iterations, a snapshot after each in the port's format,
    the eval of the last two, and an artifact with the JAX script's
    keys; `--warm-start --eval-only` reads the newest snapshot back and
    numbers on from it."""
    from cadre_tpu_torch import run_nocrash_eval

    train = write_lane_routes(str(tmp_path / "train.xml"), 3, n_short=1)
    evalx = write_lane_routes(str(tmp_path / "eval.xml"), 2, n_short=2)
    work = tmp_path / "nocrash"
    argv = ["--small", "--device", "cpu", "--num-envs", "2", "--steps", "3",
            "--snap-every", "1", "--eval-members", "2", "--tiers",
            "regular", "--eval-steps", "2", "--train-routes", train,
            "--eval-routes", f"Town01={evalx}", "--workdir", str(work)]
    art = run_nocrash_eval.main([*argv, "--iterations", "2"])
    saved = json.loads((work / "nocrash_eval.json").read_text())
    assert saved == json.loads(json.dumps(art))
    assert list(art) == NOCRASH_KEYS[""]
    for key in ("protocol", "config", "train"):
        assert list(art[key]) == NOCRASH_KEYS[key], key
    assert [list(r) for r in art["train"]["rows"]] == [NOCRASH_KEYS["row"]]
    assert art["train"]["rows"][0]["env_steps"] == 2 * 2 * 3
    assert list(art["eval"]) == ["Town01"]
    row = art["eval"]["Town01"]["regular"]
    assert list(row) == NOCRASH_KEYS["tier"] and row["routes"] == 2
    assert (row["n_vehicles_onroute"], row["n_walkers_onroute"]) == (3, 6)
    assert art["protocol"]["ensemble_members"] == 2
    assert sorted(os.listdir(work)) == [
        "eval_completion_ratio_Town01_regular.csv", "nocrash_eval.json",
        "snap_00001.pt", "snap_00002.pt"]
    with pytest.raises(ValueError, match="TOWN=XML"):
        run_nocrash_eval.main([*argv, "--eval-routes", evalx])
