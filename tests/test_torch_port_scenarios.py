"""The port's scenario runtime, host-env ensemble eval and process envs
against the JAX package, on the CPU.

The scenario runtime, the scoring and the process envs are numpy (and
native host code) in both packages, so the port is held to the JAX
package exactly: the same seeds, annotations and controls give equal
frames, rewards, done flags, infos, obstacle tables and light states. The
ensemble act and `evaluate` are held to the JAX package's with the same
weights (flax weights through cadre_tpu_torch.utils.convert) and the same
Gumbel noise (JAX's draws, rebuilt from its keys and handed to the port):
equal actions, results and CSV rows. The native libraries (ring, raster)
are built with g++ into build/host/ at first use.
"""
import functools
import glob
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.configs.agent_config import AgentConfig as JaxAgentConfig
from cadre_tpu.configs.agent_config import EvalConfig as JaxEvalConfig
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.envs import route_fig as jrf
from cadre_tpu.envs import route_parser as jparser
from cadre_tpu.envs import scenarios as jscen
from cadre_tpu.envs import scoring as jscoring
from cadre_tpu.envs import sim_env as jsim
from cadre_tpu.envs import vec_env as jvec
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.models.danet import create_danet
from cadre_tpu.models.policy import PolicyBankDef
from cadre_tpu.rl import evaluate as jevaluate
from cadre_tpu.rl.agent import CadreAgent as JaxAgent
from cadre_tpu.rl.agent import EnsembleAgent as JaxEnsembleAgent
from cadre_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from cadre_tpu.utils import checkpoint as jckpt
from cadre_tpu_torch.configs.agent_config import EvalConfig, avg_action
from cadre_tpu_torch.envs import route_fig
from cadre_tpu_torch.envs import scenarios as pscen
from cadre_tpu_torch.envs import scoring
from cadre_tpu_torch.envs.route_parser import parse_scenario_file
from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
from cadre_tpu_torch.envs.town_maps import write_lane_routes
from cadre_tpu_torch.envs.vec_env import VecDrivingEnv
from cadre_tpu_torch.rl.agent import EnsembleAgent
from cadre_tpu_torch.rl.evaluate import evaluate
from cadre_tpu_torch.runtime.native_raster import rasterize_polyline_native
from cadre_tpu_torch.runtime.proc_vec_env import ProcVecDrivingEnv, _TickCodec
from cadre_tpu_torch.runtime.shm_ring import ShmRing
from cadre_tpu_torch.utils import libbuild
from cadre_tpu_torch.utils.convert import policy_from_flax, policy_to_flax
from test_torch_port_hostenv import (
    SMALL,
    STEER_BINS,
    THROTTLE_BINS,
    _assert_ticks_equal,
    _port_agent,
    _random_variables,
)
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_utils import _reference_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_STEPS = 80


# ------------------------------------------------- scenario files

def _write_scenarios(path, events, town="Town01"):
    """An available_scenarios JSON of (type, x, y) trigger events."""
    blob = {"available_scenarios": [{town: [
        {"scenario_type": t, "available_event_configurations": [
            {"transform": {"x": float(x), "y": float(y), "z": 0.0,
                           "yaw": 0.0}}]}
        for t, x, y in events]}]}
    with open(path, "w") as f:
        json.dump(blob, f)
    return str(path)


# every synthetic route starts at the origin heading +x, its first leg at
# least 40 m long: triggers on it fire as the ego drives the first leg
FIRST_LEG = (2.0, 16.0, 32.0)


def _controls(rng):
    """Seeded random controls that keep the ego on its first leg long
    enough for the triggers at 32 m and a light's reset to come."""
    return [float(rng.uniform(-0.15, 0.15)), float(rng.uniform(0.1, 0.7)),
            float(rng.rand() < 0.05)]


def _obstacle_table(env):
    return [(o.pos.tolist(), o.radius, o.kind, o.speed, o.heading,
             o.managed, o.route_s, o.cruise) for o in env._obstacles]


def _light_table(env):
    return [(li.state, li.frozen, li.center.tolist()) for li in env._lights]


def _assert_worlds_equal(ours, ref, what):
    """The scenario-visible state of both sims equal."""
    assert _obstacle_table(ours) == _obstacle_table(ref), what
    assert _light_table(ours) == _light_table(ref), what
    for k in ("_control_noise", "_throttle_noise", "_sun_altitude",
              "_pos", "_yaw", "_speed"):
        assert np.array_equal(getattr(ours, k), getattr(ref, k)), (what, k)
    assert getattr(ours, "blackboard", None) == \
        getattr(ref, "blackboard", None), what


def _run_pair(ours, ref, what, steps=SIM_STEPS, after_reset=None):
    """`steps` steps of seeded controls on both sims, resetting on done:
    ticks, rewards, done flags, infos and worlds equal at every step.
    `after_reset(env, module)` runs on both after every reset. Returns
    what the port's scenario managers did: triggers fired, the most
    obstacles, the ticks with control noise, the ticks with a light
    frozen, and the episodes ended."""
    seen = dict(fired=0, obstacles=0, noise=0, frozen=0, ends=0)

    def reset():
        pair = ours.reset(), ref.reset()
        if after_reset is not None:
            after_reset(ours, pscen)
            after_reset(ref, jscen)
        return pair

    _assert_ticks_equal(*reset(), f"{what} reset")
    rng = np.random.RandomState(0)
    for t in range(steps):
        control = _controls(rng)
        (to, ro, do, io), (tr, rr, dr, ir) = (e.step(control)
                                              for e in (ours, ref))
        _assert_ticks_equal(to, tr, f"{what} step {t}")
        assert ro.dtype == rr.dtype and np.array_equal(ro, rr), (what, t)
        assert (do, io) == (dr, ir), (what, t)
        _assert_worlds_equal(ours, ref, f"{what} step {t}")
        mgr = ours._scenario_manager
        if mgr is not None:
            seen["fired"] = max(seen["fired"],
                                sum(tr_.fired for tr_ in mgr.triggers))
        seen["obstacles"] = max(seen["obstacles"], len(ours._obstacles))
        seen["noise"] += ours._control_noise != 0.0
        seen["frozen"] += any(li.frozen is not None for li in ours._lights)
        if do:
            seen["ends"] += 1
            _assert_ticks_equal(*reset(), f"{what} {t}")
    assert ours._rng.randint(1 << 30) == ref._rng.randint(1 << 30), what
    return seen


SCENARIO_TYPES = [f"Scenario{k}" for k in range(1, 11)]


@pytest.mark.parametrize("stype", SCENARIO_TYPES)
def test_scenario_sim_equals_jax(stype, tmp_path):
    """A scenario JSON of three `stype` triggers on the route: 80 steps
    of the port's SimDrivingEnv(scenario_file=...) exactly equal to the
    JAX package's (ticks, rewards, dones, infos, obstacle table, lights,
    control noise), and the behaviour really ran: every trigger in reach
    fired, actors spawned (or steering noise, for Scenario1), and the
    junction light forced and later restored for Scenario7-9."""
    path = _write_scenarios(tmp_path / "s.json",
                            [(stype, x, 0.0) for x in FIRST_LEG])
    k = int(stype[len("Scenario"):])
    kw = dict(scenario_file=path, seed=k, vehicle_num=(1, 1))
    seen = _run_pair(SimDrivingEnv(**kw), jsim.SimDrivingEnv(**kw), stype)
    assert seen["fired"] >= 2, seen
    if stype == "Scenario1":
        assert seen["noise"] > 0, seen
    else:
        assert seen["obstacles"] > 2, seen            # beyond the traffic
    if stype in ("Scenario7", "Scenario8", "Scenario9"):
        assert 0 < seen["frozen"] < SIM_STEPS, seen   # forced, then reset


def test_animate_weather_sim_equals_jax(tmp_path):
    """animate_weather=True on a scenario-armed sim with randomized
    weather: the sun sinks through the episode, and everything stays
    exactly equal to the JAX package's."""
    path = _write_scenarios(tmp_path / "s.json",
                            [("Scenario3", 16.0, 0.0),
                             ("Scenario10", 32.0, 0.0)])
    kw = dict(scenario_file=path, seed=21, vehicle_num=(1, 0),
              animate_weather=True, randomize_weather=True)
    ours, ref = SimDrivingEnv(**kw), jsim.SimDrivingEnv(**kw)
    seen = _run_pair(ours, ref, "animate_weather", steps=60)
    assert seen["fired"] >= 2
    assert ours._sun_altitude < 70.0


@pytest.mark.parametrize("mode", ["sample", "no_repeat"])
def test_manager_sampling_equals_jax(mode, tmp_path):
    """ScenarioManager.from_annotations with `sample` (one candidate per
    trigger location, drawn from the env's rng) or `no_repeat` (each kind
    once): the same triggers as the JAX package's, and the sims driven by
    those managers exactly equal."""
    events = [("Scenario2", 2.0, 0.0), ("Scenario4", 2.5, 0.5),
              ("Scenario6", 3.0, -0.5), ("Scenario2", 16.0, 0.0),
              ("Scenario3", 16.5, 0.0), ("Scenario10", 32.0, 0.0),
              ("Scenario2", 32.5, 0.0), ("Scenario99", 5.0, 0.0),
              ("Scenario5", 500.0, 500.0)]
    path = _write_scenarios(tmp_path / "s.json", events)
    anns = parse_scenario_file(path)
    assert anns == jparser.parse_scenario_file(path)
    opts = {mode: True}

    def rearm(env, mod):
        env._scenario_manager = mod.ScenarioManager.from_annotations(
            anns, env._route_xy, rng=env._rng, **opts)

    kw = dict(seed=12, vehicle_num=(1, 1))
    ours, ref = SimDrivingEnv(**kw), jsim.SimDrivingEnv(**kw)
    ours.reset(), ref.reset()
    rearm(ours, pscen), rearm(ref, jscen)
    kinds = [(t.kind, t.pos.tolist()) for t in ours._scenario_manager.triggers]
    assert kinds == [(t.kind, t.pos.tolist())
                     for t in ref._scenario_manager.triggers]
    if mode == "sample":            # one per location: 2 m clusters
        assert len(kinds) == 3, kinds
    else:                           # Scenario2 once; 99 and off-route out
        assert len(kinds) == 5, kinds
    seen = _run_pair(ours, ref, mode, after_reset=rearm)
    assert seen["fired"] >= 2, seen


def _composite(mod, env):
    """A tree of atomic behaviours and trigger conditions over two actors
    the tree spawns: a Sequence that waits for the ego to drive 3 m, then
    a SUCCESS_ON_ALL Parallel of conditions and actor behaviours, then
    ego noise, a waypoint follow, and a blackboard write; beside it a
    SUCCESS_ON_ONE Parallel with a flow source and sink."""
    pos, yaw = env._pos.copy(), np.radians(env._yaw)
    fwd = np.array([np.cos(yaw), np.sin(yaw)])
    left = np.array([-fwd[1], fwd[0]])
    car = env.spawn_scenario_actor("vehicle", pos + 25 * fwd + 3.5 * left,
                                   heading=yaw + np.pi, speed=0.0)
    walker = env.spawn_scenario_actor("walker", pos + 18 * fwd + 6 * left,
                                      heading=yaw - np.pi / 2, speed=0.0)
    cond = mod.ConditionBehavior
    seq = mod.SequenceBehavior([
        cond(mod.DriveDistance("ego", 3.0)),
        mod.ParallelBehavior([
            cond(mod.InTriggerDistanceToVehicle("ego", car, 15.0)),
            cond(mod.InTriggerDistanceToLocation("ego", car.pos, 18.0)),
            cond(mod.InTimeToArrivalToLocation("ego", car.pos, 6.0)),
            cond(mod.InTimeToArrivalToVehicle("ego", car, 5.0)),
            cond(mod.TriggerVelocity("ego", 1.0)),
            cond(mod.TriggerAcceleration("ego", 0.5)),
            cond(mod.ElapsedSimTime(1.0)),
            cond(mod.TimeOfDayComparison(0.5)),
            cond(mod.WaitUntilInFront(car, "ego", check_distance=False)),
            cond(mod.InTriggerDistanceToLocationAlongRoute(
                "ego", env._route_xy[20], 12.0)),
            mod.KeepVelocityBehavior(car, 2.0, distance=6.0),
            mod.LaneChangeBehavior(walker, offset=1.0, duration=8),
        ], success_on_one=False),
        mod.AddNoiseToVehicleBehavior(0.05, 0.1, duration=5),
        mod.AccelerateToVelocityBehavior(car, 4.0, throttle_inc=0.5),
        mod.WaypointFollowerBehavior(
            walker, [walker.pos + 3 * fwd, walker.pos + 3 * fwd - 4 * left],
            speed=1.5),
        mod.StopVehicleBehavior(car),
        mod.SetBlackboardVariableBehavior("crossed", True),
    ])
    side = mod.ParallelBehavior([
        mod.ActorSourceBehavior(pos + 40 * fwd - 3.5 * left, yaw + np.pi,
                                speed=4.0, interval=1.5),
        mod.ActorSinkBehavior(pos + 10 * fwd - 3.5 * left, radius=4.0),
        cond(mod.WaitForBlackboardVariable("crossed", True)),
        cond(mod.Offroad("ego")),
        cond(mod.CollisionCondition("ego")),
        cond(mod.StandStill(car, 0.5)),
        cond(mod.HasBeenOccupied(walker)),
        cond(mod.WalkerCollision(walker)),
        cond(mod.TooFarAway(walker, 60.0)),
        cond(mod.InTriggerDistanceToNextIntersection("ego", 8.0)),
        cond(mod.TimeHeadway("ego", car, 1.0)),
    ], success_on_one=True)
    return mod.ParallelBehavior([seq, side], success_on_one=False)


def test_composite_behaviours_equal_jax():
    """The composite tree of `_composite` fired at the first tick on both
    sims: 120 steps exactly equal, the blackboard written."""
    def arm(env, mod):
        env._scenario_manager = mod.ScenarioManager(
            [mod.ScenarioTrigger("composite", at_tick=1,
                                 builder=lambda e, rng: _composite(mod, e))],
            rng=env._rng)

    kw = dict(seed=30, vehicle_num=(1, 1), training=False)
    ours, ref = SimDrivingEnv(**kw), jsim.SimDrivingEnv(**kw)
    seen = _run_pair(ours, ref, "composite", steps=120, after_reset=arm)
    assert seen["fired"] == 1 and seen["obstacles"] > 4, seen
    assert getattr(ours, "blackboard", {}).get("crossed") is True


# ------------------------------------------------- the parser

@pytest.fixture(scope="module")
def gen_routes_dir(tmp_path_factory):
    """The route XMLs and scenarios.json of scripts/gen_routes.py."""
    out = tmp_path_factory.mktemp("gen_routes")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                 "gen_routes.py"),
                    "--out", str(out), "--seed", "3"], check=True,
                   capture_output=True)
    return out


def test_parse_scenario_file_and_directory_equal_jax(gen_routes_dir,
                                                     tmp_path):
    """The file form, the directory form (every .json in name order) and
    the town filter give the JAX parser's annotations."""
    path = str(gen_routes_dir / "scenarios.json")
    got = parse_scenario_file(path)
    assert got == jparser.parse_scenario_file(path) and len(got) > 20
    _write_scenarios(tmp_path / "b.json", [("Scenario3", 1.0, 2.0)],
                     town="Town02")
    _write_scenarios(tmp_path / "a.json", [("Scenario1", 3.0, 4.0)])
    (tmp_path / "notes.txt").write_text("not a scenario file")
    d = str(tmp_path)
    for town in (None, "Town01", "Town02", "SimTown"):
        assert parse_scenario_file(d, town) == \
            jparser.parse_scenario_file(d, town), town
    assert [a["type"] for a in parse_scenario_file(d)] == \
        ["Scenario1", "Scenario3"]


# ------------------------------------------------- scoring

def test_scoring_equals_jax(tmp_path):
    """Two finished episodes of a scenario-armed sim with traffic on both
    packages: score_route's records, the StatisticsManager's global
    record and the per-criterion CSV equal."""
    path = _write_scenarios(tmp_path / "s.json",
                            [("Scenario3", x, 0.0) for x in FIRST_LEG])
    kw = dict(scenario_file=path, seed=3, vehicle_num=(2, 2),
              training=False)
    envs = SimDrivingEnv(**kw), jsim.SimDrivingEnv(**kw)
    stats = scoring.StatisticsManager(), jscoring.StatisticsManager()
    csvs = [str(tmp_path / f"{n}.csv") for n in ("port", "jax")]
    recs = ([], [])
    rng = np.random.RandomState(1)
    for env in envs:
        env.reset()
    episodes = 0
    for _ in range(600):
        control = _controls(rng)
        done = [env.step(control)[2] for env in envs]
        assert done[0] == done[1]
        if done[0]:
            for i, (env, mod) in enumerate(zip(envs, (scoring, jscoring))):
                recs[i].append(mod.score_route(str(env.route_name),
                                               env._criteria))
                stats[i].compute(str(env.route_name), env._criteria)
                mod.write_criteria_csv(csvs[i], env._criteria)
                env.reset()
            episodes += 1
            if episodes == 2:
                break
    assert episodes == 2
    assert [vars(r) for r in recs[0]] == [vars(r) for r in recs[1]]
    assert stats[0].global_record() == stats[1].global_record()
    assert open(csvs[0]).read() == open(csvs[1]).read()
    assert any(r.infractions for r in recs[0]), recs[0]


# ------------------------------------------------- the ensemble

K = 3


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    """(JAX agent, JAX EnsembleAgent, port agent, member .pt paths,
    member .msgpack paths): the CLI's small encoder, K random members, one
    JAX ensemble for the module so that its act compiles once."""
    dcfg = jax_danet_params(**SMALL)
    acfg = JaxAgentConfig()
    f = dcfg.latent_dim + acfg.measurement_dim
    defs = {"steer": PolicyBankDef(acfg.command_num, STEER_BINS, f),
            "throttle": PolicyBankDef(acfg.command_num, THROTTLE_BINS, f)}
    key = jax.random.PRNGKey(0)
    vnp = _random_variables(lambda: create_danet(dcfg, key)[1],
                            np.random.RandomState(0))
    members = [{s: _random_variables(lambda d=d: d.init_params(key),
                                     np.random.RandomState(10 * m + i),
                                     ("policy",))
                for i, (s, d) in enumerate(defs.items())}
               for m in range(K)]
    jagent = JaxAgent(agent_cfg=acfg, danet_cfg=dcfg,
                      danet=JaxDANet(params_cfg=dcfg),
                      danet_vars=jax.tree.map(jnp.asarray, vnp),
                      steer_def=defs["steer"],
                      throttle_def=defs["throttle"],
                      params=jax.tree.map(jnp.asarray, members[0]),
                      ppo_cfg=JaxPPOConfig())
    out = tmp_path_factory.mktemp("members")
    pts, msgs = [], []
    for m, pnp in enumerate(members):
        msgs.append(str(out / f"member{m}.msgpack"))
        jckpt.save_pytree(msgs[-1], jax.tree.map(jnp.asarray, pnp))
        pts.append(str(out / f"member{m}.pt"))
        torch.save({s: {k: torch.from_numpy(np.asarray(v)) for k, v in
                        policy_from_flax(pnp[s]).items()}
                    for s in ("steer", "throttle")}, pts[-1])
    jens = JaxEnsembleAgent(jagent, msgs)
    return jagent, jens, _port_agent(vnp, members[0]), pts, msgs


def _ensemble_gumbel(key, k):
    """The (steer [K, 1, 33], throttle [K, 1, 3]) noise JAX's
    EnsembleAgent.act draws from `key`: one split per member, then each
    member's steer and throttle keys."""
    steer, throttle = [], []
    for mk in jax.random.split(key, k):
        rs, rt = jax.random.split(mk)
        steer.append(np.array(jax.random.gumbel(rs, (1, STEER_BINS))))
        throttle.append(np.array(jax.random.gumbel(rt, (1, THROTTLE_BINS))))
    return np.stack(steer), np.stack(throttle)


def test_ensemble_act_equals_jax(ensemble, tmp_path):
    """EnsembleAgent.act on four ticks of a sim with traffic, K=3, with
    JAX's Gumbel draws: the K (steer, throttle) pairs and their averaged
    control equal the JAX EnsembleAgent's; the agent's carry stays the
    stale zeros. The members come in the three formats an ensemble takes
    (a JAX .msgpack, a reference-format .pt of
    '{steer,throttle}_{ppo,lstm}_{k}' entries, the port's own .pt); a .pt
    of pickled modules is refused."""
    _, jens, agent, pts, msgs = ensemble
    reference = str(tmp_path / "ppo_model_2400.pt")
    torch.save(_reference_snapshot(
        {s: policy_to_flax(sd) for s, sd in torch.load(
            pts[1], weights_only=True).items()}, drop=()), reference)
    ens = EnsembleAgent(agent, [msgs[0], reference, pts[2]])
    assert ens.k == K
    env = SimDrivingEnv(seed=2, vehicle_num=(1, 1))
    tick = env.reset()
    rng = np.random.RandomState(3)
    for t in range(4):
        key = jax.random.PRNGKey(100 + t)
        ref = jens.act(tick, key)
        ours = ens.act(tick, _ensemble_gumbel(key, K))
        assert ours == ref, (t, ours, ref)
        assert avg_action(ours) == jevaluate.avg_action(ref)
        tick = env.step(_controls(rng))[0]
    assert not agent.hidden_state[0].any()
    pickled = str(tmp_path / "modules.pt")
    torch.save({"steer_ppo_0": torch.nn.Linear(2, 2)}, pickled)
    with pytest.raises(ValueError, match="pickled modules"):
        EnsembleAgent(agent, [pickled])


def _replay_jax_eval_draws(seed, steps, k):
    """Every tick's member noise of a JAX `evaluate(seed=seed)` run of
    `steps` ticks in all."""
    rng = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        draws.append(_ensemble_gumbel(key, k))
    return draws


def test_evaluate_equals_jax(ensemble, tmp_path, monkeypatch):
    """evaluate over two episodes of a scenario-armed eval sim on a route
    XML, each cut by max_steps and scored on its live progress, K=3,
    JAX's draws replayed: equal EvalEpisodeResults and criteria CSV
    rows."""
    jagent, jens, agent, pts, msgs = ensemble
    routes = write_lane_routes(str(tmp_path / "routes.xml"), 2, n_short=1)
    from cadre_tpu_torch.envs.route_parser import parse_routes_file

    events = []
    for cfg in parse_routes_file(routes):
        p0 = cfg.trajectory[0]
        events += [("Scenario1", p0.x, p0.y), ("Scenario2", p0.x, p0.y)]
    scen = _write_scenarios(tmp_path / "s.json", events)
    # the JAX ensemble of the module, whose act has compiled already
    monkeypatch.setattr(jevaluate, "EnsembleAgent", lambda a, p: jens)
    out = {}
    for name, env_cls in (("jax", jsim.SimDrivingEnv),
                          ("port", SimDrivingEnv)):
        work = tmp_path / name
        env = env_cls(routes_file=routes, scenario_file=scen,
                      vehicle_num=(1, 1), training=False, seed=4,
                      work_dir=str(work))
        csv = str(work / "criteria.csv")
        if name == "jax":
            res = jevaluate.evaluate(env, jagent, msgs,
                                     JaxEvalConfig(eval_episode=2), seed=7,
                                     max_steps=12, result_file=csv)
            draws = _replay_jax_eval_draws(7, sum(r.steps for r in res), K)
        else:
            res = evaluate(env, agent, pts, EvalConfig(eval_episode=2),
                           seed=7, max_steps=12, result_file=csv,
                           draws=draws)
        out[name] = ([vars(r) for r in res], open(csv).read())
    assert out["port"] == out["jax"]
    assert [r["steps"] for r in out["port"][0]] == [12, 12]
    assert len(out["port"][1].splitlines()) == 3     # header + 2 rows


def test_eval_cli_on_cpu(tmp_path):
    """python -m cadre_tpu_torch.eval --device cpu --small in a
    subprocess: two members matched by a glob drive one 50-step episode
    of the replay env with 2-frame windows (the scenario-armed sim is
    `evaluate`'s test above): exit 0 and the closing line of root
    eval.py."""
    from cadre_tpu_torch.configs.danet_config import danet_params
    from cadre_tpu_torch.rl.agent import CadreAgent

    for m in range(2):
        CadreAgent.create(danet_params(**SMALL), seed=m, device="cpu") \
            .save_snapshot(str(tmp_path / "models" / f"ppo_model_{m}.pt"))
    out = subprocess.run(
        [sys.executable, "-m", "cadre_tpu_torch.eval", "--env", "fake",
         "--small", "--device", "cpu", "--snapshots",
         str(tmp_path / "models" / "*.pt"), "--episodes", "1",
         "--seq-length", "2", "--work-dir", str(tmp_path / "eval")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith(
        "mean completion ratio over 1 episodes: ")
    assert "eval episode 0: 50 steps" in out.stderr


@pytest.mark.parametrize("args", [["--env", "carla"], []])
def test_eval_cli_refuses(args, tmp_path, monkeypatch):
    """Without a `carla` package --env carla raises the
    ModuleNotFoundError naming it (the JAX CLI's) and evaluates no other
    env; without --device cpu and without a GPU the eval raises instead
    of running on the CPU."""
    from cadre_tpu_torch import eval as peval

    snap = tmp_path / "m.pt"
    snap.write_bytes(b"")
    argv = [*args, "--snapshots", str(snap), "--small", "--work-dir",
            str(tmp_path / "w")]
    if args:
        monkeypatch.setitem(sys.modules, "carla", None)
        with pytest.raises(ModuleNotFoundError, match="carla") as err:
            peval.main([*argv, "--device", "cpu", "--town", "Town01"])
        assert err.value.name == "carla"
        return
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        peval.main(argv)


# ------------------------------------------------- process envs

def test_shm_ring_round_trip(tmp_path):
    """Create, attach, write and read back; a batch read; latest-wins when
    the writer laps the reader; a timeout reads None; attaching a missing
    ring raises."""
    name = f"/cadre_test_{os.getpid()}"
    ring = ShmRing(name, n_slots=4, frame_bytes=32, create=True)
    try:
        peer = ShmRing(name)
        assert (peer.n_slots, peer.frame_bytes) == (4, 32)
        frames = [np.full(8, i, np.float32) for i in range(7)]
        ring.write(frames[0])
        assert np.array_equal(np.frombuffer(peer.read(), np.float32),
                              frames[0])
        for fr in frames[1:4]:
            ring.write(fr.tobytes())
        assert peer.available == 3
        batch = peer.read_batch(8, timeout_ms=10)
        assert batch.shape == (3, 32)
        assert np.array_equal(batch.view(np.float32)[:, 0], [1, 2, 3])
        for fr in frames:              # 7 frames into 4 slots
            ring.write(fr)
        got = [np.frombuffer(peer.read(timeout_ms=10), np.float32)[0]
               for _ in range(4)]
        assert got == [3, 4, 5, 6]     # the oldest frames were overwritten
        assert peer.read(timeout_ms=5) is None
        peer.close()
    finally:
        ring.close()
    with pytest.raises(OSError, match="attach"):
        ShmRing(name)


def test_shm_ring_and_codec_refuse_what_does_not_fit():
    """A frame longer than the ring's slots raises instead of being cut;
    the process envs' codec refuses a tick of another frame size."""
    name = f"/cadre_test_fit_{os.getpid()}"
    ring = ShmRing(name, n_slots=2, frame_bytes=16, create=True)
    try:
        ring.write(bytes(16))
        with pytest.raises(ValueError, match="17 bytes"):
            ring.write(bytes(17))
    finally:
        ring.close()
    codec = _TickCodec(2)
    tick = {"rgb": np.zeros((2, 144, 256, 3), np.uint8),
            "route_fig": np.zeros((2, 256, 144), np.uint8),
            "measurements": np.zeros((2, 3), np.float32), "command": 3}
    frame = codec.encode(tick, (0.5, -1.0), True, (1, 0), 12.5)
    assert len(frame) == codec.frame_bytes
    got, rewards, done, action_done, completion = codec.decode(frame)
    assert got["command"] == 3 and done and action_done == (1, 0)
    assert list(rewards) == [0.5, -1.0] and completion == 12.5
    small = dict(tick, rgb=np.zeros((2, 72, 128, 3), np.uint8))
    with pytest.raises(ValueError, match="does not fit"):
        codec.encode(small, (0.0, 0.0), False, (0, 0), 0.0)


def test_libbuild_compiles_names_by_content_and_reports_failures(tmp_path):
    """The build helper shared by the kernels and the host libraries: a
    library named after its source's hash is compiled through a temporary
    file and loads; a failed compile leaves nothing behind and returns the
    compiler's message."""
    good, bad = tmp_path / "good.cpp", tmp_path / "bad.cpp"
    good.write_text('extern "C" int answer() { return 42; }\n')
    bad.write_text('extern "C" int answer() { return nope; }\n')
    flags = ("-O2", "-shared", "-fPIC")
    h = libbuild.content_hash([good], flags)
    assert h != libbuild.content_hash([bad], flags)
    assert h != libbuild.content_hash([good], flags[:2])
    lib, broken = tmp_path / "out" / f"libgood-{h}.so", tmp_path / "libbad.so"
    res = libbuild.compile_all({"good": (["g++", *flags, str(good)], lib),
                                "bad": (["g++", *flags, str(bad)], broken)})
    assert res["good"][0] == 0 and res["bad"][0] != 0
    assert "nope" in res["bad"][1]
    assert not broken.exists()
    assert sorted(p.name for p in tmp_path.rglob("*.so*")) == [lib.name]
    calls = []
    key = f"test/{tmp_path}"
    loaded = libbuild.load_once(key, lambda: calls.append(1) or lib)
    assert loaded.answer() == 42
    assert libbuild.load_once(key, lambda: calls.append(1) or lib) is loaded
    assert calls == [1]


def _sim_fns(n):
    return [functools.partial(SimDrivingEnv, seed=k, vehicle_num=(1, 1))
            for k in range(n)]


def test_proc_envs_equal_in_process_and_jax():
    """ProcVecDrivingEnv with two sim workers against the port's
    in-process VecDrivingEnv and the JAX package's over 60 steps with
    episode ends: equal frames, commands, measurements and rewards (as
    the f32 the rings carry), dones and action_done flags."""
    proc = ProcVecDrivingEnv(_sim_fns(2))
    try:
        vec = VecDrivingEnv(_sim_fns(2))
        jv = jvec.VecDrivingEnv([functools.partial(jsim.SimDrivingEnv, seed=k,
                                                   vehicle_num=(1, 1))
                                 for k in range(2)])
        ticks = [proc.reset(), vec.reset(), jv.reset()]
        rng = np.random.RandomState(5)
        dones = 0
        for t in range(60):
            for a in ticks[1:]:
                for k in ("rgb", "route_fig", "command"):
                    assert np.array_equal(ticks[0][k], a[k]), (t, k)
                assert np.array_equal(ticks[0]["measurements"],
                                      a["measurements"].astype(np.float32))
            # steering one way: the envs leave their routes and reset
            controls = np.stack([rng.uniform(0.2, 1.0, 2),
                                 rng.uniform(0.3, 1.0, 2),
                                 rng.rand(2) < 0.05], axis=1)
            outs = [e.step(controls) for e in (proc, vec, jv)]
            ticks = [o[0] for o in outs]
            for o in outs[1:]:
                assert np.array_equal(outs[0][1], o[1].astype(np.float32))
                assert np.array_equal(outs[0][2], o[2]), t
                assert [tuple(i["action_done"]) for i in outs[0][3]] == \
                    [tuple(i["action_done"]) for i in o[3]]
            dones += int(outs[0][2].sum())
        assert dones >= 1
        stats = proc.pop_episode_stats(), vec.pop_episode_stats()
        assert [(s["env"], np.float32(s["completion"])) for s in stats[0]] \
            == [(s["env"], np.float32(s["completion"])) for s in stats[1]]
    finally:
        proc.close()
    assert not any(p.is_alive() for p in proc._procs)


def test_killed_worker_is_respawned():
    """A worker killed between steps is respawned: its slot reports done
    with 'worker restarted', then steps on; close stops every worker."""
    proc = ProcVecDrivingEnv(_sim_fns(2))
    try:
        proc.reset()
        proc.step([[0.0, 0.5, 0.0]] * 2)
        victim = proc._procs[1]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=10)
        tick, rewards, dones, infos = proc.step([[0.0, 0.5, 0.0]] * 2)
        assert list(dones) == [False, True]
        assert infos[1]["error_message"] == "worker restarted"
        assert np.array_equal(rewards[1], [0.0, 0.0])
        assert proc.pop_episode_stats()[-1]["error_message"] == \
            "worker restarted"
        tick, rewards, dones, infos = proc.step([[0.0, 0.5, 0.0]] * 2)
        assert not dones.any() and tick["rgb"].shape == (2, 8, 144, 256, 3)
    finally:
        proc.close()
    assert not any(p.is_alive() for p in proc._procs)


def test_native_raster_equals_numpy_and_jax():
    """The native rasterizer against the port's numpy raster on random
    polylines, on polylines on the half-pixel grid (ties) and at the
    canvas edges: bit-equal everywhere. Against the JAX package's
    rasterize_polyline on the random polylines: bit-equal (the JAX
    package's native raster rounds ties otherwise, see raster.cpp)."""
    rng = np.random.RandomState(0)
    for i in range(150):
        n = rng.randint(2, 30)
        pts = np.cumsum(rng.uniform(-14, 14, (n, 2)), axis=0) + [72, 128]
        if i % 3 == 1:
            pts = np.round(pts * 2) / 2
        if i % 3 == 2:
            pts = rng.uniform(-20, 280, (n, 2))
        ours = rasterize_polyline_native(pts, 256, 144, 15.0)
        np.testing.assert_array_equal(
            ours, route_fig.rasterize_polyline_numpy(pts), err_msg=str(i))
        assert np.array_equal(route_fig.rasterize_polyline(pts), ours)
        if i % 3 != 1:
            np.testing.assert_array_equal(ours, jrf.rasterize_polyline(pts),
                                          err_msg=str(i))
    one = np.array([[10.0, 10.0]])
    assert not rasterize_polyline_native(one, 256, 144, 15.0).any()


# ------------------------------------------------- the training CLI

def test_cli_proc_envs_and_scenarios(tmp_path):
    """main --env sim --proc-envs --scenarios on the CPU: two worker
    processes, one iteration, the snapshot written; --scenarios with one
    env trains one episode."""
    from cadre_tpu_torch import main

    scen = _write_scenarios(tmp_path / "s.json",
                            [("Scenario1", 2.0, 0.0),
                             ("Scenario3", 16.0, 0.0)])
    base = ["--env", "sim", "--small", "--device", "cpu", "--num-steps", "4",
            "--scenarios", scen, "--vehicles", "1"]
    path = main.main([*base, "--num-envs", "2", "--proc-envs",
                      "--iterations", "1", "--work-dir",
                      str(tmp_path / "proc")])
    assert path.endswith(os.path.join("models", "ppo_model_0.pt"))
    assert os.path.exists(path)
    path = main.main([*base, "--num-envs", "1", "--episodes", "1",
                      "--work-dir", str(tmp_path / "one")])
    assert os.path.exists(path)
    assert not glob.glob(f"/dev/shm/cadre_{os.getpid()}_*")
