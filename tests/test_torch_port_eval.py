"""The port's eval slice against the JAX package, on the CPU: route-file,
town-traced and stop-sign banks, the hazard and priority-route env
options, forced routes, the scripted expert, the ensemble evaluation and
the CLI's route options.

As in test_torch_port_slice.py, every random number is JAX's own, handed
to the port through its draw seams, and weights go through
cadre_tpu_torch.utils.convert. Tolerances are stated per test.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.envs import jax_env
from cadre_tpu.envs import jax_expert
from cadre_tpu.envs import route_parser as jax_route_parser
from cadre_tpu.envs import scenarios as jax_scenarios
from cadre_tpu.envs import town_maps as jax_town_maps
from cadre_tpu.rl import device_eval as jax_device_eval
from cadre_tpu.rl.agent import latent_features as jax_latent
from cadre_tpu.rl.agent import preprocess_obs as jax_preprocess
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.envs import route_parser, synthetic, torch_env, \
    torch_expert, town_maps
from cadre_tpu_torch.rl import device_eval
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.device_rollout import ActDraws
from cadre_tpu_torch.utils.convert import (
    danet_from_flax,
    env_state_from_numpy,
    policy_from_flax,
    route_bank_from_numpy,
)
from tests.test_torch_port_slice import (
    SMALL,
    _assert_obs_close,
    _assert_state_close,
    _np,
    _perturb,
    _state_dict,
    few_torch_threads,  # noqa: F401  (autouse fixture)
    jax_agent,
    jax_reset_draws,
    jax_step_draws,
)

REPO = Path(__file__).resolve().parents[1]

# Town01 lane centres (TOWN_GRIDS road lines, 1.75 m right of travel):
# eastbound on road y=57.5, then a right turn (+y bound, x=90.5-1.75), a
# left turn (-y bound, x=90.5+1.75) and straight through the junction
TRACES = {"right": [[40.0, 59.25], [88.75, 100.0]],
          "left": [[40.0, 59.25], [92.25, 20.0]],
          "straight": [[40.0, 59.25], [130.0, 59.25]]}


@pytest.fixture(scope="module")
def town01():
    """The port's and the JAX package's Town01 maps, whose routers are
    built once and kept on them."""
    return town_maps.town_map("Town01"), jax_town_maps.town_map("Town01")


@pytest.fixture(scope="module")
def routes_xml(tmp_path_factory):
    """Six Town01 routes, the last three 12 m straight along one lane."""
    return town_maps.write_lane_routes(
        str(tmp_path_factory.mktemp("routes") / "town01.xml"), 6, n_short=3)


def _banks_equal(ours, ref):
    for name in torch_env.RouteBank._fields:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


# ---------------------------------------------------------------- banks

def test_parse_routes_file_equals_jax(routes_xml):
    ours = route_parser.parse_routes_file(routes_xml)
    ref = jax_route_parser.parse_routes_file(routes_xml)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert (a.name, a.town) == (b.name, b.town)
        assert [vars(w) for w in a.trajectory] == \
            [vars(w) for w in b.trajectory]
        np.testing.assert_array_equal(a.trajectory[0].xy, b.trajectory[0].xy)


@pytest.mark.parametrize("turn", list(TRACES))
def test_trace_dense_route_equals_jax(turn, town01):
    """The port's grid map and router trace Town01 exactly as the JAX
    package's host modules do; the turns round their junction."""
    kp = np.asarray(TRACES[turn])
    ours = town_maps.trace_dense_route(town01[0], kp)
    ref = jax_town_maps.trace_dense_route(town01[1], kp)
    np.testing.assert_array_equal(ours, ref)
    corners = synthetic._route_corners(ours)
    assert len(corners) == (0 if turn == "straight" else 1)


def test_route_corners_equal_jax():
    rng = np.random.RandomState(3)
    for legs in (1, 3, 6):
        kp = synthetic.synthetic_route(rng, n_legs=legs,
                                       leg_len=(25.0, 45.0))
        dense = route_parser.interpolate_route(kp)
        np.testing.assert_array_equal(synthetic._route_corners(dense),
                                      jax_scenarios._route_corners(dense))
    short = np.zeros((11, 2))
    assert synthetic._route_corners(short).shape == (0, 2)


BANKS = {
    "routes_file": lambda xml, town: dict(routes_file=xml),
    "routes_file_town01": lambda xml, town: dict(routes_file=xml,
                                                 map_name="Town01"),
    "dense_routes": lambda xml, town: dict(dense_routes=[
        jax_town_maps.trace_dense_route(town, np.asarray(kp))
        for kp in TRACES.values()]),
    "stop_signs": lambda xml, town: dict(stop_sign_prob=0.5),
    "junction_dense": lambda xml, town: dict(route_legs=6,
                                             route_leg_len=(25.0, 45.0)),
}


@pytest.mark.parametrize("case", list(BANKS))
def test_route_bank_options_equal_jax(case, routes_xml, town01):
    """Every field bit for bit, the random draws (light phases, stop-sign
    choices, props) in the JAX package's order."""
    kw = BANKS[case](routes_xml, town01[1])
    ref = jax_env.make_route_bank(4, seed=2, **kw)
    ours = torch_env.make_route_bank(4, seed=2, device="cpu", **kw)
    _banks_equal(ours, ref)
    if case == "stop_signs":
        assert (np.asarray(ref.stop_signs)[..., 0] < 1e7).any()


# ---------------------------------------------------------------- env

def _place(jstate, jbank, i, pos, yaw, speed):
    """Move env i's ego to `pos` heading `yaw` at `speed`, with its
    planner head and progress at the nearest point of its route."""
    route = np.asarray(jbank.routes)[int(jstate.route_id[i])]
    near = int(np.argmin(np.hypot(*(route - np.asarray(pos)).T)))
    return jstate._replace(
        pos=jstate.pos.at[i].set(jnp.asarray(pos, jnp.float32)),
        yaw=jstate.yaw.at[i].set(yaw), speed=jstate.speed.at[i].set(speed),
        head=jstate.head.at[i].set(max(near - 1, 0)),
        progress=jstate.progress.at[i].set(near))


def _near_hazard(jstate, jbank, i, row):
    """Env i's ego 4 m from obstacle `row`, on its crossing line: within
    the 12 m trigger, so the hazard springs on the next step."""
    obs = np.asarray(jstate.obstacles)[i, row]
    h = float(obs[5])
    return _place(jstate, jbank, i,
                  [obs[0] + 4.0 * np.cos(h), obs[1] + 4.0 * np.sin(h)],
                  float(np.rad2deg(h)) + 90.0, 3.0)


def _before_stop_sign(jstate, jbank, i):
    """Env i on a route with a stop sign, 1.2 m before its centre at 9.5
    m/s along the lane: it acquires the sign, drives through its trigger
    box without stopping, and leaves it within four steps."""
    signs = np.asarray(jbank.stop_signs)
    r = int(np.nonzero((signs[..., 0] < 1e7).any(1))[0][0])
    x, y, _, _, yaw = signs[r, 0]
    d = np.asarray([np.cos(np.deg2rad(yaw)), np.sin(np.deg2rad(yaw))])
    jstate = jstate._replace(route_id=jstate.route_id.at[i].set(r))
    return _place(jstate, jbank, i, np.asarray([x, y]) - 1.2 * d, yaw, 9.5)


OPTIONS = {
    # ego 0 near a crossing hazard, ego 1 near the junction crosser
    "hazards": (dict(n_hazards=2, n_junction_hazards=1), {},
                lambda s, b: _near_hazard(_near_hazard(s, b, 0, 12), b, 1,
                                          14)),
    # env 0 past its route timeout: its route's priority drops at done
    "priority_routes": (dict(priority_routes=True), {},
                        lambda s, b: s._replace(step=s.step.at[0].set(
                            100000))),
    # eval mode, so that the 9.5 m/s drive through the sign ends nothing
    "stop_signs": (dict(training=False), dict(stop_sign_prob=1.0),
                   lambda s, b: _before_stop_sign(s, b, 0)),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_env_options_match_jax(option):
    """Reset, then 4 steps from the moved JAX state with JAX's draws
    injected, as test_env_reset_and_steps_match_jax: state within 1e-3
    (hazard_speed and route_prio included) with integer fields equal;
    done, codes and infractions equal; rewards within 1e-3. Each case
    checks that the steps exercised its option."""
    cfg_kw, bank_kw, prepare = OPTIONS[option]
    n, k_steps = 3, 4
    cfg = jax_env.JaxEnvConfig(**cfg_kw)
    jbank = jax_env.make_route_bank(3, seed=0, **bank_kw)
    jenv = jax_env.JaxDrivingEnv(jbank, n, cfg)
    key = jax.random.PRNGKey(11)
    jstate, jobs = jenv.reset(key)
    bank = route_bank_from_numpy(_np(jbank._asdict()))
    env = torch_env.DrivingEnv(bank, n, torch_env.EnvConfig(**cfg_kw),
                               device="cpu")
    tstate, tobs = env.reset(jax_reset_draws(cfg, 3, key, n))
    _assert_obs_close(tobs, jobs, "reset")
    _assert_state_close(tstate, jstate, "reset")

    jstate = prepare(jstate, jbank)
    tstate = env_state_from_numpy(_state_dict(jstate))
    rng = np.random.RandomState(6)
    seen = []
    for k in range(k_steps):
        controls = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(0, 1, n),
                             np.zeros(n)], -1).astype(np.float32)
        draws = jax_step_draws(cfg, 3, jstate.rng)
        jstate, jout = jenv.step(jstate, jnp.asarray(controls))
        tstate, tout = env.step(tstate, torch.from_numpy(controls), draws)
        what = f"{option} step {k}"
        for name in ("done", "action_done", "error_code", "infractions"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          err_msg=f"{what} {name}")
        for name in ("rewards", "completion"):
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       atol=1e-3, err_msg=f"{what} {name}")
        _assert_obs_close(tout._asdict(), jout._asdict(), what)
        _assert_state_close(tstate, jstate, what, prio=cfg.priority_routes)
        seen.append((_state_dict(jstate), {k: np.asarray(v) for k, v in
                                           jout._asdict().items()}))

    if option == "hazards":
        state, _ = seen[0]
        assert state["obstacles"][0, 12, 4] > 0        # sprung crossings
        assert state["obstacles"][1, 14, 4] > 0
        assert state["hazard_speed"][0, 12] > 0
    elif option == "priority_routes":
        state, out = seen[0]
        assert out["done"][0]
        assert (state["route_prio"][0] < 100.0).any()
        assert (state["route_prio"][1:] == 100.0).all()
    else:
        assert any(s["stop_state"][0, 0] >= 0 for s, _ in seen)
        assert seen[-1][1]["infractions"][0, 1] == 1


def test_reset_routes_equals_jax():
    """Forced routes: env i on route_ids[i], from the same draws."""
    n = 4
    cfg = jax_env.JaxEnvConfig(n_hazards=1, priority_routes=True)
    jbank = jax_env.make_route_bank(3, seed=0)
    key = jax.random.PRNGKey(3)
    ids = [2, 0, 1, 2]
    jstate, jobs = jax_env.JaxDrivingEnv(jbank, n, cfg).reset_routes(
        key, jnp.asarray(ids, jnp.int32))
    env = torch_env.DrivingEnv(route_bank_from_numpy(_np(jbank._asdict())),
                               n, torch_env.EnvConfig(n_hazards=1,
                                                      priority_routes=True),
                               device="cpu")
    tstate, tobs = env.reset_routes(ids, jax_reset_draws(cfg, 3, key, n))
    assert tstate.route_id.tolist() == ids
    _assert_obs_close(tobs, jobs, "reset_routes")
    _assert_state_close(tstate, jstate, "reset_routes")


# ---------------------------------------------------------------- expert

def test_expert_action_equals_jax():
    """The expert's LUT indices on the JAX env's states along 30 steps
    that the JAX expert drives (traffic on, lights obeyed), one env too
    fast and one close behind a vehicle, so that it accelerates, coasts
    and brakes."""
    n = 4
    cfg = jax_env.JaxEnvConfig(render=False)
    jbank = jax_env.make_route_bank(3, seed=1)
    jenv = jax_env.JaxDrivingEnv(jbank, n, cfg)
    bank = route_bank_from_numpy(_np(jbank._asdict()))
    tcfg = torch_env.EnvConfig(render=False)
    act = jax.jit(jax.vmap(lambda s: jax_expert.expert_action(cfg, jbank, s)))
    jstate, _ = jenv.reset(jax.random.PRNGKey(2))
    # env 0 over the target speed; env 1 4 m behind its first NPC vehicle
    route = np.asarray(jbank.routes)[int(jstate.route_id[1])]
    i = int(np.asarray(jstate.npc_s)[1, 0]) - 4
    d = route[i + 1] - route[i]
    jstate = _place(jstate, jbank, 1, route[i],
                    float(np.degrees(np.arctan2(d[1], d[0]))), 2.0)
    jstate = jstate._replace(speed=jstate.speed.at[0].set(8.0))
    throttles = set()
    for _ in range(30):
        si, ti = act(jstate)
        ours = torch_expert.expert_action(
            tcfg, bank, env_state_from_numpy(_state_dict(jstate)))
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(si))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ti))
        throttles |= set(np.asarray(ti).tolist())
        control = jax.vmap(lambda s: jax_expert.expert_control(
            cfg, jbank, s))(jstate)
        jstate, _ = jenv.step(jstate, control)
    assert throttles == {0, 1, 2}


def test_expert_completes_clean_routes():
    """No traffic, lights obeyed: the port's expert finishes synthetic
    routes, as tests/test_jax_expert.py holds the JAX one (on two legs of
    25-45 m here, so that 8 envs finish in 350 steps)."""
    bank = torch_env.make_route_bank(4, seed=0, route_legs=2,
                                     route_leg_len=(25.0, 45.0), device="cpu")
    cfg = torch_env.EnvConfig(render=False, n_vehicles=0, n_walkers=0,
                              randomize_weather=False)
    comp, err = torch_expert.expert_episode_stats(
        bank, num_envs=8, steps=350, seed=0, config=cfg, device="cpu")
    assert len(comp) >= 8
    assert np.mean(comp) > 0.95, (np.mean(comp),
                                  np.unique(err, return_counts=True))
    assert np.mean(err == 6) > 0.9


# ---------------------------------------------------------------- eval

EVAL_N, EVAL_CFG = 3, dict(n_vehicles=2, n_walkers=2)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """The JAX agent with a perturbed small encoder and two perturbed
    member snapshots, as JAX msgpack files and as the port's .pt files;
    the port's agent with the same encoder; a bank whose routes 0 and 1
    are 2 and 3 m long, so that an episode on them ends on its second
    step; the JAX eval
    env and its member act and encoder, jitted once for both tests."""
    tmp = tmp_path_factory.mktemp("members")
    jagent = jax_agent()
    vnp = _perturb(_np(jagent.danet_vars), np.random.RandomState(0))
    jagent.danet_vars = jax.tree.map(jnp.asarray, vnp)
    jpaths, tpaths, members = [], [], []
    for m in range(2):
        pnp = {s: _perturb(_np(jagent.params[s]),
                           np.random.RandomState(10 * m + i))
               for i, s in enumerate(("steer", "throttle"))}
        members.append(jax.tree.map(jnp.asarray, pnp))
        jagent.params = members[-1]
        jpaths.append(str(tmp / f"member{m}.msgpack"))
        jagent.save_snapshot(jpaths[-1])
        tpaths.append(str(tmp / f"member{m}.pt"))
        torch.save({s: policy_from_flax(pnp[s]) for s in pnp}, tpaths[-1])
    danet_cfg = danet_params(**SMALL)
    agent = CadreAgent.create(danet_cfg, device="cpu",
                              encoder_state=danet_from_flax(vnp, danet_cfg))
    rng = np.random.RandomState(4)
    dense = [np.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]),
             np.asarray([[0.0, 0.0], [0.0, 1.5], [0.0, 3.0]]),
             route_parser.interpolate_route(synthetic.synthetic_route(rng))]
    jbank = jax_env.make_route_bank(3, seed=5, dense_routes=dense)

    n, f = EVAL_N, jagent.obs_dim
    zeros = (jnp.zeros((n, f)), jnp.zeros((n, f)))

    @jax.jit
    def act(params, feat_hist, commands, key):
        def one(p, k):
            s, t, _ = jagent._act_from_hist(p, feat_hist, commands, zeros, k)
            return s.action, t.action

        return jax.vmap(one)(params, jax.random.split(key, len(members)))

    @jax.jit
    def encode(o):
        x = jax_preprocess(o["rgb"], o["route_fig"])
        return jax_latent(jagent.danet, jagent.danet_vars, x,
                          o["measurements"])

    cfg = jax_env.JaxEnvConfig(training=False, **EVAL_CFG)
    return dict(jagent=jagent, jpaths=jpaths, agent=agent, tpaths=tpaths,
                jbank=jbank, act=act, encode=encode, cfg=cfg,
                jenv=jax_env.JaxDrivingEnv(jbank, n, cfg),
                stacked=jax.tree.map(lambda *xs: jnp.stack(xs), *members))


def _jax_eval_draws(e, seed, steps, route_ids):
    """evaluate_device's run in the JAX package, step by step from its
    keys, recording the port's draws: the reset's from k0, then per step
    each member's Gumbel noise from split(key, K) and split(rs, rt), and
    the env's from the per-env keys of the JAX state."""
    jenv, cfg, encode, n = e["jenv"], e["cfg"], e["encode"], EVAL_N
    k = len(e["jpaths"])
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    if route_ids is not None:
        jstate, obs = jenv.reset_routes(k0, jnp.asarray(route_ids,
                                                        jnp.int32))
    else:
        jstate, obs = jenv.reset(k0)
    reset = jax_reset_draws(cfg, 3, k0, n)
    lut_s = jnp.asarray(jax_device_eval.STEER_CONTROL, jnp.float32)
    lut_t = jnp.asarray(jax_device_eval.THROTTLE_CONTROL, jnp.float32)
    feat_hist = jnp.broadcast_to(encode(obs)[None],
                                 (8, n, e["jagent"].obs_dim))
    done_prev = jnp.zeros((n,), bool)
    out = []
    for key in jax.random.split(k1, steps):
        feats = encode(obs)
        feat_hist = jnp.where(done_prev[None, :, None],
                              jnp.broadcast_to(feats[None], feat_hist.shape),
                              jnp.concatenate([feat_hist[1:], feats[None]]))
        gumbels = [[], []]
        for mk in jax.random.split(key, k):
            rs, rt = jax.random.split(mk)
            gumbels[0].append(np.array(jax.random.gumbel(rs, (n, 33))))
            gumbels[1].append(np.array(jax.random.gumbel(rt, (n, 3))))
        env_draws = jax_step_draws(cfg, 3, jstate.rng)
        sa, ta = e["act"](e["stacked"], feat_hist, obs["command"], key)
        c = jnp.concatenate([lut_s[sa][..., None], lut_t[ta]], -1).mean(0)
        c = c.at[:, 2].set(jnp.where(c[:, 2] < 0.5, 0.0, c[:, 2]))
        jstate, o = jenv.step(jstate, c)
        obs = dict(rgb=o.rgb, route_fig=o.route_fig,
                   measurements=o.measurements, command=o.command)
        done_prev = o.done
        out.append(ActDraws(torch.from_numpy(np.stack(gumbels[0])),
                            torch.from_numpy(np.stack(gumbels[1])),
                            env_draws))
    return device_eval.EvalDraws(reset, out)


@pytest.mark.parametrize("pinned", [True, False])
def test_evaluate_device_matches_jax(pinned, eval_setup):
    """K=2 members, N=3 envs, 4 steps, JAX's draws injected, the env
    handed over in training mode (both evaluate in eval mode): the same
    rows as cadre_tpu.rl.device_eval.evaluate_device. Error, steps,
    red_lights, stops and route_id equal; completion within 1e-3,
    driving score within 0.1."""
    e, steps, seed = eval_setup, 4, 9
    route_ids = [0, 1, 2] if pinned else None
    ref = jax_device_eval.evaluate_device(
        e["jagent"], jax_env.JaxDrivingEnv(
            e["jbank"], EVAL_N, jax_env.JaxEnvConfig(**EVAL_CFG)),
        e["jpaths"], max_steps=steps, seed=seed, route_ids=route_ids)
    draws = _jax_eval_draws(e, seed, steps, route_ids)
    env = torch_env.DrivingEnv(
        route_bank_from_numpy(_np(e["jbank"]._asdict())), EVAL_N,
        torch_env.EnvConfig(**EVAL_CFG), device="cpu")
    ours = device_eval.evaluate_device(e["agent"], env, e["tpaths"],
                                       seed=seed, route_ids=route_ids,
                                       draws=draws)
    assert len(ref) >= 2 and len(ours) == len(ref)
    assert any(r["error"] == "success" for r in ref)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in ("error", "steps", "red_lights", "stops", "route_id"):
            assert a.get(k) == b.get(k), (k, a, b)
        assert a["completion"] == pytest.approx(b["completion"], abs=1e-3)
        assert a["driving_score"] == pytest.approx(b["driving_score"],
                                                   abs=0.1)
    if pinned:
        ids = [r["route_id"] for r in ours]
        assert len(ids) == len(set(ids))


def test_evaluate_device_own_draws(tmp_path):
    """Without injected draws: the same seed gives the same rows, every
    row is a valid score, and a pinned env reports one episode."""
    agent = CadreAgent.create(danet_params(**SMALL), seed=1, device="cpu")
    path = str(tmp_path / "a.pt")
    agent.save_snapshot(path)
    dense = [np.asarray([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])]
    bank = torch_env.make_route_bank(1, dense_routes=dense, device="cpu")
    env = torch_env.DrivingEnv(bank, 2, torch_env.EnvConfig(n_vehicles=0,
                                                            n_walkers=1),
                               device="cpu")
    runs = [device_eval.evaluate_device(agent, env, [path, path],
                                        max_steps=5, seed=3, route_ids=ids)
            for ids in (None, None, [0, 0])]
    assert runs[0] == runs[1] and len(runs[0]) >= 4
    assert len(runs[2]) == 2
    for row in runs[0] + runs[2]:
        assert 0.0 <= row["completion"] <= 1.0
        assert 0.0 <= row["driving_score"] <= 100.0
        assert row["error"] == "success"


# ---------------------------------------------------------------- CLI

def test_cli_trains_with_routes_hazards_and_priority(tmp_path, routes_xml):
    out = subprocess.run(
        [sys.executable, "-m", "cadre_tpu_torch.main", "--env", "jax",
         "--small", "--device", "cpu", "--routes", routes_xml,
         "--hazards", "1", "--priority-routes", "--num-envs", "2",
         "--num-steps", "3", "--iterations", "1",
         "--work-dir", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "models" / "ppo_model_1.pt").exists()
