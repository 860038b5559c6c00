"""The port's host-env slice against the JAX package, on the CPU.

The host simulator and its modules are numpy in both packages, so the
port's copies are held to the JAX package's exactly: the same arguments,
seeds and controls give equal frames, measurements, commands, rewards,
done flags, infos and completion ratios. The agent's act paths, the
rollout inserts and one training iteration of each loop are held to the
JAX package's with the same weights (flax weights through
cadre_tpu_torch.utils.convert) and the same random numbers (JAX's Gumbel
noise and row permutations, rebuilt from its keys and handed to the port).
Tolerances are stated per test.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.configs.agent_config import AgentConfig as JaxAgentConfig
from cadre_tpu.configs.agent_config import RolloutConfig as JaxRolloutConfig
from cadre_tpu.configs.agent_config import TrainConfig as JaxTrainConfig
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.envs import expert as jexpert
from cadre_tpu.envs import fake_env as jfake
from cadre_tpu.envs import sim_env as jsim
from cadre_tpu.envs import vec_env as jvec
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.models.danet import create_danet
from cadre_tpu.models.policy import PolicyBankDef
from cadre_tpu.rl import rollout as jro
from cadre_tpu.rl.agent import CadreAgent as JaxAgent
from cadre_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from cadre_tpu.rl.ppo import make_optimizer as jax_make_optimizer
from cadre_tpu.rl.train import collect_rollout as jax_collect_rollout
from cadre_tpu.rl.train import ppo_update_epochs as jax_ppo_update_epochs
from cadre_tpu.rl.train import train as jax_train
from cadre_tpu.rl.vec_train import train_vec as jax_train_vec
from cadre_tpu_torch.configs.agent_config import RolloutConfig, TrainConfig
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.envs import sim_env as psim
from cadre_tpu_torch.envs import torch_env
from cadre_tpu_torch.envs.expert import OracleExpert
from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv
from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
from cadre_tpu_torch.envs.town_maps import write_lane_routes
from cadre_tpu_torch.envs.vec_env import VecDrivingEnv
from cadre_tpu_torch.models.danet import DANet
from cadre_tpu_torch.rl import rollout
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.train import (
    IterationDraws,
    collect_rollout,
    ppo_update_epochs,
    train,
)
from cadre_tpu_torch.rl.vec_train import train_vec
from cadre_tpu_torch.utils.convert import danet_from_flax, policy_from_flax
from test_golden_trace import CONTROL_SCRIPT, GOLDEN_PATH
from test_torch_port_slice import (
    _rel_close,
    few_torch_threads,  # noqa: F401 (autouse fixture)
)
from test_torch_port_update import _assert_params_moved_alike, _jax_perms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI's --small encoder
SMALL = dict(da_feature_channel=64, inter_att_dims=48, z_dims=32)
STEER_BINS, THROTTLE_BINS = 33, 3


# ------------------------------------------------- (a) the numpy modules

def _events(tick):
    return [(e.get_type().name, e.get_message(), e.get_dict())
            for e in tick.get("new_event_list", [])]


def _assert_ticks_equal(ours, ref, what):
    """Every array of the tick equal, with its dtype; scalars and the
    tick's new events equal."""
    for k in ("rgb", "route_fig", "measurements", "last_rgb",
              "last_route_fig", "gps", "forward"):
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
    for k in ("command", "speed", "compass", "obstacle", "light_state",
              "light_dist", "last_measurements", "_dis", "_theta"):
        assert ours[k] == ref[k], (what, k, ours[k], ref[k])
    assert _events(ours) == _events(ref), what


@pytest.fixture(scope="module")
def routes_xml(tmp_path_factory):
    """Six Town01 lane routes, two of them 12 m long."""
    return write_lane_routes(
        str(tmp_path_factory.mktemp("routes") / "routes.xml"), 6, n_short=2)


SIM_CASES = {
    "traffic": dict(seed=3, vehicle_num=(2, 2)),
    "no_lights_random_weather": dict(seed=4, with_traffic_lights=False,
                                     randomize_weather=True),
    "eval": dict(seed=5, training=False, vehicle_num=(1, 1)),
    "routes_sequential": dict(seed=6, vehicle_num=(1, 1),
                              use_priority_indexer=False),
    "routes_priority": dict(seed=7, vehicle_num=(2, 1)),
    "work_dir": dict(seed=8, vehicle_num=(1, 0)),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_sim_env_equals_jax(case, routes_xml, tmp_path):
    """150 steps of seeded random controls, resetting on done: every tick,
    reward, done flag, info and completion ratio equal to the JAX
    package's env with the same arguments; with a work_dir, the completion
    CSVs equal; with the priority indexer, its priorities equal."""
    kw = dict(SIM_CASES[case])
    if case.startswith("routes"):
        kw["routes_file"] = routes_xml
    envs = []
    for cls, sub in ((SimDrivingEnv, "port"), (jsim.SimDrivingEnv, "jax")):
        extra = dict(work_dir=str(tmp_path / sub)) if case == "work_dir" \
            else {}
        env = cls(**kw, **extra)
        if env.route_indexer is not None and case == "routes_priority":
            # the indexer draws from an unseeded RandomState
            env.route_indexer._rng = np.random.RandomState(11)
        envs.append(env)
    ours, ref = envs
    _assert_ticks_equal(ours.reset(), ref.reset(), f"{case} reset")
    rng = np.random.RandomState(0)
    ends = 0
    for t in range(150):
        control = [float(rng.uniform(-0.5, 0.5)), float(rng.uniform(0, 1)),
                   float(rng.rand() < 0.1)]
        (to, ro, do, io), (tr, rr, dr, ir) = (e.step(control)
                                              for e in (ours, ref))
        _assert_ticks_equal(to, tr, f"{case} step {t}")
        assert ro.dtype == rr.dtype and np.array_equal(ro, rr), (case, t)
        assert (do, io) == (dr, ir), (case, t)
        assert ours.completion_ratio == ref.completion_ratio
        if do:
            ends += 1
            _assert_ticks_equal(ours.reset(), ref.reset(), f"{case} {t}")
            assert ours.route_name == ref.route_name
    assert ends >= 1, case
    if case == "work_dir":
        csvs = [open(tmp_path / sub / "completion_ratio.csv").read()
                for sub in ("port", "jax")]
        assert csvs[0] == csvs[1] and csvs[0].count("\n") == ends
    if case == "routes_priority":
        np.testing.assert_array_equal(ours.route_indexer.route_priority,
                                      ref.route_indexer.route_priority)


def test_vec_and_fake_envs_equal_jax():
    """VecDrivingEnv over two sim envs (auto-reset, episode stats) and
    FakeDrivingEnv (synthetic ticks, made-up rewards): equal to the JAX
    package's under the same controls."""
    def make(mod):
        return [lambda k=k: mod.SimDrivingEnv(seed=k, vehicle_num=(1, 1))
                for k in range(2)]

    ours, ref = VecDrivingEnv(make(psim)), \
        jvec.VecDrivingEnv(make(jsim))
    to, tr = ours.reset(), ref.reset()
    rng = np.random.RandomState(1)
    for t in range(60):
        for k in to:
            assert to[k].dtype == tr[k].dtype
            np.testing.assert_array_equal(to[k], tr[k], err_msg=f"{t} {k}")
        controls = [[float(rng.uniform(-0.3, 0.3)), 1.0, 0.0]
                    for _ in range(2)]
        (to, ro, do, io), (tr, rr, dr, ir) = (v.step(controls)
                                              for v in (ours, ref))
        np.testing.assert_array_equal(ro, rr)
        np.testing.assert_array_equal(do, dr)
        assert io == ir
    stats = ours.pop_episode_stats()
    assert stats and stats == ref.pop_episode_stats()
    assert ours.pop_episode_stats() == []

    fo, fr = FakeDrivingEnv(episode_length=3, seed=2), \
        jfake.FakeDrivingEnv(episode_length=3, seed=2)
    ticks = [(fo.reset(), fr.reset())]
    for t in range(5):
        action = [0.1 * t, 0.6, 0.0]
        (a, ra, da, ia), (b, rb, db, ib) = fo.step(action), fr.step(action)
        np.testing.assert_array_equal(ra, rb)
        assert (da, ia, fo.completion_ratio) == (db, ib, fr.completion_ratio)
        ticks.append((a, b))
    for a, b in ticks:
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_expert_equals_jax():
    """OracleExpert on equal states gives equal controls; each env driven
    by its own package's expert for 150 steps stays equal (lights and
    traffic on)."""
    ours, ref = SimDrivingEnv(seed=2, vehicle_num=(2, 2)), \
        jsim.SimDrivingEnv(seed=2, vehicle_num=(2, 2))
    eo, er = OracleExpert(), jexpert.OracleExpert()
    to, tr = ours.reset(), ref.reset()
    moved = 0.0
    for t in range(150):
        ao, ar = eo.act(ours, to), er.act(ref, tr)
        assert ao == ar, (t, ao, ar)
        (to, _, do, _), (tr, _, dr, _) = ours.step(ao), ref.step(ar)
        _assert_ticks_equal(to, tr, f"expert step {t}")
        moved = max(moved, to["speed"])
        if do:
            to, tr = ours.reset(), ref.reset()
    assert moved > 3.0


# ------------------------------------------------- (b) the golden trace

def test_golden_trace_reproduced():
    """The port's SimDrivingEnv(seed=1234, seq_length=2) under the golden
    test's control script: the recorded rewards (rtol = atol = 1e-4),
    done flags and end message."""
    golden = json.load(open(GOLDEN_PATH))
    env = SimDrivingEnv(seed=1234, seq_length=2)
    env.reset()
    rewards, dones = [], []
    for control in CONTROL_SCRIPT:
        _, r, done, info = env.step(control)
        rewards.append([round(float(r[0]), 5), round(float(r[1]), 5)])
        dones.append(bool(done))
        if done:
            break
    assert info["error_message"] == golden["end"]
    assert dones == golden["dones"]
    np.testing.assert_allclose(np.asarray(rewards),
                               np.asarray(golden["rewards"]),
                               rtol=1e-4, atol=1e-4)


# --------------------------------------- (c) device env against host env

def _bank_from_sim(sim) -> torch_env.RouteBank:
    """A one-route device bank holding exactly the host env's dense route
    and props (no lights, no stop signs)."""
    far = 1.0e8
    dense = sim._route_xy.astype(np.float32)
    n = len(dense)
    routes = np.concatenate([dense, np.repeat(dense[-1:], 80, 0)])[None]
    seg = np.hypot(*(np.diff(dense, axis=0).T))
    cum = np.concatenate([[0.0], np.cumsum(seg)]) / seg.sum()
    cums = np.ones((1, n + 80), np.float32)
    cums[0, :n] = cum
    props = np.full((1, 40, 6), far, np.float32)
    props[0, :len(sim._props)] = sim._props
    t = torch.from_numpy
    return torch_env.RouteBank(
        t(routes), torch.tensor([n]), t(cums),
        t(np.full((1, 8, 5), far, np.float32)),
        t(np.full((1, 2, 5), far, np.float32)), t(props))


def test_device_env_tracks_host_env():
    """The port's device env against the port's host env on the host env's
    route, both driven by the host expert's controls: measurements and
    rewards within 2e-3 per step, the turn-grace flag on the same number
    of steps, and both ending on the same step with 'success' (code 6) and
    rewards within 1e-3 (the tolerances of tests/test_jax_env.py)."""
    sim = SimDrivingEnv(seed=0, with_traffic_lights=False, seq_length=1,
                        route_legs=2, route_leg_len=(25.0, 30.0))
    tick = sim.reset()
    cfg = torch_env.EnvConfig(n_vehicles=0, n_walkers=0,
                              randomize_weather=False, render=False)
    env = torch_env.DrivingEnv(_bank_from_sim(sim), 1, cfg, device="cpu")
    state, _ = env.reset()
    expert = OracleExpert()
    turn_sim = turn_dev = 0
    for t in range(200):
        a = expert.act(sim, tick)
        tick, rew, done, info = sim.step(a)
        state, out = env.step(state, torch.tensor([a], dtype=torch.float32))
        turn_sim += int(sim._turn_state.in_turn)
        turn_dev += int(state.turn[0, 7] >= 0.5)
        if done or bool(out.done[0]):
            assert done and bool(out.done[0]), (t, info, out.error_code)
            assert info["error_message"] == "success"
            assert int(out.error_code[0]) == 6
            np.testing.assert_allclose(out.rewards[0].numpy(), rew,
                                       atol=1e-3)
            break
        np.testing.assert_allclose(out.measurements[0].numpy(),
                                   tick["last_measurements"], atol=2e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(out.rewards[0].numpy(), rew, atol=2e-3,
                                   err_msg=f"step {t}")
    else:
        pytest.fail("route never completed")
    assert turn_sim == turn_dev > 0


# ------------------------------------------------- (d) the rollout code

def _steps(rng, n, seq, f, k):
    """k steps of rollout fields with a leading [n] (None: one env)."""
    lead = () if n is None else (n,)
    for _ in range(k):
        yield dict(obs=rng.standard_normal(lead + (seq, f)).astype(np.float32),
                   action=rng.randint(0, 5, lead).astype(np.int32),
                   log_prob=rng.standard_normal(lead).astype(np.float32),
                   value=rng.standard_normal(lead).astype(np.float32),
                   reward=rng.standard_normal(lead).astype(np.float32),
                   mask=np.asarray(rng.rand(*lead) > 0.3, np.float32),
                   hidden=tuple(rng.standard_normal((n or 1, f)).astype(
                       np.float32) for _ in range(2)),
                   command=rng.randint(0, 4, lead).astype(np.int32))


def _one_env(ours, ref):
    """The port's buffer field as the JAX one is shaped: the one-env loop's
    N = 1 axis dropped where JAX's single-env Rollout has none."""
    return ours.numpy().reshape(np.shape(ref))


def _assert_buffers_equal(ours, ref):
    assert ours.step == int(ref.step)
    for k in ("obs", "action", "log_prob", "value", "reward", "mask",
              "command", "hn", "cn"):
        np.testing.assert_array_equal(
            _one_env(getattr(ours, k), getattr(ref, k)),
            np.asarray(getattr(ref, k)), err_msg=k)


def test_rollout_inserts_and_minibatches_equal_jax():
    """One env (the port's N = 1 buffer against JAX's Rollout): insert (8
    steps into 6 slots, so the ring wraps and the carry stops at slot T),
    after_update, the returns, the minibatch gather with JAX's permutation
    injected and minibatch_indices; two envs (against JAX's
    BatchedRollout): insert and after_update with and without a carry.
    All equal to JAX's."""
    t, seq, f, n = 5, 3, 4, 2
    rng = np.random.RandomState(0)
    ours = rollout.create_rollout(t, 1, seq, f)
    ref = jro.create_rollout(t, seq, f)
    for s in _steps(rng, None, seq, f, 8):
        args = (s["obs"], s["action"], s["log_prob"], s["value"],
                s["reward"], s["mask"], s["hidden"], s["command"])
        ours = rollout.insert(ours, *(
            tuple(map(torch.from_numpy, a)) if isinstance(a, tuple)
            else torch.from_numpy(np.asarray(a)) for a in args))
        ref = jro.insert(ref, *args)
        _assert_buffers_equal(ours, ref)
    carry = tuple(rng.standard_normal((1, f)).astype(np.float32)
                  for _ in range(2))
    ours = rollout.after_update(ours, tuple(map(torch.from_numpy, carry)))
    ref = jro.after_update(ref, carry)
    _assert_buffers_equal(ours, ref)

    ret, adv = rollout.batched_returns(ours, torch.tensor(0.7), 0.99, 0.95)
    jret, jadv = jro.rollout_returns(ref, jnp.asarray(0.7), 0.99, 0.95)
    np.testing.assert_allclose(_one_env(ret, jret), np.asarray(jret),
                               atol=1e-6)
    key = jax.random.PRNGKey(3)
    jidx = jro.minibatch_indices(key, t, 2)
    idx = rollout.minibatch_indices(t, 2, perm=torch.from_numpy(np.asarray(
        jax.random.permutation(key, t)).astype(np.int64)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    mb = rollout.gather_minibatch_batched(ours, ret, adv, idx[1])
    jmb = jro.gather_minibatch(ref, jret, jadv, jidx[1])
    for a, b in zip(jax.tree.leaves(tuple(mb)), jax.tree.leaves(tuple(jmb))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    own = rollout.minibatch_indices(t, 2, torch.Generator().manual_seed(0))
    assert own.shape == (2, 2) and len(set(own.flatten().tolist())) == 4

    ours = rollout.create_rollout(t, n, seq, f)
    ref = jro.create_batched_rollout(t, n, seq, f)
    for s in _steps(rng, n, seq, f, 7):
        args = (s["obs"], s["action"], s["log_prob"], s["value"],
                s["reward"], s["mask"], s["hidden"], s["command"])
        ours = rollout.insert(ours, *(
            tuple(map(torch.from_numpy, a)) if isinstance(a, tuple)
            else torch.from_numpy(a) for a in args))
        ref = jro.insert_batch(ref, *args)
        _assert_buffers_equal(ours, ref)
    carry = tuple(rng.standard_normal((n, f)).astype(np.float32)
                  for _ in range(2))
    _assert_buffers_equal(
        rollout.after_update(ours, tuple(map(torch.from_numpy, carry))),
        jro.after_update_batched(ref, carry))
    assert rollout.after_update(ours).step == 0


# ------------------------------------------------- (e) the act paths

def _gumbel(key, n):
    """The (steer, throttle) noise JAX's act paths draw from `key`."""
    rs, rt = jax.random.split(key)
    return (np.array(jax.random.gumbel(rs, (n, STEER_BINS))),
            np.array(jax.random.gumbel(rt, (n, THROTTLE_BINS))))


def _random_variables(init, rng, path=()):
    """Weights in the layout `init` returns (traced by jax.eval_shape, not
    run: compiling flax's init takes longer than the tests): kernels
    normal / sqrt(fan-in), the attention gammas 0.5 / 0.3, BN scale and
    variance in [0.5, 1.5), biases and BN means 0.1 * normal."""
    tree = jax.eval_shape(init) if callable(init) else init
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_variables(v, rng, path + (k,))
            continue
        shape = v.shape
        if k == "gamma":
            x = np.full(shape, 0.5 if "sa" in path else 0.3)
        elif k in ("var", "scale"):
            x = rng.uniform(0.5, 1.5, shape)
        elif k in ("mean", "bias", "bias_ih", "bias_hh"):
            x = 0.1 * rng.standard_normal(shape)
        else:               # flax kernel [..., in, out]; LSTM [C, 4H, in]
            fan_in = shape[-1] if k.startswith("weight") else \
                int(np.prod(shape[1 if "policy" in path else 0:-1]))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def agents():
    """(JAX agent, port agent, weights): the CLI's small encoder at
    144x256, random eval-mode weights, one JAX agent for the module so
    that its jitted act paths compile once."""
    dcfg = jax_danet_params(**SMALL)
    acfg = JaxAgentConfig()
    f = dcfg.latent_dim + acfg.measurement_dim
    steer, throttle = (PolicyBankDef(acfg.command_num, a, f)
                       for a in (STEER_BINS, THROTTLE_BINS))
    key = jax.random.PRNGKey(0)
    vnp = _random_variables(lambda: create_danet(dcfg, key)[1],
                            np.random.RandomState(0))
    pnp = {s: _random_variables(lambda: d.init_params(key),
                                np.random.RandomState(i + 1), ("policy",))
           for i, (s, d) in enumerate((("steer", steer),
                                       ("throttle", throttle)))}
    jagent = JaxAgent(agent_cfg=acfg, danet_cfg=dcfg,
                      danet=JaxDANet(params_cfg=dcfg),
                      danet_vars=jax.tree.map(jnp.asarray, vnp),
                      steer_def=steer, throttle_def=throttle,
                      params=jax.tree.map(jnp.asarray, pnp),
                      ppo_cfg=JaxPPOConfig())
    return jagent, _port_agent(vnp, pnp), (vnp, pnp)


def _port_agent(vnp, pnp):
    cfg = danet_params(**SMALL)
    agent = CadreAgent.create(cfg, device="cpu",
                              encoder_state=danet_from_flax(vnp, cfg))
    agent.steer.load_state_dict(policy_from_flax(pnp["steer"]))
    agent.throttle.load_state_dict(policy_from_flax(pnp["throttle"]))
    return agent


def _fresh(agents):
    """Both agents back at the fixture's weights with fresh optimizers."""
    jagent, _, (vnp, pnp) = agents
    jagent.params = jax.tree.map(jnp.asarray, pnp)
    jagent.opt_state = jax_make_optimizer(jagent.ppo_cfg).init(jagent.params)
    return jagent, _port_agent(vnp, pnp)


@pytest.fixture(scope="module")
def ticks():
    """Four stacked ticks of two sim envs with traffic (measurements in
    float64, as the envs give them)."""
    vec = VecDrivingEnv([lambda k=k: SimDrivingEnv(seed=k, vehicle_num=(1, 1))
                         for k in range(2)])
    out = [vec.reset()]
    for _ in range(3):
        out.append(vec.step([[0.1, 0.6, 0.0], [-0.1, 0.6, 0.0]])[0])
    assert out[0]["measurements"].dtype == np.float64
    return out


def _assert_out_close(ours, ref, what):
    """Actions equal; log-probs and values within 1e-5."""
    np.testing.assert_array_equal(np.asarray(ours.action),
                                  np.asarray(ref.action), err_msg=what)
    for k in ("log_prob", "value"):
        np.testing.assert_allclose(getattr(ours, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=1e-5,
                                   err_msg=f"{what} {k}")


def test_act_matches_jax(agents, ticks):
    """act on one env's tick: features within 1e-4 of their scale, actions
    equal, log-probs, values and the carry within 1e-5; the agent's carry
    stays the stale zeros."""
    jagent, agent, _ = agents
    tick = {k: ticks[1][k][1] for k in ("rgb", "route_fig", "measurements")}
    tick["command"] = int(ticks[1]["command"][1])
    key = jax.random.PRNGKey(21)
    ref = jagent.act(tick, key)
    ours = agent.act(tick, _gumbel(key, 1))
    _rel_close(ours.features.numpy(), ref.features, 1e-4)
    for k in ("steer_action", "throttle_action"):
        assert int(getattr(ours, k)) == int(getattr(ref, k)), k
    for k in ("steer_log_prob", "throttle_log_prob", "steer_value",
              "throttle_value"):
        np.testing.assert_allclose(float(getattr(ours, k)),
                                   float(getattr(ref, k)), atol=1e-5)
    for a, b in zip(ours.hidden, ref.hidden):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert not agent.hidden_state[0].any()


def test_act_vec_and_incremental_match_jax(agents, ticks):
    """act_vec on two envs' windows, then act_vec_incremental on the next
    tick (newest frame encoded and shifted in) and with refresh: features
    and histories within 1e-4 of their scale, actions equal, log-probs,
    values and carries within 1e-5."""
    jagent, agent, _ = agents
    f = agent.obs_dim
    hidden = (np.zeros((2, f), np.float32), np.zeros((2, f), np.float32))
    key = jax.random.PRNGKey(22)
    jfeats, js, jt, jh = jagent.act_vec(ticks[0], tuple(map(jnp.asarray,
                                                           hidden)), key)
    th = tuple(map(torch.from_numpy, hidden))
    feats, s, t, h = agent.act_vec(ticks[0], th, _gumbel(key, 2))
    _rel_close(feats.numpy(), jfeats, 1e-4)
    _assert_out_close(s, js, "act_vec steer")
    _assert_out_close(t, jt, "act_vec throttle")
    for a, b in zip(h, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)

    jhist, hist = jnp.transpose(jfeats, (1, 0, 2)), feats.transpose(0, 1)
    for refresh in (False, True):
        key = jax.random.PRNGKey(23 + refresh)
        js, jt, _, jhist2 = jagent.act_vec_incremental(
            ticks[1], jhist, tuple(map(jnp.asarray, hidden)), key,
            refresh=refresh)
        s, t, _, hist2 = agent.act_vec_incremental(
            ticks[1], hist, th, _gumbel(key, 2), refresh=refresh)
        _rel_close(hist2.numpy(), jhist2, 1e-4)
        _assert_out_close(s, js, f"incremental {refresh} steer")
        _assert_out_close(t, jt, f"incremental {refresh} throttle")
        if not refresh:     # the old history shifted by one frame
            assert torch.equal(hist2[:-1], hist[1:])


def test_act_vec_store_matches_jax(agents, ticks):
    """Four fused ticks (store off, on, on with a refresh, on): the
    buffers' stored histories within 1e-4 of their scale, actions and
    commands equal, log-probs, values, rewards, masks and the recorded
    act-input carries within 1e-5, the ring pointer equal."""
    jagent, agent, _ = agents
    n, f = 2, agent.obs_dim
    rng = np.random.RandomState(4)
    hidden = tuple(0.1 * rng.standard_normal((n, f)).astype(np.float32)
                   for _ in range(2))
    jhidden, thidden = tuple(map(jnp.asarray, hidden)), \
        tuple(map(torch.from_numpy, hidden))
    jbufs = [jro.create_batched_rollout(4, n, 8, f) for _ in range(2)]
    bufs = [rollout.create_rollout(4, n, 8, f) for _ in range(2)]
    jhist = hist = None
    jpend, pend = jagent.zero_pending(n), agent.zero_pending(n)
    for k, (store, refresh) in enumerate(((False, True), (True, False),
                                          (True, True), (True, False))):
        key = jax.random.PRNGKey(30 + k)
        js, jt, _, jhist, *jbufs = jagent.act_vec_store(
            ticks[k], jhist, jhidden, key, *jbufs, jpend, store=store,
            refresh=refresh)
        s, t, _, hist, *bufs = agent.act_vec_store(
            ticks[k], hist, thidden, *bufs, pend, store=store,
            refresh=refresh, gumbel=_gumbel(key, n))
        _assert_out_close(s, js, f"tick {k} steer")
        _assert_out_close(t, jt, f"tick {k} throttle")
        rewards = rng.standard_normal((n, 2)).astype(np.float32)
        masks = [(rng.rand(n) > 0.3).astype(np.float32) for _ in range(2)]
        cmd = np.asarray(ticks[k]["command"], np.int32)
        jpend = (js, jt, cmd, rewards, *masks, jhidden)
        pend = (s, t, cmd, rewards, *masks, thidden)
    for buf, jbuf in zip(bufs, jbufs):
        assert buf.step == int(jbuf.step) == 3
        _rel_close(buf.obs.numpy(), jbuf.obs, 1e-4)
        for name in ("action", "command"):
            np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                          np.asarray(getattr(jbuf, name)))
        for name in ("log_prob", "value", "reward", "mask", "hn", "cn"):
            np.testing.assert_allclose(getattr(buf, name).numpy(),
                                       np.asarray(getattr(jbuf, name)),
                                       atol=1e-5, err_msg=name)


def test_get_value_matches_jax(agents, ticks):
    """get_value: each signal's stored window unrolled through its
    command's LSTM, within 1e-5; zeros when done."""
    jagent, agent, _ = agents
    rng = np.random.RandomState(5)
    obs = [rng.standard_normal((8, agent.obs_dim)).astype(np.float32)
           for _ in range(2)]
    ref = jagent.get_value(False, (obs[0], 1), (obs[1], 3))
    ours = agent.get_value(False, (obs[0], 1), (obs[1], 3))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)
    assert [float(v) for v in agent.get_value(True, None, None)] == [0, 0]


# ------------------------------------------------- (f) one training iteration

def _vec_draws(seed, t_steps, n, fused, epochs=4, mini_batch_num=2):
    """The Gumbel noise and permutations train_vec draws from
    PRNGKey(seed) in its first iteration: the fused update's from one key,
    the per-minibatch loop's from one split per epoch."""
    rng = jax.random.PRNGKey(seed)
    gumbels = []
    for _ in range(t_steps + 1):
        rng, key = jax.random.split(rng)
        gumbels.append(_gumbel(key, n))
    rows = t_steps * n
    if fused:
        rng, key = jax.random.split(rng)
        return IterationDraws(gumbels, _jax_perms(key, epochs, rows,
                                                  mini_batch_num))
    perms = ([], [])
    for _ in range(epochs):
        rng, k1, k2 = jax.random.split(rng, 3)
        for out, k in zip(perms, (k1, k2)):
            perm = np.asarray(jax.random.permutation(k, rows))
            out.append(perm.reshape(mini_batch_num, rows // mini_batch_num))
    return IterationDraws(gumbels, tuple(
        torch.from_numpy(np.concatenate(p).astype(np.int64)) for p in perms))


def test_train_vec_iteration_matches_jax(agents):
    """One train_vec iteration (2 sim envs with traffic, T=4, the fused
    tick and the fused update, 4 epochs x 2 minibatches) with JAX's draws
    and permutations injected: the three losses within 1% and every
    parameter within 1% of the largest change the JAX iteration made to
    its tensor."""
    _check_train_vec_iteration(agents, fused=True)


def test_train_vec_minibatch_update_matches_jax(agents):
    """The same iteration through the per-minibatch loop
    (`fused_update=False`, one `agent.update_policy` per minibatch) against
    the same path of JAX's train_vec, with its per-epoch permutations
    injected, at the same bounds."""
    _check_train_vec_iteration(agents, fused=False)


def _check_train_vec_iteration(agents, fused):
    jagent, agent = _fresh(agents)
    f, t_steps, seed = agent.obs_dim, 4, 9

    def envs(mod):
        return [lambda k=k: mod.SimDrivingEnv(seed=k, vehicle_num=(1, 1))
                for k in range(2)]

    ref = jax_train_vec(jvec.VecDrivingEnv(envs(jsim)), jagent,
                        JaxRolloutConfig(num_steps=t_steps, feature_dims=f),
                        JaxTrainConfig(), iterations=1, seed=seed,
                        fused_update=fused)[0]
    ours = train_vec(VecDrivingEnv(envs(psim)), agent,
        RolloutConfig(num_steps=t_steps, feature_dims=f), TrainConfig(),
        iterations=1, seed=seed, fused_update=fused,
        draws=[_vec_draws(seed, t_steps, 2, fused)])[0]
    np.testing.assert_allclose(
        [ours.value_loss, ours.policy_loss, ours.entropy_loss],
        [ref.value_loss, ref.policy_loss, ref.entropy_loss], rtol=1e-2)
    assert (ours.mean_steer_reward, ours.mean_throttle_reward) == \
        (ref.mean_steer_reward, ref.mean_throttle_reward)
    assert ours.refreshes == 1 + ours.episodes_finished == 1
    assert set(ours.phase_seconds) == {
        "act", "env", "update"}
    _assert_params_moved_alike({"steer": agent.steer,
                                "throttle": agent.throttle},
                               agents[2][1], jagent.params, 0.01)


def _train_draws(seed, t_steps, epochs=4, mini_batch_num=2):
    """The noise and per-epoch minibatch permutations train draws from
    PRNGKey(seed) in its first episode."""
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    gumbels, rng = [], k1
    for _ in range(t_steps + 1):
        rng, key = jax.random.split(rng)
        gumbels.append(_gumbel(key, 1))
    perms, rng = ([], []), k2
    for _ in range(epochs):
        rng, ka, kb = jax.random.split(rng, 3)
        for out, k in zip(perms, (ka, kb)):
            out.append(np.asarray(jro.minibatch_indices(k, t_steps,
                                                        mini_batch_num)))
    return IterationDraws(gumbels, tuple(
        torch.from_numpy(np.concatenate(p).astype(np.int64)) for p in perms))


def test_train_episode_matches_jax(agents):
    """One episode of `train` on FakeDrivingEnv (T=8, random commands, the
    episode ends on its last step) with JAX's draws and permutations
    injected: rewards equal and the losses within 1% of JAX's `train`.
    Then its two halves: `collect_rollout` against JAX's (stored
    histories within 1e-4 of their scale, actions, commands, rewards and
    masks equal, log-probs, values and carries within 1e-5) and
    `ppo_update_epochs` on the port's buffers against JAX's on the same
    buffers (every parameter within 1% of the largest change JAX made to
    its tensor). Across the whole episode the parameters agree to 0.3-1.2%
    of that change, depending on the draws: Adam turns the f32 rounding of
    a gradient entry near zero (a ReLU at its kink, minibatches of 4 rows)
    into a share of a full step."""
    jagent, agent = _fresh(agents)
    f, t_steps, seed = agent.obs_dim, 8, 12
    jcfg = JaxRolloutConfig(num_steps=t_steps, feature_dims=f)
    cfg = RolloutConfig(num_steps=t_steps, feature_dims=f)
    draws = _train_draws(seed, t_steps)
    ref = jax_train(jfake.FakeDrivingEnv(episode_length=t_steps, seed=3),
                    jagent, jcfg, JaxTrainConfig(), max_episode=1,
                    seed=seed)[0]
    ours = train(FakeDrivingEnv(episode_length=t_steps, seed=3), agent, cfg,
                 TrainConfig(), max_episode=1, seed=seed, draws=[draws])[0]
    np.testing.assert_allclose(
        [ours.value_loss, ours.policy_loss, ours.entropy_loss],
        [ref.value_loss, ref.policy_loss, ref.entropy_loss], rtol=1e-2)
    assert (ours.steer_reward, ours.throttle_reward) == \
        (ref.steer_reward, ref.throttle_reward)

    jagent, agent = _fresh(agents)
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    out = {}
    for side in ("jax", "port"):
        env = (jfake.FakeDrivingEnv if side == "jax" else FakeDrivingEnv)(
            episode_length=t_steps, seed=3)
        if side == "jax":
            bufs = [jro.create_rollout(t_steps, 8, f) for _ in range(2)]
            out[side] = jax_collect_rollout(env, jagent, *bufs, env.reset(),
                                            t_steps, k1)
        else:
            bufs = [rollout.create_rollout(t_steps, 1, 8, f)
                    for _ in range(2)]
            out[side] = collect_rollout(env, agent, *bufs, env.reset(),
                                        t_steps, draws.gumbel)
    (_, jdone, *jbufs, jsums, _), (_, done, *bufs, sums, nv) = \
        out["jax"], out["port"]
    assert done and jdone and sums == jsums
    for buf, jbuf in zip(bufs, jbufs):
        assert buf.step == int(jbuf.step) == t_steps
        _rel_close(_one_env(buf.obs, jbuf.obs), jbuf.obs, 1e-4)
        for name in ("action", "command", "reward", "mask"):
            np.testing.assert_array_equal(
                _one_env(getattr(buf, name), getattr(jbuf, name)),
                np.asarray(getattr(jbuf, name)))
        for name in ("log_prob", "value", "hn", "cn"):
            np.testing.assert_allclose(
                _one_env(getattr(buf, name), getattr(jbuf, name)),
                np.asarray(getattr(jbuf, name)), atol=1e-5, err_msg=name)
    as_jax = [jro.Rollout(**{k: jnp.asarray(_one_env(v, getattr(jb, k)))
                             for k, v in b._asdict().items() if k != "step"},
                          step=jnp.zeros((), jnp.int32))
              for b, jb in zip(bufs, jbufs)]
    jloss = jax_ppo_update_epochs(jagent, *as_jax, tuple(map(
        lambda v: jnp.asarray(v.numpy()).reshape(()), nv)), JaxTrainConfig(),
        jcfg, k2)
    loss = ppo_update_epochs(agent, *bufs, nv, TrainConfig(), cfg,
                             draws.perms)
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    _assert_params_moved_alike({"steer": agent.steer,
                                "throttle": agent.throttle},
                               agents[2][1], jagent.params, 0.01)


# ------------------------------------------------- (g) the CLI

CLI_RUNS = {
    "sim_vec": ["--env", "sim", "--num-envs", "2", "--iterations", "1"],
    "fake_vec": ["--env", "fake", "--num-envs", "2", "--iterations", "1"],
    "sim_one": ["--env", "sim", "--num-envs", "1", "--episodes", "1"],
    "fake_one": ["--env", "fake", "--num-envs", "1", "--episodes", "1"],
}


def test_cli_host_envs_train_and_save(tmp_path):
    """`python -m cadre_tpu_torch.main --env sim|fake --small --device cpu
    --num-steps 4` with --num-envs 2 (train_vec) and 1 (train), four
    subprocesses at once: each exits 0 and writes its snapshot where the
    JAX CLI would, and load_snapshot reads it back equal."""
    env = dict(os.environ, OMP_NUM_THREADS="2")

    def run(name):
        return subprocess.run(
            [sys.executable, "-m", "cadre_tpu_torch.main", *CLI_RUNS[name],
             "--small", "--device", "cpu", "--num-steps", "4",
             "--work-dir", str(tmp_path / name)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)

    with concurrent.futures.ThreadPoolExecutor(len(CLI_RUNS)) as pool:
        outs = dict(zip(CLI_RUNS, pool.map(run, CLI_RUNS)))
    agent = CadreAgent.create(danet_params(**SMALL), seed=1, device="cpu")
    for name, out in outs.items():
        assert out.returncode == 0, (name, out.stderr[-2000:])
        sub = "models" if name.endswith("vec") else os.path.join("0",
                                                                 "models")
        path = tmp_path / name / sub / "ppo_model_0.pt"
        assert f"saved {path}" in out.stdout, (name, out.stdout)
        agent.load_snapshot(str(path))
        saved = torch.load(path, weights_only=True)
        for s, bank in (("steer", agent.steer),
                        ("throttle", agent.throttle)):
            for k, v in bank.state_dict().items():
                torch.testing.assert_close(v, saved[s][k], rtol=0, atol=0)


@pytest.mark.parametrize("flag", ["--env=carla", "--town=Town01"])
def test_cli_unported_host_flag_raises(flag, tmp_path, monkeypatch):
    """The CARLA flags of the JAX CLI are ported: `--town` is accepted,
    and without a `carla` package `--env carla` raises the
    ModuleNotFoundError naming it (the JAX CLI's), falling back to no
    other env."""
    from cadre_tpu_torch import main

    monkeypatch.setitem(sys.modules, "carla", None)
    assert main.parse_args(["--env", "sim", flag]).town == "Town01"
    carla = [flag] if flag == "--env=carla" else [flag, "--env=carla"]
    with pytest.raises(ModuleNotFoundError, match="carla") as err:
        main.main(["--env", "sim", "--small", "--device", "cpu",
                   "--work-dir", str(tmp_path), *carla])
    assert err.value.name == "carla"


@pytest.mark.parametrize("args", [["--env", "sim", "--num-envs", "2"],
                                  ["--env", "fake"]])
def test_cli_host_env_without_gpu_raises(args):
    """The host-env paths run on the GPU by default: without one they
    raise and do not carry on on the CPU."""
    from cadre_tpu_torch import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main.main([*args, "--small", "--iterations", "1"])


def test_train_vec_mesh_raises(agents):
    """A mesh is a parallel.mesh.Mesh: the JAX CLI's string is refused
    (the data-parallel path is held in test_torch_port_parallel.py)."""
    with pytest.raises(TypeError, match="make_mesh"):
        train_vec(None, agents[1], mesh="data")


# ------------------------------------------------- the 'position' fault

def test_danet_position_without_bc_matches_jax():
    """att_type='position' with pred_bc=False (the 'position' experiments
    and the DA-beta-VAE family) through the whole eval forward at 64x96:
    camera, route and light_state within 1e-4 of their scale of the JAX
    DANet.__call__; with pred_bc the port still refuses the config."""
    geom = dict(image_height=64, image_width=96, feat_h=2, feat_w=3)
    flags = dict(SMALL, att_type="position", pred_bc=False, **geom)
    jcfg, cfg = jax_danet_params(**flags), danet_params(**flags)
    vnp = _random_variables(lambda: create_danet(jcfg,
                                                 jax.random.PRNGKey(4))[1],
                            np.random.RandomState(6))
    x = np.random.RandomState(7).uniform(0, 1, (2, 64, 96, 4)) \
        .astype(np.float32)
    ref = jax.jit(lambda v, a: JaxDANet(params_cfg=jcfg).apply(v, a))(
        jax.tree.map(jnp.asarray, vnp), jnp.asarray(x))
    model = DANet(cfg).eval()
    model.load_state_dict(danet_from_flax(vnp, cfg))
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    assert set(ours) == set(ref) == {"camera", "route", "light_state"}
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        _rel_close(ours[k].numpy(), ref[k], 1e-4)
    with pytest.raises(ValueError, match="position"):
        DANet(danet_params(**dict(flags, pred_bc=True)))(torch.from_numpy(x))
