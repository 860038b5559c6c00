"""The port's acting slice against the JAX package, on the CPU.

Weights, inputs and every random number are made once (numpy or JAX's own
keys) and handed to both: flax weights go through
cadre_tpu_torch.utils.convert, and the JAX env's reset draws, camera noise
and action Gumbel noise enter the port through its draw seam.
Tolerances are stated per test; the env's images may differ at a small
share of shape-boundary pixels where the two frameworks' trig differs in
the last ulp.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.configs.agent_config import AgentConfig as JaxAgentConfig
from cadre_tpu.configs.agent_config import STEER_CONTROL, THROTTLE_CONTROL
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.envs import jax_env
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.models.danet import create_danet
from cadre_tpu.models.policy import PolicyBankDef
from cadre_tpu.rl.agent import CadreAgent as JaxAgent
from cadre_tpu.rl.agent import latent_features as jax_latent
from cadre_tpu.rl.agent import preprocess_obs as jax_preprocess
from cadre_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from cadre_tpu_torch.configs.agent_config import RolloutConfig
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.envs import torch_env
from cadre_tpu_torch.models.danet import DANet
from cadre_tpu_torch.models.policy import PolicyBank
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.device_rollout import ActDraws, make_device_rollout
from cadre_tpu_torch.utils.convert import (
    danet_from_flax,
    env_state_from_numpy,
    policy_from_flax,
    route_bank_from_numpy,
)

SMALL = dict(da_feature_channel=32, inter_att_dims=24, z_dims=16)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads for this module's torch work: the suite runs
    several worker processes, each beside JAX's own thread pool, and
    torch's default of one thread per core oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, rng, path=()):
    """Non-trivial eval-mode weights: BN statistics and affine terms, the
    attention gammas and all biases away from their init values."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, p)
        elif k == "gamma":
            out[k] = np.full_like(v, 0.5 if "sa" in p else 0.3)
        elif k in ("var", "scale"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean", "bias"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = np.array(v)
    return out


def _rel_close(ours, ref, rtol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("fused", [True, False])
def test_encoder_latent_matches_jax(fused):
    """DANet.latent at a small width in f32: within 1e-4 of the latent's
    scale (ResNet18 depth, sums in another order)."""
    jcfg = jax_danet_params(**SMALL, use_fused_attention=fused)
    model, variables = create_danet(jcfg, jax.random.PRNGKey(0))
    vnp = _perturb(_np(variables), np.random.RandomState(0))
    x = np.random.RandomState(1).uniform(0, 1, (3, 144, 256, 4)) \
        .astype(np.float32)
    ref = model.apply(jax.tree.map(jnp.asarray, vnp), jnp.asarray(x),
                      method=JaxDANet.latent)
    cfg = danet_params(**SMALL, use_fused_attention=fused)
    enc = DANet(cfg).eval()
    enc.load_state_dict(danet_from_flax(vnp, cfg))
    with torch.no_grad():
        ours = enc.latent(torch.from_numpy(x))
    assert ours.shape == (3, 2 * SMALL["z_dims"])
    _rel_close(ours.numpy(), ref, 1e-4)


def test_policy_act_batch_matches_jax():
    """Logits, log-probs, values and the carry within 1e-5; actions equal
    under the same Gumbel noise (jax.random.categorical is
    argmax(logits + gumbel))."""
    t, n, f = 8, 5, 50
    jdef = PolicyBankDef(4, 33, f)
    pnp = _perturb(_np(jdef.init_params(jax.random.PRNGKey(1))),
                   np.random.RandomState(2))
    rng = np.random.RandomState(3)
    obs = rng.standard_normal((t, n, f)).astype(np.float32)
    commands = rng.randint(0, 4, n).astype(np.int32)
    carry = tuple(rng.standard_normal((n, f)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.PRNGKey(4)
    ref, ref_carry = jdef.act_batch(jax.tree.map(jnp.asarray, pnp),
                                    jnp.asarray(commands), jnp.asarray(obs),
                                    tuple(map(jnp.asarray, carry)), key)
    gumbel = np.array(jax.random.gumbel(key, (n, 33)))
    bank = PolicyBank(4, 33, f)
    bank.load_state_dict(policy_from_flax(pnp))
    with torch.no_grad():
        ours, our_carry = bank.act_batch(
            torch.from_numpy(obs), torch.from_numpy(commands),
            tuple(map(torch.from_numpy, carry)), torch.from_numpy(gumbel))
    np.testing.assert_array_equal(ours.action.numpy(), np.asarray(ref.action))
    for a, b in ((ours.logits, ref.logits), (ours.log_prob, ref.log_prob),
                 (ours.value, ref.value), (our_carry[0], ref_carry[0]),
                 (our_carry[1], ref_carry[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_categorical_log_prob_and_entropy_match_jax():
    from cadre_tpu.rl import distributions as jd
    from cadre_tpu_torch.rl import distributions as td

    rng = np.random.RandomState(8)
    logits = (3.0 * rng.standard_normal((6, 33))).astype(np.float32)
    action = rng.randint(0, 33, 6)
    t = torch.from_numpy(logits)
    np.testing.assert_allclose(
        td.categorical_log_prob(t, torch.from_numpy(action)).numpy(),
        np.asarray(jd.categorical_log_prob(jnp.asarray(logits),
                                           jnp.asarray(action))), atol=1e-5)
    np.testing.assert_allclose(
        td.categorical_entropy(t).numpy(),
        np.asarray(jd.categorical_entropy(jnp.asarray(logits))), atol=1e-5)


# ---------------------------------------------------------------- env

def test_route_bank_equals_jax():
    ref = jax_env.make_route_bank(3, seed=0)
    ours = torch_env.make_route_bank(3, seed=0, device="cpu")
    for name in torch_env.RouteBank._fields:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def _reset_draws_one(cfg, n_routes, key):
    """_reset_one's draws from its key, as the JAX env makes them
    (`jax.random.categorical(k, prio)` is argmax(gumbel(k, (K,)) + prio))."""
    k_route, k_obs, k_weather, k_state = jax.random.split(key, 4)
    ks = list(jax.random.split(k_obs, 7)) + [jax.random.fold_in(k_obs, 101),
                                             jax.random.fold_in(k_obs, 102)]
    m = max(cfg.n_vehicles + cfg.n_walkers + cfg.n_hazards
            + cfg.n_junction_hazards, 1)
    u = jax.random.uniform
    if cfg.priority_routes:
        k_eps, k_soft, k_route = jax.random.split(k_route, 3)
        prio = dict(prio_eps=u(k_eps),
                    prio_gumbel=jax.random.gumbel(k_soft, (n_routes,)))
    else:
        prio = dict(prio_eps=jnp.zeros(()),
                    prio_gumbel=jnp.zeros((n_routes,)))
    return k_state, dict(
        route=jax.random.randint(k_route, (), 0, n_routes),
        spawn=jax.random.randint(ks[0], (m,), 0, 1 << 30),
        lateral=u(ks[1], (m, 2), minval=-3.0, maxval=3.0),
        walker_speed=u(ks[2], (m,), minval=0.3, maxval=1.2),
        heading=u(ks[3], (m,), minval=0.0, maxval=2.0 * jnp.pi),
        cruise=u(ks[6], (m,), minval=cfg.npc_cruise[0],
                 maxval=cfg.npc_cruise[1]),
        weather=jax.random.randint(k_weather, (), 0,
                                   len(jax_env._WNAMES)),
        side=jax.random.bernoulli(ks[4], shape=(m,)),
        hazard_speed=u(ks[5], (m,), minval=1.2, maxval=2.0),
        junction_light=jax.random.randint(ks[7], (m,), 0, 1 << 30),
        junction_speed=u(ks[8], (m,), minval=cfg.junction_hazard_speed[0],
                         maxval=cfg.junction_hazard_speed[1]),
        **prio)


def _noise(key):
    return jax.random.normal(key, (144, 256, 3))


def _torch_draws(reset, noise):
    reset = torch_env.ResetDraws(**{k: torch.from_numpy(np.array(v))
                                    for k, v in reset.items()})
    return torch_env.StepDraws(reset, torch.from_numpy(np.array(noise)))


@functools.lru_cache(maxsize=None)
def _reset_draws_fn(cfg, n_routes, n):
    def draws(key):
        k_state, reset = jax.vmap(
            lambda k: _reset_draws_one(cfg, n_routes, k))(
                jax.random.split(key, n))
        return reset, jax.vmap(lambda k: _noise(jax.random.split(k)[1]))(
            k_state)

    return jax.jit(draws)


def jax_reset_draws(cfg, n_routes, key, n):
    """Port draws equal to what JaxDrivingEnv.reset(key) uses."""
    return _torch_draws(*_reset_draws_fn(cfg, n_routes, n)(key))


@functools.lru_cache(maxsize=None)
def _step_draws_fn(cfg, n_routes):
    def one(key):
        _, k_reset, k_noise = jax.random.split(key, 3)
        return _reset_draws_one(cfg, n_routes, k_reset)[1], _noise(k_noise)

    return jax.jit(jax.vmap(one))


def jax_step_draws(cfg, n_routes, rng):
    """Port draws equal to what JaxDrivingEnv.step uses from state.rng."""
    return _torch_draws(*_step_draws_fn(cfg, n_routes)(rng))


def _assert_obs_close(ours, ref, what, max_px_share=0.005):
    """Measurements within 1e-3; images equal except for a small share of
    boundary pixels."""
    np.testing.assert_allclose(ours["measurements"].numpy(),
                               np.asarray(ref["measurements"]), atol=1e-3,
                               err_msg=what)
    for name in ("rgb", "route_fig"):
        a, b = ours[name].numpy(), np.asarray(ref[name])
        assert a.shape == b.shape
        share = float((np.abs(a - b) > 1e-3).mean())
        assert share <= max_px_share, f"{what} {name}: {share:.4%} differ"


def _state_dict(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state_close(ours, ref, what, prio=True):
    """Every field of the port's EnvState against the JAX state's. With
    `prio` False the port's route priorities must be the untouched table
    of 100s instead: without priority routes the port leaves the table as
    reset made it, where the JAX env updates it at every episode's end."""
    ref = _state_dict(ref)
    for name in torch_env.EnvState._fields:
        if name == "route_prio" and not prio:
            assert (ours.route_prio == 100.0).all(), what
            continue
        a, b = getattr(ours, name).numpy(), ref[name]
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-5,
                                       err_msg=f"{what} {name}")


ENV_VARIANTS = {
    "train": {},
    # evaluation settings: no training-only terminations, no route timeout
    # (env 0 then ends blocked), fixed weather, speed-only measurements
    "eval": dict(training=False, route_timeout=False,
                 randomize_weather=False, blind_route=True),
}


@pytest.mark.parametrize("variant", list(ENV_VARIANTS))
def test_env_reset_and_steps_match_jax(variant):
    """Reset, then K=4 steps from the transferred JAX state with JAX's
    draws injected. Env 0 starts past its route timeout and env 1 above
    the speed limit, so termination and auto-reset are exercised.
    Rewards within 1e-3; done, action_done and error codes equal."""
    n, k_steps = 4, 4
    cfg = jax_env.JaxEnvConfig(**ENV_VARIANTS[variant])
    jbank = jax_env.make_route_bank(3, seed=0)
    jenv = jax_env.JaxDrivingEnv(jbank, n, cfg)
    key = jax.random.PRNGKey(5)
    jstate, jobs = jenv.reset(key)

    bank = route_bank_from_numpy(_np(jbank._asdict()))
    env = torch_env.DrivingEnv(bank, n, torch_env.EnvConfig(
        **ENV_VARIANTS[variant]), device="cpu")
    tstate, tobs = env.reset(jax_reset_draws(cfg, 3, key, n))
    _assert_obs_close(tobs, jobs, "reset")
    _assert_state_close(tstate, jstate, "reset")

    jstate = jstate._replace(step=jstate.step.at[0].set(100000),
                             speed=jstate.speed.at[1].set(9.5))
    tstate = env_state_from_numpy(_state_dict(jstate))
    rng = np.random.RandomState(6)
    done_any = np.zeros(n, bool)
    for k in range(k_steps):
        controls = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(0, 1, n),
                             np.zeros(n)], -1).astype(np.float32)
        draws = jax_step_draws(cfg, 3, jstate.rng)
        jstate, jout = jenv.step(jstate, jnp.asarray(controls))
        tstate, tout = env.step(tstate, torch.from_numpy(controls), draws)
        what = f"step {k}"
        for name in ("done", "action_done", "error_code", "infractions",
                     "command"):
            np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          err_msg=f"{what} {name}")
        for name in ("rewards", "completion"):
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       atol=1e-3, err_msg=f"{what} {name}")
        _assert_obs_close(tout._asdict(), jout._asdict(), what)
        _assert_state_close(tstate, jstate, what, prio=cfg.priority_routes)
        done_any |= np.asarray(jout.done)
    assert done_any[0]
    assert done_any[1] == cfg.training     # overspeed ends training only


# ---------------------------------------------------------------- slice

def jax_agent(seed=0):
    """The agent JaxAgent.create makes with the small encoder, its
    initialisation jitted: flax's eager init compiles every op alone."""
    dcfg = jax_danet_params(**SMALL)
    acfg = JaxAgentConfig()
    f = dcfg.latent_dim + acfg.measurement_dim
    steer, throttle = (PolicyBankDef(acfg.command_num, a, f) for a in
                       (acfg.num_steer_outputs, acfg.num_throttle_outputs))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    danet_vars, params = jax.jit(lambda: (
        create_danet(dcfg, k1)[1],
        {"steer": steer.init_params(k2),
         "throttle": throttle.init_params(k3)}))()
    return JaxAgent(agent_cfg=acfg, danet_cfg=dcfg,
                    danet=JaxDANet(params_cfg=dcfg), danet_vars=danet_vars,
                    steer_def=steer, throttle_def=throttle, params=params,
                    ppo_cfg=JaxPPOConfig())


def three_step_reference(n=2, t_steps=3):
    """The JAX pieces of the acting slice, step by step: render -> encode
    -> act -> step for `t_steps` steps at N=`n`, small encoder in f32,
    perturbed weights; env 0 times out on the first step, so its history is
    re-tiled. Returns the JAX agent, weights, env, per-step outputs and
    commands, the port's draws for the same steps and the state after the
    last step."""
    jagent = jax_agent()
    vnp = _perturb(_np(jagent.danet_vars), np.random.RandomState(0))
    pnp = {s: _perturb(_np(jagent.params[s]), np.random.RandomState(i + 1))
           for i, s in enumerate(("steer", "throttle"))}
    jvars = jax.tree.map(jnp.asarray, vnp)
    jparams = jax.tree.map(jnp.asarray, pnp)

    cfg = jax_env.JaxEnvConfig()
    jbank = jax_env.make_route_bank(3, seed=0)
    jenv = jax_env.JaxDrivingEnv(jbank, n, cfg)
    key = jax.random.PRNGKey(7)
    jstate, obs = jenv.reset(key)
    jstate = jstate._replace(step=jstate.step.at[0].set(100000))
    jstate0 = jstate

    def encode(o):
        x = jax_preprocess(o["rgb"], o["route_fig"])
        return jax_latent(jagent.danet, jvars, x, o["measurements"])

    f = jagent.obs_dim
    feat_hist = jnp.broadcast_to(encode(obs)[None], (8, n, f))
    done_prev = jnp.zeros((n,), bool)
    zeros = (jnp.zeros((n, f)), jnp.zeros((n, f)))
    steer_lut = jnp.asarray(STEER_CONTROL, jnp.float32)
    throttle_lut = jnp.asarray(THROTTLE_CONTROL, jnp.float32)
    act = jax.jit(jagent._act_from_hist)
    ref, draws, commands = [], [], []
    for t in range(t_steps):
        feats = encode(obs)
        rolled = jnp.concatenate([feat_hist[1:], feats[None]], axis=0)
        feat_hist = jnp.where(done_prev[None, :, None],
                              jnp.broadcast_to(feats[None], feat_hist.shape),
                              rolled)
        k = jax.random.PRNGKey(100 + t)
        commands.append(obs["command"])
        s_out, t_out, _ = act(jparams, feat_hist, obs["command"], zeros, k)
        rs, rt = jax.random.split(k)
        step_draws = jax_step_draws(cfg, 3, jstate.rng)
        controls = jnp.concatenate([steer_lut[s_out.action][:, None],
                                    throttle_lut[t_out.action]], axis=-1)
        jstate, out = jenv.step(jstate, controls)
        obs = dict(rgb=out.rgb, route_fig=out.route_fig,
                   measurements=out.measurements, command=out.command)
        done_prev = out.done
        ref.append((np.asarray(jnp.swapaxes(feat_hist, 0, 1)), s_out, t_out,
                    out))
        draws.append(ActDraws(
            torch.from_numpy(np.array(jax.random.gumbel(rs, (n, 33)))),
            torch.from_numpy(np.array(jax.random.gumbel(rt, (n, 3)))),
            step_draws))
    return dict(jagent=jagent, vnp=vnp, pnp=pnp, jparams=jparams,
                encode=encode, act=act, cfg=cfg, jbank=jbank, key=key,
                jstate0=jstate0, ref=ref, draws=draws, commands=commands,
                obs=obs,
                feat_hist=feat_hist, done_prev=done_prev)


def port_agent_and_carry(r, rollout_cfg, make=make_device_rollout, **kw):
    """The port's agent and env with the reference's weights, and `make`'s
    (step fn, init_carry) with its carry started from the reference's
    reset and initial state."""
    n = r["done_prev"].shape[0]
    agent = CadreAgent.create(danet_params(**SMALL), device="cpu")
    agent.encoder.load_state_dict(danet_from_flax(r["vnp"], agent.danet_cfg))
    agent.steer.load_state_dict(policy_from_flax(r["pnp"]["steer"]))
    agent.throttle.load_state_dict(policy_from_flax(r["pnp"]["throttle"]))
    bank = route_bank_from_numpy(_np(r["jbank"]._asdict()))
    env = torch_env.DrivingEnv(bank, n, device="cpu")
    fn, init_carry = make(agent, env, rollout_cfg, **kw)
    carry = init_carry(jax_reset_draws(r["cfg"], 3, r["key"], n))
    carry = carry._replace(
        env_state=env_state_from_numpy(_state_dict(r["jstate0"])))
    return agent, fn, carry


def test_slice_three_steps_match_jax():
    """render -> encode -> act -> step for 3 steps at N=2, small encoder in
    f32: the port's rollout buffers against the JAX pieces step by step.
    Features, log-probs and values within 1e-4 of their scale, actions and
    done equal, rewards within 1e-3."""
    n, t_steps = 2, 3
    r = three_step_reference(n, t_steps)
    _, rollout, carry = port_agent_and_carry(
        r, RolloutConfig(num_steps=t_steps))
    carry, steer_buf, throttle_buf, _, metrics = rollout(carry, r["draws"])

    f = r["jagent"].obs_dim
    assert steer_buf.obs.shape == (t_steps + 1, n, 8, f)
    for t, (hist, s_out, t_out, out) in enumerate(r["ref"]):
        _rel_close(steer_buf.obs[t].numpy(), hist, 1e-4)
        for buf, o in ((steer_buf, s_out), (throttle_buf, t_out)):
            np.testing.assert_array_equal(buf.action[t].numpy(),
                                          np.asarray(o.action))
            _rel_close(buf.log_prob[t].numpy(), o.log_prob, 1e-4)
            _rel_close(buf.value[t].numpy(), o.value, 1e-4)
        np.testing.assert_allclose(steer_buf.reward[t].numpy(),
                                   np.asarray(out.rewards[:, 0]), atol=1e-3)
        np.testing.assert_allclose(throttle_buf.reward[t].numpy(),
                                   np.asarray(out.rewards[:, 1]), atol=1e-3)
    assert float(metrics.episodes_done) >= 1.0
    assert torch.isfinite(metrics.checksum)


def _small_rollout(t_steps):
    agent = CadreAgent.create(danet_params(**SMALL), seed=3, device="cpu")
    env = torch_env.DrivingEnv(
        torch_env.make_route_bank(3, seed=0, device="cpu"), 3, seed=4,
        device="cpu")
    return make_device_rollout(agent, env, RolloutConfig(num_steps=t_steps),
                               seed=5)


def test_device_rollout_own_draws():
    """The rollout with its own generators: the same seeds give the same
    run; an env that ends on the last step gets a zero bootstrap value and,
    in the next rollout, a history re-tiled from its fresh first frame."""
    runs = []
    for _ in range(2):
        rollout, init_carry = _small_rollout(t_steps=1)
        carry = init_carry()
        state = carry.env_state
        # env 0 is past its route timeout, so the one step ends it
        carry = carry._replace(env_state=state._replace(
            step=state.step.index_fill(0, torch.tensor([0]), 100000)))
        runs.append(rollout(carry))
    (carry, steer, throttle, next_values, m), again = runs
    assert float(m.checksum) == float(again[4].checksum)
    torch.testing.assert_close(steer.obs, again[1].obs, rtol=0, atol=0)

    f = 2 * SMALL["z_dims"] + 18
    assert steer.obs.shape == (2, 3, 8, f) and throttle.action.shape == (2, 3)
    assert not steer.obs[1].any() and not throttle.log_prob[1].any()
    assert bool(carry.done_prev[0]) and float(m.episodes_done) >= 1.0
    assert float(m.error_hist.sum()) == float(m.episodes_done)
    for values in next_values:
        assert float(values[0]) == 0.0
        assert bool((values[~carry.done_prev] != 0).all())

    carry, steer, *_ = rollout(carry)
    hist = steer.obs[0, 0]                               # [seq, F] of env 0
    assert bool((hist == hist[-1]).all())
    assert not bool((steer.obs[0, 1] == steer.obs[0, 1, -1]).all())
