"""The policy-bank options of the port against the JAX package, on the
CPU: memory 'transformer' and 'none', `use_lstm=False`, and the ordinal
head on top of each memory.

Bank weights are drawn with numpy in the layout of the JAX bank's
`init_params` (traced by jax.eval_shape, not run) and carried into the
port by utils.convert.policy_from_flax; buffers, observations and noise
are numpy draws from seeds, handed to both. Each option's JAX act,
evaluate_masked and fused update are jitted once for the module. Widths
are small (F=12, C=4 banks, a window of T=4 frames, N=3 envs, 7 and 5
bins). Tolerances are stated per test.
"""
import dataclasses
import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.configs import loader as jloader
from cadre_tpu.configs.agent_config import AgentConfig as JaxAgentConfig
from cadre_tpu.configs.agent_config import RolloutConfig as JaxRolloutConfig
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.models.policy import PolicyBankDef
from cadre_tpu.rl import distributions as jdist
from cadre_tpu.rl import fused_update as jfu
from cadre_tpu.rl import ppo as jppo
from cadre_tpu.rl.agent import CadreAgent as JaxAgent
from cadre_tpu.utils import checkpoint as jckpt
from cadre_tpu_torch.configs import loader
from cadre_tpu_torch.configs.agent_config import AgentConfig, RolloutConfig
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.envs.fake_env import synthetic_tick
from cadre_tpu_torch.models.policy import PolicyBank
from cadre_tpu_torch.rl import distributions, fused_update, ppo, rollout
from cadre_tpu_torch.rl.agent import CadreAgent, Ensemble
from cadre_tpu_torch.utils import checkpoint as ckpt
from cadre_tpu_torch.utils.convert import policy_from_flax, policy_to_flax
from chip_smoke import _zero_gradient
from test_torch_port_hostenv import SMALL, _random_variables
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_update import (
    _buffer_arrays,
    _jax_buffer,
    _jax_perms,
    _port_buffer,
)
from test_torch_port_utils import CONFIGS

F, C, T, N = 12, 4, 4, 3
OUTPUTS = {"steer": 7, "throttle": 5}
# every option but the default LSTM without the ordinal head
OPTIONS = {
    "transformer": dict(memory="transformer"),
    "none": dict(memory="none"),
    "use_lstm_false": dict(use_lstm=False),
    "lstm_ordinal": dict(ordinal=True),
    "transformer_ordinal": dict(memory="transformer", ordinal=True),
    "none_ordinal": dict(memory="none", ordinal=True),
}
AGENT_OPTIONS = {"default": {}, **OPTIONS}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bank_weights(opts, f, outputs, seed):
    """(JAX bank defs, numpy weights in their init_params layout)."""
    defs = {s: PolicyBankDef(C, a, f, **opts) for s, a in outputs.items()}
    pnp = {s: _random_variables(
        lambda d=d: d.init_params(jax.random.PRNGKey(0)),
        np.random.RandomState(seed + i), ("policy",))
        for i, (s, d) in enumerate(defs.items())}
    return defs, pnp


@functools.lru_cache(maxsize=None)
def _setup(option):
    """The option's defs and weights at F, and its jitted JAX act_batch,
    evaluate_masked and fused update (E=2, M=2, rollouts of T steps of N
    envs over windows of T frames)."""
    defs, pnp = _bank_weights(OPTIONS[option], F, OUTPUTS, 30)
    cfg = jppo.PPOConfig(ppo_epoch=2, num_steps=T, seq_length=T)
    rcfg = JaxRolloutConfig(num_steps=T, mini_batch_num=2, seq_length=T,
                            feature_dims=F)
    return dict(
        defs=defs, pnp=pnp, cfg=cfg,
        act={s: jax.jit(d.act_batch) for s, d in defs.items()},
        evaluate={s: jax.jit(d.evaluate_masked) for s, d in defs.items()},
        update=jax.jit(jfu.make_fused_iteration_update(
            defs["steer"], defs["throttle"], cfg, rcfg)))


def _port_banks(option, pnp, f=F):
    banks = {}
    for s, a in OUTPUTS.items():
        banks[s] = PolicyBank(C, a, f, **OPTIONS[option])
        banks[s].load_state_dict(policy_from_flax(pnp[s]))
    return banks


def _assert_params_moved_alike(banks, pnp, ref_params, steps, lr, ordinal):
    """Every updated tensor of the port within 1% of the largest change
    the JAX update made to it (tests/test_torch_port_update.py's bound),
    but for the elements of chip_smoke's `_zero_gradient` (the attention's
    key biases, the ordinal fc3's first row): both updates move those by
    Adam's normalised rounding noise alone, so each must stay within
    Adam's bound on a step, lr (1 - beta1) / sqrt(1 - beta2) = 3.17 lr."""
    bound = 3.17 * lr * steps
    for s in OUTPUTS:
        before = policy_from_flax(pnp[s])
        after = policy_from_flax(_np(ref_params[s]))
        for k, p in banks[s].state_dict().items():
            zero = _zero_gradient(k, p.shape, ordinal)
            ref_move, our_move = after[k] - before[k], p - before[k]
            if zero.any():
                assert float(ref_move[zero].abs().max()) <= bound, (s, k)
                assert float(our_move[zero].abs().max()) <= bound, (s, k)
            if zero.all():
                continue
            change = float(ref_move[~zero].abs().max())
            assert change > 0, (s, k)
            err = float((p - after[k])[~zero].abs().max())
            assert err <= 0.01 * change, (s, k, err, change)


def test_ordinal_logits_match_jax():
    """The transform (its 1e-8 inside both logs) within 1e-6, on logits
    saturating the sigmoid too."""
    rng = np.random.RandomState(0)
    raw = (6.0 * rng.standard_normal((C, N, 7))).astype(np.float32)
    raw[0, 0, :3] = [30.0, -30.0, 0.0]
    ours = distributions.ordinal_logits(torch.from_numpy(raw)).numpy()
    ref = np.asarray(jdist.ordinal_logits(jnp.asarray(raw)))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_act_batch_and_evaluate_masked_match_jax(option):
    """act_batch's logits, log-probs and values within 1e-5 and its
    actions equal under JAX's Gumbel noise; evaluate_masked's values,
    log-probs and entropies within 1e-5; the carry is the LSTM's (within
    1e-5) or the one given, untouched, and without an LSTM the outputs do
    not depend on it (tests/test_rl_math.py's carry-independence check);
    the masked log-likelihood has a gradient in every bank's head."""
    s = _setup(option)
    rng = np.random.RandomState(1)
    obs = rng.standard_normal((T, N, F)).astype(np.float32)
    commands = np.asarray([0, 1, 3], np.int32)
    carry = tuple(rng.standard_normal((N, F)).astype(np.float32)
                  for _ in range(2))
    banks = _port_banks(option, s["pnp"])
    t_obs, t_cmd = torch.from_numpy(obs), torch.from_numpy(commands)
    t_carry = tuple(map(torch.from_numpy, carry))
    lstm = OPTIONS[option].get("memory", "lstm") == "lstm" and \
        OPTIONS[option].get("use_lstm", True)
    for i, (sig, a) in enumerate(OUTPUTS.items()):
        key = jax.random.PRNGKey(2 + i)
        params = jax.tree.map(jnp.asarray, s["pnp"][sig])
        ref, ref_carry = s["act"][sig](params, jnp.asarray(commands),
                                       jnp.asarray(obs),
                                       tuple(map(jnp.asarray, carry)), key)
        gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (N, a))))
        with torch.no_grad():
            ours, our_carry = banks[sig].act_batch(t_obs, t_cmd, t_carry,
                                                   gumbel)
        np.testing.assert_array_equal(ours.action.numpy(),
                                      np.asarray(ref.action))
        for x, y in ((ours.logits, ref.logits),
                     (ours.log_prob, ref.log_prob), (ours.value, ref.value),
                     (our_carry[0], ref_carry[0]),
                     (our_carry[1], ref_carry[1])):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
        if not lstm:
            assert our_carry[0] is t_carry[0] and our_carry[1] is t_carry[1]
            with torch.no_grad():
                other, _ = banks[sig].act_batch(
                    t_obs, t_cmd, (torch.ones(N, F), torch.ones(N, F)),
                    gumbel)
            np.testing.assert_allclose(other.logits.numpy(),
                                       ours.logits.numpy(), atol=1e-6)
        action = rng.randint(0, a, N)
        refs = s["evaluate"][sig](params, jnp.asarray(obs),
                                  tuple(map(jnp.asarray, carry)),
                                  jnp.asarray(action),
                                  jnp.asarray(commands))
        outs = banks[sig].evaluate_masked(t_obs, t_carry,
                                          torch.from_numpy(action), t_cmd)
        for x, y in zip(outs, refs):
            np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                       atol=1e-5)
        (-outs[1].sum()).backward()
        for name in ("fc1", "fc2", "fc3"):
            grad = banks[sig].control[name].weight.grad
            assert float(grad[0].abs().sum()) > 0, (sig, name)
        if lstm or OPTIONS[option].get("memory") == "transformer":
            assert all(p.grad is not None and float(p.grad.abs().sum()) > 0
                       for p in banks[sig].lstm.parameters()), sig


@pytest.mark.parametrize("option", list(OPTIONS))
def test_fused_update_matches_jax(option):
    """One fused update (E=2, M=2, JAX's permutations injected) from the
    same weights and buffers: loss means within 1e-4 relative, every
    updated tensor within 1% of the largest change the JAX update made to
    it (tests/test_torch_port_update.py's bounds; see
    `_assert_params_moved_alike` for the elements whose gradient is
    zero)."""
    s = _setup(option)
    arrays = {sig: _buffer_arrays(40 + i, a, t=T, n=N, seq=T, f=F)
              for i, (sig, a) in enumerate(OUTPUTS.items())}
    nv = np.random.RandomState(6).standard_normal((2, N)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, s["pnp"])
    key = jax.random.PRNGKey(5)
    ref_params, _, ref_aux = s["update"](
        params, jppo.make_optimizer(s["cfg"]).init(params),
        _jax_buffer(arrays["steer"]), _jax_buffer(arrays["throttle"]),
        (jnp.asarray(nv[0]), jnp.asarray(nv[1])), key)

    banks = _port_banks(option, s["pnp"])
    update = fused_update.make_fused_iteration_update(
        banks["steer"], banks["throttle"], ppo.PPOConfig(ppo_epoch=2),
        RolloutConfig(num_steps=T, mini_batch_num=2, seq_length=T,
                      feature_dims=F))
    params_port = [*banks["steer"].parameters(),
                   *banks["throttle"].parameters()]
    aux = update(ppo.make_optimizer(params_port, ppo.PPOConfig()),
                 _port_buffer(arrays["steer"]),
                 _port_buffer(arrays["throttle"]),
                 (torch.from_numpy(nv[0]), torch.from_numpy(nv[1])),
                 _jax_perms(key, 2, T * N, 2))
    for o, r in zip(aux, ref_aux):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-4)
    _assert_params_moved_alike(banks, s["pnp"], ref_params, 4,
                               ppo.PPOConfig().lr,
                               OPTIONS[option].get("ordinal", False))


def _agent_weights(option):
    """Bank weights at the width of SMALL's agent (latent + 18)."""
    f = jax_danet_params(**SMALL).latent_dim + 18
    return f, _bank_weights(AGENT_OPTIONS[option], f,
                            {"steer": 33, "throttle": 3}, 50)


def _port_agent(option, pnp):
    agent = CadreAgent.create(danet_params(**SMALL), device="cpu",
                              agent_cfg=AgentConfig(**AGENT_OPTIONS[option]))
    for s, bank in agent.banks().items():
        bank.load_state_dict(policy_from_flax(pnp[s]))
    return agent


@pytest.mark.parametrize("option", list(OPTIONS))
def test_msgpack_round_trip_is_byte_equal_to_flax(option, tmp_path):
    """A JAX-layout snapshot of the option's banks (flax's to_bytes) and an
    optax state with random moments, read by the port's agent and written
    back: both files byte for byte flax's, the banks read back exactly,
    policy_to_flax inverting policy_from_flax in flax's key order; two
    such members in an Ensemble act as the agent does."""
    f, (defs, pnp) = _agent_weights(option)
    params = jax.tree.map(jnp.asarray, pnp)
    state = jppo.make_optimizer(jppo.PPOConfig()).init(params)
    rng = np.random.RandomState(9)
    adam = state[1][0]._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params),
        nu=jax.tree.map(lambda p: jnp.asarray(
            rng.uniform(0, 1, p.shape).astype(np.float32)), params))
    state = (state[0], (adam, state[1][1]))
    ref = str(tmp_path / "jax.msgpack")
    jckpt.save_pytree(ref, params)
    jckpt.save_pytree(ref + ".opt", state)

    agent = _port_agent(option, jax.tree.map(np.zeros_like, pnp))
    agent.load_snapshot(ref, agent.opt)
    ours = str(tmp_path / "port.msgpack")
    agent.save_snapshot(ours, agent.opt)
    for suffix in ("", ".opt"):
        with open(ours + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    for s, bank in agent.banks().items():
        back = policy_to_flax(bank.state_dict())
        assert fser.to_bytes(back) == fser.to_bytes(_np(params[s])), s
        assert ("lstm" in back) == (defs[s]._memory_kind != "none")

    ens = Ensemble.load(agent, [ours, ref])
    rng = np.random.RandomState(10)
    hist = torch.from_numpy(rng.standard_normal((8, 2, f)).astype(np.float32))
    cmd = torch.tensor([1, 2])
    hidden = (torch.zeros(2, f), torch.zeros(2, f))
    g_s = torch.from_numpy(rng.gumbel(size=(2, 2, 33)).astype(np.float32))
    g_t = torch.from_numpy(rng.gumbel(size=(2, 2, 3)).astype(np.float32))
    steer, throttle = ens.act(hist, cmd, hidden, g_s, g_t)
    for k in range(2):
        s_out, t_out, _ = agent.act_from_hist(hist, cmd, hidden, g_s[k],
                                              g_t[k])
        assert torch.equal(steer[k], s_out.action)
        assert torch.equal(throttle[k], t_out.action)


@pytest.mark.parametrize("option", ["transformer_ordinal",
                                    "use_lstm_false"])
def test_host_act_paths_take_each_option(option):
    """act, act_vec, act_vec_incremental and act_vec_store (from
    zero_pending, then storing) of an agent with the option: each acts as
    act_from_hist does on the same feature window and noise, and hands
    back its input carry."""
    f, (_, pnp) = _agent_weights(option)
    agent = _port_agent(option, pnp)
    rng = np.random.RandomState(14)
    ticks = [synthetic_tick(rng) for _ in range(3)]

    def batch(ts):
        out = {k: np.stack([t[k] for t in ts])
               for k in ("rgb", "route_fig", "measurements")}
        out["command"] = np.asarray([t["command"] for t in ts])
        return out

    noise = (rng.gumbel(size=(2, 33)).astype(np.float32),
             rng.gumbel(size=(2, 3)).astype(np.float32))
    hidden = (torch.randn(2, f), torch.randn(2, f))
    cmd = torch.from_numpy(batch(ticks[:2])["command"])

    def same(outs, hist, carry=hidden):
        ref = agent.act_from_hist(hist, cmd, carry, *map(torch.from_numpy,
                                                         noise))
        for o, r in zip(outs[:2], ref[:2]):
            assert torch.equal(o.action, r.action)
            assert torch.equal(o.logits, r.logits)
        assert outs[2][0] is carry[0] and outs[2][1] is carry[1]

    feats, s_out, t_out, carry = agent.act_vec(batch(ticks[:2]), hidden,
                                               noise)
    hist = feats.transpose(0, 1)
    same((s_out, t_out, carry), hist)
    out = agent.act_vec_incremental(batch(ticks[1:]), hist, hidden, noise)
    cmd = torch.from_numpy(batch(ticks[1:])["command"])
    same(out, out[3])
    assert torch.equal(out[3][:-1], hist[1:])
    bufs = [rollout.create_rollout(2, 2, 8, f, device="cpu")
            for _ in range(2)]
    pending = agent.zero_pending(2)
    assert pending[6][0].shape == (2, f)
    first = agent.act_vec_store(batch(ticks[1:]), None, hidden, *bufs,
                                pending, False, noise)
    same(first, first[3])
    second = agent.act_vec_store(
        batch(ticks[1:]), first[3], hidden, first[4], first[5],
        (first[0], first[1], cmd, np.ones((2, 2), np.float32),
         np.ones(2, np.float32), np.ones(2, np.float32), hidden), True,
        noise)
    same(second, second[3])
    assert torch.equal(second[4].obs[0], first[3].transpose(0, 1))
    one = agent.act({k: ticks[0][k] for k in ("rgb", "route_fig",
                                              "measurements", "command")},
                    (noise[0][:1], noise[1][:1]))
    ref = agent.act_from_hist(one.features[:, None],
                              torch.tensor([ticks[0]["command"]]),
                              agent.hidden_state,
                              *(torch.from_numpy(n[:1]) for n in noise))
    assert int(one.steer_action) == int(ref[0].action[0])
    assert int(one.throttle_action) == int(ref[1].action[0])
    assert one.hidden[0] is agent.hidden_state[0]


def test_load_experiment_agent_fields_equal_jax(tmp_path):
    """The reference's production config and one with ordinal=True,
    use_lstm=False and vae_params='VAE': every AgentConfig field, and
    obs_dim, equal to the JAX loader's."""
    names = [f.name for f in dataclasses.fields(JaxAgentConfig)]
    assert names == [f.name for f in dataclasses.fields(AgentConfig)]
    path = tmp_path / "options.py"
    path.write_text(
        "agent_cfg = dict(model_cfg=dict(use_lstm=False, ordinal=True, "
        "vae_params='VAE', measurement_dim=18, command_num=4), frame=6, "
        "ent_coeff=0.02, value_coeff=0.5, clip_coeff=2.0, clip=0.2)\n")
    for p in (f"{CONFIGS}/agent_config.py", str(path)):
        ours = loader.load_experiment(p)["agent"]
        ref = jloader.load_experiment(p)["agent"]
        for name in names:
            assert getattr(ours, name) == getattr(ref, name), (p, name)
        assert ours.obs_dim == ref.obs_dim
    assert ours.obs_dim == 256 + 18 and not ours.use_lstm and ours.ordinal


def _jax_agent(option, defs, pnp):
    dcfg = jax_danet_params(**SMALL)
    return JaxAgent(agent_cfg=JaxAgentConfig(**AGENT_OPTIONS[option]),
                    danet_cfg=dcfg, danet=JaxDANet(params_cfg=dcfg),
                    danet_vars=None, steer_def=defs["steer"],
                    throttle_def=defs["throttle"],
                    params=jax.tree.map(jnp.asarray, pnp),
                    ppo_cfg=jppo.PPOConfig())


@pytest.mark.parametrize("option", ["default", "use_lstm_false",
                                    "transformer", "none"])
def test_get_value_raises_where_jax_raises(option):
    """The bootstrap value: the JAX agent's within 1e-5 where it works
    (the LSTM, use_lstm=False); where it fails (use_lstm with memory
    'transformer' or 'none': an AttributeError), the port refuses with a
    ValueError; done gives zeros either way."""
    f, (defs, pnp) = _agent_weights(option)
    jagent = _jax_agent(option, defs, pnp)
    agent = _port_agent(option, pnp)
    rng = np.random.RandomState(11)
    batches = [(rng.standard_normal((8, f)).astype(np.float32), c)
               for c in (2, 1)]
    zeros = agent.get_value(True, *batches)
    assert [float(z) for z in zeros] == [0.0, 0.0]
    if option in ("transformer", "none"):
        with pytest.raises(AttributeError):
            jagent.get_value(False, *batches)
        with pytest.raises(ValueError, match="_bootstrap_value"):
            agent.get_value(False, *batches)
        return
    ours = agent.get_value(False, *batches)
    ref = jagent.get_value(False, *batches)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)


def _reference_snapshot(pnp, with_lstm):
    """A reference ppo_model_<N>.pt dict of the banks' actor-critics, and
    with `with_lstm` of LSTMs of their width."""
    out = {}
    rng = np.random.RandomState(12)
    for signal in ("steer", "throttle"):
        sd = policy_from_flax(pnp[signal])
        f = sd["critic_fc1.weight"].shape[-1]
        for k in range(C):
            ac = {}
            for i, name in enumerate(("fc1", "fc2", "fc3")):
                ac[f"control.linear.{2 * i}.weight"] = \
                    sd[f"control.{name}.weight"][k] + 1.0
                ac[f"control.linear.{2 * i}.bias"] = \
                    sd[f"control.{name}.bias"][k]
                ac[f"critic.{2 * i}.weight"] = \
                    sd[f"critic_fc{i + 1}.weight"][k]
                ac[f"critic.{2 * i}.bias"] = sd[f"critic_fc{i + 1}.bias"][k]
            out[f"{signal}_ppo_{k}"] = ac
            if with_lstm:
                out[f"{signal}_lstm_{k}"] = {
                    f"rnn.{n}": torch.from_numpy(rng.standard_normal(
                        shape).astype(np.float32)) for n, shape in
                    (("weight_ih", (4 * f, f)), ("weight_hh", (4 * f, f)),
                     ("bias_ih", (4 * f,)), ("bias_hh", (4 * f,)))}
    return out


@pytest.mark.parametrize("option", ["transformer", "none"])
@pytest.mark.parametrize("with_lstm", [True, False])
def test_reference_pt_import_fails_where_jax_fails(option, with_lstm):
    """A reference snapshot into banks without an LSTM: with its LSTM
    entries both importers raise a KeyError (the JAX importer assigns
    them into the bank's 'rnn', which these banks lack); without them
    both give the same banks, the memory kept as it was."""
    _, (_, pnp) = _agent_weights(option)
    snap = _reference_snapshot(pnp, with_lstm)
    jparams = {s: jax.tree.map(jnp.asarray, pnp[s]) for s in pnp}
    if with_lstm:
        with pytest.raises(KeyError):
            jckpt.import_policy_torch(snap, jparams["steer"],
                                      jparams["throttle"], C)
        with pytest.raises(KeyError):
            ckpt.import_policy_torch(snap, pnp["steer"], pnp["throttle"], C)
        return
    ours, missing = ckpt.import_policy_torch(snap, pnp["steer"],
                                             pnp["throttle"], C)
    ref, ref_missing = jckpt.import_policy_torch(
        snap, jparams["steer"], jparams["throttle"], C)
    assert missing == ref_missing
    assert fser.to_bytes(ours) == fser.to_bytes(_np(ref))
