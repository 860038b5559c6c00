"""The port's PPO update and whole device iteration against the JAX
package, on the CPU.

Every input is made with numpy from a seed (buffers at f=12, t=6, n=4,
seq=3, as tests/test_fused_update.py uses) and handed to both packages;
flax bank weights enter the port through utils.convert.policy_from_flax,
which also carries gradients and updated weights back for comparison. The
JAX side runs cadre_tpu's functions as they are. Tolerances are stated per
test.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cadre_tpu.configs.agent_config import RolloutConfig as JaxRolloutConfig
from cadre_tpu.models.policy import PolicyBankDef
from cadre_tpu.rl import fused_update as jfu
from cadre_tpu.rl import ppo as jppo
from cadre_tpu.rl import rollout as jro
from cadre_tpu_torch.configs.agent_config import RolloutConfig, TrainConfig
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.envs import torch_env
from cadre_tpu_torch.models import policy
from cadre_tpu_torch.models.policy import PolicyBank
from cadre_tpu_torch.rl import fused_update, ppo, rollout
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.device_rollout import (
    make_device_iteration,
    train_device,
)
from cadre_tpu_torch.rl.distributions import (
    categorical_entropy,
    categorical_log_prob,
)
from cadre_tpu_torch.utils.convert import policy_from_flax
from test_torch_port_slice import (
    SMALL,
    _np,
    _perturb,
    _rel_close,
    few_torch_threads,  # noqa: F401 (autouse fixture)
    port_agent_and_carry,
    three_step_reference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, T, N, SEQ = 12, 6, 4, 3
OUTPUTS = {"steer": 5, "throttle": 3}


def _buffer_arrays(seed, n_out, t=T, n=N, seq=SEQ, f=F):
    """[t+1, n, ...] numpy rollout fields, slot t zero padding; some masks
    are 0 (ended episodes) and the stored LSTM carry is not zero."""
    rng = np.random.RandomState(seed)
    fields = dict(
        obs=rng.standard_normal((t, n, seq, f)),
        action=rng.randint(0, n_out, (t, n)),
        log_prob=-np.abs(rng.standard_normal((t, n))) - 0.5,
        value=0.1 * rng.standard_normal((t, n)),
        reward=rng.standard_normal((t, n)),
        mask=(rng.rand(t, n) > 0.25).astype(np.float64),
        command=rng.randint(0, 4, (t, n)),
        hn=0.5 * rng.standard_normal((t, n, f)),
        cn=0.5 * rng.standard_normal((t, n, f)))
    out = {}
    for k, v in fields.items():
        v = np.concatenate([v, np.zeros_like(v[:1])])
        out[k] = v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
    return out


def _jax_buffer(a):
    return jro.BatchedRollout(**{k: jnp.asarray(v) for k, v in a.items()},
                              step=jnp.zeros((), jnp.int32))


def _port_buffer(a):
    return rollout.RolloutBuffer(**{
        k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                            else v) for k, v in a.items()})


@functools.lru_cache(maxsize=None)
def _bank_weights():
    defs = {s: PolicyBankDef(4, a, F) for s, a in OUTPUTS.items()}
    pnp = {s: _perturb(_np(jax.jit(d.init_params)(jax.random.PRNGKey(i))),
                       np.random.RandomState(10 + i))
           for i, (s, d) in enumerate(defs.items())}
    return defs, pnp


def _banks():
    """JAX bank defs, perturbed numpy weights and the port's banks with
    the same weights."""
    defs, pnp = _bank_weights()
    banks = {}
    for s, a in OUTPUTS.items():
        banks[s] = PolicyBank(4, a, F)
        banks[s].load_state_dict(policy_from_flax(pnp[s]))
    return defs, pnp, banks


def _params(banks):
    return [*banks["steer"].parameters(), *banks["throttle"].parameters()]


def _named(banks):
    return {(s, k): p for s in OUTPUTS
            for k, p in banks[s].named_parameters()}


def _assert_params_moved_alike(banks, pnp, ref_params, share):
    """Every updated tensor of the port within `share` of the largest
    change the JAX update made to that tensor."""
    for s in OUTPUTS:
        before = policy_from_flax(pnp[s])
        after = policy_from_flax(_np(ref_params[s]))
        for k, p in banks[s].state_dict().items():
            change = float((after[k] - before[k]).abs().max())
            assert change > 0, (s, k)
            err = float((p - after[k]).abs().max())
            assert err <= share * change, (s, k, err, change)


# ---------------------------------------------------------------- pieces

def test_gae_and_normalisation_match_jax():
    """GAE returns and advantages (some masks 0) within 1e-5 of their
    scale; the normalised advantages within 1e-6."""
    a = _buffer_arrays(0, 5)
    nv = np.random.RandomState(1).standard_normal(N).astype(np.float32)
    ref_ret, ref_adv = jro.batched_returns(_jax_buffer(a), jnp.asarray(nv),
                                           0.99, 0.95)
    ret, adv = rollout.batched_returns(_port_buffer(a), torch.from_numpy(nv),
                                       0.99, 0.95)
    assert float((torch.from_numpy(a["mask"]) == 0).sum()) > 0
    _rel_close(ret.numpy(), ref_ret, 1e-5)
    _rel_close(adv.numpy(), ref_adv, 1e-5)
    np.testing.assert_allclose(
        rollout.normalize_advantages(torch.from_numpy(np.array(ref_adv)))
        .numpy(), np.asarray(jro.normalize_advantages(ref_adv)), atol=1e-6)


def test_gather_minibatch_equals_jax():
    """The same flat row indices select the same rows, bit for bit."""
    a = _buffer_arrays(2, 3)
    rng = np.random.RandomState(3)
    ret = rng.standard_normal((T, N)).astype(np.float32)
    adv = rng.standard_normal((T, N)).astype(np.float32)
    idx = rng.permutation(T * N)[:9]
    ref = jro.gather_minibatch_batched(_jax_buffer(a), jnp.asarray(ret),
                                       jnp.asarray(adv), jnp.asarray(idx))
    mb = rollout.gather_minibatch_batched(
        _port_buffer(a), torch.from_numpy(ret), torch.from_numpy(adv),
        torch.from_numpy(idx))
    assert mb.obs_seq.shape == (SEQ, 9, F)
    for name in rollout.Minibatch._fields:
        ours, theirs = getattr(mb, name), getattr(ref, name)
        pairs = zip(ours, theirs) if name == "hidden" else [(ours, theirs)]
        for o, r in pairs:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                          err_msg=name)


def _minibatches(seed, rows=12):
    """(JAX, port) steer and throttle minibatches of `rows` rows."""
    rng = np.random.RandomState(seed)
    out = {"jax": {}, "port": {}}
    for i, (s, a) in enumerate(OUTPUTS.items()):
        arrays = _buffer_arrays(seed + i, a)
        ret = rng.standard_normal((T, N)).astype(np.float32)
        adv = rng.standard_normal((T, N)).astype(np.float32)
        idx = rng.permutation(T * N)[:rows]
        out["jax"][s] = jro.gather_minibatch_batched(
            _jax_buffer(arrays), jnp.asarray(ret), jnp.asarray(adv),
            jnp.asarray(idx))
        out["port"][s] = rollout.gather_minibatch_batched(
            _port_buffer(arrays), torch.from_numpy(ret),
            torch.from_numpy(adv), torch.from_numpy(idx))
    return out


def test_evaluate_masked_matches_jax():
    """Values, log-probs and entropies of each sample's own bank within
    1e-5, over a minibatch that holds every command."""
    defs, pnp, banks = _banks()
    mbs = _minibatches(4, rows=T * N)
    for s in OUTPUTS:
        mb, jmb = mbs["port"][s], mbs["jax"][s]
        assert set(mb.command.tolist()) == {0, 1, 2, 3}
        ref = jax.jit(defs[s].evaluate_masked)(
            jax.tree.map(jnp.asarray, pnp[s]), jmb.obs_seq, jmb.hidden,
            jmb.action, jmb.command)
        with torch.no_grad():
            ours = banks[s].evaluate_masked(mb.obs_seq, mb.hidden, mb.action,
                                            mb.command)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def _dense_masked(bank, obs_seq, carry, action, commands):
    """The one-hot formula evaluate_masked routes around: every bank on
    every sample, each sample's own bank's terms kept by a mask summed
    over banks."""
    logits_c, values_c, _ = bank(obs_seq, carry)
    lps = categorical_log_prob(logits_c, action.expand(logits_c.shape[:2]))
    ents = categorical_entropy(logits_c)
    onehot = torch.nn.functional.one_hot(
        commands, logits_c.shape[0]).to(values_c.dtype).T
    return ((values_c * onehot).sum(0), (lps * onehot).sum(0),
            (ents * onehot).sum(0))


@pytest.mark.parametrize("commands", ["mixed_one_empty", "one_bank"])
@pytest.mark.parametrize("ordinal", [False, True])
@pytest.mark.parametrize("memory", ["lstm", "transformer", "none"])
def test_routed_evaluate_masked_matches_the_dense_mask(memory, ordinal,
                                                       commands):
    """Each sample through its own bank alone against the dense one-hot
    formula: values, log-probs, entropies and every parameter's gradient
    (of a random weighting of the three) within f32 rounding, both when
    evaluate_masked groups the samples itself and when they come grouped
    with their counts. A bank no sample uses gets an exact zero gradient
    of its parameter's shape."""
    torch.manual_seed(11)
    b, seq, f = 23, 4, 16
    bank = PolicyBank(4, 5, f, memory=memory, ordinal=ordinal)
    obs = torch.randn(seq, b, f)
    carry = (0.5 * torch.randn(b, f), 0.5 * torch.randn(b, f))
    action = torch.randint(0, 5, (b,))
    if commands == "one_bank":
        cmd = torch.full((b,), 2, dtype=torch.long)
    else:
        cmd = torch.tensor([3, 0, 3, 3, 1] * 5)[:b]          # bank 2 empty
    weights = torch.randn(3, b)
    params = dict(bank.named_parameters())

    def terms_and_grads(fn, *args, order=slice(None)):
        out = fn(*args)
        loss = sum((w[order] * t).sum() for w, t in zip(weights, out))
        return out, dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    ref, ref_g = terms_and_grads(_dense_masked, bank, obs, carry, action,
                                 cmd)
    order = torch.sort(cmd, stable=True).indices
    rows = torch.bincount(cmd, minlength=4).tolist()
    grouped = (obs[:, order], (carry[0][order], carry[1][order]),
               action[order], cmd[order])
    routed = [terms_and_grads(bank.evaluate_masked, obs, carry, action, cmd)]
    out, g = terms_and_grads(bank.evaluate_masked, *grouped, rows,
                             order=order)
    routed.append((tuple(t[torch.argsort(order)] for t in out), g))
    empty = [c for c in range(4) if rows[c] == 0]
    assert empty
    # the attention key biases' gradient is zero but for rounding: their
    # bound takes a floor from the largest gradient
    floor = 1e-7 * max(float(r.abs().max()) for r in ref_g.values())
    for out, grads in routed:
        for o, r in zip(out, ref):
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-5)
        for k, r in ref_g.items():
            assert grads[k].shape == params[k].shape, k
            bound = 1e-5 * float(r.abs().max()) + floor
            assert float((grads[k] - r).abs().max()) <= bound, k
            for c in empty:
                assert torch.equal(grads[k][c], torch.zeros_like(r[c])), k


def _bank_rows_of(minibatches):
    """Rows per bank of recorded minibatches' commands, summed."""
    return torch.stack([torch.bincount(c, minlength=4)
                        for c in minibatches]).sum(0).tolist()


def test_fused_update_reads_bank_rows_once(monkeypatch):
    """The fused update's per-bank rows equal the bincount of the commands
    of the minibatches it gathered and add up to E x M x B per signal;
    they are read from the device once per update, whatever the number
    of minibatch steps, and evaluate_masked reads nothing more."""
    _, _, banks = _banks()
    arrays = {s: _buffer_arrays(40 + i, a)
              for i, (s, a) in enumerate(OUTPUTS.items())}
    for a in arrays.values():
        a["command"][:T] = np.minimum(a["command"][:T], 2)   # bank 3 empty
    reads, gathered = [], []
    read = policy.read_bank_rows
    gather = fused_update.gather_minibatch_batched

    def counted(counts):
        reads.append(counts.shape)
        return read(counts)

    def recorded(buf, ret, adv, idx):
        mb = gather(buf, ret, adv, idx)
        gathered.append(mb.command)
        return mb

    monkeypatch.setattr(policy, "read_bank_rows", counted)
    monkeypatch.setattr(fused_update, "read_bank_rows", counted)
    monkeypatch.setattr(fused_update, "gather_minibatch_batched", recorded)
    update = fused_update.make_fused_iteration_update(
        banks["steer"], banks["throttle"], ppo.PPOConfig(ppo_epoch=2),
        RolloutConfig(num_steps=T, mini_batch_num=3, seq_length=SEQ,
                      feature_dims=F), seed=2)
    opt = ppo.make_optimizer(_params(banks), ppo.PPOConfig())
    eff_mb, b = fused_update.minibatch_layout(T * N, 3)
    for call in (1, 2):
        gathered.clear()
        update(opt, _port_buffer(arrays["steer"]),
               _port_buffer(arrays["throttle"]),
               (torch.zeros(N), torch.zeros(N)))
        assert reads == [(2 * eff_mb, 2, 4)] * call
        want = [_bank_rows_of(gathered[0::2]), _bank_rows_of(gathered[1::2])]
        assert update.bank_rows == want
        for rows in update.bank_rows:
            assert sum(rows) == 2 * eff_mb * b and rows[3] == 0


def test_ppo_loss_and_gradients_match_jax():
    """The total loss and LossAux within 1e-5 relative; the gradient of
    every parameter of both banks (jax.grad against autograd) within 1e-4
    of that tensor's largest |grad|."""
    defs, pnp, banks = _banks()
    mbs = _minibatches(6)
    cfg = jppo.PPOConfig()
    (ref_total, ref_aux), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, smb, tmb: jppo.ppo_loss(p, defs["steer"], defs["throttle"],
                                          smb, tmb, cfg), has_aux=True))(
        jax.tree.map(jnp.asarray, pnp), mbs["jax"]["steer"],
        mbs["jax"]["throttle"])
    total, aux = ppo.ppo_loss(banks["steer"], banks["throttle"],
                              mbs["port"]["steer"], mbs["port"]["throttle"],
                              ppo.PPOConfig())
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    for o, r in zip(aux, ref_aux):
        np.testing.assert_allclose(o.item(), float(r), rtol=1e-5)
    named = _named(banks)
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    for s in OUTPUTS:
        for k, g in policy_from_flax(_np(ref_grads[s])).items():
            scale = float(g.abs().max())
            assert scale > 0, (s, k)
            err = float((grads[s, k] - g).abs().max())
            assert err <= 1e-4 * scale, (s, k, err, scale)


@pytest.mark.parametrize("norm", [10.0, 1000.0])
def test_clip_and_adam_step_match_optax(norm):
    """One global-norm clip (250) + Adam step from identical gradients
    whose global norm is below the limit (10) and above it (1000): the
    clipped gradients within 1e-6 relative of optax's, the parameters
    within 1e-6."""
    defs, pnp, banks = _banks()
    rng = np.random.RandomState(7)
    gnp = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                       .astype(np.float32), pnp)
    scale = norm / np.sqrt(sum(float((x * x).sum())
                               for x in jax.tree_util.tree_leaves(gnp)))
    gnp = jax.tree.map(lambda x: (x * scale).astype(np.float32), gnp)
    cfg = jppo.PPOConfig()
    opt = jppo.make_optimizer(cfg)
    params = jax.tree.map(jnp.asarray, pnp)

    @jax.jit
    def step(params, grads):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    ref = step(params, jax.tree.map(jnp.asarray, gnp))

    clipped, _ = optax.clip_by_global_norm(cfg.max_grad_norm).update(
        jax.tree.map(jnp.asarray, gnp), None)
    named = _named(banks)
    grads = [policy_from_flax(gnp[s])[k].clone() for s, k in named]
    got = ppo.clip_by_global_norm_(grads, cfg.max_grad_norm)
    np.testing.assert_allclose(float(got), norm, rtol=1e-5)
    ref_grads = {s: policy_from_flax(_np(clipped[s])) for s in OUTPUTS}
    for (s, k), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[s][k].numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)
    topt = ppo.make_optimizer(list(named.values()), ppo.PPOConfig())
    for p, g in zip(named.values(), grads):
        p.grad = g
    topt.step()
    for s in OUTPUTS:
        for k, r in policy_from_flax(_np(ref[s])).items():
            np.testing.assert_allclose(named[s, k].detach().numpy(),
                                       r.numpy(), atol=1e-6, err_msg=k)


def _jax_perms(key, epochs, total_rows, mini_batch_num):
    """The permutations make_fused_iteration_update draws from `key`."""
    eff_mb, mb_size = fused_update.minibatch_layout(total_rows,
                                                    mini_batch_num)

    def make_perms(k):
        keys = jax.random.split(k, epochs)
        perms = jax.vmap(lambda kk: jax.random.permutation(kk, total_rows))(
            keys)
        return perms[:, :mb_size * eff_mb].reshape(epochs * eff_mb, mb_size)

    rs, rt = jax.random.split(key)
    return tuple(torch.from_numpy(np.asarray(make_perms(k)).astype(np.int64))
                 for k in (rs, rt))


def test_fused_update_matches_jax():
    """One whole fused update, E=2 and M=2, from identical weights and
    buffers, the JAX permutations injected into the port: LossAux means
    within 1e-4 relative, every updated tensor within 1% of the largest
    change the JAX update made to it."""
    defs, pnp, banks = _banks()
    arrays = {s: _buffer_arrays(20 + i, a)
              for i, (s, a) in enumerate(OUTPUTS.items())}
    # command 0 in one row only: its bank sits out some minibatches, where
    # Adam must still move it on its moments
    for a in arrays.values():
        a["command"][:T] = np.maximum(a["command"][:T], 1)
        a["command"][2, 1] = 0
    nv = np.random.RandomState(5).standard_normal((2, N)).astype(np.float32)
    cfg = jppo.PPOConfig(ppo_epoch=2, num_steps=T, seq_length=SEQ)
    rcfg = JaxRolloutConfig(num_steps=T, mini_batch_num=2, seq_length=SEQ,
                            feature_dims=F)
    params = jax.tree.map(jnp.asarray, pnp)
    key = jax.random.PRNGKey(4)
    ref_params, _, ref_aux = jfu.make_fused_iteration_update(
        defs["steer"], defs["throttle"], cfg, rcfg)(
        params, jppo.make_optimizer(cfg).init(params),
        _jax_buffer(arrays["steer"]), _jax_buffer(arrays["throttle"]),
        (jnp.asarray(nv[0]), jnp.asarray(nv[1])), key)

    update = fused_update.make_fused_iteration_update(
        banks["steer"], banks["throttle"], ppo.PPOConfig(ppo_epoch=2),
        RolloutConfig(num_steps=T, mini_batch_num=2, seq_length=SEQ,
                      feature_dims=F))
    perms = _jax_perms(key, 2, T * N, 2)
    assert perms[0].shape == (4, T * N // 2)
    aux = update(ppo.make_optimizer(_params(banks), ppo.PPOConfig()),
                 _port_buffer(arrays["steer"]),
                 _port_buffer(arrays["throttle"]),
                 (torch.from_numpy(nv[0]), torch.from_numpy(nv[1])), perms)
    for o, r in zip(aux, ref_aux):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-4)
    _assert_params_moved_alike(banks, pnp, ref_params, 0.01)


def test_fused_update_draws_its_own_permutations():
    """Without injected permutations: E*M minibatches of B rows from a
    seeded generator, the same seed giving the same update."""
    _, _, banks = _banks()
    arrays = {s: _buffer_arrays(30 + i, a)
              for i, (s, a) in enumerate(OUTPUTS.items())}
    eff_mb, b = fused_update.minibatch_layout(T * N, 3)
    perms = fused_update.make_perms(2, T * N, 3, torch.Generator(), "cpu")
    assert perms.shape == (2 * eff_mb, b) and b == T * N // 3
    assert all(len(set(row)) == b for row in perms.tolist())
    state = {k: v.clone() for k, v in _named(banks).items()}
    after = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in _named(banks).items():
                p.copy_(state[k])
        update = fused_update.make_fused_iteration_update(
            banks["steer"], banks["throttle"], ppo.PPOConfig(ppo_epoch=2),
            RolloutConfig(num_steps=T, mini_batch_num=3, seq_length=SEQ,
                          feature_dims=F), seed=9)
        aux = update(ppo.make_optimizer(_params(banks), ppo.PPOConfig()),
                     _port_buffer(arrays["steer"]),
                     _port_buffer(arrays["throttle"]),
                     (torch.zeros(N), torch.zeros(N)))
        assert all(bool(torch.isfinite(x)) for x in aux)
        after.append([p.detach().clone() for p in _params(banks)])
    for a, b in zip(*after):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- iteration

def test_iteration_matches_jax():
    """The three reference steps of the acting slice, their JAX buffers
    and bootstrap built as cadre_tpu.rl.device_rollout does, then the
    jitted JAX fused update (E=2, M=2) on them, against the port's
    make_device_iteration given the same draws and permutations. Updated
    tensors within 1% of the largest JAX change; losses within 1e-3
    relative, since the features carry 1e-4."""
    n, t_steps = 2, 3
    r = three_step_reference(n, t_steps)
    jagent = r["jagent"]
    f = jagent.obs_dim

    def buf(get, mask_col):
        def stack(xs):
            x = jnp.stack([jnp.asarray(v) for v in xs])
            return jnp.concatenate([x, jnp.zeros_like(x[:1])])

        ref = r["ref"]
        return jro.BatchedRollout(
            obs=stack([h for h, *_ in ref]),
            action=stack([get(o).action for o in ref]),
            log_prob=stack([get(o).log_prob for o in ref]),
            value=stack([get(o).value for o in ref]),
            reward=stack([o[3].rewards[:, mask_col] for o in ref]),
            mask=stack([1.0 - o[3].action_done[:, mask_col]
                        .astype(jnp.float32) for o in ref]),
            command=stack(r["commands"]),
            hn=stack([jnp.zeros((n, f))] * t_steps),
            cn=stack([jnp.zeros((n, f))] * t_steps),
            step=jnp.zeros((), jnp.int32))

    steer_buf, throttle_buf = buf(lambda o: o[1], 0), buf(lambda o: o[2], 1)
    obs, done_prev = r["obs"], r["done_prev"]
    feats = r["encode"](obs)
    fh = jnp.where(done_prev[None, :, None],
                   jnp.broadcast_to(feats[None], r["feat_hist"].shape),
                   jnp.concatenate([r["feat_hist"][1:], feats[None]]))
    zeros = (jnp.zeros((n, f)), jnp.zeros((n, f)))
    s_out, t_out, _ = r["act"](r["jparams"], fh, obs["command"], zeros,
                               jax.random.PRNGKey(200))
    live = 1.0 - done_prev.astype(jnp.float32)
    cfg = dataclasses.replace(jagent.ppo_cfg, ppo_epoch=2)
    rcfg = JaxRolloutConfig(num_steps=t_steps, seq_length=8, feature_dims=f)
    key = jax.random.PRNGKey(300)
    params = r["jparams"]
    ref_params, _, ref_aux = jfu.make_fused_iteration_update(
        jagent.steer_def, jagent.throttle_def, cfg, rcfg)(
        params, jppo.make_optimizer(cfg).init(params), steer_buf,
        throttle_buf, (s_out.value * live, t_out.value * live), key)

    agent, iteration, carry = port_agent_and_carry(
        r, RolloutConfig(num_steps=t_steps), make=make_device_iteration,
        train_cfg=TrainConfig(ppo_epoch=2))
    opt = ppo.make_optimizer(agent.policy_parameters(), agent.ppo_cfg)
    carry, m = iteration(opt, carry, draws=r["draws"],
                         perms=_jax_perms(key, 2, t_steps * n, 2))
    for o, ref in ((m.value_loss, ref_aux.value_loss),
                   (m.policy_loss, ref_aux.action_loss),
                   (m.entropy_loss, ref_aux.entropy_loss)):
        np.testing.assert_allclose(float(o), float(ref), rtol=1e-3)
    banks = {"steer": agent.steer, "throttle": agent.throttle}
    _assert_params_moved_alike(banks, r["pnp"], ref_params, 0.01)
    assert float(m.episodes_done) >= 1.0


# ---------------------------------------------------------------- port only

def _small_setup(seed=3):
    agent = CadreAgent.create(danet_params(**SMALL), seed=seed, device="cpu")
    env = torch_env.DrivingEnv(
        torch_env.make_route_bank(3, seed=0, device="cpu"), 2, seed=4,
        device="cpu")
    return agent, env


def test_train_device_two_iterations(tmp_path):
    """Two iterations of train_device (small encoder, 2 envs, T=4): finite
    metrics, parameters moved, the same seeds give the same checksums;
    the carry advances from one iteration to the next; a snapshot with
    the optimizer restores both."""
    runs = []
    for _ in range(2):
        agent, env = _small_setup()
        before = [p.detach().clone() for p in agent.policy_parameters()]
        rows = train_device(agent, env, iterations=2,
                            rollout_cfg=RolloutConfig(num_steps=4),
                            train_cfg=TrainConfig(ppo_epoch=2), seed=5,
                            log_fn=None)
        runs.append([row["checksum"] for row in rows])
        assert len(rows) == 2
        for row in rows:
            assert all(np.isfinite(v) for v in row.values()), row
            assert row["rollout_seconds"] > 0 and row["update_seconds"] > 0
        assert all(bool(torch.isfinite(p).all())
                   for p in agent.policy_parameters())
        assert any(not torch.equal(a, b) for a, b in
                   zip(before, agent.policy_parameters()))
    assert runs[0] == runs[1]

    path = str(tmp_path / "snap.pt")
    agent.save_snapshot(path, agent.opt)
    fresh, _ = _small_setup(seed=8)
    fresh_opt = ppo.make_optimizer(fresh.policy_parameters(), fresh.ppo_cfg)
    fresh.load_snapshot(path, fresh_opt)
    for a, b in zip(fresh.policy_parameters(), agent.policy_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fresh_opt.state_dict()["state"][0]["step"] == 8.0

    agent, env = _small_setup()
    iteration, init_carry = make_device_iteration(
        agent, env, RolloutConfig(num_steps=2), TrainConfig(ppo_epoch=1))
    opt = agent.opt
    carry = init_carry()
    steps = [carry.env_state.step.clone()]
    for _ in range(2):
        carry, _ = iteration(opt, carry)
        steps.append(carry.env_state.step.clone())
    assert not torch.equal(steps[0], steps[1])
    assert not torch.equal(steps[1], steps[2])


def test_iteration_reports_update_bank_rows(monkeypatch):
    """IterationMetrics.update_bank_rows: the rows each bank had over the
    update's minibatch steps, per signal, as gathered; the device env
    gives every env command 3, so bank 3 has all E x M x B rows."""
    gathered = []
    gather = fused_update.gather_minibatch_batched

    def recorded(buf, ret, adv, idx):
        mb = gather(buf, ret, adv, idx)
        gathered.append(mb.command)
        return mb

    monkeypatch.setattr(fused_update, "gather_minibatch_batched", recorded)
    agent, env = _small_setup()
    rollout_cfg = RolloutConfig(num_steps=4)
    iteration, init_carry = make_device_iteration(
        agent, env, rollout_cfg, TrainConfig(ppo_epoch=2))
    _, m = iteration(agent.opt, init_carry())
    eff_mb, b = fused_update.minibatch_layout(4 * env.num_envs,
                                              rollout_cfg.mini_batch_num)
    rows = 2 * eff_mb * b
    assert m.update_bank_rows == [_bank_rows_of(gathered[0::2]),
                                  _bank_rows_of(gathered[1::2])]
    assert m.update_bank_rows == [[0, 0, 0, rows]] * 2


def test_cli_trains_and_saves_a_snapshot(tmp_path):
    """`python -m cadre_tpu_torch.main --env jax --small ... --device cpu`
    trains one iteration and saves a snapshot that load_snapshot reads
    back equal."""
    out = subprocess.run(
        [sys.executable, "-m", "cadre_tpu_torch.main", "--env", "jax",
         "--small", "--num-envs", "2", "--num-steps", "4", "--iterations",
         "1", "--device", "cpu", "--work-dir", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    path = tmp_path / "models" / "ppo_model_1.pt"
    assert path.exists()
    agent = CadreAgent.create(
        danet_params(da_feature_channel=64, inter_att_dims=48, z_dims=32),
        seed=1, device="cpu")
    agent.load_snapshot(str(path))
    saved = torch.load(path, weights_only=True)
    for name, bank in (("steer", agent.steer), ("throttle", agent.throttle)):
        for k, v in bank.state_dict().items():
            torch.testing.assert_close(v, saved[name][k], rtol=0, atol=0)


@pytest.mark.parametrize("flag", ["--env=carla", "--town=Town01"])
def test_cli_unported_flag_raises(flag, tmp_path, monkeypatch):
    """The CARLA env's flags of the JAX CLI are ported: `--town` is
    accepted, and without a `carla` package `--env carla` raises the
    ModuleNotFoundError naming it instead of training another env."""
    from cadre_tpu_torch import main

    monkeypatch.setitem(sys.modules, "carla", None)
    assert main.parse_args(["--env", "jax", flag]).town == "Town01"
    carla = [flag] if flag == "--env=carla" else [flag, "--env=carla"]
    with pytest.raises(ModuleNotFoundError, match="carla") as err:
        main.main(["--env", "jax", "--small", "--device", "cpu",
                   "--work-dir", str(tmp_path), *carla])
    assert err.value.name == "carla"


def test_cli_without_gpu_raises():
    """The CLI's default device is the GPU: without one it raises and
    does not carry on on the CPU."""
    from cadre_tpu_torch import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main.main(["--env", "jax", "--small", "--iterations", "1"])
