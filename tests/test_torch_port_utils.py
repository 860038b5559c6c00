"""The port's checkpoint and config utilities against the JAX package, on
the CPU: flax's msgpack format (utils/msgpack.py), the importers of
reference-format state_dicts (utils/checkpoint.py), JAX-format policy
snapshots with their optax state (rl/agent.py), Config.fromfile and
load_experiment, `main --config`, and the watchdog.

Trees are made with numpy from seeds (flax's initializers are traced by
jax.eval_shape, not run) and handed to both packages. Tolerances are
stated per test.
"""
import inspect
import json
import os
import time

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadre_tpu.configs import loader as jloader
from cadre_tpu.configs.agent_config import AgentConfig as JaxAgentConfig
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.models.danet import create_danet
from cadre_tpu.models.policy import PolicyBankDef
from cadre_tpu.rl import rollout as jro
from cadre_tpu.rl.agent import CadreAgent as JaxAgent
from cadre_tpu.rl.agent import EnsembleAgent as JaxEnsembleAgent
from cadre_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from cadre_tpu.rl.ppo import make_optimizer as jax_make_optimizer
from cadre_tpu.utils import checkpoint as jckpt
from cadre_tpu.utils import config as jconfig
from cadre_tpu.utils import watchdog as jwatchdog
from cadre_tpu_torch.configs import loader
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.models.danet import DANet
from cadre_tpu_torch.rl import rollout
from cadre_tpu_torch.rl.agent import Ensemble, EnsembleAgent, snapshot_banks
from cadre_tpu_torch.utils import checkpoint as ckpt
from cadre_tpu_torch.utils import config
from cadre_tpu_torch.utils import msgpack
from cadre_tpu_torch.utils.convert import (
    danet_from_flax,
    policy_from_flax,
    policy_to_flax,
)
from cadre_tpu_torch.utils.watchdog import Watchdog
from test_torch_port_hostenv import (
    SMALL,
    STEER_BINS,
    THROTTLE_BINS,
    _gumbel,
    _port_agent,
    _random_variables,
)
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "config_files")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """(DANet variables, {steer, throttle} bank weights) of the CLI's
    small encoder and its banks, drawn with numpy."""
    dcfg = jax_danet_params(**SMALL)
    f = dcfg.latent_dim + JaxAgentConfig().measurement_dim
    key = jax.random.PRNGKey(0)
    vnp = _random_variables(lambda: create_danet(dcfg, key)[1],
                            np.random.RandomState(0))
    defs = {"steer": PolicyBankDef(4, STEER_BINS, f),
            "throttle": PolicyBankDef(4, THROTTLE_BINS, f)}
    pnp = {s: _random_variables(lambda d=d: d.init_params(key),
                                np.random.RandomState(i + 1), ("policy",))
           for i, (s, d) in enumerate(defs.items())}
    return vnp, pnp, defs


def _jax_agent(weights, pnp=None):
    vnp, pnp0, defs = weights
    dcfg = jax_danet_params(**SMALL)
    return JaxAgent(agent_cfg=JaxAgentConfig(), danet_cfg=dcfg,
                    danet=JaxDANet(params_cfg=dcfg),
                    danet_vars=jax.tree.map(jnp.asarray, vnp),
                    steer_def=defs["steer"], throttle_def=defs["throttle"],
                    params=jax.tree.map(jnp.asarray, pnp or pnp0),
                    ppo_cfg=JaxPPOConfig())


def _adam_state(weights):
    """The JAX agent's optax state as an update leaves it: count 1 and
    random moments."""
    _, pnp, _ = weights
    params = jax.tree.map(jnp.asarray, pnp)
    state = jax_make_optimizer(JaxPPOConfig()).init(params)
    rng = np.random.RandomState(7)

    def moments():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)

    adam = state[1][0]._replace(count=jnp.asarray(1, jnp.int32),
                                mu=moments(), nu=moments())
    return (state[0], (adam, state[1][1]))


def _dtype_tree():
    rng = np.random.RandomState(3)
    return {
        "f16": rng.standard_normal((3, 5)).astype(np.float16),
        "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "f64": rng.standard_normal(300).astype(np.float64),
        "i8": rng.randint(-128, 127, 40).astype(np.int8),
        "i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (4, 4)).astype(np.int32),
        "i64": np.arange(70000, 70100, dtype=np.int64),
        "u8": rng.randint(0, 255, (17,)).astype(np.uint8),
        "bool": rng.rand(20) > 0.5,
        "bf16": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(2.5),
        "count": jnp.asarray(3, jnp.int32),
        "list": [np.ones(2, np.float32), (np.int64(-5), 1.25)],
        "python": {"int": 300, "neg": -40, "big": 2 ** 40, "none": None,
                   "true": True, "text": "k" * 40},
    }


TREES = {
    "agent_params": lambda w: jax.tree.map(jnp.asarray, w[1]),
    "optax_state": _adam_state,
    "danet_variables": lambda w: w[0],
    "dtypes": lambda w: _dtype_tree(),
}


def _port_leaves(tree):
    """The same tree (keys in their order) as the port holds it: numpy
    arrays, and bfloat16 as torch.bfloat16 tensors."""
    if isinstance(tree, dict):
        return {k: _port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_port_leaves(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_port_leaves(v) for v in tree)
    if isinstance(tree, jax.Array) and tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(tree).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


def _assert_restored_equal(ours, ref, path="", ordered=True):
    """Equal trees: keys (in the same order with `ordered`), dtypes,
    shapes and values."""
    if isinstance(ref, dict):
        assert (list(ours) == list(ref)) if ordered else \
            (sorted(ours) == sorted(ref)), path
        for k in ref:
            _assert_restored_equal(ours[k], ref[k], f"{path}/{k}", ordered)
    elif isinstance(ours, torch.Tensor):
        assert ours.dtype == torch.bfloat16 and ref.dtype.name == "bfloat16"
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16))
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref)
    else:
        assert type(ours) is type(ref) and ours == ref, path


@pytest.mark.parametrize("name", list(TREES))
def test_save_pytree_is_byte_equal_to_flax(weights, name, tmp_path):
    """save_pytree's file equals flax.serialization.to_bytes of the same
    tree byte for byte (the JAX agent's params, its optax state after one
    update, a small DANet's variables, every dtype they hold plus
    bfloat16, scalars and Python leaves); load_pytree gives
    msgpack_restore's tree, dtypes and key order included."""
    tree = TREES[name](weights)
    want = fser.to_bytes(tree)
    path = str(tmp_path / f"{name}.msgpack")
    ckpt.save_pytree(path, _port_leaves(tree))
    with open(path, "rb") as f:
        assert f.read() == want
    assert msgpack.packb(_port_leaves(tree)) == want
    _assert_restored_equal(ckpt.load_pytree(path),
                           fser.msgpack_restore(want))


def test_chunked_arrays_round_trip(monkeypatch):
    """With a small MAX_CHUNK_SIZE in both packages, an array above it is
    written in flax's chunked form byte for byte, inside a tree and at
    its root, and read back whole."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 256)
    rng = np.random.RandomState(4)
    big = rng.standard_normal((10, 30)).astype(np.float32)
    for tree in ({"w": big, "b": np.float32(1.0)}, big):
        want = fser.to_bytes(tree)
        assert msgpack.packb(tree) == want
        assert b"__msgpack_chunked_array__" in want
        got = msgpack.unpackb(want)
        np.testing.assert_array_equal(got["w"] if isinstance(tree, dict)
                                      else got, big)


def test_reader_refuses_what_is_not_flax():
    with pytest.raises(ValueError, match="trailing"):
        msgpack.unpackb(fser.to_bytes({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(fser.to_bytes({"a": np.ones(4)})[:-3])


# ------------------------------------------------------------ importers

def test_import_danet_torch_equals_jax_and_inverts_danet_from_flax(weights,
                                                                 tmp_path):
    """On the port DANet's state_dict, import_danet_torch gives the JAX
    importer's tree exactly (keys and values), and danet_from_flax of it
    gives the state_dict back; load_danet_pt reads the same from a
    reference-format file ({'autoencoder': state_dict})."""
    vnp = weights[0]
    cfg = danet_params(**SMALL)
    sd = danet_from_flax(vnp, cfg)
    model = DANet(cfg)
    model.load_state_dict(sd)
    ours = ckpt.import_danet_torch(model.state_dict(), cfg)
    ref = _np(jckpt.import_danet_torch(model.state_dict(),
                                       jax_danet_params(**SMALL)))
    _assert_restored_equal(ours, ref, ordered=False)
    back = danet_from_flax(ours, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    path = str(tmp_path / "reference.pt")
    torch.save({"autoencoder": model.state_dict()}, path)
    _assert_restored_equal(ckpt.load_danet_pt(path, cfg), ours)


def _reference_snapshot(pnp, drop=("throttle_lstm",)):
    """A reference ppo_model_<N>.pt dict ('{signal}_{ppo,lstm}_{k}'
    state_dicts) of the banks `pnp`, lacking the `drop` families (the
    reference's own save_snapshot omits throttle_lstm)."""
    out = {}
    for signal in ("steer", "throttle"):
        sd = policy_from_flax(pnp[signal])
        for k in range(4):
            if f"{signal}_ppo" not in drop:
                ac = {}
                for i, name in enumerate(("fc1", "fc2", "fc3")):
                    ac[f"control.linear.{2 * i}.weight"] = \
                        sd[f"control.{name}.weight"][k]
                    ac[f"control.linear.{2 * i}.bias"] = \
                        sd[f"control.{name}.bias"][k]
                    ac[f"critic.{2 * i}.weight"] = \
                        sd[f"critic_fc{i + 1}.weight"][k]
                    ac[f"critic.{2 * i}.bias"] = sd[f"critic_fc{i + 1}.bias"][k]
                out[f"{signal}_ppo_{k}"] = ac
            if f"{signal}_lstm" not in drop:
                out[f"{signal}_lstm_{k}"] = {
                    f"rnn.{n}": sd[f"lstm.{n}"][k] for n in
                    ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    return out


def test_import_policy_torch_equals_jax(weights, tmp_path):
    """A reference snapshot of other banks without throttle_lstm: the
    port's import_policy_torch gives the JAX function's banks (the
    missing ones kept from the current weights) and its `missing` list;
    load_policy_pt gives the same from the file."""
    _, pnp, defs = weights
    other = {s: _random_variables(lambda d=d: d.init_params(
        jax.random.PRNGKey(0)), np.random.RandomState(20 + i), ("policy",))
        for i, (s, d) in enumerate(defs.items())}
    snap = _reference_snapshot(other)
    ours, missing = ckpt.import_policy_torch(snap, pnp["steer"],
                                             pnp["throttle"], 4)
    ref, ref_missing = jckpt.import_policy_torch(
        snap, jax.tree.map(jnp.asarray, pnp["steer"]),
        jax.tree.map(jnp.asarray, pnp["throttle"]), 4)
    assert missing == ref_missing == [f"throttle_lstm_{k}" for k in range(4)]
    _assert_restored_equal(ours, _np(ref), ordered=False)
    path = str(tmp_path / "ppo_model_2400.pt")
    torch.save(snap, path)
    from_file, from_file_missing = ckpt.load_policy_pt(
        path, pnp["steer"], pnp["throttle"], 4)
    _assert_restored_equal(from_file, ours)
    assert from_file_missing == missing
    np.testing.assert_array_equal(ours["throttle"]["lstm"]["rnn"]["weight_ih"],
                                  pnp["throttle"]["lstm"]["rnn"]["weight_ih"])
    np.testing.assert_array_equal(ours["steer"]["ac"]["critic_fc2"]["kernel"],
                                  other["steer"]["ac"]["critic_fc2"]["kernel"])


def test_policy_to_flax_inverts_policy_from_flax(weights):
    """policy_to_flax(policy_from_flax(bank)) is the bank, in flax's key
    order, so a port snapshot is the JAX agent's file byte for byte."""
    pnp = weights[1]
    for s in ("steer", "throttle"):
        back = policy_to_flax(policy_from_flax(pnp[s]))
        _assert_restored_equal(back, _np(jax.tree.map(jnp.asarray, pnp[s])))


def test_pickled_modules_are_refused(tmp_path):
    """A .pt of pickled modules (the reference's other snapshot form)
    needs the reference's classes: load_policy_pt and an ensemble member
    refuse it with a message."""
    path = str(tmp_path / "ppo_model_0.pt")
    torch.save({"steer_ppo_0": torch.nn.Linear(2, 2)}, path)
    with pytest.raises(ValueError, match="pickled modules"):
        ckpt.load_policy_pt(path, None, None)
    with pytest.raises(ValueError, match="pickled modules"):
        Ensemble.load(None, [path])          # refused before the agent


# ------------------------------------------------------------- snapshots

def _minibatch(seed, n_out, f, b=6, seq=3):
    rng = np.random.RandomState(seed)
    return dict(
        obs_seq=rng.standard_normal((seq, b, f)).astype(np.float32),
        action=rng.randint(0, n_out, b),
        old_value=(0.1 * rng.standard_normal(b)).astype(np.float32),
        returns=rng.standard_normal(b).astype(np.float32),
        mask=np.ones(b, np.float32),
        old_log_prob=(-np.abs(rng.standard_normal(b)) - 0.5).astype(
            np.float32),
        advantage=rng.standard_normal(b).astype(np.float32),
        hidden=(np.zeros((b, f), np.float32), np.zeros((b, f), np.float32)),
        command=rng.randint(0, 4, b))


def _jax_mb(a):
    return jro.Minibatch(**{k: (tuple(jnp.asarray(x) for x in v)
                                if k == "hidden" else jnp.asarray(v))
                            for k, v in a.items()})


def _port_mb(a):
    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype.kind == "i"
                                else x)
    return rollout.Minibatch(**{k: (tuple(t(x) for x in v)
                                    if k == "hidden" else t(v))
                                for k, v in a.items()})


def test_jax_snapshot_and_optimizer_resume_in_the_port(weights, tmp_path):
    """The JAX agent after one update saves .msgpack and .opt; the port
    loads both. Acting on a feature history with JAX's Gumbel draws gives
    the JAX agent's actions, and its log-probs and values within 1e-5;
    one more update on the same minibatch moves every tensor within 1% of
    the JAX update's largest change to it. The port's own .msgpack and
    .opt of the resumed state equal the JAX agent's files byte for byte."""
    vnp, pnp, _ = weights
    jagent = _jax_agent(weights)
    f = jagent.obs_dim
    mbs = [(_minibatch(2 * i, STEER_BINS, f), _minibatch(2 * i + 1,
                                                         THROTTLE_BINS, f))
           for i in range(2)]
    jagent.update_policy(*(_jax_mb(m) for m in mbs[0]))
    path = str(tmp_path / "ppo_model_1.msgpack")
    jagent.save_snapshot(path, include_opt=True)
    before = _np(jagent.params)

    agent = _port_agent(vnp, pnp)
    agent.load_snapshot(path, agent.opt)
    hist = np.random.RandomState(5).standard_normal((8, 3, f)) \
        .astype(np.float32)
    cmd = np.array([0, 2, 3])
    zeros = jnp.zeros((3, f))
    key = jax.random.PRNGKey(9)
    js, jt, _ = jagent._act_from_hist(jagent.params, jnp.asarray(hist),
                                      jnp.asarray(cmd), (zeros, zeros), key)
    zt = torch.zeros(3, f)
    ps, pt, _ = agent.act_from_hist(
        torch.from_numpy(hist), torch.from_numpy(cmd), (zt, zt),
        *(torch.from_numpy(g) for g in _gumbel(key, 3)))
    for ours, ref in ((ps, js), (pt, jt)):
        np.testing.assert_array_equal(ours.action.numpy(),
                                      np.asarray(ref.action))
        for field in ("log_prob", "value"):
            np.testing.assert_allclose(getattr(ours, field).numpy(),
                                       np.asarray(getattr(ref, field)),
                                       rtol=1e-5, atol=1e-5)

    jagent.update_policy(*(_jax_mb(m) for m in mbs[1]))
    agent.update_policy(*(_port_mb(m) for m in mbs[1]))
    after = _np(jagent.params)
    for s, bank in agent.banks().items():
        got = policy_to_flax(bank.state_dict())
        for path_, ref in jax.tree_util.tree_leaves_with_path(after[s]):
            keys = [p.key for p in path_]
            old = before[s]
            mine = got
            for k in keys:
                old, mine = old[k], mine[k]
            change = float(np.abs(ref - old).max())
            assert change > 0, keys
            assert float(np.abs(mine - ref).max()) <= 0.01 * change, keys

    ours = str(tmp_path / "port.msgpack")
    agent.save_snapshot(ours, agent.opt)
    jagent.save_snapshot(str(tmp_path / "jax.msgpack"), include_opt=True)
    restored = jckpt.load_pytree(ours, jagent.params)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5)
    opt_tree = fser.msgpack_restore(open(ours + ".opt", "rb").read())
    ref_tree = fser.msgpack_restore(
        open(str(tmp_path / "jax.msgpack.opt"), "rb").read())
    assert jax.tree.structure(opt_tree) == jax.tree.structure(ref_tree)
    assert int(opt_tree["1"]["0"]["count"]) == 2
    assert opt_tree["1"]["0"]["count"].dtype == np.int32


def test_port_snapshot_bytes_equal_jax(weights, tmp_path):
    """An agent's .msgpack snapshot (and fresh .opt) is the JAX agent's
    file for the same weights byte for byte, and reads back exactly."""
    vnp, pnp, _ = weights
    agent = _port_agent(vnp, pnp)
    jagent = _jax_agent(weights)
    ours, ref = str(tmp_path / "p.msgpack"), str(tmp_path / "j.msgpack")
    agent.save_snapshot(ours, agent.opt)
    jagent.save_snapshot(ref, include_opt=True)
    for suffix in ("", ".opt"):
        with open(ours + suffix, "rb") as a, open(ref + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    other = _port_agent(vnp, {s: jax.tree.map(np.zeros_like, pnp[s])
                              for s in pnp})
    other.load_snapshot(ours)
    for s, bank in other.banks().items():
        for k, v in bank.state_dict().items():
            assert torch.equal(v, agent.banks()[s].state_dict()[k]), (s, k)


def test_ensemble_of_msgpack_and_reference_members_matches_jax(weights,
                                                               tmp_path):
    """K=3 members in three formats (a JAX .msgpack, a reference
    ppo_model_<N>.pt without throttle_lstm, the port's own .pt): the
    port's folded banks hold the JAX EnsembleAgent's stacked members,
    bank for bank (a reference member's missing banks are the agent's)."""
    vnp, pnp, defs = weights
    members = [{s: _random_variables(lambda d=d: d.init_params(
        jax.random.PRNGKey(0)), np.random.RandomState(40 + 2 * m + i),
        ("policy",)) for i, (s, d) in enumerate(defs.items())}
        for m in range(3)]
    paths = [str(tmp_path / "m0.msgpack"), str(tmp_path / "ppo_model_1.pt"),
             str(tmp_path / "m2.pt")]
    jckpt.save_pytree(paths[0], jax.tree.map(jnp.asarray, members[0]))
    torch.save(_reference_snapshot(members[1]), paths[1])
    torch.save({s: policy_from_flax(members[2][s])
                for s in ("steer", "throttle")}, paths[2])
    jens = JaxEnsembleAgent(_jax_agent(weights), paths[:2])
    agent = _port_agent(vnp, pnp)
    ens = EnsembleAgent(agent, paths).ensemble
    stacked = _np(jens.stacked)
    for m in range(3):
        for s in ("steer", "throttle"):
            bank = getattr(ens, s)
            got = policy_to_flax({k: v[4 * m:4 * m + 4] for k, v in
                                  bank.state_dict().items()})
            want = jax.tree.map(lambda x: x[m], stacked[s]) if m < 2 else \
                members[2][s]
            for (pa, a), (_, b) in zip(
                    jax.tree_util.tree_leaves_with_path(got),
                    jax.tree_util.tree_leaves_with_path(want)):
                np.testing.assert_array_equal(a, b, err_msg=f"{m} {s} {pa}")
    # the reference member's throttle LSTM is the agent's own
    np.testing.assert_array_equal(
        ens.throttle.state_dict()["lstm.weight_ih"][4:8].numpy(),
        agent.throttle.state_dict()["lstm.weight_ih"].numpy())


# ------------------------------------------------------------- configs

def _plain(x):
    return json.loads(json.dumps(x, default=list))


@pytest.mark.parametrize("name", ["agent_config.py", "eval_agent_config.py"])
def test_config_and_load_experiment_equal_jax(name):
    """Config.fromfile gives the JAX engine's dict (eval_agent_config.py
    through `_base_`); load_experiment's configs equal JAX's field by
    field on every field the port's dataclasses have."""
    path = os.path.join(CONFIGS, name)
    assert _plain(config.Config.fromfile(path)) == \
        _plain(jconfig.Config.fromfile(path))
    ours, ref = loader.load_experiment(path), jloader.load_experiment(path)
    assert ours["env"] == ref["env"]
    for key in ("rollout", "agent", "train", "eval"):
        if ref[key] is None:
            assert ours[key] is None
            continue
        for field, value in vars(ours[key]).items():
            assert value == getattr(ref[key], field), (key, field)
    if name == "eval_agent_config.py":
        assert ours["eval"].load_episodes == (2400, 2500, 2600, 2700, 2800,
                                              2900)
        assert ours["env"]["route_indexer"] == "sequential"


def test_config_delete_and_merge_args(tmp_path):
    """`_delete_` replaces a base dict instead of merging into it, a list
    of bases merges in order, and merge_args sets dotted keys (making
    dicts on the way): as the JAX engine does."""
    (tmp_path / "a.py").write_text(
        "x = dict(a=1, b=dict(c=2, d=3))\ny = [1, 2]\n")
    (tmp_path / "b.py").write_text("x = dict(b=dict(e=4))\nz = 'b'\n")
    (tmp_path / "c.py").write_text(
        "_base_ = ['a.py', 'b.py']\n"
        "x = dict(b=dict(_delete_=True, f=5), g=6)\nz = 'c'\n")
    for engine in (config, jconfig):
        cfg = engine.Config.fromfile(str(tmp_path / "c.py"))
        assert _plain(cfg) == {"x": {"a": 1, "b": {"f": 5}, "g": 6},
                               "y": [1, 2], "z": "c"}
        assert cfg.x.b.f == 5
        engine.Config.merge_args(cfg, {"x.a": 10, "w.v": 7})
        assert cfg.x.a == 10 and cfg.w.v == 7


def test_main_config_runs_in_process(tmp_path):
    """`main --config` on an experiment derived from agent_config.py:
    its rollout_cfg (4 steps) and train_cfg (save every iteration) are
    the ones trained with, not --num-steps."""
    from cadre_tpu_torch import main

    cfg = tmp_path / "short.py"
    cfg.write_text(f"_base_ = {os.path.join(CONFIGS, 'agent_config.py')!r}\n"
                   "rollout_cfg = dict(num_steps=4)\n"
                   "train_cfg = dict(save_interval=1, log_interval=1)\n")
    work = tmp_path / "wd"
    path = main.main(["--config", str(cfg), "--env", "fake", "--num-envs",
                      "2", "--num-steps", "999", "--iterations", "2",
                      "--small", "--device", "cpu", "--work-dir", str(work)])
    assert path == str(work / "models" / "ppo_model_1.pt")
    assert os.path.exists(path)
    log = open(work / "0" / "debug.log").read()
    assert "iter 1:" in log


# ------------------------------------------------------------- watchdog

def test_watchdog_expires_clears_on_update_and_pauses():
    """It fails (and calls back) once a window passes without update();
    update() opens a fresh window and clears the failure; pause() stops
    the clock; the port's is the JAX package's class."""
    fired = []
    dog = Watchdog(0.05, on_timeout=lambda: fired.append(1))
    dog.start()
    time.sleep(0.2)
    assert dog.failed and not dog.get_status() and fired == [1]
    dog.update()
    assert not dog.failed
    dog.pause()
    time.sleep(0.2)
    assert not dog.failed and fired == [1]
    dog.update()
    time.sleep(0.2)
    assert dog.failed and fired == [1, 1]
    dog.stop()
    assert inspect.getsource(Watchdog) == \
        inspect.getsource(jwatchdog.Watchdog)


def test_snapshot_refuses_a_file_of_other_contents(tmp_path):
    path = str(tmp_path / "other.pt")
    torch.save({"state_dict": {}}, path)
    with pytest.raises(ValueError, match="not a policy snapshot"):
        snapshot_banks(path, None)
