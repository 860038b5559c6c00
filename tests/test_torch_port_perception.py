"""The port's perception slice against the JAX package, on the CPU.

The full DANet (decoders, light, bc and route-geometry heads) in eval and
train mode, its BatchNorm statistics, the dual-attention gradient, the
losses, the shard loader, the gradient of the total loss, three trainer
steps, the schedule, evaluation, checkpoints and both CLIs of the cascade
(pretrain, then PPO on the trained encoder).

Weights are the JAX package's (one jitted init, perturbed so that BN
statistics, biases and both attention gammas are away from their init
values) converted by cadre_tpu_torch.utils.convert; inputs come from
numpy RandomStates; shards from the JAX package's collect_dataset. Dropout
masks are drawn with numpy and handed to both: to the port through its
`DropoutMasks` seam, to JAX by standing in for jax.random.bernoulli while
the JAX function is traced (the masks then enter its trace as constants).
Tolerances are stated per test: f32 throughout, sums in other orders.
"""
import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_slice import _np, _perturb
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from cadre_tpu.configs.danet_config import PerceptionTrainParams as JaxTP
from cadre_tpu.configs.danet_config import danet_params as jax_danet_params
from cadre_tpu.envs.expert import OracleExpert
from cadre_tpu.envs.sim_env import SimDrivingEnv
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.ops import dual_attention as jda
from cadre_tpu.perception import data as jdata
from cadre_tpu.perception import losses as jlosses
from cadre_tpu.perception import trainer as jtrainer
from cadre_tpu.utils.checkpoint import import_danet_torch
from cadre_tpu.utils.checkpoint import save_pytree as jckpt_save_pytree
from cadre_tpu_torch.configs.danet_config import (
    PerceptionTrainParams,
    danet_params,
)
from cadre_tpu_torch.models import torch_compat
from cadre_tpu_torch.models.danet import DANet, DropoutMasks
from cadre_tpu_torch.ops import dual_attention as tda
from cadre_tpu_torch.perception import data as tdata
from cadre_tpu_torch.perception import losses as tlosses
from cadre_tpu_torch.rl.pipeline import DevicePrefetcher
from cadre_tpu_torch.perception.trainer import (
    PerceptionTrainer,
    warmup_cosine_lr,
)
from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint
from cadre_tpu_torch.utils.convert import danet_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(da_feature_channel=64, inter_att_dims=48, z_dims=32)
# output mode 12 with the route-geometry head and a non-unit geom weight
FULL = dict(SMALL, pred_route_geom=True, route_geom_weight=3.0)


def _rel_close(ours, ref, rtol, what=""):
    """Every value within rtol of the reference's largest magnitude."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ours - ref).max()) if ref.size else 0.0
    assert err <= rtol * scale, f"{what}: {err:.3g} > {rtol} x {scale:.3g}"


@pytest.fixture(scope="module")
def jax_weights():
    """(JAX config, perturbed numpy variables) of the full small DANet,
    from one jitted init."""
    jcfg = jax_danet_params(**FULL)
    model = JaxDANet(params_cfg=jcfg)
    x = jnp.zeros((1, 144, 256, 4))
    speed = jnp.zeros((1, 1))

    @jax.jit
    def init(key):
        return model.init({"params": key, "dropout": key}, x, speed)

    variables = _np(init(jax.random.PRNGKey(0)))
    return jcfg, _perturb(variables, np.random.RandomState(0))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """24 expert frames in 3 shards, recorded by the JAX package."""
    out = str(tmp_path_factory.mktemp("perception_shards"))
    env = SimDrivingEnv(seed=0, seq_length=2, vehicle_num=(4, 2))
    shards = jdata.collect_dataset(env, OracleExpert(), 24, out,
                                   shard_size=8)
    assert len(shards) == 3
    return out


def _batch(b, seed=3):
    """A random model batch (the unpacked loader's keys)."""
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(0, 1, (b, 144, 256, 3)).astype(np.float32)
    route = (rng.rand(b, 144, 256, 1) > 0.8).astype(np.float32)
    return {
        "x": np.concatenate([rgb, route], -1), "camera_rgb": rgb,
        "route_fig": route,
        "camera_seg": rng.randint(0, 8, (b, 144, 256)).astype(np.int32),
        "speed": rng.uniform(0, 8, (b, 1)).astype(np.float32),
        "steer": rng.uniform(-1, 1, b).astype(np.float32),
        "throttle": rng.uniform(0, 1, b).astype(np.float32),
        "light_state": rng.randint(0, 4, b).astype(np.int32),
        "light_dist": rng.uniform(0, 30, b).astype(np.float32),
        "dis": rng.uniform(0, 1, b).astype(np.float32),
        "theta": rng.uniform(0, 1, b).astype(np.float32),
    }


def _masks(b, cfg, seed=4):
    """Numpy keep masks in the JAX draw order: DANetHead [B,1,1,128], then
    the crosses that make att_bc and att_visual [B,z,z]."""
    rng = np.random.RandomState(seed)
    z = cfg.z_dims
    return [rng.rand(b, 1, 1, 128) < 0.9, rng.rand(b, z, z) < 0.9,
            rng.rand(b, z, z) < 0.9]


def _port_masks(masks):
    head, att_bc, att_visual = (torch.from_numpy(m) for m in masks)
    return DropoutMasks(head.reshape(head.shape[0], -1), att_bc, att_visual)


@contextlib.contextmanager
def jax_dropout(monkeypatch, masks):
    """jax.random.bernoulli hands out `masks` in turn (checking shapes)
    while the JAX model is traced."""
    calls = []

    def bernoulli(key, p, shape):
        m = masks[len(calls) % len(masks)]
        calls.append(tuple(shape))
        assert tuple(shape) == m.shape and p == 0.9
        return jnp.asarray(m)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        yield calls


def _port_model(cfg, vnp, train=False):
    model = DANet(cfg)
    model.load_state_dict(danet_from_flax(vnp, cfg))
    return model.train(train)


def _sd_np(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    """Every loss and the weighted total (with light dist and route
    geometry on) within 1e-6 relative."""
    rng = np.random.RandomState(5 + weighted)
    b, h, w = 3, 6, 10
    seg = rng.standard_normal((b, h, w, 8)).astype(np.float32)
    seg_t = rng.randint(0, 8, (b, h, w)).astype(np.int32)
    light = rng.standard_normal((b, 4)).astype(np.float32)
    light_t = rng.randint(0, 4, b).astype(np.int32)
    sw = rng.uniform(0, 1, 8).astype(np.float32) if weighted else None
    lw = rng.uniform(0, 1, 4).astype(np.float32) if weighted else None
    recon = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    recon_t = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    vec = [rng.standard_normal(b).astype(np.float32) for _ in range(2)]
    mu, logvar = rng.standard_normal((2, b, 7)).astype(np.float32)
    t, j = (lambda a: None if a is None else torch.from_numpy(a)), \
        (lambda a: None if a is None else jnp.asarray(a))
    pairs = [
        (tlosses.weighted_cross_entropy(t(light), t(light_t), t(lw)),
         jlosses.weighted_cross_entropy(j(light), j(light_t), j(lw))),
        (tlosses.seg_loss(t(seg), t(seg_t), t(sw)),
         jlosses.seg_loss(j(seg), j(seg_t), j(sw))),
        (tlosses.recon_loss(t(recon), t(recon_t)),
         jlosses.recon_loss(j(recon), j(recon_t))),
        (tlosses.light_state_loss(t(light), t(light_t), t(lw)),
         jlosses.light_state_loss(j(light), j(light_t), j(lw))),
        (tlosses.light_dist_loss(t(vec[0]), t(vec[1])),
         jlosses.light_dist_loss(j(vec[0]), j(vec[1]))),
        (tlosses.bc_loss(t(vec[0]), t(vec[1])),
         jlosses.bc_loss(j(vec[0]), j(vec[1]))),
        (tlosses.kld_loss(t(mu), t(logvar)), jlosses.kld_loss(j(mu),
                                                             j(logvar))),
    ]
    for i, (ours, ref) in enumerate(pairs):
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6,
                                   err_msg=f"loss {i}")
    outputs = {"camera": seg, "route": recon[..., :1],
               "light_state": light, "light_dist": vec[0][:, None],
               "steer": vec[1], "throttle": vec[0],
               "route_geom": np.stack(vec, -1), "mu": mu, "logvar": logvar}
    batch = {"camera_seg": seg_t, "route_fig": recon_t[..., :1],
             "light_state": light_t, "light_dist": vec[1], "steer": vec[0],
             "throttle": vec[1], "dis": vec[1], "theta": vec[0]}
    flags = dict(FULL, pred_light_dist=True)
    tt, tl = tlosses.total_danet_loss(
        {k: t(v) for k, v in outputs.items()},
        {k: t(v) for k, v in batch.items()}, danet_params(**flags), t(sw),
        t(lw), light_weight=2.5)
    jt, jl = jlosses.total_danet_loss(
        {k: j(v) for k, v in outputs.items()},
        {k: j(v) for k, v in batch.items()}, jax_danet_params(**flags),
        j(sw), j(lw), light_weight=2.5)
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("options", [
    dict(), dict(packed=True), dict(balance=True),
    dict(augment=True, cache_in_memory=True, drop_last=False)],
    ids=["plain", "packed", "balance", "augment-cache-tail"])
def test_loader_batches_equal_jax(dataset_dir, options):
    """Same seed, same shards: two epochs of batches equal, key by key,
    in order (a list of shard paths as the root)."""
    paths = sorted(os.path.join(dataset_dir, p)
                   for p in os.listdir(dataset_dir))
    ours = tdata.PerceptionDataLoader(paths, batch_size=5, seed=7, **options)
    ref = jdata.PerceptionDataLoader(paths, batch_size=5, seed=7, **options)
    assert len(ours) == len(ref) == 4
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) >= 4
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_stats_unpack_and_blank_route_equal_jax(dataset_dir):
    paths = tdata.PerceptionDataLoader(dataset_dir).paths
    ours, ref = tdata.compute_stats(paths), jdata.compute_stats(paths)
    for k in ("seg_class_weight", "light_class_weight",
              "command_class_weight"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    assert ours.num_frames == ref.num_frames == 24
    batch = next(iter(tdata.PerceptionDataLoader(paths, batch_size=4,
                                                 seed=1, packed=True)))
    got = tdata.unpack_batch({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    want = jdata.unpack_batch({k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(
        tdata.blank_route_plane(got["x"]).numpy(),
        np.asarray(jdata.blank_route_plane(want["x"])))


def test_prefetcher_keeps_order_and_raises_the_loaders_error():
    batches = [{"a": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(DevicePrefetcher(iter(batches), "cpu"))
    assert [int(b["a"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["a"], torch.Tensor) for b in got)

    def broken():
        yield batches[0]
        raise OSError("bad shard")

    with pytest.raises(OSError, match="bad shard"):
        list(DevicePrefetcher(broken(), "cpu"))


# ---------------------------------------------------------------- model

def test_batchnorm_running_variance_is_flax():
    """One train step on a [2, 3, 3, 4] batch: the port's BatchNorm folds
    the biased batch variance into running_var, as flax's nn.BatchNorm
    does; torch.nn.BatchNorm2d folds the unbiased one (channel 0 here:
    flax 1.07206, torch 1.08218). Normalised outputs agree either way."""
    from flax import linen as fnn

    x = np.random.RandomState(0).standard_normal((2, 3, 3, 4)) \
        .astype(np.float32) * 2.0 + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, new = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    ref_var = np.asarray(new["batch_stats"]["var"])
    ref_mean = np.asarray(new["batch_stats"]["mean"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = torch_compat.BatchNorm2d(4).train()
    stock = torch.nn.BatchNorm2d(4).train()
    y = ours(xt)
    stock(xt)
    np.testing.assert_allclose(ours.running_var.numpy(), ref_var, rtol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), ref_mean,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_ref), atol=1e-5)
    assert np.abs(stock.running_var.numpy() - ref_var).max() > 1e-3


def _jax_apply(jcfg, variables, x, *args, method=None):
    """The JAX DANet's eval-mode `method` (default: the forward), jitted."""
    fn = jax.jit(lambda v, *a: JaxDANet(params_cfg=jcfg).apply(
        v, *a, method=method))
    return fn(jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
              *map(jnp.asarray, args))


def _port_forward(model, x, speed):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(speed))


def _forward_pair(jcfg, vnp, cfg, x, speed, port_model=None):
    model = port_model or _port_model(cfg, vnp)
    return _port_forward(model, x, speed), _jax_apply(jcfg, vnp, x, speed)


@pytest.mark.parametrize("in_bc_speed", [True, False])
def test_forward_eval_matches_jax(jax_weights, in_bc_speed):
    """Every head of output mode 12 + route geometry, NHWC decoder maps:
    each within 1e-4 of its own scale; bc_actions too."""
    jcfg, vnp = jax_weights
    vnp = dict(vnp, params=dict(vnp["params"]))
    if not in_bc_speed:
        for k in ("in_bc_speed_fc1", "in_bc_speed_fc2"):
            vnp["params"].pop(k)
    jcfg = jax_danet_params(**FULL, in_bc_speed=in_bc_speed)
    cfg = danet_params(**FULL, in_bc_speed=in_bc_speed)
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 1, (2, 144, 256, 4)).astype(np.float32)
    speed = rng.uniform(0, 8, (2, 1)).astype(np.float32)
    model = _port_model(cfg, vnp)
    ours, ref = _forward_pair(jcfg, vnp, cfg, x, speed, model)
    assert set(ours) == set(ref) == {"camera", "route", "light_state",
                                     "steer", "throttle", "route_geom"}
    for k in ref:
        assert tuple(ours[k].shape) == ref[k].shape, k
        _rel_close(ours[k].numpy(), ref[k], 1e-4, k)
    steer, throttle = _jax_apply(jcfg, vnp, x, speed,
                                 method=JaxDANet.bc_actions)
    with torch.no_grad():
        s, t = model.bc_actions(torch.from_numpy(x), torch.from_numpy(speed))
    _rel_close(s.numpy(), steer, 1e-4, "bc_actions steer")
    _rel_close(t.numpy(), throttle, 1e-4, "bc_actions throttle")


def _ablation_variables(vnp, kind, rng):
    """The small DANet's variables rearranged for an ablation, new modules
    filled from `rng` (their shapes are the flax modules')."""
    p = dict(vnp["params"])
    c, flat = SMALL["da_feature_channel"], SMALL["da_feature_channel"] * 40

    def dense(i, o):
        return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    if kind == "invaild":
        ita = p["inter_task_att"]
        p["inter_task_att"] = {k: ita[k] for k in ("visual_value",
                                                   "bc_value")}
    elif kind == "no_bc":
        for k in ("bc_conv", "inter_task_att", "bc_branch",
                  "in_bc_speed_fc1", "in_bc_speed_fc2"):
            p.pop(k)
        p["visual_fc1"] = dense(flat, 1024)
        p["visual_fc2"] = dense(1024, SMALL["z_dims"])
        p["route_geom_branch"] = {"fc1": dense(SMALL["z_dims"], 16),
                                  "fc2": dense(16, 2)}
    else:                                               # position
        conv = {"kernel": (rng.standard_normal((1, 1, c, c)) / np.sqrt(c))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
        p["inter_task_att"] = {n: conv for n in (
            "visual_query", "visual_key", "visual_value", "bc_query",
            "bc_key", "bc_value")}
        p["inter_task_att"].update(visual_gamma=np.full(1, 0.4, np.float32),
                                   bc_gamma=np.full(1, 0.6, np.float32))
        keep = ("backbone", "da_head", "visual_conv", "bc_conv",
                "inter_task_att")
        p = {k: p[k] for k in keep}
        return {"params": p, "batch_stats": {
            k: vnp["batch_stats"][k] for k in ("backbone", "da_head")}}
    return {"params": p, "batch_stats": vnp["batch_stats"]}


@pytest.mark.parametrize("kind", ["invaild", "no_bc", "position"])
def test_forward_eval_ablations_match_jax(jax_weights, kind):
    """'invaild' and pred_bc=False through the whole forward; 'position'
    through latent (its NHWC maps reach no decoder: the JAX package's
    DANet.__call__ fails on them as well, and the port's raises). Each
    output within 1e-4 of its scale."""
    _, vnp = jax_weights
    flags = dict(FULL, att_type="position" if kind == "position" else
                 "invaild" if kind == "invaild" else "transformer",
                 pred_bc=kind != "no_bc")
    jcfg, cfg = jax_danet_params(**flags), danet_params(**flags)
    var = _ablation_variables(vnp, kind, np.random.RandomState(2))
    x = np.random.RandomState(3).uniform(0, 1, (2, 144, 256, 4)) \
        .astype(np.float32)
    speed = np.full((2, 1), 3.0, np.float32)
    if kind != "position":
        ours, ref = _forward_pair(jcfg, var, cfg, x, speed)
        assert set(ours) == set(ref)
        for k in ref:
            _rel_close(ours[k].numpy(), ref[k], 1e-4, k)
    model = DANet(cfg, latent_only=True).eval()
    keys = model.state_dict().keys()
    model.load_state_dict({k: v for k, v in danet_from_flax(var, cfg).items()
                           if k in keys})
    ref = _jax_apply(jcfg, var, x, method=JaxDANet.latent)
    with torch.no_grad():
        ours = model.latent(torch.from_numpy(x))
    assert tuple(ours.shape) == ref.shape
    _rel_close(ours.numpy(), ref, 1e-4, "latent")
    if kind == "position":
        with pytest.raises(ValueError, match="position"):
            DANet(cfg)(torch.from_numpy(x))


def test_forward_train_matches_jax(jax_weights, monkeypatch):
    """Train mode with the JAX dropout masks injected: every head within
    1e-4 of its scale; every BatchNorm running statistic after the
    forward within 1e-5 relative (torch.nn.BatchNorm2d's unbiased update
    misses this by about 1e-2 at B=2 on the 5x8 maps)."""
    jcfg, vnp = jax_weights
    cfg = danet_params(**FULL)
    b = 2
    batch = _batch(b)
    masks = _masks(b, cfg)
    with jax_dropout(monkeypatch, masks) as calls:
        ref, new = jax.jit(lambda v, x, s: JaxDANet(params_cfg=jcfg).apply(
            v, x, s, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"]))(
            jax.tree.map(jnp.asarray, vnp), jnp.asarray(batch["x"]),
            jnp.asarray(batch["speed"]))
    assert len(calls) == 3
    model = _port_model(cfg, vnp, train=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(batch["x"]),
                     torch.from_numpy(batch["speed"]),
                     masks=_port_masks(masks))
    for k in ref:
        _rel_close(ours[k].numpy(), ref[k], 1e-4, k)
    want = danet_from_flax({"params": vnp["params"],
                            "batch_stats": _np(new["batch_stats"])}, cfg)
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (20 + 4 + 8)    # backbone, head, decoders
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- gradients

def _attention_args(b, c, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    d = c // 8
    return [f(b, 5, 8, c), f(b, 5, 8, d), f(b, 5, 8, d), f(b, 5, 8, c),
            np.full((1,), 0.7, np.float32), f(b, 5, 8, c),
            np.full((1,), -0.4, np.float32)], [f(b, 5, 8, c), f(b, 5, 8, c)]


@pytest.mark.parametrize("b, c", [(3, 128), (2, 32)],
                         ids=["production-head", "small-head"])
def test_dual_attention_backward_plain_matches_jax(b, c):
    """The plain backward (what chip_smoke.py holds the backward kernel
    to) against jax.vjp of the JAX pam_apply / cam_apply, non-zero
    gammas, f32: every input gradient and both gamma gradients within
    1e-4 of their tensor's largest magnitude."""
    args, (dy_p, dy_c) = _attention_args(b, c, 11)

    @jax.jit
    def grads(a, dy):
        _, vjp = jax.vjp(lambda *a: (jda.pam_apply(*a[:5]),
                                     jda.cam_apply(a[5], a[6])), *a)
        return vjp(dy)

    want = grads([jnp.asarray(a) for a in args],
                 (jnp.asarray(dy_p), jnp.asarray(dy_c)))
    got = tda.dual_attention_backward_ref(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(dy_p),
        torch.from_numpy(dy_c))
    names = ("dx_pam", "dq", "dk", "dv", "dgamma_pam", "dx_cam",
             "dgamma_cam")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        _rel_close(g.numpy(), w, 1e-4, name)
    # the gradient is not trivial: gamma is non-zero, so q, k and v get one
    assert all(float(g.abs().max()) > 0 for g in got)


@pytest.mark.parametrize("case", ["bf16", "wide", "misshapen"])
def test_dual_attention_backward_wrapper_refuses_what_it_does_not_take(
        case):
    """The backward kernel's wrapper raises before any launch on a type
    without a backward kernel and on shapes the kernel does not take; it
    never falls back to the plain version."""
    args, (dy_p, dy_c) = _attention_args(2, 32, 13)
    t = [torch.from_numpy(a) for a in args[1:]]
    dy = [torch.from_numpy(dy_p), torch.from_numpy(dy_c)]
    if case == "bf16":
        t, dy = [a.bfloat16() for a in t], [a.bfloat16() for a in dy]
        with pytest.raises(TypeError, match="no backward kernel"):
            tda.dual_attention_backward(*t, *dy)
    elif case == "wide":
        x = torch.zeros(1, 1, 40, 544)
        qk = torch.zeros(1, 1, 40, 32)
        with pytest.raises(ValueError, match="the kernel takes"):
            tda.dual_attention_backward(qk, qk, x, t[3], x, t[5], x, x)
    else:
        with pytest.raises(ValueError, match="shapes disagree"):
            tda.dual_attention_backward(*t, dy[0][:1], dy[1])
    assert tda.backward_launches == 0


def test_danet_head_train_gradients_reach_conv5a_and_gammas():
    """Failing-first test of the detach fault: a train-mode DANetHead with
    non-zero gammas must pass gradients to conv5a, the PAM projections and
    both gammas (a kernel whose outputs carried no grad_fn gave them
    none). On the CPU this runs the plain versions under autograd; on the
    card chip_smoke.py phase 8 checks the same through the kernels."""
    torch.manual_seed(0)
    head = DANet(danet_params(**SMALL)).da_head.train()
    with torch.no_grad():
        head.sa.gamma.fill_(0.5)
        head.sc.gamma.fill_(0.3)
    x = torch.randn(2, 512, 5, 8)
    mask = torch.ones(2, 128, dtype=torch.bool)
    head(x, mask).square().sum().backward()
    for name in ("conv5a.0.weight", "conv5c.0.weight", "sa.query_conv.weight",
                 "sa.key_conv.weight", "sa.value_conv.weight", "sa.gamma",
                 "sc.gamma"):
        grad = dict(head.named_parameters())[name].grad
        assert grad is not None and float(grad.abs().max()) > 0, name


def _jax_trainer(monkeypatch, jcfg, vnp, tp, steps_per_epoch, weights):
    """The JAX PerceptionTrainer on the given variables (its eager init
    replaced by those variables, which it would only overwrite)."""
    variables = jax.tree.map(jnp.asarray, vnp)
    monkeypatch.setattr(
        jtrainer, "create_danet",
        lambda cfg, rng, train=False, axis_name=None: (
            JaxDANet(params_cfg=cfg, axis_name=axis_name), variables))
    return jtrainer.PerceptionTrainer(
        jcfg, tp, steps_per_epoch=steps_per_epoch,
        rng=jax.random.PRNGKey(0), seg_class_weight=weights[0],
        light_class_weight=weights[1])


def _class_weights():
    rng = np.random.RandomState(8)
    return (rng.uniform(0.1, 1, 8).astype(np.float32),
            rng.uniform(0.1, 1, 4).astype(np.float32))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else a, tree)


def _port_trainer(cfg, vnp, tp, f64=False):
    weights = _class_weights()
    trainer = PerceptionTrainer(
        cfg, tp, 2, device="cpu", state_dict=danet_from_flax(vnp, cfg),
        seg_class_weight=weights[0], light_class_weight=weights[1])
    if f64:
        trainer.model.double()
    return trainer


# Gradients and optimizer steps are compared in float64 on both sides
# (jax.enable_x64; the port's model.double()). In float32 the rounding of
# this h*w-scaled loss alone moves some gradient tensors by several
# percent of their largest magnitude: the port's f32 gradient of
# backbone.layer4.0.conv1.weight is 5.6% of it from the port's own f64
# one, JAX's f32 gradients likewise; in float64 every tensor agrees within
# about 1e-6 (what remains is the attention products, which both
# frameworks' plain versions take in f32). Biases that a train-mode
# BatchNorm or the PAM softmax cancels have a gradient that is zero in
# exact arithmetic; they are held to the largest gradient of the model.
_ZERO_GRADIENT = ("backbone.conv1.bias", "da_head.sa.key_conv.bias") + tuple(
    f"visual_branch.{d}.{i}.bias" for d in ("reverse_image", "reverse_route")
    for i in (0, 3, 6, 9))


def test_total_loss_gradients_match_jax(jax_weights, monkeypatch):
    """The gradient of total_danet_loss (class weights, light weight 2,
    route-geometry weight 3, dropout masks injected) with respect to every
    parameter, against jax.grad of the JAX trainer's _loss_fn on the same
    batch: in float64, each tensor within 1e-3 of its largest magnitude
    (see above); the float32 total within 1e-5 relative of JAX's float64
    one."""
    jcfg, vnp = jax_weights
    cfg = danet_params(**FULL)
    batch = _batch(2, seed=9)
    masks = _masks(2, cfg, seed=10)
    trainer = _port_trainer(cfg, vnp,
                            PerceptionTrainParams(w_light_state=2.0))
    tb = trainer._to_device(batch)
    with torch.no_grad():
        total32 = float(trainer._losses(
            trainer._apply(tb, _port_masks(masks)), tb)[0])
    with jax.enable_x64(True), jax_dropout(monkeypatch, masks):
        jt = _jax_trainer(monkeypatch, jcfg, _f64(vnp),
                          JaxTP(w_light_state=2.0), 2, _class_weights())
        fn = jax.jit(jax.value_and_grad(
            lambda p, s, bt: jt._loss_fn(p, s, bt, jax.random.PRNGKey(0))[0]))
        total64, grads = fn(jt.state.params, jt.state.batch_stats,
                            jax.tree.map(jnp.asarray, _f64(batch)))
        grads = _np(grads)
    np.testing.assert_allclose(total32, float(total64), rtol=1e-5)
    want = {k: v.double().numpy() for k, v in danet_from_flax(
        {"params": grads, "batch_stats": vnp["batch_stats"]}, cfg).items()}
    trainer.model.double()
    tb = trainer._to_device(_f64(batch))
    total, _ = trainer._losses(trainer._apply(tb, _port_masks(masks)), tb)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(total64),
                               rtol=1e-5)
    params = dict(trainer.model.named_parameters())
    assert set(params) <= set(want)
    largest = max(float(np.abs(w).max()) for w in want.values())
    for name, p in params.items():
        g, w = p.grad.numpy(), want[name]
        if name in _ZERO_GRADIENT:
            assert float(np.abs(g - w).max()) <= 1e-9 * largest, name
        else:
            _rel_close(g, w, 1e-3, name)
    for name in ("da_head.sa.gamma", "da_head.sc.gamma"):
        assert float(params[name].grad.abs()) > 0, name


def test_trainer_three_steps_match_jax(jax_weights, monkeypatch):
    """Three steps of the trainers from the same weights, batches and
    masks, in float64 (see above; steps_per_epoch 2: learning rates 0,
    lr/2, lr): each loss within 1e-5 relative; every parameter and
    BatchNorm statistic within 1% of the largest change the JAX trainer
    made to its tensor. The biases whose gradient is zero in exact
    arithmetic move by weight decay and rounding, whose sign Adam
    amplifies to a full step: they are held to twice that change."""
    jcfg, vnp = jax_weights
    cfg = danet_params(**FULL)
    trainer = _port_trainer(cfg, vnp, PerceptionTrainParams(max_epochs=3),
                            f64=True)
    masks = _masks(2, cfg, seed=12)
    with jax.enable_x64(True), jax_dropout(monkeypatch, masks):
        jt = _jax_trainer(monkeypatch, jcfg, _f64(vnp), JaxTP(max_epochs=3),
                          2, _class_weights())
        for step in range(3):
            batch = _f64(_batch(2, seed=20 + step))
            want = jt.train_step(batch, jax.random.PRNGKey(step))
            got = trainer.train_step(batch, masks=_port_masks(masks))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"step {step} {k}")
        final = danet_from_flax({"params": _np(jt.state.params),
                                 "batch_stats": _np(jt.state.batch_stats)},
                                cfg)
    assert trainer.step == 3
    init = danet_from_flax(vnp, cfg)
    ours = _sd_np(trainer.model)
    moved = 0
    for k, got in ours.items():
        ref = final[k].double().numpy()
        change = float(np.abs(ref - init[k].double().numpy()).max())
        err = float(np.abs(got - ref).max())
        bound = 2.0 if k in _ZERO_GRADIENT else 0.01
        assert err <= bound * change, \
            f"{k}: {err:.3g} > 1% of its largest change {change:.3g}"
        moved += change > 0
    assert moved == len(ours)


def test_schedule_matches_optax():
    """The learning rate of every step of a 2-epoch schedule (and past
    its end) against optax's, read at the count before each update as
    optax.adam reads it."""
    tp = PerceptionTrainParams(max_epochs=2, warmup_epochs=1, lr=3e-4)
    steps = 7
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=tp.lr, warmup_steps=steps,
        decay_steps=2 * steps, end_value=0.0)
    got = [warmup_cosine_lr(n, tp, steps) for n in range(2 * steps + 3)]
    want = [float(sched(n)) for n in range(2 * steps + 3)]
    assert got[0] == 0.0 and got[-1] == 0.0 and max(got) == tp.lr
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_evaluate_matches_jax(jax_weights, dataset_dir, monkeypatch):
    """evaluate (losses and accuracies) and evaluate_per_class (the
    held-out tables) on the same loader: losses within 1e-4 relative (f32
    sums over 8 x 36,864 pixel terms in other orders), class counts equal,
    accuracies equal up to the JAX package's f32 division."""
    jcfg, vnp = jax_weights
    cfg = danet_params(**FULL)
    weights = _class_weights()
    jt = _jax_trainer(monkeypatch, jcfg, vnp, JaxTP(), 2, weights)
    trainer = _port_trainer(cfg, vnp, PerceptionTrainParams())

    def loader():
        return tdata.PerceptionDataLoader(dataset_dir, batch_size=8, seed=2,
                                          packed=True)

    got, want = trainer.evaluate(loader()), jt.evaluate(loader())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    got, want = trainer.evaluate_per_class(loader()), \
        jt.evaluate_per_class(loader())
    assert set(got) == set(want)
    for k in ("seg_counts", "light_counts"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX package divides its f32 counts in f32
    for k in ("seg_per_class", "light_per_class", "seg_mean_class_acc",
              "light_mean_class_acc", "seg_pixel_acc", "light_acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["geom_mse"], want["geom_mse"], rtol=1e-4)


# ---------------------------------------------------------------- checkpoints

def test_checkpoints_round_trip_and_use_the_reference_names(jax_weights,
                                                            tmp_path):
    """save -> load gives identical outputs; the port's state_dict fed to
    the JAX package's reference-format importer gives a JAX model with
    the port's outputs (the names are the reference's); a reference-format
    file ({'autoencoder': state_dict}) loads; so does a JAX .msgpack of
    the same weights, written by the JAX package's save_pytree."""
    jcfg, vnp = jax_weights
    cfg = danet_params(**FULL)
    trainer = PerceptionTrainer(cfg, PerceptionTrainParams(), 2,
                                device="cpu",
                                state_dict=danet_from_flax(vnp, cfg))
    path = str(tmp_path / "net_epoch0.pt")
    trainer.save(path)
    x = np.random.RandomState(4).uniform(0, 1, (2, 144, 256, 4)) \
        .astype(np.float32)
    speed = np.full((2, 1), 2.0, np.float32)
    first = _port_forward(trainer.model.eval(), x, speed)
    other = PerceptionTrainer(cfg, PerceptionTrainParams(), 2, seed=5,
                              device="cpu")
    other.load(path)
    again = _port_forward(other.model.eval(), x, speed)
    for k in first:
        assert torch.equal(first[k], again[k]), k
    # the importer knows no route-geometry head: read the rest without it
    plain = jax_danet_params(**SMALL)
    imported = import_danet_torch(trainer.model.state_dict(), plain)
    from_import = _jax_apply(plain, _np(imported), x, speed)
    for k in ("camera", "route", "light_state", "steer", "throttle"):
        _rel_close(first[k].numpy(), from_import[k], 1e-4, k)
    reference = tmp_path / "reference.pt"
    torch.save({"autoencoder": trainer.model.state_dict()}, reference)
    loaded = load_danet_checkpoint(str(reference), cfg)
    assert all(torch.equal(v, loaded[k])
               for k, v in trainer.model.state_dict().items())
    msgpack_path = str(tmp_path / "net_epoch0.msgpack")
    jckpt_save_pytree(msgpack_path, vnp)
    from_msgpack = load_danet_checkpoint(msgpack_path, cfg)
    want = danet_from_flax(vnp, cfg)
    assert set(from_msgpack) == set(want)
    assert all(torch.equal(v, from_msgpack[k]) for k, v in want.items())
    with pytest.raises(ValueError, match="other widths"):
        load_danet_checkpoint(path, danet_params())


# ---------------------------------------------------------------- CLIs

def test_cascade_clis_pretrain_then_train_on_the_encoder(dataset_dir,
                                                         tmp_path):
    """`python -m cadre_tpu_torch.train_perception` on the CPU writes
    net_epoch0.pt; `python -m cadre_tpu_torch.main --danet-checkpoint` on
    it trains an iteration; the agent's encoder gives the trained model's
    latent."""
    from cadre_tpu_torch.rl.agent import CadreAgent

    # two of the shards: one to train on (two steps), one held out
    data = tmp_path / "shards"
    data.mkdir()
    for name in sorted(os.listdir(dataset_dir))[:2]:
        os.symlink(os.path.join(dataset_dir, name), data / name)
    work = tmp_path / "perception"
    cmd = [sys.executable, "-m", "cadre_tpu_torch.train_perception",
           "--data-dir", str(data), "--small", "--device", "cpu",
           "--epochs", "1", "--batch-size", "4", "--work-dir", str(work),
           "--holdout"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    assert "perception epoch 0" in out.stdout
    assert "holdout summary" in out.stdout
    ckpt = work / "net_epoch0.pt"
    assert ckpt.exists()
    cmd = [sys.executable, "-m", "cadre_tpu_torch.main", "--env", "jax",
           "--small", "--device", "cpu", "--danet-checkpoint", str(ckpt),
           "--num-envs", "2", "--num-steps", "4", "--iterations", "1",
           "--work-dir", str(tmp_path / "rl")]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "rl" / "models" / "ppo_model_1.pt").exists()
    cfg = danet_params(**SMALL)
    state = load_danet_checkpoint(str(ckpt), cfg)
    agent = CadreAgent.create(cfg, seed=3, device="cpu",
                              encoder_state=state)
    trained = DANet(cfg)
    trained.load_state_dict(state)
    trained = trained.eval().to(memory_format=torch.channels_last)
    x = torch.from_numpy(_batch(2)["x"])
    with torch.no_grad():
        torch.testing.assert_close(agent.encoder.latent(x),
                                   trained.latent(x), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key"):
        CadreAgent.create(cfg, device="cpu", encoder_state={
            k: v for k, v in state.items() if not k.startswith("bc_conv")})


@pytest.mark.parametrize("flag", [["--mesh", "--model", "oldv2_vae"],
                                  ["--mesh", "--mesh-devices", "2"]],
                         ids=["mesh", "mesh-devices"])
def test_perception_cli_unported_flags_raise(flag, dataset_dir):
    """Data-parallel training refuses what it does not do, as the JAX CLI
    does: a model other than the production DANet, and more ranks than
    the world has (--mesh itself is held in test_torch_port_parallel.py;
    --collect, --experiment and --model in test_torch_port_zoo.py)."""
    import torch.distributed as dist

    from cadre_tpu_torch import train_perception

    with pytest.raises((SystemExit, ValueError),
                       match="production DANet|requested 2 devices"):
        train_perception.main(["--data-dir", dataset_dir, "--device", "cpu",
                               *flag])
    assert not dist.is_initialized()


def test_perception_cli_without_gpu_raises(dataset_dir):
    """The pretraining CLI's default device is the GPU: without one it
    raises and does not carry on on the CPU."""
    from cadre_tpu_torch import train_perception

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        train_perception.main(["--data-dir", dataset_dir, "--small",
                               "--epochs", "1", "--batch-size", "4"])
