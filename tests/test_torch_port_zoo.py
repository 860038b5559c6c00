"""The port's perception zoo against the JAX package, on the CPU.

The mode tables and the 42 experiment records; for every distinct
(model, input mode, output mode, att_type) of the grid, the converted
state_dict's names and shapes and the outputs' keys and shapes (JAX by
jax.eval_shape, the port on the meta device: nothing is computed); the
forward of each model family in eval and train mode; every registry
name under the CLI's config; two trainer steps of DABetaVAE, of OldV2VAE
and of the CarlaNet (CILTrainer); collect_dataset; the recon PNGs; both
CLIs; the refusal of input widths the loader does not give.

Weights are drawn with numpy on the shapes jax.eval_shape gives for the
JAX module (flax's initializers would take minutes to compile here), with
BN statistics and biases away from their init values, and converted by
cadre_tpu_torch.utils.convert.zoo_from_flax; one jitted JAX reference per
family. Dropout masks are drawn
with numpy and handed to both: to the port as arguments, to JAX by
standing in for jax.random.bernoulli while the JAX function is traced.
Widths are the zoo tests' SMALL (64x96 images); tolerances are stated per
test.
"""
import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_slice import _np
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_perception import _rel_close, jax_dropout
from cadre_tpu.configs import danet_config as jdc
from cadre_tpu.configs import experiments as jexp
from cadre_tpu.configs.danet_config import PerceptionTrainParams as JaxTP
from cadre_tpu.envs.expert import OracleExpert as JaxExpert
from cadre_tpu.envs.sim_env import SimDrivingEnv as JaxSim
from cadre_tpu.models import cil as jcil
from cadre_tpu.models import lbc as jlbc
from cadre_tpu.models import registry as jreg
from cadre_tpu.models import resnet as jresnet
from cadre_tpu.models import unet as junet
from cadre_tpu.models import vae as jvae
from cadre_tpu.models.danet import DANet as JaxDANet
from cadre_tpu.perception import cil_trainer as jcil_trainer
from cadre_tpu.perception import data as jdata
from cadre_tpu.perception import trainer as jtrainer
from cadre_tpu.perception import visualize as jvis
from cadre_tpu_torch import train_cil, train_perception
from cadre_tpu_torch.configs import danet_config as tdc
from cadre_tpu_torch.configs import experiments as texp
from cadre_tpu_torch.configs.danet_config import PerceptionTrainParams
from cadre_tpu_torch.envs.expert import OracleExpert
from cadre_tpu_torch.envs.sim_env import SimDrivingEnv
from cadre_tpu_torch.models import cil as tcil
from cadre_tpu_torch.models import lbc as tlbc
from cadre_tpu_torch.models import registry as treg
from cadre_tpu_torch.models import resnet as tresnet
from cadre_tpu_torch.models import unet as tunet
from cadre_tpu_torch.models import vae as tvae
from cadre_tpu_torch.models.danet import DANet, DropoutMasks
from cadre_tpu_torch.perception import data as tdata
from cadre_tpu_torch.perception import visualize as tvis
from cadre_tpu_torch.perception.cil_trainer import CILTrainer
from cadre_tpu_torch.perception.losses import total_danet_loss
from cadre_tpu_torch.perception.trainer import (
    PerceptionTrainer,
    check_input_width,
)
from cadre_tpu_torch.utils import convert
from cadre_tpu_torch.utils.checkpoint import load_danet_checkpoint
from cadre_tpu_torch.utils.convert import zoo_from_flax

SMALL = dict(image_height=64, image_width=96, feat_h=2, feat_w=3,
             da_feature_channel=64, inter_att_dims=48, z_dims=32)
B = 2


def _fields(cfg):
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------- configs

def test_mode_tables_and_params_for_modes_equal_jax():
    """The tables, and every (input, output) mode pair's DANetParams,
    field by field (the two dataclasses have the same fields)."""
    assert tdc.INPUT_MODES == jdc.INPUT_MODES
    assert tdc.OUTPUT_MODES == jdc.OUTPUT_MODES
    assert _fields(tdc.danet_params()) == _fields(jdc.danet_params())
    for i in jdc.INPUT_MODES:
        for o in jdc.OUTPUT_MODES:
            assert _fields(tdc.params_for_modes(i, o, z_dims=7)) == \
                _fields(jdc.params_for_modes(i, o, z_dims=7)), (i, o)


def test_experiments_equal_jax():
    """All 42 records, the distinct combos, and every record's expanded
    parameters (with and without overrides)."""
    assert texp.EXPERIMENTS == jexp.EXPERIMENTS
    assert len(texp.EXPERIMENTS) == 42
    assert texp.distinct_combos() == jexp.distinct_combos()
    for name in jexp.EXPERIMENTS:
        for extra in ({}, SMALL):
            assert _fields(texp.experiment_params(name, **extra)) == \
                _fields(jexp.experiment_params(name, **extra)), name


# ---------------------------------------------------------------- combos

def _combo_name(combo):
    return next(k for k, v in jexp.EXPERIMENTS.items() if v == combo)


def _combo_inputs(model_name, cfg):
    hw = (144, 256) if model_name in ("cil", "cilrs") else \
        (cfg.image_height, cfg.image_width)
    x = np.zeros((B,) + hw + (3 if model_name in ("cil", "cilrs")
                              else cfg.input_channel,), np.float32)
    if model_name in ("cil", "cilrs"):
        return x, np.zeros((B, 1), np.float32), np.zeros(B, np.int32)
    if model_name == "danet":
        return x, np.zeros((B, 1), np.float32)
    return (x,)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: tuple(v.shape) for k, v in tree.items()}
    return [tuple(v.shape) for v in tree]


@pytest.mark.parametrize("combo", jexp.distinct_combos(),
                         ids=lambda c: "-".join(str(v) for v in c))
def test_combo_names_shapes_and_outputs_match_jax(combo, monkeypatch):
    """For the combo's first experiment at SMALL: the port model's
    state_dict equals the converted JAX variables name for name and shape
    for shape, and its output keys and shapes are JAX's. JAX is traced
    with jax.eval_shape and the port runs on the meta device, so nothing
    is computed."""
    name = _combo_name(combo)
    jmodel, jcfg = jexp.build_experiment(name, **SMALL)
    if jmodel is None:
        jmodel = JaxDANet(params_cfg=jcfg)
    args = _combo_inputs(combo[0], jcfg)
    key = jax.random.PRNGKey(0)
    out, shapes = jax.eval_shape(lambda a: jmodel.init_with_output(
        {"params": key, "dropout": key}, *a), args)
    with torch.device("meta"):
        model, cfg = texp.build_experiment(name, **SMALL)
        if model is None:
            model = DANet(cfg)
        ours = model.eval()(*(torch.zeros(a.shape, dtype=torch.from_numpy(
            a).dtype) for a in args))
    assert _fields(cfg) == _fields(jcfg)
    # weights of the traced shapes: zero-stride arrays in, meta tensors out
    variables = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    monkeypatch.setattr(convert, "_t", lambda a: torch.empty(
        np.shape(a), device="meta"))
    converted = zoo_from_flax(model, variables) if combo[0] != "danet" \
        else convert.danet_from_flax(variables, cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want
    assert _shapes(ours) == _shapes(out)


@pytest.mark.parametrize("name", treg.ZOO_NAMES)
def test_every_registry_name_runs_under_the_cli_config(name):
    """What `train_perception --model NAME` builds: adapt_config equal to
    JAX's, the width check passed, the full-width model built and its
    outputs scored by total_danet_loss (every head the config asks for
    exists), on the meta device."""
    jcfg = jreg.adapt_config(name, jdc.danet_params())
    cfg = treg.adapt_config(name, tdc.danet_params())
    assert _fields(cfg) == _fields(jcfg)
    cfg = dataclasses.replace(cfg, model_name=name)
    check_input_width(cfg)
    with torch.device("meta"):
        model = treg.build_model(name, cfg)
        x = torch.zeros(2, 144, 256, 4)
        if model is None:
            out = DANet(cfg).eval()(x, torch.zeros(2, 1))
        else:
            out = model.eval()(x)
        batch = {"camera_seg": torch.zeros(2, 144, 256, dtype=torch.long),
                 "camera_rgb": torch.zeros(2, 144, 256, 3),
                 "route_fig": torch.zeros(2, 144, 256, 1),
                 "light_state": torch.zeros(2, dtype=torch.long),
                 "steer": torch.zeros(2), "throttle": torch.zeros(2)}
        total, _ = total_danet_loss(out, batch, cfg)
    assert total.shape == ()


# ---------------------------------------------------------------- forwards

@contextlib.contextmanager
def jax_bernoulli(monkeypatch, masks, p):
    """jax.random.bernoulli hands out `masks` in turn (shapes and p
    checked) while JAX traces."""
    calls = []

    def bernoulli(key, p_=None, shape=None, **kw):
        m = masks[len(calls) % len(masks)]
        calls.append(tuple(shape))
        assert tuple(shape) == m.shape and abs(kw.get("p", p_) - p) < 1e-12
        return jnp.asarray(m)

    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        yield calls


def _flat(out):
    if isinstance(out, dict):
        return out
    if isinstance(out, torch.Tensor) or hasattr(out, "shape"):
        return {"out": out}
    return {str(i): o for i, o in enumerate(out)}


def _check_family(monkeypatch, jmod, port, jargs, *, train_kw=None,
                  jax_masks=None, p=0.9, port_masks=None, jkw=None,
                  tkw=None, f64=False, core=None):
    """`jmod` (flax) and `port` (torch) on the same weights and inputs:
    eval outputs, then train-mode outputs with the masks replayed and the
    BatchNorm running statistics after it. Every output and statistic
    within 1e-4 of its tensor's scale (the statistics are means of the
    activations the outputs are made of). With `f64`, both run in float64
    (see the callers for why). `core` is the module within `port` that
    holds the weights, where `port` wraps it. Returns the variables."""
    jkw, tkw = jkw or {}, tkw or {}
    core = port if core is None else core
    train_kw = {"train": True} if train_kw is None else train_kw
    key = jax.random.PRNGKey(0)
    vnp = _random_variables(jmod, *jargs, **jkw)
    core.load_state_dict(zoo_from_flax(core, vnp))
    if f64:
        jargs, vrun = _f64(list(jargs)), _f64(vnp)
        port.double()
    else:
        vrun = vnp
    targs = [torch.from_numpy(np.asarray(a)) for a in jargs]

    def run(variables, *a):
        ev = jmod.apply(variables, *a, **jkw)
        if not train_kw:
            return ev, None, None
        tr, new = jmod.apply(variables, *a, **train_kw, **jkw,
                             rngs={"dropout": key},
                             mutable=["batch_stats"])
        return ev, tr, new

    with jax.enable_x64(f64), jax_bernoulli(monkeypatch, jax_masks or [], p):
        ev, tr, new = jax.jit(run)(jax.tree.map(jnp.asarray, vrun),
                                   *(jnp.asarray(a) for a in jargs))
    with torch.no_grad():
        got = _flat(port.eval()(*targs, **tkw))
        for k, want in _flat(ev).items():
            assert tuple(got[k].shape) == want.shape, k
            _rel_close(got[k].numpy(), want, 1e-4, f"eval {k}")
        if tr is None:
            return vnp
        kw = dict(tkw, **{k: v for k, v in train_kw.items() if k != "train"})
        if port_masks is not None:
            kw["masks"] = port_masks
        got = _flat(port.train()(*targs, **kw))
    for k, want in _flat(tr).items():
        _rel_close(got[k].numpy(), want, 1e-4, f"train {k}")
    if new.get("batch_stats"):
        want = zoo_from_flax(core, {"params": vnp["params"],
                                    "batch_stats": _np(new["batch_stats"])})
        sd = core.state_dict()
        names = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
        assert names
        for k in names:
            _rel_close(sd[k].numpy(), want[k].numpy(), 1e-4, k)
    return vnp


def _random_variables(jmod, *args, seed=0, **kw):
    """Variables of `jmod` without running its initializers (which JAX
    would compile): the shapes from jax.eval_shape, the values drawn with
    numpy (kernels scaled by 1/sqrt(fan-in); BatchNorm scales and
    variances in [0.5, 1.5], means and biases around 0; the PAM gamma
    0.5, the CAM gamma 0.3)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda a: jmod.init(
        {"params": key, "dropout": key}, *a, **kw), args)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "gamma":
            value = np.full(s.shape, 0.5 if any(
                getattr(p, "key", None) == "sa" for p in path) else 0.3)
        elif name in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            value = 0.1 * rng.standard_normal(s.shape)
        else:
            fan_in = int(np.prod(s.shape[:-1])) or 1
            value = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _x(channels, h=64, w=96, seed=1):
    return np.random.RandomState(seed).uniform(
        0, 1, (B, h, w, channels)).astype(np.float32)


@pytest.mark.parametrize("kind", ["vanilla_vae", "beta_vae"])
def test_vanilla_and_beta_vae_match_jax(kind, monkeypatch):
    """With the bc head on (input mode 5, output mode 9 + pred_bc); no
    generator, so z = mu on both sides."""
    cfg = dict(SMALL, pred_bc=True)
    jcfg = jdc.params_for_modes(5, 9, **cfg)
    jmod = (jvae.VanillaVAE if kind == "vanilla_vae" else jvae.BetaVAE)(
        params_cfg=jcfg)
    port = treg.build_model(kind, tdc.params_for_modes(5, 9, **cfg))
    _check_family(monkeypatch, jmod, port, [_x(4)])


def test_da_beta_vae_matches_jax(monkeypatch):
    """Both streams (input mode 10, output mode 14, pred_bc): eval, and
    train with the head's channel-dropout mask replayed; the latent."""
    jcfg = jdc.params_for_modes(10, 14, **SMALL)
    cfg = tdc.params_for_modes(10, 14, **SMALL)
    jmod, port = jvae.DABetaVAE(params_cfg=jcfg), tvae.DABetaVAE(cfg)
    head = np.random.RandomState(4).rand(B, 1, 1, 128) < 0.9
    vnp = _check_family(monkeypatch, jmod, port, [_x(3)], jax_masks=[head],
                        port_masks=DropoutMasks(torch.from_numpy(
                            head.reshape(B, -1))))
    want = jax.jit(lambda v, x: jmod.apply(v, x, method="latent"))(
        jax.tree.map(jnp.asarray, vnp), jnp.asarray(_x(3, seed=2)))
    port.load_state_dict(zoo_from_flax(port, vnp))   # before train mode
    with torch.no_grad():
        got = port.eval().latent(torch.from_numpy(_x(3, seed=2)))
    _rel_close(got.numpy(), want, 1e-4, "latent")


@pytest.mark.parametrize("kind", ["old_vae", "oldv2_vae"])
def test_old_vaes_match_jax(kind, monkeypatch):
    """The rgb stem and the stem over the route plane (4 input planes),
    the deconv heads (ConvTranspose 4/2/1) to 144x256."""
    cfg = treg.adapt_config(kind, tdc.danet_params(**SMALL))
    jcfg = jreg.adapt_config(kind, jdc.danet_params(**SMALL))
    jmod = (jvae.OldVAE if kind == "old_vae" else jvae.OldV2VAE)(
        params_cfg=jcfg)
    _check_family(monkeypatch, jmod, treg.build_model(kind, cfg), [_x(4)],
                  train_kw={})


@pytest.mark.parametrize("recurrent,attention",
                         [(False, False), (False, True), (True, False),
                          (True, True)],
                         ids=["unet", "att_unet", "r2_unet", "r2att_unet"])
def test_unets_match_jax(recurrent, attention, monkeypatch):
    """At base width 8 (the registry builds base 64: shapes in the combo
    test), depth 4, 6 input planes of 32x48."""
    jmod = junet.UNet(out_channels=3, base=8, recurrent=recurrent,
                      attention=attention)
    port = tunet.UNet(6, 3, base=8, recurrent=recurrent, attention=attention)
    _check_family(monkeypatch, jmod, port, [_x(6, 32, 48)])


def test_nested_unet_matches_jax(monkeypatch):
    jmod = junet.NestedUNet(out_channels=8, base=8)
    _check_family(monkeypatch, jmod, tunet.NestedUNet(4, 8, base=8),
                  [_x(4, 32, 48)])


def _cil_inputs(h=48, w=64, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, (B, h, w, 3)).astype(np.float32),
            rng.uniform(0, 8, (B, 1)).astype(np.float32),
            np.array([1, 3], np.int32)]


def test_carla_net_matches_jax(monkeypatch):
    """Commands selected and dense (command None); train mode with the
    image FC's dropout mask (keep 0.7) replayed."""
    mask = np.random.RandomState(6).rand(B, 512) < 0.7
    port = tcil.CarlaNet(3, (48, 64))
    _check_family(monkeypatch, jcil.CarlaNet(), port, _cil_inputs(),
                  jax_masks=[mask], p=0.7,
                  port_masks=(torch.from_numpy(mask),))
    with torch.no_grad():
        dense = port.eval()(*(torch.from_numpy(a) for a in
                              _cil_inputs()[:2]))[0]
        picked = port(*(torch.from_numpy(a) for a in _cil_inputs()))[0]
    assert tuple(dense.shape) == (B, 4, 3)
    torch.testing.assert_close(dense[[0, 1], [1, 3]], picked)


@pytest.mark.parametrize("structure", [2, 3])
def test_cil_final_net_matches_jax(structure, monkeypatch):
    mask = np.random.RandomState(7).rand(B, 512) < 0.7
    _check_family(monkeypatch, jcil.CilFinalNet(structure=structure),
                  tcil.CilFinalNet(3, (48, 64), structure=structure),
                  _cil_inputs(), jax_masks=[mask], p=0.7,
                  port_masks=(torch.from_numpy(mask),))


def test_cilrs_net_and_small_cnn_match_jax(monkeypatch):
    """CilrsNet on a resnet18 trunk (resnet34 is held in the ResNet test;
    it is CilrsNet's default), and SmallCNN."""
    _check_family(monkeypatch, jcil.CilrsNet(arch="resnet18"),
                  tcil.CilrsNet(3, "resnet18"), _cil_inputs(64, 96))
    _check_family(monkeypatch, jcil.SmallCNN(z_dims=64),
                  tcil.SmallCNN(4, (64, 96), z_dims=64), [_x(4)],
                  train_kw={})


class _Nhwc(torch.nn.Module):
    """A backbone under the NHWC interface of the JAX module."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("arch", ["resnet34", "resnet50"])
def test_deep_resnets_match_jax(arch, monkeypatch):
    """The backbone alone: BasicBlock (resnet34) and Bottleneck
    (resnet50, 2048 output channels). resnet50 runs in float64: flax's
    BatchNorm takes the batch variance as E[x^2] - E[x]^2, which in
    float32 loses digits to cancellation on its Bottleneck maps (its
    train-mode output read 5e-4 of scale from the port's in float32)."""
    port = tresnet.ResNetBackbone(3, arch)
    _check_family(monkeypatch, jresnet.ResNetBackbone(arch=arch),
                  _Nhwc(port), [_x(3)], f64=arch == "resnet50", core=port)


@pytest.mark.parametrize("kind", ["map", "image"])
def test_lbc_models_match_jax(kind, monkeypatch):
    """MapModel (10 topdown planes) and ImageModel, with the heatmap of
    the target, the dilated head, the bilinear resize, the soft argmax
    and the controller (with_actions), in float64: as resnet50's, flax's
    float32 batch variance loses digits to cancellation (ImageModel's
    train-mode waypoints read 1.4e-4 of scale in float32)."""
    rng = np.random.RandomState(8)
    if kind == "map":
        jmod, port = jlbc.MapModel(), tlbc.MapModel()
        img = _x(10)
    else:
        jmod, port = jlbc.ImageModel(), tlbc.ImageModel()
        img = _x(3)
    target = (rng.uniform(0, 1, (B, 2)) * [95, 63]).astype(np.float32)
    _check_family(monkeypatch, jmod, port, [img, target],
                  jkw={"with_actions": True}, tkw={"with_actions": True},
                  f64=True)


def test_lbc_helpers_and_converter_match_jax():
    """to_heatmap (points on the border and outside), spatial_softmax,
    the LUTs, every Converter map, and the bilinear resize on its edge
    rows and columns: F.interpolate against jax.image.resize at the
    SegmentationModel's 2x3 -> 64x96 and 5x8 -> 144x256."""
    rng = np.random.RandomState(9)
    pts = np.array([[0.0, 0.0], [95.4, 63.6], [40.5, 20.5], [-3, 70]],
                   np.float32)
    _rel_close(tlbc.to_heatmap(torch.from_numpy(pts), 64, 96, 5).numpy(),
               jlbc.to_heatmap(jnp.asarray(pts), 64, 96, 5), 1e-6, "heat")
    logit = rng.standard_normal((3, 7, 9, 4)).astype(np.float32)
    _rel_close(tlbc.spatial_softmax(torch.from_numpy(logit), 0.7).numpy(),
               jlbc.spatial_softmax(jnp.asarray(logit), 0.7), 1e-6, "soft")
    np.testing.assert_array_equal(tlbc.SEG_CONVERTER, jlbc.SEG_CONVERTER)
    np.testing.assert_array_equal(tlbc.SEG_COLOR, jlbc.SEG_COLOR)
    tc, jc = tlbc.Converter(), jlbc.Converter()
    assert (tc.fx, tc.fy) == (jc.fx, jc.fy)
    cam = (rng.uniform(0, 1, (5, 3, 2)) * [255, 60] + [0, 80]) \
        .astype(np.float32)
    pix = (rng.uniform(0, 1, (5, 3, 2)) * 255).astype(np.float32)
    for name, a in (("cam_to_world", cam), ("cam_to_map", cam),
                    ("map_to_world", pix), ("map_to_cam", pix),
                    ("world_to_map", pix / 9), ("world_to_cam", pix / 9)):
        _rel_close(getattr(tc, name)(torch.from_numpy(a)).numpy(),
                   getattr(jc, name)(jnp.asarray(a)), 1e-6, name)
    for (h, w), (oh, ow) in (((2, 3), (64, 96)), ((5, 8), (144, 256))):
        m = rng.standard_normal((2, h, w, 4)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(m), (2, oh, ow, 4),
                                           "bilinear"))
        got = torch.nn.functional.interpolate(
            torch.from_numpy(m).permute(0, 3, 1, 2), size=(oh, ow),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
        for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2],
                     np.s_[:, :, -2:]):
            np.testing.assert_allclose(got[edge], want[edge], atol=1e-6)
        np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------- training

def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else a, tree)


def _batch(seed, h=64, w=96, th=64, tw=96):
    """A loader-style batch: x at h x w, the targets at th x tw."""
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(0, 1, (B, h, w, 3))
    route = (rng.rand(B, h, w, 1) > 0.8).astype(np.float64)
    return {
        "x": np.concatenate([rgb, route], -1), "camera_rgb": rgb,
        "route_fig": (rng.rand(B, th, tw, 1) > 0.8).astype(np.float64),
        "camera_seg": rng.randint(0, 8, (B, th, tw)).astype(np.int32),
        "speed": rng.uniform(0, 8, (B, 1)),
        "steer": rng.uniform(-1, 1, B), "throttle": rng.uniform(0, 1, B),
        "command": rng.randint(0, 4, B).astype(np.int32),
        "light_state": rng.randint(0, 4, B).astype(np.int32),
        "light_dist": rng.uniform(0, 30, B),
        "dis": rng.uniform(0, 1, B), "theta": rng.uniform(0, 1, B),
    }


def _preset_init(monkeypatch, jmod, variables):
    """The JAX trainers initialise their module eagerly (minutes of
    initializer compiles on the CPU): hand them `variables` (float64)."""
    v64 = _f64(variables)
    monkeypatch.setattr(type(jmod), "init", lambda self, *a, **k: v64)


def _check_steps(trainer, init, final, grads):
    """Every tensor moved, and every element is within 1% of the largest
    change JAX made to its tensor, but for two kinds of element, which are
    held to twice it:
    - at most 1 in 10^5 elements of a tensor: where a gradient cancels to
      its float64 rounding, Adam turns the rounding into a step of either
      sign;
    - in a tensor whose gradient is zero in exact arithmetic (a bias before
      a train-mode BatchNorm, the PAM's key bias, a branch no command
      picks), shown by a port gradient below 1e-8 of the model's largest
      on both steps (`grads`, see _grad_max): the elements whose weight
      decay term wd * w is under ten times the tensor's largest gradient.
      Every other element of such a tensor moves as weight decay alone
      moves it (Adam's last step on wd * w), to 1% of the change, in the
      port and in JAX: there Adam's step g / (|g| + eps) changes by less
      than eps / (81 |wd * w|) of itself for a gradient of rounding noise.
    """
    group = trainer.opt.param_groups[0]
    wd, eps, lr = group["weight_decay"], group["eps"], group["lr"]
    top = max(float(g.max()) for g in grads.values())
    for k, got in _sd_np(trainer.model).items():
        w0 = init[k].double().numpy()
        ref = final[k].double().numpy()
        change = float(np.abs(ref - w0).max())
        err = np.abs(got - ref)
        assert change > 0, k
        assert float(err.max()) <= 2.0 * change, k
        free = np.zeros(err.shape, bool)
        noise = float(grads[k].max()) if k in grads else top
        if noise <= 1e-8 * top:
            decay = wd * w0
            alone = w0 - lr * decay / (np.abs(decay) + eps)
            free = np.abs(decay) < 10.0 * noise
            for side, moved in (("port", got), ("JAX", ref)):
                off = float(np.abs(moved - alone)[~free].max(initial=0.0))
                assert off <= 0.01 * change, \
                    f"{k} ({side}): {off:.3g} from weight decay's step"
        loose = int((err[~free] > 0.01 * change).sum())
        assert loose <= int(1e-5 * err.size), \
            f"{k}: {loose} elements beyond 1% of {change:.3g}"


def _grad_max(model, seen):
    """`seen` updated to each parameter's largest |gradient| so far,
    element by element (float64, after a train step)."""
    for k, p in model.named_parameters():
        g = np.abs(p.grad.detach().numpy())
        seen[k] = np.maximum(seen[k], g) if k in seen else g
    return seen


def _sd_np(model):
    return {k: v.detach().double().numpy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("kind", ["da_beta_vae", "oldv2_vae"])
def test_zoo_trainer_steps_match_jax(kind, monkeypatch):
    """Two steps of the perception trainer with a zoo model (warm-up of
    one step: rates 0, then lr) in float64 on both sides, from the same
    weights, batches and (DABetaVAE) head masks: each loss within 1e-5
    relative, each tensor within 1% of JAX's change. DABetaVAE is
    auto_da_beta_vae (modes 5 / 9, KLD); OldV2VAE reads 64x96 planes and
    writes 144x256 maps (its deconv is fixed), scored against 144x256
    targets, seg and light state."""
    if kind == "da_beta_vae":
        cfg = texp.experiment_params("auto_da_beta_vae", **SMALL)
        jcfg = jexp.experiment_params("auto_da_beta_vae", **SMALL)
        jmod, size = jvae.DABetaVAE(params_cfg=jcfg), {}
        # one mask for both steps: JAX's jitted step keeps the one it traced
        heads = [np.random.RandomState(30).rand(B, 1, 1, 128) < 0.9] * 2
    else:
        flags = dict(SMALL, pred_route=False)
        cfg = treg.adapt_config(kind, tdc.danet_params(**flags))
        jcfg = jreg.adapt_config(kind, jdc.danet_params(**flags))
        jmod, size, heads = jvae.OldV2VAE(params_cfg=jcfg), \
            dict(th=144, tw=256), None
    tp = PerceptionTrainParams(max_epochs=3, warmup_epochs=1)
    weights = (np.random.RandomState(8).uniform(0.1, 1, 8)
               .astype(np.float32),
               np.random.RandomState(9).uniform(0.1, 1, 4)
               .astype(np.float32))
    port = treg.build_model(kind, cfg)
    vnp = _random_variables(jmod, _batch(0, **size)["x"].astype(np.float32))
    port.load_state_dict(zoo_from_flax(port, vnp))
    with jax.enable_x64(True):
        _preset_init(monkeypatch, jmod, vnp)
        jt = jtrainer.PerceptionTrainer(
            jcfg, JaxTP(max_epochs=3, warmup_epochs=1), 1,
            jax.random.PRNGKey(0), seg_class_weight=weights[0],
            light_class_weight=weights[1], model=jmod)
        trainer = PerceptionTrainer(cfg, tp, 1, device="cpu", model=port,
                                    seg_class_weight=weights[0],
                                    light_class_weight=weights[1])
        trainer.model.double()
        init, grads = zoo_from_flax(port, vnp), {}
        for step in range(2):
            batch = _f64(_batch(40 + step, **size))
            masks = None if heads is None else [heads[step]]
            with jax_dropout(monkeypatch, masks or []):
                want = jt.train_step(batch, jax.random.PRNGKey(step))
            got = trainer.train_step(batch, masks=None if heads is None else
                                     DropoutMasks(torch.from_numpy(
                                         heads[step].reshape(B, -1))))
            _grad_max(trainer.model, grads)
            assert set(got) == set(want)
            assert "visual_kld" in got
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"step {step} {k}")
        final = zoo_from_flax(port, {"params": _np(jt.state.params),
                                     "batch_stats": _np(
                                         jt.state.batch_stats)})
    _check_steps(trainer, init, final, grads)


def test_cil_trainer_steps_match_jax(monkeypatch):
    """Two CILTrainer steps of the CarlaNet (rates 0, then lr) in float64
    from the same weights and batches (48x64 frames), its dropout mask
    replayed: each loss within 1e-5 relative, each tensor within 1% of
    JAX's change (see _check_steps)."""
    jmod, port = jcil.CarlaNet(), tcil.CarlaNet(3, (48, 64))
    tp = PerceptionTrainParams(max_epochs=3, warmup_epochs=1)
    # one mask for both steps: JAX's jitted step keeps the one it traced
    masks = [np.random.RandomState(50).rand(B, 512) < 0.7] * 2
    vnp = _random_variables(jmod, *_cil_inputs(), seed=2)
    port.load_state_dict(zoo_from_flax(port, vnp))
    with jax.enable_x64(True):
        _preset_init(monkeypatch, jmod, vnp)
        jt = jcil_trainer.CILTrainer(jmod, JaxTP(max_epochs=3,
                                                 warmup_epochs=1), 1,
                                     jax.random.PRNGKey(0),
                                     image_hw=(48, 64))
        trainer = CILTrainer(port, tp, 1, device="cpu")
        trainer.model.double()
        init, grads = zoo_from_flax(port, vnp), {}
        for step in range(2):
            batch = _f64(_batch(60 + step, 48, 64))
            with jax_bernoulli(monkeypatch, [masks[step]], 0.7):
                want = jt.train_step(batch, jax.random.PRNGKey(step))
            got = trainer.train_step(batch,
                                     masks=(torch.from_numpy(masks[step]),))
            _grad_max(trainer.model, grads)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"step {step} {k}")
        final = zoo_from_flax(port, {"params": _np(jt.state.params),
                                     "batch_stats": _np(
                                         jt.state.batch_stats)})
    _check_steps(trainer, init, final, grads)


# ---------------------------------------------------------------- data

def test_collect_dataset_equals_jax(tmp_path, monkeypatch):
    """40 frames in shards of 16 from the same sim settings: every array
    of every shard equal; the stuck guard is taken (ticks stepped without
    a frame recorded) with small record and reset limits."""
    kw = dict(shard_size=16, max_stuck_record=2, max_stuck_reset=12)
    env = SimDrivingEnv(seed=3, seq_length=2, vehicle_num=(4, 2))
    steps = []
    step = env.step
    monkeypatch.setattr(env, "step", lambda c: steps.append(1) or step(c))
    ours = tdata.collect_dataset(env, OracleExpert(), 40,
                                 str(tmp_path / "port"), **kw)
    ref = jdata.collect_dataset(JaxSim(seed=3, seq_length=2,
                                       vehicle_num=(4, 2)),
                                JaxExpert(), 40, str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref] == \
        ["shard_00000.npz", "shard_00001.npz", "shard_00002.npz"]
    assert len(steps) > 40
    for a, b in zip(ours, ref):
        with np.load(a) as za, np.load(b) as zb:
            assert za.files == zb.files == list(tdata.FIELDS)
            for k in zb.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_recon_png_decodes_to_the_jax_grid(tmp_path):
    """write_png's file decodes (zlib alone) to JAX's visualization_grid
    bit for bit; dump_visualizations writes the JAX layout."""
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in _batch(70).items()}
    rng = np.random.RandomState(71)
    outputs = {"camera": rng.standard_normal((B, 64, 96, 8))
               .astype(np.float32),
               "route": rng.uniform(0, 1, (B, 64, 96, 1)).astype(np.float32)}
    d = tvis.dump_visualizations(batch, outputs, str(tmp_path), 3)
    assert d == str(tmp_path / "recon_epoch3")
    assert sorted(os.listdir(d)) == ["sample_0.png", "sample_1.png"]
    for i in range(B):
        want = jvis.visualization_grid(batch, outputs, i)
        assert want.shape == (64, 4 * 96, 3)
        got = tvis.read_png(os.path.join(d, f"sample_{i}.png"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tvis.visualization_grid(batch, outputs, i), want)
    np.testing.assert_array_equal(tvis.SEG_PALETTE, jvis.SEG_PALETTE)


# ---------------------------------------------------------------- CLIs

@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """12 frames collected by the perception CLI's --collect, in process,
    training the DANet at --small for one epoch of 3 steps."""
    root = tmp_path_factory.mktemp("zoo_cli")
    data, work = str(root / "data"), str(root / "danet")
    path = train_perception.main([
        "--data-dir", data, "--collect", "12", "--small", "--device", "cpu",
        "--epochs", "1", "--batch-size", "4", "--work-dir", work])
    return data, path


def test_perception_cli_collects_and_trains_experiments(collected,
                                                         tmp_path):
    """--collect wrote one shard of 12 frames that the loader reads; the
    'invaild' ablation (auto_danet_exp50) and a zoo model (--model
    da_beta_vae) train on it; each checkpoint is read back for its own
    model and refused for another."""
    data, danet_ckpt = collected
    assert os.listdir(data) == ["shard_00000.npz"]
    with np.load(os.path.join(data, "shard_00000.npz")) as z:
        assert z["camera_rgb"].shape == (12, 144, 256, 3)
    state = load_danet_checkpoint(danet_ckpt, tdc.danet_params(
        da_feature_channel=64, inter_att_dims=48, z_dims=32))
    assert "bc_conv.weight" in state
    for flags, cfg in (
            (["--experiment", "auto_danet_exp50"],
             texp.experiment_params("auto_danet_exp50", da_feature_channel=64,
                                    inter_att_dims=48, z_dims=32)),
            (["--model", "da_beta_vae"], None)):
        work = str(tmp_path / flags[1])
        path = train_perception.main([
            "--data-dir", data, "--small", "--device", "cpu", "--epochs",
            "1", "--batch-size", "6", "--work-dir", work, *flags])
        if cfg is None:
            cfg = dataclasses.replace(tdc.danet_params(
                da_feature_channel=64, inter_att_dims=48, z_dims=32),
                model_name="da_beta_vae")
        state = load_danet_checkpoint(path, cfg)
        model = DANet(cfg) if cfg.model_name == "danet" else \
            treg.build_model(cfg.model_name, cfg)
        model.load_state_dict(state)
        with pytest.raises(ValueError, match="another model"):
            load_danet_checkpoint(path, dataclasses.replace(
                cfg, model_name="oldv2_vae"))


def test_cil_cli_trains_on_collected_frames(collected, tmp_path):
    data, _ = collected
    path = train_cil.main(["--data-dir", data, "--device", "cpu",
                           "--epochs", "1", "--batch-size", "6",
                           "--work-dir", str(tmp_path)])
    assert path.endswith("cil_epoch0.pt")
    blob = torch.load(path, weights_only=True)
    assert blob["config"] == {"model_name": "cilrs", "arch": "resnet18"}
    tcil.CilrsNet(arch="resnet18").load_state_dict(blob["state_dict"])


def test_trainer_solve_evaluates_and_dumps_recon_grids(collected, tmp_path):
    """solve(eval_loader=...) evaluates each epoch and writes the recon
    grids of the eval loader's first batch, which decode to the grid of
    the trained model's outputs."""
    data, _ = collected
    cfg = texp.experiment_params("auto_da_beta_vae", da_feature_channel=64,
                                 inter_att_dims=48, z_dims=32)
    torch.manual_seed(0)
    trainer = PerceptionTrainer(cfg, PerceptionTrainParams(), 2,
                                device="cpu",
                                model=treg.build_model("da_beta_vae", cfg))
    loader = tdata.PerceptionDataLoader(data, batch_size=6, seed=0,
                                        packed=True)
    lines = []
    trainer.solve(loader, epochs=1, work_dir=str(tmp_path),
                  log_fn=lines.append,
                  eval_loader=tdata.PerceptionDataLoader(data, batch_size=4,
                                                         seed=1))
    assert any(line.startswith("  eval: ") for line in lines)
    d = tmp_path / "recon_epoch0"
    assert sorted(os.listdir(d)) == [f"sample_{i}.png" for i in range(4)]
    # the batch solve dumped: the eval loader's next after evaluate's pass
    again = tdata.PerceptionDataLoader(data, batch_size=4, seed=1)
    list(again)
    batch = next(iter(again))
    outputs, _ = trainer._eval_outputs(batch)
    want = tvis.visualization_grid(
        batch, {k: v.numpy() for k, v in outputs.items()}, 2)
    np.testing.assert_array_equal(tvis.read_png(str(d / "sample_2.png")),
                                  want)
    assert want.shape == (144, 4 * 256, 3)


def test_input_width_refusal(collected):
    """An experiment whose input width is not the loader's 4 planes
    raises before the first step, naming both widths: from the trainer,
    and from the CLI before it collects."""
    data, _ = collected
    cfg = texp.experiment_params("auto_vanilla_vae", **SMALL)
    assert cfg.input_channel == 5
    with pytest.raises(ValueError, match="takes 5 input planes.*gives 4"):
        PerceptionTrainer(cfg, PerceptionTrainParams(), 1, device="cpu",
                          model=treg.build_model("vanilla_vae", cfg))
    for name in ("auto_da_beta_vae_exp46", "auto_unet", "cilrs_net"):
        with pytest.raises(ValueError, match="input planes.*gives 4"):
            train_perception.main(["--data-dir", data + "_never",
                                   "--collect", "4", "--device", "cpu",
                                   "--experiment", name])
    assert not os.path.exists(data + "_never")
