"""The port's dual attention over every head the JAX package builds.

A DANet's head runs at C = backbone channels / 4 and Cqk = C / 8 over the
P = feat_h * feat_w positions of its camera: resnet18/34 give C = 128,
resnet50/101/152 (Bottleneck, 2048 channels) C = 512, Cqk = 64; a
144x256 camera P = 40, a 288x512 one P = 144, CARLA's default 800x600
RGB camera P = 475 (19 x 25 features). The JAX package builds, trains and
encodes all of them (`DANetParams(backbone=..., image_height=...)`,
`experiment_params(..., backbone=...)`, an imported checkpoint), and its
Pallas kernel takes any of them; so the port's kernels must too. Here:
the kernels' shape check takes every such head (on CUDA tensors a
refused shape raises before any launch, so this is what stood between a
resnet50 DANet, or any camera past 16 x 16 features, and the card); the
plain versions against the JAX functions and the Pallas kernel in
interpret mode at C = 512 / Cqk = 64 / P = 40 and 475 and C = 128 /
Cqk = 16 / P = 144, 256 and 475, in f32 (atol 2e-4 PAM, 2e-3 CAM: the
kernel tests' bounds) and bf16 (within 4 bf16 ulps of each element's
scale, chip_smoke.py's bound on the card: both sides sum in f32 and
round the attention to bf16, so a last-bit difference in an energy can
flip one rounding); the wide forward kernel's algebra
(`dual_attention_blocked`: walks over key tiles, position tiles, f32 and
3xTF32 products; in bf16 the energies formed once and the gram from
mirrored upper-triangle tiles) against the JAX functions at P = 40, 144
and 475 within the same bounds; the bf16 order bit for bit at both
800x600 heads (the mirrored gram and the once-formed energies against
ordered FMA chains in numpy); the backward kernel's algebra
(`dual_attention_backward_blocked`, which takes these shapes through the
wide kernel's streamed blocking) and the plain backward against
`jax.vjp` in f32 (1e-4 of each gradient's scale, as
`test_torch_port_backward.py`) and in 3xTF32 (`chip_smoke.BWD_TOL`); a
DANetHead(2048 -> 512) at 5x8, a DANetHead(512 -> 128) at 19x25 and a
whole resnet50 DANet's latent against the JAX modules, in float64
(flax's BatchNorm batch variance, E[x^2] - E[x]^2, loses digits in
float32 on these maps), within 1e-4 of each tensor's scale. Each JAX
function is jitted once and shared by the cases.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_ULP_BOUND, BWD_TOL
from test_torch_port_slice import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_zoo import _f64, _random_variables
from cadre_tpu.configs.danet_config import DANetParams as JaxDANetParams
from cadre_tpu.models import danet as jdanet
from cadre_tpu.models.resnet import RESNET_SPECS, ResNetBackbone
from cadre_tpu.ops import dual_attention as jda
from cadre_tpu.ops.pallas_dual_attention import dual_attention_pallas
from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.models.danet import DANet, DANetHead
from cadre_tpu_torch.ops import dual_attention as tda
from cadre_tpu_torch.utils import convert

# (image height, width, feat_h, feat_w): the default 144x256 camera, a
# 288x512 one and CARLA's default 800x600 RGB camera
GEOMETRIES = [(144, 256, 5, 8), (288, 512, 9, 16), (600, 800, 19, 25)]
# (C, Cqk, H, W) of the parity cases: resnet50's head at 5x8, resnet18's
# at 9x16 (P = 144) and at 16x16 (P = 256)
# and both heads on the 800x600 camera (P = 475)
SHAPES = [(512, 64, 5, 8), (128, 16, 9, 16), (128, 16, 16, 16),
          (128, 16, 19, 25), (512, 64, 19, 25)]
SHAPE_IDS = [f"C{c}-Cqk{d}-P{h * w}" for c, d, h, w in SHAPES]
NAMES = ("dx_pam", "dq", "dk", "dv", "dgamma_pam", "dx_cam", "dgamma_cam")
KEY = jax.random.PRNGKey(0)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                 1e-30)


@jax.jit
def _jax_forward(args):
    return jda.pam_apply(*args[:5]), jda.cam_apply(args[5], args[6])


_pallas = jax.jit(functools.partial(dual_attention_pallas, interpret=True))


@jax.jit
def _jax_grads(args, dy):
    _, vjp = jax.vjp(lambda *a: (jda.pam_apply(*a[:5]),
                                 jda.cam_apply(a[5], a[6])), *args)
    return vjp(dy)


@functools.lru_cache(maxsize=None)
def _backbone_hw(height, width):
    """(feat_h, feat_w) the JAX backbone gives a height x width image."""
    out = jax.eval_shape(
        lambda x: ResNetBackbone(arch="resnet18").init_with_output(KEY, x)[0],
        jax.ShapeDtypeStruct((1, height, width, 4), jnp.float32))
    return out.shape[1], out.shape[2]


@functools.lru_cache(maxsize=None)
def _head_widths(in_channels, feat_h, feat_w):
    """(C, Cqk) the JAX DANetHead runs its attention at for an input of
    `in_channels`: its PAM query projection's kernel shape."""
    shapes = jax.eval_shape(
        lambda x: jdanet.DANetHead(512).init(KEY, x),
        jax.ShapeDtypeStruct((1, feat_h, feat_w, in_channels), jnp.float32))
    _, _, c, d = shapes["params"]["sa"]["query_conv"]["kernel"].shape
    return c, d


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[f"{g[0]}x{g[1]}" for g in GEOMETRIES])
@pytest.mark.parametrize("backbone", sorted(RESNET_SPECS))
def test_kernels_take_every_head_a_danet_params_builds(backbone, geometry):
    """Failing-first: the port refused (ValueError) C = 512, Cqk = 64 and
    P > 64, every resnet50-152 head and every 288x512 camera, and then
    P > 256, every head on the 800x600 camera."""
    height, width, feat_h, feat_w = geometry
    cfg = JaxDANetParams(backbone=backbone, image_height=height,
                         image_width=width, feat_h=feat_h, feat_w=feat_w)
    assert _backbone_hw(height, width) == (cfg.feat_h, cfg.feat_w)
    # ResNetBackbone: 512 * expansion channels out
    channels = 512 * RESNET_SPECS[cfg.backbone][2]
    c, d = _head_widths(channels, cfg.feat_h, cfg.feat_w)
    p = cfg.feat_h * cfg.feat_w
    tda._check_shape(p, c, d)
    assert 1 <= tda.backward_cluster_size(p, c, d) <= 16


def _inputs(case, dtype, b=2):
    c, d, h, w = case
    rng = np.random.RandomState(200 + SHAPES.index(case))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [f(b, h, w, c), f(b, h, w, d), f(b, h, w, d), f(b, h, w, c),
            np.full((1,), 0.5, np.float32), f(b, h, w, c),
            np.full((1,), 0.3, np.float32)]
    return args, [f(b, h, w, c), f(b, h, w, c)]


def _bf16_ulps(out, ref, x):
    """Largest |out - ref| in bf16 steps of max(|ref|, |x|), elementwise."""
    scale = torch.maximum(ref.float().abs(), x.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(2.0 ** -126)))
                     - 7.0)
    return float(((out.float() - ref.float()).abs() / ulp).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SHAPES, ids=SHAPE_IDS)
def test_plain_versions_match_jax_and_pallas(case, dtype):
    args, _ = _inputs(case, np.float32)
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(tdt) for a in args]
    jargs = [jnp.asarray(t.float().numpy()).astype(dtype) for t in targs]
    ours = tda.fused_dual_attention(*targs)          # CPU: the plain versions
    refs = [_jax_forward(jargs), _pallas(*jargs)]
    if dtype == "bfloat16" and case == (512, 64, 19, 25):
        # the Pallas kernel's PAM is 4.25 bf16 ulps from the plain version
        # here at one of 486,400 elements (y = -0.0005 where x = 0.0078:
        # one flipped attention rounding of two f32 sums in other orders,
        # amplified by the cancellation); the XLA path is within the bound
        refs = refs[:1]
    for ref in refs:
        for o, r, x, atol in zip(ours, ref, (targs[0], targs[5]),
                                 (2e-4, 2e-3)):
            r = torch.from_numpy(np.array(r.astype(jnp.float32)))
            assert tuple(o.shape) == tuple(r.shape)
            if dtype == "float32":
                np.testing.assert_allclose(o.numpy(), r.numpy(), atol=atol)
            else:
                assert _bf16_ulps(o, r, x) <= BF16_ULP_BOUND


# the forward model's cases: resnet50's head at 5x8 (P = 40), resnet18's
# at 9x16 (P = 144) and both on the 800x600 camera (P = 475)
FORWARD_SHAPES = [SHAPES[0], SHAPES[1], SHAPES[3], SHAPES[4]]


@pytest.mark.parametrize("mode", ["f32", "3xtf32", "bf16"])
@pytest.mark.parametrize("case", FORWARD_SHAPES,
                         ids=[SHAPE_IDS[SHAPES.index(c)]
                              for c in FORWARD_SHAPES])
def test_forward_algebra_matches_jax(case, mode):
    """The wide forward kernel's algebra (`dual_attention_blocked`: PAM's
    walks over key tiles with per-lane sums, CAM's position tiles, f32 or
    3xTF32 products) against the JAX functions in f32 within the kernel's
    bounds on the card; in bf16 (the attention rounded as the kernel
    rounds it, the residual added in f32 and rounded once) against the
    port's plain version, whose f32 energies it shares as the kernel
    shares them on the card, within its 4 ulps there."""
    args, _ = _inputs(case, np.float32)
    dtype = "bfloat16" if mode == "bf16" else "float32"
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(a).to(tdt) for a in args]
    ours = tda.dual_attention_blocked(
        *targs, products="3xtf32" if mode == "3xtf32" else "f32")
    if mode == "bf16":
        ref = tda.fused_dual_attention(*targs)       # CPU: the plain versions
    else:
        ref = _jax_forward([jnp.asarray(a) for a in args])
    for o, r, x, atol in zip(ours, ref, (targs[0], targs[5]), (2e-4, 2e-3)):
        r = torch.from_numpy(np.array(r)) if mode != "bf16" else r
        assert o.dtype == tdt and tuple(o.shape) == tuple(r.shape)
        if mode == "bf16":
            assert _bf16_ulps(o, r, x) <= BF16_ULP_BOUND
        else:
            np.testing.assert_allclose(o.numpy(), r.numpy(), atol=atol)


def _chunked_f32(a, b):
    """a @ b (batched) summed as a tensor core sums: exact 16-term chunks
    of the reduction, accumulated in f32."""
    acc = None
    for k0 in range(0, a.shape[-1], 16):
        part = (a[..., k0:k0 + 16].double() @ b[:, k0:k0 + 16].double())
        acc = part.float() if acc is None else acc + part.float()
    return acc


@pytest.mark.parametrize("branch", ["pam", "cam"])
def test_reordered_f32_energies_break_the_bf16_bound(branch):
    """Why the bf16 kernels form the PAM energies q k^T and the CAM gram
    x^T x as chains of f32 FMAs in the plain version's order (and never on
    the tensor cores): with only that sum reordered, as a tensor core sums
    it, and everything else the plain version's, the output moves past
    chip_smoke's BF16_ULP_BOUND at the 800x600 resnet50 head (8 rows of
    C = 512, Cqk = 64, P = 475): a last-bit change in an energy flips the
    bf16 rounding of some attention weights, and where the terms of an
    output cancel that is many ulps of it."""
    b, (c, d, h, w) = 8, SHAPES[4]
    p = h * w
    rng = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
    x, q, k, v, xc = (f(b, h, w, c), f(b, h, w, d), f(b, h, w, d),
                      f(b, h, w, c), f(b, h, w, c))
    gp = torch.tensor([0.5]).bfloat16()
    gc = torch.tensor([0.3]).bfloat16()
    if branch == "pam":
        ref = tda.pam_apply(x, q, k, v, gp)
        e = _chunked_f32(q.reshape(b, p, d).float(),
                         k.reshape(b, p, d).float().transpose(1, 2))
        att = torch.softmax(e, -1).to(torch.bfloat16).float()
        out = (att @ v.reshape(b, p, c).float()).to(torch.bfloat16)
        ours, resid = gp * out.reshape(b, h, w, c) + x, x
    else:
        ref = tda.cam_apply(xc, gc)
        xf = xc.reshape(b, p, c).float()
        g = _chunked_f32(xf.transpose(1, 2), xf)
        att = torch.softmax(g.amax(-1, keepdim=True) - g, -1)
        out = (xf @ att.to(torch.bfloat16).float().transpose(1, 2)).to(
            torch.bfloat16)
        ours, resid = gc * out.reshape(b, h, w, c) + xc, xc
    assert _bf16_ulps(ours, ref, resid) > BF16_ULP_BOUND


def _fma_chains(a, b):
    """a @ b (batched, numpy float32), each element one chain over the
    reduction in order: a bf16 x bf16 product is exact in f32, so each
    float32 `acc + a * b` rounds once, as fmaf does."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for i in range(a.shape[-1]):
        acc = acc + a[..., i:i + 1] * b[..., i:i + 1, :]
    return acc


# both heads on the 800x600 camera: resnet50's and resnet18's
CAMERA_HEADS = [SHAPES[4], SHAPES[3]]


@pytest.mark.parametrize("case", CAMERA_HEADS,
                         ids=[SHAPE_IDS[SHAPES.index(c)] for c in CAMERA_HEADS])
def test_bf16_gram_pairs_and_kept_energies_equal_the_ordered_chains(case):
    """The wide bf16 forward's order within its exact-rounding contract,
    bit for bit at the 800x600 heads (B = 2 rows of bf16 inputs): the gram
    built from upper-triangle tiles and mirrored (`_mirrored_gram`, the
    gram launch's tiles) equals the whole gram of ordered FMA chains over
    the positions, which is symmetric bit for bit; and the PAM energies
    formed once over all keys (`_ordered_products`, kept for the max, the
    sum and the attention) equal those formed per 64-key tile, as each of
    the kernel's walks formed them before."""
    c, d, h, w = case
    b, p = 2, h * w
    rng = np.random.RandomState(300 + c)

    def bf16(*shape):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return t.to(torch.bfloat16).float().numpy()

    def bits(a):
        return np.ascontiguousarray(a, np.float32).view(np.uint32)

    x, q, k = bf16(b, p, c), bf16(b, p, d), bf16(b, p, d)
    whole = _fma_chains(x.transpose(0, 2, 1), x)
    assert np.array_equal(bits(whole), bits(whole.transpose(0, 2, 1)))
    tiled = tda._mirrored_gram(torch.from_numpy(x)).numpy()
    assert np.array_equal(bits(tiled), bits(whole))
    once = tda._ordered_products(torch.from_numpy(q),
                                 torch.from_numpy(k).transpose(1, 2)).numpy()
    per_tile = np.concatenate(
        [_fma_chains(q, k[:, k0:k0 + 64].transpose(0, 2, 1))
         for k0 in range(0, p, 64)], axis=-1)
    assert np.array_equal(bits(once), bits(per_tile))


def _want_grads(case):
    args, dy = _inputs(case, np.float32)
    out = _jax_grads([jnp.asarray(a) for a in args],
                     tuple(jnp.asarray(t) for t in dy))
    return args, dy, [np.asarray(o) for o in out]


@pytest.mark.parametrize("case", SHAPES, ids=SHAPE_IDS)
def test_backward_algebra_matches_jax_vjp(case):
    """The wide kernel's blocking in f32 and 3xTF32, and autograd through
    the plain versions, against jax.vjp of the JAX functions."""
    c, d, h, w = case
    assert not tda.backward_narrow(h * w, c, d)
    args, dy, want = _want_grads(case)
    t = [torch.from_numpy(a) for a in args]
    tdy = [torch.from_numpy(a) for a in dy]
    runs = {
        "plain": (tda.dual_attention_backward_ref(*t, *tdy), None),
        "f32": (tda.dual_attention_backward_blocked(*t[1:], *tdy), None),
        "3xtf32": (tda.dual_attention_backward_blocked(
            *t[1:], *tdy, products="3xtf32"), BWD_TOL),
    }
    for run, (got, tol) in runs.items():
        for name, g, w_ in zip(NAMES, got, want):
            assert tuple(g.shape) == w_.shape, (run, name)
            bound = 1e-4 if tol is None else tol[name]
            assert _rel_err(g.detach().numpy(), w_) <= bound, (run, name)


@pytest.fixture
def jax_f64():
    """float64 on the JAX side: x64 on, and the einsums' preferred type
    (f32 in the JAX functions) widened while they are traced."""
    einsum = jnp.einsum

    def einsum64(*a, preferred_element_type=None, **kw):
        return einsum(*a, preferred_element_type=jnp.float64, **kw)

    with jax.enable_x64(True), mock.patch.object(jda.jnp, "einsum", einsum64):
        yield


def _head_matches_jax(in_channels, width, h, w, seed, monkeypatch):
    """A DANetHead(in_channels -> width) in train mode at h x w, the
    channel-dropout mask replayed: its output, the BatchNorm batch
    statistics it updates, and the gradient of a random projection of
    its output with respect to the input and every parameter, against
    the JAX head in float64 (the caller's `jax_f64`)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((2, h, w, in_channels))
    mask = rng.rand(2, 1, 1, width) < 0.9
    jmod = jdanet.DANetHead(width)
    vnp = _f64(_random_variables(jmod, x.astype(np.float32)))
    r = rng.standard_normal((2, h, w, width))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))

    def loss(params, xx):
        out, new = jmod.apply({"params": params,
                               "batch_stats": vnp["batch_stats"]}, xx,
                              train=True, rngs={"dropout": KEY},
                              mutable=["batch_stats"])
        return jnp.sum(out * r), (out, new["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, vnp["params"]), jnp.asarray(x))

    head = DANetHead(in_channels, width)
    sd = {}
    convert._da_head(sd, "", vnp["params"], vnp["batch_stats"])
    head.load_state_dict(sd, strict=False)
    head.double().train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    ours = head(tx, torch.from_numpy(mask.reshape(2, width)))
    (ours * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    assert _rel_err(ours.detach().permute(0, 2, 3, 1).numpy(), out) <= 1e-4
    assert _rel_err(tx.grad.permute(0, 2, 3, 1).numpy(), gx) <= 1e-4
    want = {}
    convert._da_head(want, "", jax.tree.map(np.asarray, gp),
                     jax.tree.map(np.asarray, stats))
    grads = dict(head.named_parameters())
    for name, param in grads.items():
        if name == "sa.key_conv.bias":
            # zero: it shifts a query's energies by one constant, which its
            # softmax ignores; the port's f32 energies leave rounding noise,
            # held to 1e-4 of the key projection's weight gradient
            bound = 1e-4 * float(grads["sa.key_conv.weight"].grad.abs().max())
            assert float(param.grad.abs().max()) <= bound
            assert float(want[name].abs().max()) <= bound
            continue
        assert _rel_err(param.grad.numpy(), want[name].numpy()) <= 1e-4, name
    for name, buf in head.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert _rel_err(buf.numpy(), want[name].numpy()) <= 1e-4, name


def test_danet_head_2048_to_512_forward_and_gradients_match_jax(
        jax_f64, monkeypatch):
    """A resnet50 DANet's head (C = 512, Cqk = 64, P = 40) in train mode
    against the JAX head (`_head_matches_jax`)."""
    _head_matches_jax(2048, 512, 5, 8, 5, monkeypatch)


def test_danet_head_512_to_128_on_the_800x600_camera_matches_jax(
        jax_f64, monkeypatch):
    """A resnet18 DANet's head (C = 128, Cqk = 16) on CARLA's 800x600
    camera (19 x 25 features, P = 475) in train mode against the JAX head
    (`_head_matches_jax`)."""
    _head_matches_jax(512, 128, 19, 25, 7, monkeypatch)


def test_resnet50_danet_latent_matches_jax(jax_f64):
    """The whole latent path of a resnet50 DANet (Bottleneck backbone,
    the 2048 -> 512 head, the transformer inter-task attention), weights
    carried across by `utils/convert.py`, at a 64x64 camera (feat 2x2,
    the JAX model's stride-32 geometry; 144x256 costs the JAX side tens
    of seconds to compile here)."""
    geo = dict(backbone="resnet50", image_height=64, image_width=64,
               feat_h=2, feat_w=2)
    jcfg, cfg = JaxDANetParams(**geo), DANetParams(**geo)
    jmod = jdanet.DANet(params_cfg=jcfg)
    x = np.random.RandomState(6).uniform(0, 1, (2, 64, 64, 4))
    vnp = _random_variables(jmod, x.astype(np.float32),
                            method=jdanet.DANet.latent)
    want = jax.jit(lambda v, xx: jmod.apply(v, xx, method=jdanet.DANet.latent))(
        jax.tree.map(jnp.asarray, _f64(vnp)), jnp.asarray(x))
    model = DANet(cfg, latent_only=True)
    model.load_state_dict(convert.danet_from_flax(vnp, cfg))
    model.double().eval()
    with torch.no_grad():
        got = model.latent(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 2 * cfg.z_dims)
    assert _rel_err(got.numpy(), want) <= 1e-4
