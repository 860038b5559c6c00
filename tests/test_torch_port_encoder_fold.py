"""The frozen encoder's inference form (`models.danet.fold_batch_norms`,
`models.resnet.FoldedBackbone`, `ops.conv_epilogue`): BatchNorm folded
into the convolutions, bias, residual add and ReLU in the epilogue.

On the CPU the fused convolution runs its plain version, so here the
folded net is held to the unfolded one in eval mode: exactly in float64
(the fold is algebra), and in float32 to float32 rounding. The card's
fused convolution is held to the plain version by the CUDA case below
(skipped without a card) and by the benchmark's `latent` check.
"""
from __future__ import annotations

import copy
import types

import pytest
import torch
import torch.nn.functional as F

from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.models import resnet
from cadre_tpu_torch.models.danet import DANet, fold_batch_norms
from cadre_tpu_torch.models.torch_compat import BatchNorm2d
from cadre_tpu_torch.ops import conv_epilogue
from cadre_tpu_torch.rl.agent import CadreAgent
from portbench.core.weights import make_weights, shapes_of

# a 64x64 camera keeps the stride-32 geometry (feat 2x2) and the CPU fast
GEO = dict(image_height=64, image_width=64, feat_h=2, feat_w=2,
           da_feature_channel=64, inter_att_dims=48, z_dims=32)


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(net: torch.nn.Module, recipe: str, seed: int):
    """The benchmark's weights (running statistics 0 and 1), or the same
    with running statistics far from them ('far')."""
    w = make_weights(shapes_of(net), seed, "cpu")
    if recipe == "far":
        gen = torch.Generator().manual_seed(seed + 1)
        for k, v in w.items():
            if k.endswith("running_mean"):
                w[k] = 0.5 * torch.randn(v.shape, generator=gen)
            elif k.endswith("running_var"):
                w[k] = 0.2 + 3.0 * torch.rand(v.shape, generator=gen)
    return w


def _pair(arch: str, att_type: str, recipe: str, seed: int = 3):
    """(unfolded, folded) eval-mode latent nets on the same weights."""
    cfg = danet_params(backbone=arch, att_type=att_type, **GEO)
    net = DANet(cfg, latent_only=True)
    net.load_state_dict(_weights(net, recipe, seed))
    net.eval()
    return net, fold_batch_norms(copy.deepcopy(net))


def _frames(b: int = 2, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(b, 64, 64, 4, generator=gen)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("recipe", ["bench", "far"])
@pytest.mark.parametrize("att_type", ["transformer", "invaild", "position"])
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_folded_latent_equals_unfolded(arch, att_type, recipe):
    """float64: the folded latent is the unfolded one to 1e-12 (the fold
    is exact algebra). float32: the folded latent lies within 1e-5 of the
    unfolded one's scale (relative RMS), and no farther from the float64
    latent than twice the unfolded float32 net's own rounding."""
    net, folded = _pair(arch, att_type, recipe)
    x = _frames()
    with torch.no_grad():
        want = net.latent(x)
        got = folded.latent(x)
        truth = copy.deepcopy(net).double().latent(x.double())
        exact = _pair(arch, att_type, recipe)[0].double()
        got64 = fold_batch_norms(exact).latent(x.double())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got64, truth) <= 1e-12
    assert _rel(got, want) <= 1e-5
    assert _rel(got, truth) <= 2 * _rel(want, truth) + 1e-7


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_downsample_bias_joins_the_last_convolution(block):
    """A downsampling block's shortcut runs its bare convolution; the
    folded bias of its BatchNorm is added to the last convolution's."""
    torch.manual_seed(0)
    cls = resnet.BasicBlock if block == "basic" else resnet.Bottleneck
    blk = cls(32, 16, stride=2).double()
    for m in blk.modules():
        if isinstance(m, BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, dtype=torch.float64))
            m.running_var.copy_(0.5 + torch.rand(n, dtype=torch.float64))
            m.weight.data.copy_(1 + 0.2 * torch.randn(n, dtype=torch.float64))
            m.bias.data.copy_(0.2 * torch.randn(n, dtype=torch.float64))
    blk.eval()
    folded = resnet.FoldedBlock(blk)
    last = folded.conv3 if block == "bottleneck" else folded.conv2
    last_bn = blk.bn3 if block == "bottleneck" else blk.bn2
    conv_last = blk.conv3 if block == "bottleneck" else blk.conv2
    _, b_last = resnet.fold_batch_norm(conv_last, last_bn)
    w_down, b_down = resnet.fold_batch_norm(blk.downsample[0],
                                            blk.downsample[1])
    assert folded.downsample.bias is None
    torch.testing.assert_close(folded.downsample.weight, w_down, rtol=0,
                               atol=0)
    torch.testing.assert_close(last.bias, b_last + b_down, rtol=0, atol=0)
    x = torch.randn(2, 32, 12, 10, dtype=torch.float64)
    with torch.no_grad():
        torch.testing.assert_close(folded(x), blk(x), rtol=1e-12,
                                   atol=1e-12)


def test_fold_then_bf16():
    """The fold is taken in float32 (from float64 sums, rounded once)
    before the bf16 cast, as `CadreAgent.create` orders them: the folded
    weights in bf16 are the float64 fold rounded to f32 then to bf16, and
    lie closer to the float64 fold than folding after the cast puts them;
    the bf16 latent stays within bf16 rounding of the float64 one."""
    net, folded = _pair("resnet18", "transformer", "far")
    late = folded.to(torch.bfloat16)
    early = fold_batch_norms(copy.deepcopy(net).to(torch.bfloat16))
    exact = fold_batch_norms(copy.deepcopy(net).double())
    gaps = {"late": 0.0, "early": 0.0}
    for name, w in exact.state_dict().items():
        if not name.startswith(("backbone.", "da_head.conv5")):
            continue
        want = w.float().to(torch.bfloat16)
        torch.testing.assert_close(late.state_dict()[name], want, rtol=0,
                                   atol=0)
        for side, m in (("late", late), ("early", early)):
            gaps[side] += float((m.state_dict()[name].double() - w)
                                .abs().sum())
    assert gaps["late"] < gaps["early"]
    x = _frames(4)
    with torch.no_grad():
        truth = exact.latent(x.double())
        assert _rel(late.latent(x.to(torch.bfloat16)), truth) <= 0.05


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_folded_net_holds_no_batch_norm_and_refuses_training_state(arch):
    """The folded latent path has no BatchNorm module and no BatchNorm key;
    a training state_dict does not load into it; a training-mode net is
    not folded."""
    net, folded = _pair(arch, "transformer", "bench")
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in folded.modules())
    keys = folded.state_dict().keys()
    assert not any("bn" in k or "running_" in k for k in keys)
    assert "backbone.layer1.0.conv1.bias" in keys
    assert "da_head.conv5a.bias" in keys
    with pytest.raises(RuntimeError, match="Missing key"):
        folded.load_state_dict(net.state_dict())
    with pytest.raises(ValueError, match="eval mode"):
        fold_batch_norms(DANet(danet_params(**GEO), latent_only=True))


def test_cpu_agent_keeps_the_unfolded_encoder():
    """Only a CUDA agent folds: on the CPU the encoder keeps its
    BatchNorms (the perception tests hold its latent exactly to the
    trained net's)."""
    agent = CadreAgent.create(danet_params(**GEO), seed=1, device="cpu")
    assert isinstance(agent.encoder.backbone, resnet.ResNetBackbone)
    assert isinstance(agent.encoder.da_head.conv5a[1], BatchNorm2d)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("stride, padding, k", [(1, 1, 3), (2, 1, 3),
                                                (1, 0, 1), (2, 3, 7)])
def test_conv_bias_relu_plain_path(stride, padding, k, residual):
    """On CPU tensors the wrapper is relu(conv2d(x, w, b) + z), exactly."""
    gen = torch.Generator().manual_seed(k + stride)
    x = torch.randn(2, 8, 11, 13, generator=gen)
    w = torch.randn(16, 8, k, k, generator=gen)
    b = torch.randn(16, generator=gen)
    y = F.conv2d(x, w, b, stride, padding)
    z = torch.randn(y.shape, generator=gen) if residual else None
    want = torch.relu(y + z) if residual else torch.relu(y)
    before = conv_epilogue.launches
    got = conv_epilogue.conv_bias_relu(x, w, b, (stride, stride),
                                       (padding, padding), z)
    assert torch.equal(got, want)
    assert conv_epilogue.launches == before


@pytest.mark.parametrize("residual", [False, True])
def test_conv_bias_relu_dispatches_cuda_tensors_to_the_fused_op(monkeypatch,
                                                               residual):
    """A CUDA tensor goes to cuDNN's fused convolution (relu, or add_relu
    with the residual at alpha 1), with the bias, stride and padding, and
    is counted; the plain version is not run."""
    seen = []
    monkeypatch.setattr(torch, "cudnn_convolution_relu",
                        lambda *a: seen.append(("relu", a)) or "relu")
    monkeypatch.setattr(torch, "cudnn_convolution_add_relu",
                        lambda *a: seen.append(("add_relu", a)) or "add")
    monkeypatch.setattr(conv_epilogue, "conv_bias_relu_ref",
                        lambda *a: pytest.fail("plain path on CUDA"))
    x = types.SimpleNamespace(is_cuda=True)
    z = object() if residual else None
    before = conv_epilogue.launches
    out = conv_epilogue.conv_bias_relu(x, "w", "b", (2, 2), (1, 1), z)
    assert conv_epilogue.launches == before + 1
    if residual:
        assert out == "add" and seen == [
            ("add_relu", (x, "w", z, 1.0, "b", (2, 2), (1, 1), (1, 1), 1))]
    else:
        assert out == "relu" and seen == [
            ("relu", (x, "w", "b", (2, 2), (1, 1), (1, 1), 1))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_conv_on_the_card(residual, dtype):
    """On a card: the fused convolution against the plain version,
    channels_last as the agent runs it: in f32 with TF32 off (float32
    rounding), and in bf16 (the bf16 encoder's) within four bf16 steps of
    the output's scale, the plain version rounding the convolution, the
    bias and the add each to bf16."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU: the fused convolution runs on a card only")
    dt = getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 4 * 2.0 ** -8
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        cl = torch.channels_last

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen,
                                        device="cuda")).to(dt)

        x = rand(8, 64, 18, 32).to(memory_format=cl)
        w = rand(128, 64, 3, 3, scale=0.05).to(memory_format=cl)
        b = rand(128)
        z = rand(8, 128, 9, 16).to(memory_format=cl) if residual else None
        got = conv_epilogue.conv_bias_relu(x, w, b, (2, 2), (1, 1), z)
        want = conv_epilogue.conv_bias_relu_ref(x, w, b, (2, 2), (1, 1), z)
        assert got.dtype == dt and got.shape == want.shape
        assert _rel(got, want) <= tol
    finally:
        torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.parametrize("kind", ["dilated", "grouped"])
def test_folded_conv_refuses_dilated_and_grouped_convolutions(kind):
    """The fused convolution runs undilated and ungrouped: a convolution
    that is neither is refused, not folded into a wrong one."""
    kw = dict(dilation=2) if kind == "dilated" else dict(groups=2)
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, bias=False, **kw)
    bn = BatchNorm2d(8).eval()
    with pytest.raises(ValueError, match="undilated, ungrouped"):
        resnet.FoldedConv.of(conv, bn)
