"""Headless ResNet backbones (stride 32, no pool/fc): resnet18/34 of
BasicBlocks, resnet50/101/152 of Bottlenecks.

PyTorch counterpart of cadre_tpu.models.resnet. Module names follow
torchvision and the reference's torch checkpoints (backbone.conv1,
backbone.layer1.0.conv1, backbone.layer1.0.downsample.0, ...). Torch
defaults already give what the JAX package's torch_compat helpers
emulate: symmetric integer padding and max pooling padded with -inf.
BatchNorm is `torch_compat.BatchNorm2d` (eps 1e-5, flax's running-variance
update in train mode).

The frozen copy that the RL agent runs on the card is `FoldedBackbone`:
every eval-mode BatchNorm folded into the convolution before it, and the
bias, the residual add and the ReLU run in the convolution's epilogue
(`ops/conv_epilogue.py`), so BatchNorm, the add and the ReLU make no pass
of their own over the maps. It holds no BatchNorm.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.fusion import fuse_conv_bn_weights

from cadre_tpu_torch.models.torch_compat import BatchNorm2d
from cadre_tpu_torch.ops.conv_epilogue import conv_bias_relu

_STAGE_PLANES = (64, 128, 256, 512)


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                         BatchNorm2d(planes))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = _downsample(inplanes, planes, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 at 4x the planes, as torchvision's v1.5
    (the stride on the 3x3)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = _downsample(inplanes, out, stride)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


def out_channels(arch: str) -> int:
    """Channels of the backbone's output map: 512 x the block's
    expansion."""
    return 512 * RESNET_SPECS[arch][0].expansion


class ResNetBackbone(nn.Module):
    """[B, Cin, H, W] -> [B, out_channels(arch), H/32, W/32]."""

    def __init__(self, in_channels: int, arch: str = "resnet18"):
        super().__init__()
        if arch not in RESNET_SPECS:
            raise ValueError(f"unknown backbone {arch!r}")
        self.arch = arch
        block, depths = RESNET_SPECS[arch]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=True)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip(_STAGE_PLANES, depths)):
            stride = 1 if stage == 0 else 2
            layers = []
            for b in range(blocks):
                layers.append(block(inplanes, planes, stride if b == 0 else 1))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def fold_batch_norm(conv: nn.Conv2d, bn: nn.BatchNorm2d
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval-mode BatchNorm after `conv` folded into it, in float64:
    (w * s, beta + (b - mean) * s) with s = gamma / sqrt(var + eps) per
    output channel (b = 0 for a convolution without a bias)."""
    def f64(t):
        return None if t is None else t.detach().double()

    weight, bias = fuse_conv_bn_weights(
        f64(conv.weight), f64(conv.bias), f64(bn.running_mean),
        f64(bn.running_var), bn.eps, f64(bn.weight), f64(bn.bias))
    return weight.detach(), bias.detach()


class FoldedConv(nn.Module):
    """A frozen convolution (undilated and ungrouped, as every one of the
    backbone's and DANetHead's is; others are refused) with its BatchNorm
    folded in, from the float64 fold rounded once to the convolution's
    dtype. With a bias it is
    relu(conv(x) + bias [+ z]) in one fused convolution (`conv_bias_relu`);
    without one (a downsample branch, whose folded bias the block's last
    convolution adds) the bare convolution."""

    def __init__(self, conv: nn.Conv2d, weight: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        if conv.dilation != (1, 1) or conv.groups != 1:
            raise ValueError("FoldedConv takes an undilated, ungrouped "
                             f"convolution, not dilation {conv.dilation}, "
                             f"groups {conv.groups}")
        dtype = conv.weight.dtype
        self.weight = nn.Parameter(weight.to(dtype), requires_grad=False)
        self.bias = None if bias is None else \
            nn.Parameter(bias.to(dtype), requires_grad=False)
        self.stride, self.padding = conv.stride, conv.padding

    @classmethod
    def of(cls, conv: nn.Conv2d, bn: nn.BatchNorm2d) -> "FoldedConv":
        return cls(conv, *fold_batch_norm(conv, bn))

    def forward(self, x: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.bias is None:
            return F.conv2d(x, self.weight, None, self.stride, self.padding)
        return conv_bias_relu(x, self.weight, self.bias, self.stride,
                              self.padding, z)


class FoldedBlock(nn.Module):
    """A BasicBlock or Bottleneck folded: conv1, conv2 (and conv3) as
    FoldedConvs, the last adding the identity before its ReLU. A
    downsample branch is its bare convolution; its folded bias joins the
    last convolution's."""

    def __init__(self, block: nn.Module):
        super().__init__()
        names = [n for n in ("conv1", "conv2", "conv3") if hasattr(block, n)]
        self.downsample = None
        carried = 0.0
        if block.downsample is not None:
            conv, bn = block.downsample
            weight, carried = fold_batch_norm(conv, bn)
            self.downsample = FoldedConv(conv, weight, None)
        for i, name in enumerate(names, 1):
            conv = getattr(block, name)
            weight, bias = fold_batch_norm(conv, getattr(block, f"bn{i}"))
            if i == len(names):
                bias = bias + carried
            setattr(self, name, FoldedConv(conv, weight, bias))
        self.convs = names

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = x
        for name in self.convs[:-1]:
            out = getattr(self, name)(out)
        return getattr(self, self.convs[-1])(out, identity)


class FoldedBackbone(nn.Module):
    """`ResNetBackbone` in eval mode, folded (module docstring): its stem
    and every block, under the same names, with no BatchNorm."""

    def __init__(self, backbone: ResNetBackbone):
        super().__init__()
        self.conv1 = FoldedConv.of(backbone.conv1, backbone.bn1)
        for stage in range(1, 5):
            blocks = getattr(backbone, f"layer{stage}")
            setattr(self, f"layer{stage}",
                    nn.Sequential(*[FoldedBlock(b) for b in blocks]))

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
