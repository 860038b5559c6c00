"""Headless ResNet backbones (stride 32, no pool/fc): resnet18/34 of
BasicBlocks, resnet50/101/152 of Bottlenecks.

PyTorch counterpart of cadre_tpu.models.resnet. Module names follow
torchvision and the reference's torch checkpoints (backbone.conv1,
backbone.layer1.0.conv1, backbone.layer1.0.downsample.0, ...). Torch
defaults already give what the JAX package's torch_compat helpers
emulate: symmetric integer padding and max pooling padded with -inf.
BatchNorm is `torch_compat.BatchNorm2d` (eps 1e-5, flax's running-variance
update in train mode).
"""
from __future__ import annotations

import torch
from torch import nn

from cadre_tpu_torch.models.torch_compat import BatchNorm2d

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
