"""Headless ResNet backbone of the CoPM encoder (stride 32, no pool/fc).

PyTorch counterpart of cadre_tpu.models.resnet. Module names follow the
reference's torch checkpoints (backbone.conv1, backbone.layer1.0.conv1,
backbone.layer1.0.downsample.0, ...). Torch defaults already give what the
JAX package's torch_compat helpers emulate: symmetric integer padding,
max pooling padded with -inf, BatchNorm eps 1e-5.
"""
from __future__ import annotations

import torch
from torch import nn

_STAGE_PLANES = (64, 128, 256, 512)
RESNET_SPECS = {"resnet18": (2, 2, 2, 2)}


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class ResNetBackbone(nn.Module):
    """[B, Cin, H, W] -> [B, 512, H/32, W/32] (resnet18)."""

    def __init__(self, in_channels: int, arch: str = "resnet18"):
        super().__init__()
        if arch not in RESNET_SPECS:
            raise NotImplementedError(f"backbone {arch!r} is not ported")
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=True)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(
                zip(_STAGE_PLANES, RESNET_SPECS[arch])):
            stride = 1 if stage == 0 else 2
            layers = []
            for b in range(blocks):
                layers.append(BasicBlock(inplanes, planes,
                                         stride if b == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))
