"""LBC-style waypoint models (the counterpart of cadre_tpu.models.lbc):
the seg-class LUTs, the target heatmap stamp (`to_heatmap`), the soft
argmax (`spatial_softmax`), `SegmentationModel` (a ResNet trunk, a
dilated-conv head and a bilinear resize of its logits to the input size),
`RawController`, the pinhole `Converter`, and `MapModel` / `ImageModel`.

Maps and heatmaps are NHWC as in the JAX package ([B, H, W, C]); points
are [B, n, 2] pixel or [-1, 1] coordinates. The bilinear resize is
`F.interpolate(mode="bilinear", align_corners=False)`: the same half-pixel
sample positions as `jax.image.resize(..., "bilinear")`, and at the
borders, where JAX drops the taps outside the map and renormalises the
rest, torch clamps the outside tap onto the edge pixel: both give the
edge pixel its whole weight.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cadre_tpu_torch.models.resnet import ResNetBackbone, out_channels
from cadre_tpu_torch.models.torch_compat import BatchNorm1d, BatchNorm2d

# CARLA semantic-seg class reduction and display palette
SEG_CONVERTER = np.uint8(
    [0, 0, 0, 0, 1, 0, 2, 3, 4, 0, 5, 0, 0, 6, 7, 8])
SEG_COLOR = np.uint8([
    (0, 0, 0),        # unlabeled
    (220, 20, 60),    # ped
    (157, 234, 50),   # road line
    (128, 64, 128),   # road
    (244, 35, 232),   # sidewalk
    (0, 0, 142),      # car
    (255, 0, 0),
    (255, 255, 0),
    (0, 255, 0),
])


def to_heatmap(points: torch.Tensor, h: int, w: int,
               radius: int = 5) -> torch.Tensor:
    """A Gaussian stamp exp(-d^2 / 2r^2), min-max normalised over its
    (2r+1)^2 window and zero outside it, at each sample's rounded pixel
    [B, 2] (x, y) -> [B, h, w]."""
    cx = torch.clamp(torch.round(points[:, 0]), 0, w - 1)[:, None, None]
    cy = torch.clamp(torch.round(points[:, 1]), 0, h - 1)[:, None, None]
    ys = torch.arange(h, dtype=points.dtype, device=points.device)[None, :,
                                                                   None]
    xs = torch.arange(w, dtype=points.dtype, device=points.device)[None,
                                                                   None, :]
    dx, dy = xs - cx, ys - cy
    k = torch.exp(-(dx * dx + dy * dy) / (2.0 * radius * radius))
    kmin = math.exp(-1.0)          # the window's corner, d^2 = 2 r^2
    val = (k - kmin) / (1.0 - kmin)
    inside = (dx.abs() <= radius) & (dy.abs() <= radius)
    return torch.where(inside, val, torch.zeros_like(val))


def spatial_softmax(logit: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """[B, H, W, C] -> soft-argmax coordinates [B, C, 2] in [-1, 1]."""
    b, h, w, c = logit.shape
    weights = torch.softmax(logit.reshape(b, h * w, c) / temperature,
                            dim=1).reshape(b, h, w, c)
    xs = torch.linspace(-1.0, 1.0, w, dtype=logit.dtype, device=logit.device)
    ys = torch.linspace(-1.0, 1.0, h, dtype=logit.dtype, device=logit.device)
    x = torch.einsum("bhwc,w->bc", weights, xs)
    y = torch.einsum("bhwc,h->bc", weights, ys)
    return torch.stack([x, y], dim=-1)


class SegmentationModel(nn.Module):
    """Input BatchNorm, a ResNet trunk, a 1x1 conv plus 3x3 convs at
    dilation 2 and 4 (summed), BatchNorm + ReLU, a 1x1 conv to n_steps
    logit maps resized to the input, and their soft argmax."""

    def __init__(self, in_channels: int, n_steps: int = 4,
                 arch: str = "resnet18", temperature: float = 1.0,
                 input_norm: bool = True):
        super().__init__()
        self.temperature = temperature
        if input_norm:
            self.input_bn = BatchNorm2d(in_channels)
        self.backbone = ResNetBackbone(in_channels, arch)
        c = out_channels(arch)
        self.head_1x1 = nn.Conv2d(c, 256, 1)
        for rate in (2, 4):
            setattr(self, f"head_d{rate}",
                    nn.Conv2d(c, 256, 3, padding=rate, dilation=rate))
        self.head_bn = BatchNorm2d(256)
        self.out_conv = nn.Conv2d(256, n_steps, 1)

    def forward(self, x, heatmap: bool = False):
        """x [B, H, W, Cin] -> waypoints [B, n_steps, 2] (and the logit
        maps [B, H, W, n_steps] with heatmap=True)."""
        h, w = x.shape[1], x.shape[2]
        x = x.permute(0, 3, 1, 2)
        if hasattr(self, "input_bn"):
            x = self.input_bn(x)
        feat = self.backbone(x)
        head = self.head_1x1(feat) + self.head_d2(feat) + self.head_d4(feat)
        logit = self.out_conv(torch.relu(self.head_bn(head)))
        logit = F.interpolate(logit, size=(h, w), mode="bilinear",
                              align_corners=False).permute(0, 2, 3, 1)
        y = spatial_softmax(logit, self.temperature)
        return (y, logit) if heatmap else y


class RawController(nn.Module):
    """Waypoints [B, n, 2] -> (steer, speed): BatchNorm and a Linear of k
    units (ReLU) twice, BatchNorm, a Linear to 2."""

    def __init__(self, in_features: int, k: int = 32):
        super().__init__()
        self.bn0 = BatchNorm1d(in_features)
        self.fc0 = nn.Linear(in_features, k)
        self.bn1 = BatchNorm1d(k)
        self.fc1 = nn.Linear(k, k)
        self.bn2 = BatchNorm1d(k)
        self.fc2 = nn.Linear(k, 2)

    def forward(self, points):
        x = points.reshape(points.shape[0], -1)
        x = torch.relu(self.fc0(self.bn0(x)))
        x = torch.relu(self.fc1(self.bn1(x)))
        return self.fc2(self.bn2(x))


PIXELS_PER_WORLD = 5.5
CAM_HEIGHT = 1.3


@dataclasses.dataclass(frozen=True)
class Converter:
    """Pinhole camera <-> topdown-map coordinates; points are tensors
    [..., 2]."""

    w: int = 256
    h: int = 144
    fov: float = 90.0
    map_size: int = 256
    pixels_per_world: float = PIXELS_PER_WORLD
    hack: float = 0.4
    cam_height: float = CAM_HEIGHT

    @property
    def fy(self) -> float:
        return self.w / (2.0 * math.tan(self.fov * math.pi / 360.0))

    @property
    def fx(self) -> float:
        return 1.1 * self.fy

    def _position(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor([self.map_size // 2, self.map_size + 1],
                            dtype=like.dtype, device=like.device)

    def map_to_world(self, pix):
        rel = pix - self._position(pix)
        return torch.stack([rel[..., 0], -rel[..., 1]], dim=-1) \
            / self.pixels_per_world

    def world_to_map(self, world):
        pix = world * self.pixels_per_world
        return torch.stack([pix[..., 0], -pix[..., 1]], dim=-1) \
            + self._position(world)

    def cam_to_world(self, points):
        z = (self.fy * self.cam_height) / (points[..., 1] - self.h / 2)
        x = (points[..., 0] - self.w / 2) * (z / self.fx)
        return torch.stack([x, z - self.hack], dim=-1)

    def world_to_cam(self, world):
        """Clamped to the image: points near or behind the camera plane
        would otherwise project far outside it."""
        z = world[..., 1] + self.hack
        u = torch.clamp(world[..., 0] * self.fx / z + self.w / 2, 0,
                        self.w - 1)
        v = torch.clamp(self.fy * self.cam_height / z + self.h / 2, 0,
                        self.h - 1)
        return torch.stack([u, v], dim=-1)

    def map_to_cam(self, pix):
        return self.world_to_cam(self.map_to_world(pix))

    def cam_to_map(self, points):
        return self.world_to_map(self.cam_to_world(points))


class _WaypointModel(nn.Module):
    """A map (topdown or camera) and a target point's heatmap ->
    n waypoints (and actions)."""

    def __init__(self, in_channels: int, n_steps: int, heatmap_radius: int,
                 temperature: float, arch: str):
        super().__init__()
        self.heatmap_radius = heatmap_radius
        self.net = SegmentationModel(in_channels + 1, n_steps, arch,
                                     temperature)
        self.controller = RawController(2 * n_steps)

    def forward(self, image, target, with_actions: bool = False):
        hm = to_heatmap(target, image.shape[1], image.shape[2],
                        self.heatmap_radius)[..., None]
        points = self.net(torch.cat([image, hm], dim=-1))
        if not with_actions:
            return points
        return points, self.controller(points)


class MapModel(_WaypointModel):
    """Topdown birdview [B, H, W, topdown_channels] and a target pixel ->
    waypoints in [-1, 1] map coordinates."""

    def __init__(self, n_steps: int = 4, topdown_channels: int = 10,
                 heatmap_radius: int = 5, temperature: float = 1.0,
                 arch: str = "resnet18"):
        super().__init__(topdown_channels, n_steps, heatmap_radius,
                         temperature, arch)


class ImageModel(_WaypointModel):
    """Camera frame [B, H, W, 3] and a target in camera pixels ->
    camera-space waypoints (distilled from a MapModel through
    `Converter.cam_to_map`)."""

    def __init__(self, n_steps: int = 4, heatmap_radius: int = 5,
                 temperature: float = 1.0, arch: str = "resnet18"):
        super().__init__(3, n_steps, heatmap_radius, temperature, arch)
