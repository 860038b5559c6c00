"""Conditional imitation learning baselines (the counterpart of
cadre_tpu.models.cil): `CarlaNet` (the 8-conv CIL net), `CilrsNet` (a
ResNet trunk with measurement fusion), `UncertainNet` and `CilFinalNet`
(log-variance heads over CarlaNet), and `SmallCNN` (the DANet-free RL
encoder ablation).

Images are NHWC [B, H, W, C] and speed [B, 1]. The command branches are
evaluated densely and selected by a one-hot of the command, as the JAX
`Branches` does (a command outside [0, N) selects zeros). CarlaNet and
SmallCNN flatten their maps in NHWC order, as the JAX modules do, so
their Dense kernels convert without a permutation; the layers whose
input width depends on the image size take it at construction
(`image_hw`). CarlaNet's image FC drops 30% of its first layer's units in
train mode: the keep mask [B, 512] comes in as `masks` or is drawn from
`generator` (`draw_masks`), so a step can replay the JAX draws.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from cadre_tpu_torch.models.resnet import ResNetBackbone, out_channels
from cadre_tpu_torch.models.torch_compat import BatchNorm2d

CIL_DROPOUT = 0.3


class _FC(nn.Module):
    """Linear layers `fc{i}`, ReLU between; with `dropout`, the units
    after each hidden ReLU are dropped by the given keep masks (one per
    hidden layer) and scaled by 1 / (1 - dropout)."""

    def __init__(self, in_dim: int, neurons: Sequence[int],
                 dropout: float = 0.0):
        super().__init__()
        self.n, self.dropout = len(neurons), dropout
        for i, n in enumerate(neurons):
            setattr(self, f"fc{i}", nn.Linear(in_dim, n))
            in_dim = n

    def forward(self, x, masks: Optional[Sequence[torch.Tensor]] = None):
        for i in range(self.n):
            x = getattr(self, f"fc{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
                if self.training and self.dropout > 0:
                    keep = 1.0 - self.dropout
                    x = torch.where(masks[i], x / keep, torch.zeros_like(x))
        return x


class Branches(nn.Module):
    """`num_branches` FC stacks on the joint embedding; [B, N, out], or
    the command's row [B, out]."""

    def __init__(self, in_dim: int, num_branches: int,
                 neurons: Sequence[int]):
        super().__init__()
        self.num_branches = num_branches
        for i in range(num_branches):
            setattr(self, f"branch{i}", _FC(in_dim, neurons))

    def forward(self, j, command=None):
        stacked = torch.stack([getattr(self, f"branch{i}")(j)
                               for i in range(self.num_branches)], dim=1)
        if command is None:
            return stacked
        onehot = command.long()[:, None] == torch.arange(
            self.num_branches, device=stacked.device)
        return torch.einsum("bno,bn->bo", stacked, onehot.to(stacked.dtype))


_CARLA_CHANNELS = (32, 32, 64, 64, 128, 128, 256, 256)
_CARLA_STRIDES = (2, 1, 2, 1, 2, 1, 1, 1)


def _carla_hw(h: int, w: int) -> Tuple[int, int]:
    for i, s in enumerate(_CARLA_STRIDES):
        k = 5 if i == 0 else 3
        h, w = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    return h, w


class CarlaNet(nn.Module):
    """8 conv + BatchNorm + ReLU layers, an image FC (512, 512, dropout
    0.3), a speed FC (128, 128), a joint FC (512), command branches (256,
    256, out_dim) and a speed head (256, 256, 1) on the image embedding."""

    def __init__(self, in_channels: int = 3, image_hw=(144, 256),
                 num_branches: int = 4, out_dim: int = 3,
                 with_embeddings: bool = False):
        super().__init__()
        self.with_embeddings = with_embeddings
        cin = in_channels
        for i, (c, s) in enumerate(zip(_CARLA_CHANNELS, _CARLA_STRIDES)):
            k = 5 if i == 0 else 3
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, k, s, k // 2))
            setattr(self, f"bn{i}", BatchNorm2d(c))
            cin = c
        h, w = _carla_hw(*image_hw)
        self.img_fc = _FC(cin * h * w, (512, 512), dropout=CIL_DROPOUT)
        self.speed_fc = _FC(1, (128, 128))
        self.join_fc = _FC(512 + 128, (512,))
        self.branches = Branches(512, num_branches, (256, 256, out_dim))
        self.speed_branch = _FC(512, (256, 256, 1))

    def draw_masks(self, batch: int, generator=None, device="cpu"):
        """The image FC's keep mask, Bernoulli(0.7), as a 1-tuple."""
        return (torch.rand(batch, 512, generator=generator, device=device)
                >= CIL_DROPOUT,)

    def forward(self, image, speed, command=None, masks=None,
                generator=None):
        if self.training and masks is None:
            masks = self.draw_masks(image.shape[0], generator, image.device)
        x = image.permute(0, 3, 1, 2)
        for i in range(len(_CARLA_CHANNELS)):
            x = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"conv{i}")(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.img_fc(x, masks)
        j = self.join_fc(torch.cat([x, self.speed_fc(speed)], dim=-1))
        controls = self.branches(j, command)
        pred_speed = self.speed_branch(x)[..., 0]
        if self.with_embeddings:
            return controls, pred_speed, x, j
        return controls, pred_speed


class CilrsNet(nn.Module):
    """ResNet trunk, global average pool, perception FC (512),
    measurement FC (128, 128), joint FC (512), command branches and a
    speed head. No dropout."""

    def __init__(self, in_channels: int = 3, arch: str = "resnet34",
                 num_branches: int = 4, out_dim: int = 3):
        super().__init__()
        self.perception = ResNetBackbone(in_channels, arch)
        self.perception_fc = _FC(out_channels(arch), (512,))
        self.measurements_fc = _FC(1, (128, 128))
        self.join_fc = _FC(512 + 128, (512,))
        self.branches = Branches(512, num_branches, (256, 256, out_dim))
        self.speed_branch = _FC(512, (256, 256, 1))

    def draw_masks(self, batch: int, generator=None, device="cpu"):
        return None

    def forward(self, image, speed, command=None, masks=None,
                generator=None):
        feat = self.perception(image.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        x = self.perception_fc(feat)
        j = self.join_fc(torch.cat([x, self.measurements_fc(speed)], dim=-1))
        return self.branches(j, command), self.speed_branch(x)[..., 0]


class UncertainNet(nn.Module):
    """Log-variance heads over CarlaNet's embeddings: per-command control
    branches (structure 2) or one shared head tiled over the commands
    (structure 3), and a speed head on the image embedding."""

    def __init__(self, structure: int = 2, num_branches: int = 4,
                 out_dim: int = 3):
        super().__init__()
        if structure not in (2, 3):
            raise ValueError("structure must be 2 or 3")
        self.structure, self.num_branches = structure, num_branches
        if structure == 2:
            self.uncert_control_branches = Branches(
                512, num_branches, (256, 256, out_dim))
        else:
            self.uncert_control_shared = _FC(512, (256, 256, out_dim))
        self.uncert_speed_branch = _FC(512, (256, 256, 1))

    def forward(self, img_emb, emb, command=None):
        if self.structure == 2:
            log_var_control = self.uncert_control_branches(emb, command)
        else:
            log_var_control = self.uncert_control_shared(emb)
            if command is None:
                log_var_control = log_var_control[:, None, :].repeat(
                    1, self.num_branches, 1)
        return log_var_control, self.uncert_speed_branch(img_emb)[..., 0]


class CilFinalNet(nn.Module):
    """CarlaNet and UncertainNet: controls and speed with their
    log-variances."""

    def __init__(self, in_channels: int = 3, image_hw=(144, 256),
                 structure: int = 2, num_branches: int = 4,
                 out_dim: int = 3):
        super().__init__()
        self.carla_net = CarlaNet(in_channels, image_hw, num_branches,
                                  out_dim, with_embeddings=True)
        self.uncertain_net = UncertainNet(structure, num_branches, out_dim)

    def draw_masks(self, batch: int, generator=None, device="cpu"):
        return self.carla_net.draw_masks(batch, generator, device)

    def forward(self, image, speed, command=None, masks=None,
                generator=None):
        controls, pred_speed, img_emb, emb = self.carla_net(
            image, speed, command, masks, generator)
        log_var_control, log_var_speed = self.uncertain_net(img_emb, emb,
                                                            command)
        return controls, pred_speed, log_var_control, log_var_speed


class SmallCNN(nn.Module):
    """Three 4x4 stride-2 VALID convs (64, 32, 32) and two FC layers
    (512, z_dims), ReLU throughout."""

    def __init__(self, in_channels: int, image_hw, z_dims: int = 256):
        super().__init__()
        h, w = image_hw
        cin = in_channels
        for i, c in enumerate((64, 32, 32)):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, 4, 2))
            h, w, cin = (h - 4) // 2 + 1, (w - 4) // 2 + 1, c
        self.fc1 = nn.Linear(cin * h * w, 512)
        self.fc2 = nn.Linear(512, z_dims)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))
