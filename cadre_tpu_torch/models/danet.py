"""CoPM encoder (DANet) up to its PPO latent, in eval mode.

PyTorch counterpart of the latent path of cadre_tpu.models.danet:
ResNet18 -> DANetHead (PAM and CAM, through the fused dual-attention
kernel on CUDA) -> 1x1 visual/bc convs -> InterTaskAtt 'transformer' ->
[B, 2 * z_dims]. Module names follow the reference's torch checkpoints
(da_head.conv5a.0, da_head.sa.query_conv, inter_task_att.visual_query_layer.1,
...), so the latent subset of such a checkpoint loads with load_state_dict.
Convolutions run NCHW (channels_last in memory); the public input is NHWC
like the JAX package's, and the flatten before InterTaskAtt is NCHW order,
which is the JAX package's `flatten_nchw`.
"""
from __future__ import annotations

import torch
from torch import nn

from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.models.resnet import ResNetBackbone
from cadre_tpu_torch.ops.dual_attention import (
    cam_apply,
    fused_dual_attention,
    pam_apply,
)

LEAKY_SLOPE = 0.01


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU())


class PositionAttention(nn.Module):
    """PAM parameters: 1x1 q/k at C/8, v at C, gamma gate (zero at init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.query_conv = nn.Conv2d(dim, dim // 8, 1)
        self.key_conv = nn.Conv2d(dim, dim // 8, 1)
        self.value_conv = nn.Conv2d(dim, dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))


class ChannelAttention(nn.Module):
    """CAM parameters: the gamma gate only."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))


class DANetHead(nn.Module):
    """conv5a -> PAM -> conv51 and conv5c -> CAM -> conv52, summed, then
    (Dropout2d, inactive in eval) + 1x1 conv to `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_fused_attention=True):
        super().__init__()
        inter = in_channels // 4
        self.use_fused_attention = use_fused_attention
        self.conv5a = _conv_bn_relu(in_channels, inter)
        self.conv5c = _conv_bn_relu(in_channels, inter)
        self.sa = PositionAttention(inter)
        self.sc = ChannelAttention()
        self.conv51 = _conv_bn_relu(inter, inter)
        self.conv52 = _conv_bn_relu(inter, inter)
        self.conv8 = nn.Sequential(nn.Dropout2d(0.1),
                                   nn.Conv2d(inter, out_channels, 1))

    def forward(self, x):
        feat1 = self.conv5a(x)
        feat2 = self.conv5c(x)
        q = _nhwc(self.sa.query_conv(feat1))
        k = _nhwc(self.sa.key_conv(feat1))
        v = _nhwc(self.sa.value_conv(feat1))
        f1, f2 = _nhwc(feat1), _nhwc(feat2)
        if self.use_fused_attention is False:
            sa = pam_apply(f1, q, k, v, self.sa.gamma)
            sc = cam_apply(f2, self.sc.gamma)
        else:
            sa, sc = fused_dual_attention(f1, q, k, v, self.sa.gamma, f2,
                                          self.sc.gamma)
        sa = self.conv51(_nchw(sa))
        sc = self.conv52(_nchw(sc))
        return self.conv8(sa + sc)


def _qkv_mlp(in_dim: int, inter_dims: int, z_dims: int) -> nn.Sequential:
    return nn.Sequential(nn.Flatten(), nn.Linear(in_dim, inter_dims),
                         nn.LeakyReLU(LEAKY_SLOPE),
                         nn.Linear(inter_dims, z_dims))


class InterTaskAtt(nn.Module):
    """'transformer' cross-task attention: per-task q/k/v MLPs to z_dims,
    z x z single-token cross attention at temperature sqrt(z), residual on v
    (attention dropout is inactive in eval)."""

    _NAMES = ("visual_query", "visual_key", "visual_value", "bc_query",
              "bc_key", "bc_value")

    def __init__(self, cfg: DANetParams):
        super().__init__()
        if cfg.att_type != "transformer":
            raise NotImplementedError(
                f"InterTaskAtt {cfg.att_type!r} is not ported yet")
        flat = cfg.da_feature_channel * cfg.feat_h * cfg.feat_w
        for name in self._NAMES:
            setattr(self, f"{name}_layer",
                    _qkv_mlp(flat, cfg.inter_att_dims, cfg.z_dims))
        self.temp = cfg.z_dims ** 0.5

    def _cross(self, q, k, v):
        energy = (q / self.temp)[:, :, None] * k[:, None, :]
        att = torch.softmax(energy, dim=-1)
        return torch.bmm(att, v[:, :, None])[:, :, 0] + v

    def forward(self, da_visual, da_bc):
        vq = self.visual_query_layer(da_visual)
        vk = self.visual_key_layer(da_visual)
        vv = self.visual_value_layer(da_visual)
        bq = self.bc_query_layer(da_bc)
        bk = self.bc_key_layer(da_bc)
        bv = self.bc_value_layer(da_bc)
        return self._cross(bq, vk, vv), self._cross(vq, bk, bv)


class DANet(nn.Module):
    """The encoder's latent path: `latent(x)` maps [B, H, W, Cin] NHWC to
    [B, 2 * z_dims] (the reference's get_latent_feature 'concate')."""

    def __init__(self, cfg: DANetParams):
        super().__init__()
        if not cfg.pred_bc:
            raise NotImplementedError("DANet without the bc stream is not "
                                      "ported yet")
        c = cfg.da_feature_channel
        self.cfg = cfg
        self.backbone = ResNetBackbone(cfg.input_channel, cfg.backbone)
        self.da_head = DANetHead(512, c, cfg.use_fused_attention)
        self.visual_conv = nn.Conv2d(c, c, 1)
        self.bc_conv = nn.Conv2d(c, c, 1)
        self.inter_task_att = InterTaskAtt(cfg)

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        da = self.da_head(self.backbone(_nchw(x)))
        att_visual, att_bc = self.inter_task_att(self.visual_conv(da),
                                                 self.bc_conv(da))
        return torch.cat([att_visual, att_bc], dim=-1)
