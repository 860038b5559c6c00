"""CoPM encoder-decoder (DANet), in train and eval mode.

PyTorch counterpart of cadre_tpu.models.danet: ResNet18 -> DANetHead (PAM
and CAM through the fused dual-attention kernels on CUDA, forward and
backward) -> 1x1 visual/bc convs -> InterTaskAtt ('transformer',
'position' or 'invaild') -> the visual branch (decoders and light heads),
the bc head, the route-geometry head and the speed feature.

Module names follow the reference's torch checkpoints wherever
cadre_tpu.utils.checkpoint.import_danet_torch names them
(da_head.conv5a.0, inter_task_att.visual_query_layer.1,
visual_branch.reverse_feature.0, visual_branch.reverse_image.12,
visual_branch.reverse_lightState.5, bc_branch.bc_model.3,
in_bc_speed_fc.1, ...), so such a checkpoint loads with load_state_dict;
heads that importer does not name take the JAX module's name
(route_geom_branch.fc1, visual_fc1, visual_branch.reverse_lightDist.1,
inter_task_att.visual_gamma, ...).

Layouts: the public input is NHWC [B, H, W, Cin] like the JAX package's;
convolutions run NCHW (channels_last in memory where the caller moves the
module so); every flatten is NCHW order, the JAX `flatten_nchw`. The
forward returns the JAX dict: decoder maps NHWC [B, H, W, K] (views of
the NCHW results, free under channels_last), heads [B, K] or [B].

Train mode: BatchNorm uses the batch and folds flax's running statistics
(torch_compat.BatchNorm2d); DANetHead drops whole channels (Dropout2d(0.1),
scaled by 1/0.9) and 'transformer' drops attention weights
(where(keep, att / 0.9, 0)). The keep masks come in as `DropoutMasks`, so
a test can hand in the JAX draws, or are drawn from an explicit
torch.Generator (`draw_dropout_masks`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.models.resnet import ResNetBackbone
from cadre_tpu_torch.models.torch_compat import (
    LEAKY_SLOPE,
    BatchNorm2d,
    conv_transpose,
    flatten_nchw,
    leaky_relu,
    unflatten_nchw,
)
from cadre_tpu_torch.ops.dual_attention import (
    cam_apply,
    fused_dual_attention,
    pam_apply,
)

KEEP = 0.9                         # 1 - the reference's dropout rate 0.1
DECODER_DIMS = (512, 256, 128, 64, 32)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         BatchNorm2d(cout), nn.ReLU())


class DropoutMasks(NamedTuple):
    """Keep masks of one train-mode forward (True keeps):
    head [B, C/4] one value per channel of DANetHead's summed map;
    att_bc, att_visual [B, z, z] the 'transformer' attention weights of the
    cross that makes att_bc (visual queries) and att_visual (bc queries);
    None where the configuration has no such dropout."""

    head: torch.Tensor
    att_bc: Optional[torch.Tensor] = None
    att_visual: Optional[torch.Tensor] = None


def draw_dropout_masks(cfg: DANetParams, batch: int,
                       generator: Optional[torch.Generator] = None,
                       device="cpu") -> DropoutMasks:
    """Bernoulli(0.9) keep masks for one forward, drawn from `generator`
    (which must live on `device`)."""
    def keep(*shape):
        return torch.rand(*shape, generator=generator, device=device) < KEEP

    head = keep(batch, 512 // 4)
    if cfg.pred_bc and cfg.att_type == "transformer":
        z = cfg.z_dims
        return DropoutMasks(head, keep(batch, z, z), keep(batch, z, z))
    return DropoutMasks(head)


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
    the channel dropout (train mode) and a 1x1 conv to `out_channels`."""

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
        # index 0 is the reference's Dropout2d(0.1), which forward applies
        # itself with a given mask
        self.conv8 = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(inter, out_channels, 1))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
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
        feat = self.conv51(_nchw(sa)) + self.conv52(_nchw(sc))
        if self.training:
            feat = feat * mask[:, :, None, None].to(feat.dtype) / KEEP
        return self.conv8[1](feat)


def _qkv_mlp(in_dim: int, inter_dims: int, z_dims: int) -> nn.Sequential:
    return nn.Sequential(nn.Flatten(), nn.Linear(in_dim, inter_dims),
                         nn.LeakyReLU(LEAKY_SLOPE),
                         nn.Linear(inter_dims, z_dims))


class InterTaskAtt(nn.Module):
    """Cross-task attention between the visual and bc streams.

    'transformer' (production): per-task q/k/v MLPs to z_dims, z x z
    single-token cross attention at temperature sqrt(z), attention dropout
    in train mode, residual on v; returns [B, z] each.
    'position': 1x1 q/k/v convs, P x P spatial cross attention with a
    gamma-gated residual; returns NHWC maps [B, H, W, C] each.
    'invaild': the value MLPs alone (the "CoPM w/o att" ablation).
    """

    _NAMES = ("visual_query", "visual_key", "visual_value", "bc_query",
              "bc_key", "bc_value")

    def __init__(self, cfg: DANetParams):
        super().__init__()
        self.att_type = cfg.att_type
        c = cfg.da_feature_channel
        flat = c * cfg.feat_h * cfg.feat_w
        if cfg.att_type == "transformer":
            names = self._NAMES
        elif cfg.att_type == "invaild":
            names = ("visual_value", "bc_value")
        elif cfg.att_type == "position":
            for name in self._NAMES:
                setattr(self, name, nn.Conv2d(c, c, 1))
            self.visual_gamma = nn.Parameter(torch.zeros(1))
            self.bc_gamma = nn.Parameter(torch.zeros(1))
            return
        else:
            raise ValueError(f"unknown att_type {cfg.att_type!r}")
        for name in names:
            setattr(self, f"{name}_layer",
                    _qkv_mlp(flat, cfg.inter_att_dims, cfg.z_dims))
        self.temp = cfg.z_dims ** 0.5

    def _cross(self, q, k, v, mask):
        energy = (q / self.temp)[:, :, None] * k[:, None, :]
        att = torch.softmax(energy, dim=-1)
        if self.training:
            att = torch.where(mask, att / KEEP, torch.zeros_like(att))
        return torch.bmm(att, v[:, :, None])[:, :, 0] + v

    def _position(self, da_visual, da_bc):
        b, c, h, w = da_visual.shape

        def proj(x, name):
            return _nhwc(getattr(self, name)(x)).reshape(b, h * w, c)

        def cross(q, k, v, gamma, res):
            att = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1)
            out = torch.bmm(att, v).reshape(b, h, w, c)
            return gamma * out + _nhwc(res)

        att_bc = cross(proj(da_visual, "visual_query"),
                       proj(da_bc, "bc_key"), proj(da_bc, "bc_value"),
                       self.bc_gamma, da_bc)
        att_visual = cross(proj(da_bc, "bc_query"),
                           proj(da_visual, "visual_key"),
                           proj(da_visual, "visual_value"),
                           self.visual_gamma, da_visual)
        return att_visual, att_bc

    def forward(self, da_visual, da_bc,
                masks: Optional[DropoutMasks] = None):
        if self.att_type == "position":
            return self._position(da_visual, da_bc)
        if self.att_type == "invaild":
            return (self.visual_value_layer(da_visual),
                    self.bc_value_layer(da_bc))
        vq = self.visual_query_layer(da_visual)
        vk = self.visual_key_layer(da_visual)
        vv = self.visual_value_layer(da_visual)
        bq = self.bc_query_layer(da_bc)
        bk = self.bc_key_layer(da_bc)
        bv = self.bc_value_layer(da_bc)
        m_bc, m_visual = (masks.att_bc, masks.att_visual) if self.training \
            else (None, None)
        att_bc = self._cross(vq, bk, bv, m_bc)
        return self._cross(bq, vk, vv, m_visual), att_bc


def _stage_sizes(target: int, n_stages: int):
    """Spatial size after each transposed-conv stage, back-computed from
    the target by ceil-halving: 144 -> [9, 18, 36, 72, 144]."""
    sizes = []
    s = target
    for _ in range(n_stages):
        sizes.append(s)
        s = -(-s // 2)
    return sizes[::-1]


def reverse_decoder(cfg: DANetParams, out_channels: int,
                    sigmoid: bool = False) -> nn.Sequential:
    """One ConvTranspose pyramid [B, 512, feat_h, feat_w] -> [B, out, H, W]:
    512 -> 256 -> 128 -> 64 -> 32 -> out, each hidden stage ConvTranspose,
    BatchNorm, LeakyReLU (Sequential indices 0,1,3,4,6,7,9,10 and 12 hold
    weights, as in the reference's checkpoint). Each stage's output_padding
    is what reaches the next of `_stage_sizes`: (0, 1) for the first stage
    at 5x8 -> 9x16, (1, 1) after."""
    n = len(DECODER_DIMS)
    hs = _stage_sizes(cfg.image_height, n)
    ws = _stage_sizes(cfg.image_width, n)
    layers = []
    h_in, w_in = cfg.feat_h, cfg.feat_w
    for i in range(n):
        opad = (hs[i] - (2 * h_in - 1), ws[i] - (2 * w_in - 1))
        cout = DECODER_DIMS[i + 1] if i < n - 1 else out_channels
        layers.append(conv_transpose(DECODER_DIMS[i], cout, opad))
        if i < n - 1:
            layers += [BatchNorm2d(cout), nn.LeakyReLU(LEAKY_SLOPE)]
        h_in, w_in = hs[i], ws[i]
    if sigmoid:
        layers.append(nn.Sigmoid())
    return nn.Sequential(*layers)


def _head_mlp(in_dim: int, out_dim: int) -> nn.Sequential:
    """Flatten -> 256 -> 64 -> out with LeakyReLU (indices 1, 3, 5)."""
    return nn.Sequential(nn.Flatten(), nn.Linear(in_dim, 256),
                         nn.LeakyReLU(LEAKY_SLOPE), nn.Linear(256, 64),
                         nn.LeakyReLU(LEAKY_SLOPE), nn.Linear(64, out_dim))


# decoder attribute, output key, flag, output channels, sigmoid
def _decoders(cfg: DANetParams):
    return (
        ("reverse_image", "camera", True, cfg.camera_output_channel,
         not cfg.pred_camera_seg),
        ("reverse_route", "route", cfg.pred_route, 1, True),
    )


class VisualBranch(nn.Module):
    """z -> reverse_feature FC -> [B, 512, feat_h, feat_w] -> the decoders
    and light heads that the pred_* flags turn on."""

    def __init__(self, cfg: DANetParams):
        super().__init__()
        self.cfg = cfg
        flat = 512 * cfg.feat_h * cfg.feat_w
        self.reverse_feature = nn.Sequential(
            nn.Linear(cfg.z_dims, 512), nn.LeakyReLU(LEAKY_SLOPE),
            nn.Linear(512, flat))
        for attr, _, on, channels, sigmoid in _decoders(cfg):
            if on:
                setattr(self, attr, reverse_decoder(cfg, channels, sigmoid))
        if cfg.pred_light_state:
            self.reverse_lightState = _head_mlp(flat, cfg.light_classes_num)
        if cfg.pred_light_dist:
            self.reverse_lightDist = _head_mlp(flat, 1)

    def forward(self, z) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        feat = unflatten_nchw(self.reverse_feature(z), 512, cfg.feat_h,
                              cfg.feat_w)
        out: Dict[str, torch.Tensor] = {}
        for attr, key, on, _, _ in _decoders(cfg):
            if on:
                out[key] = getattr(self, attr)(feat).permute(0, 2, 3, 1)
        if cfg.pred_light_state:
            out["light_state"] = self.reverse_lightState(feat)
        if cfg.pred_light_dist:
            out["light_dist"] = self.reverse_lightDist(feat)
        return out


class BCBranch(nn.Module):
    """z -> z/2 -> 2 (steer, throttle); bc_model indices 1 and 3."""

    def __init__(self, z_dims: int):
        super().__init__()
        self.bc_model = nn.Sequential(
            nn.Flatten(), nn.Linear(z_dims, z_dims // 2),
            nn.LeakyReLU(LEAKY_SLOPE), nn.Linear(z_dims // 2, 2))

    def forward(self, z):
        return self.bc_model(z)


class RouteGeomBranch(nn.Module):
    """The PPO latent (visual ++ bc, before the speed feature) -> (dis,
    theta)."""

    def __init__(self, in_dim: int, z_dims: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, z_dims // 2)
        self.fc2 = nn.Linear(z_dims // 2, 2)

    def forward(self, z):
        return self.fc2(leaky_relu(self.fc1(z)))


class DANet(nn.Module):
    """The full CoPM encoder-decoder. `forward(x, bc_speed)` gives the JAX
    package's heads dict; `latent(x)` the PPO latent [B, 2 * z_dims] (the
    reference's get_latent_feature 'concate'); `bc_actions(x, bc_speed)`
    the bc head alone. In train mode each takes `masks` (DropoutMasks) or
    draws them from `generator`. `latent_only` builds the latent path
    alone (no decoders or heads: what the RL agent runs)."""

    def __init__(self, cfg: DANetParams, latent_only: bool = False):
        super().__init__()
        c = cfg.da_feature_channel
        self.cfg = cfg
        self.latent_only = latent_only
        self.backbone = ResNetBackbone(cfg.input_channel, cfg.backbone)
        self.da_head = DANetHead(512, c, cfg.use_fused_attention)
        self.visual_conv = nn.Conv2d(c, c, 1)
        if not latent_only:
            self.visual_branch = VisualBranch(cfg)
        if cfg.pred_bc:
            self.bc_conv = nn.Conv2d(c, c, 1)
            self.inter_task_att = InterTaskAtt(cfg)
            if not latent_only:
                self.bc_branch = BCBranch(cfg.z_dims)
            if cfg.in_bc_speed and not latent_only:
                self.in_bc_speed_fc = nn.Sequential(
                    nn.Flatten(), nn.Linear(1, 64),
                    nn.LeakyReLU(LEAKY_SLOPE), nn.Linear(64, cfg.z_dims))
        else:
            flat = c * cfg.feat_h * cfg.feat_w
            self.visual_fc1 = nn.Linear(flat, 1024)
            self.visual_fc2 = nn.Linear(1024, cfg.z_dims)
        if cfg.pred_route_geom and not latent_only:
            self.route_geom_branch = RouteGeomBranch(cfg.latent_dim,
                                                     cfg.z_dims)

    def _masks(self, x, masks, generator):
        if self.training and masks is None:
            return draw_dropout_masks(self.cfg, x.shape[0], generator,
                                      x.device)
        return masks

    def _zs(self, x, masks):
        """backbone -> dual-attention head -> per-task 1x1 convs ->
        (att_visual, att_bc); att_bc is None without the bc stream."""
        da = self.da_head(self.backbone(_nchw(x)),
                          masks.head if self.training else None)
        da_visual = self.visual_conv(da)
        if self.cfg.pred_bc:
            return self.inter_task_att(da_visual, self.bc_conv(da), masks)
        h = leaky_relu(self.visual_fc1(flatten_nchw(da_visual)))
        return self.visual_fc2(h), None

    def _speed(self, att_bc, bc_speed):
        if self.cfg.in_bc_speed and bc_speed is not None:
            return att_bc + self.in_bc_speed_fc(bc_speed.reshape(-1, 1))
        return att_bc

    def forward(self, x: torch.Tensor, bc_speed: Optional[torch.Tensor] = None,
                masks: Optional[DropoutMasks] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B, H, W, Cin] NHWC, bc_speed [B, 1] or None -> {camera,
        route, ... [B, H, W, K] NHWC; light_state [B, L]; steer, throttle
        [B]; route_geom [B, 2]} as the flags say."""
        cfg = self.cfg
        if cfg.att_type == "position":
            raise ValueError("att_type 'position' gives NHWC maps, which "
                             "the decoders and heads do not take (nor does "
                             "the JAX package's DANet.__call__); use latent")
        att_visual, att_bc = self._zs(x, self._masks(x, masks, generator))
        z_ppo = (torch.cat([att_visual, att_bc], dim=-1) if cfg.pred_bc
                 else att_visual)
        out = self.visual_branch(att_visual)
        if cfg.pred_bc:
            bc = self.bc_branch(self._speed(att_bc, bc_speed))
            out["steer"] = bc[:, 0]
            out["throttle"] = bc[:, 1]
        if cfg.pred_route_geom:
            out["route_geom"] = self.route_geom_branch(z_ppo)
        return out

    def latent(self, x: torch.Tensor, mode: str = "concate",
               masks: Optional[DropoutMasks] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        att_visual, att_bc = self._zs(x, self._masks(x, masks, generator))
        if not self.cfg.pred_bc:
            return att_visual
        if mode == "add":
            return att_visual + att_bc
        return torch.cat([att_visual, att_bc], dim=-1)

    def bc_actions(self, x: torch.Tensor,
                   bc_speed: Optional[torch.Tensor] = None,
                   masks: Optional[DropoutMasks] = None,
                   generator: Optional[torch.Generator] = None):
        """(steer, throttle), each [B]."""
        _, att_bc = self._zs(x, self._masks(x, masks, generator))
        bc = self.bc_branch(self._speed(att_bc, bc_speed))
        return bc[:, 0], bc[:, 1]
