"""The VAE family of the perception zoo (the counterpart of
cadre_tpu.models.vae).

- `VanillaVAE`: a stride-2 conv pyramid (`ConvEncoder`) -> mu / logvar
  MLPs -> the DANet decoder bank (`VisualBranch`) and, with pred_bc, the bc
  head. `BetaVAE` is the same with a reparameterised z.
- `DABetaVAE`: the DANet trunk (ResNet -> `DANetHead`, whose PAM + CAM run
  the dual-attention kernels on the card, forward and backward) -> 1x1
  convs -> mu / logvar MLPs per stream -> decoders and bc head.
- `OldVAE` / `OldV2VAE`: the pre-mode-system VAEs: per-modality conv stems
  (`OldStem`) -> mu / logvar -> small deconv heads (`OldDeconv`).

Every model takes NHWC input [B, H, W, Cin] and returns the heads dict of
the perception losses, with "mu" and "logvar" (and "bc_mu", "bc_logvar").
`forward(x, masks=None, generator=None)` reparameterises z = mu + sigma *
eps only when given a generator (BetaVAE, DABetaVAE, the old VAEs), as
the JAX modules do only when given `rng`; the JAX trainer passes none, so
its zoo VAEs train on z = mu, and so does the port's. DABetaVAE's head
drops whole channels in train mode with `masks.head` (a `DropoutMasks`),
drawn from the generator (or torch's global one) when none is given.
Flattened maps follow `flatten_nchw` order, so the flax Dense kernels
convert without a permutation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from cadre_tpu_torch.configs.danet_config import DANetParams
from cadre_tpu_torch.models.danet import (
    KEEP,
    BCBranch,
    DANetHead,
    DropoutMasks,
    VisualBranch,
    _nchw,
)
from cadre_tpu_torch.models.resnet import ResNetBackbone, out_channels
from cadre_tpu_torch.models.torch_compat import (
    BatchNorm2d,
    flatten_nchw,
    leaky_relu,
    unflatten_nchw,
)

Heads = Dict[str, torch.Tensor]


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _reparameterise(mu, logvar, generator):
    if generator is None:
        return mu
    eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps


def _add_gaussian_heads(owner: nn.Module, prefix: str, in_dim: int,
                        hidden: int, z: int) -> None:
    """Linear -> LeakyReLU -> Linear for mu and for logvar, as the owner's
    `{prefix}mu_1`, `{prefix}mu_2`, `{prefix}var_1`, `{prefix}var_2` (the
    flax names)."""
    for kind in ("mu", "var"):
        setattr(owner, f"{prefix}{kind}_1", nn.Linear(in_dim, hidden))
        setattr(owner, f"{prefix}{kind}_2", nn.Linear(hidden, z))


def _gaussian(owner: nn.Module, prefix: str, h: torch.Tensor):
    mu = getattr(owner, f"{prefix}mu_2")(
        leaky_relu(getattr(owner, f"{prefix}mu_1")(h)))
    logvar = getattr(owner, f"{prefix}var_2")(
        leaky_relu(getattr(owner, f"{prefix}var_1")(h)))
    return mu, logvar


class ConvEncoder(nn.Module):
    """Stride-2 3x3 conv + BatchNorm + LeakyReLU per hidden width:
    [B, Cin, H, W] -> [B, 512, H/16, W/16]."""

    def __init__(self, in_channels: int, hidden_dims=(64, 128, 256, 512)):
        super().__init__()
        self.depth = len(hidden_dims)
        cin = in_channels
        for i, h in enumerate(hidden_dims):
            setattr(self, f"enc{i}_conv", nn.Conv2d(cin, h, 3, 2, 1,
                                                    bias=False))
            setattr(self, f"enc{i}_bn", BatchNorm2d(h))
            cin = h

    def forward(self, x):
        for i in range(self.depth):
            x = leaky_relu(getattr(self, f"enc{i}_bn")(
                getattr(self, f"enc{i}_conv")(x)))
        return x


class VanillaVAE(nn.Module):
    """ConvEncoder -> mu / logvar (512 hidden) -> VisualBranch (+ bc)."""

    variational = False

    def __init__(self, cfg: DANetParams):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(cfg.input_channel)
        h, w = cfg.image_height, cfg.image_width
        for _ in range(self.encoder.depth):
            h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
        flat = 512 * h * w
        _add_gaussian_heads(self, "fc_", flat, 512, cfg.z_dims)
        self.visual_branch = VisualBranch(cfg)
        if cfg.pred_bc:
            self.bc_branch = BCBranch(cfg.z_dims)

    def encode(self, x):
        h = flatten_nchw(self.encoder(_nchw(x)))
        return _gaussian(self, "fc_", h)

    def forward(self, x, masks: Optional[DropoutMasks] = None,
                generator: Optional[torch.Generator] = None) -> Heads:
        mu, logvar = self.encode(x)
        z = _reparameterise(mu, logvar,
                            generator if self.variational else None)
        out = self.visual_branch(z)
        out["mu"] = mu
        out["logvar"] = logvar
        if self.cfg.pred_bc:
            bc = self.bc_branch(z)
            out["steer"] = bc[:, 0]
            out["throttle"] = bc[:, 1]
        return out

    def latent(self, x):
        return self.encode(x)[0]


class BetaVAE(VanillaVAE):
    """VanillaVAE with z reparameterised (when given a generator); the
    beta weighting lives in the loss."""

    variational = True


class DABetaVAE(nn.Module):
    """The DANet trunk with mu / logvar heads per task stream."""

    def __init__(self, cfg: DANetParams):
        super().__init__()
        self.cfg = cfg
        c = cfg.da_feature_channel
        flat = c * cfg.feat_h * cfg.feat_w
        self.backbone = ResNetBackbone(cfg.input_channel, cfg.backbone)
        self.da_head = DANetHead(out_channels(cfg.backbone), c,
                                 cfg.use_fused_attention)
        self.visual_conv = nn.Conv2d(c, c, 1)
        _add_gaussian_heads(self, "visual_", flat, cfg.inter_att_dims,
                            cfg.z_dims)
        self.visual_branch = VisualBranch(cfg)
        if cfg.pred_bc:
            self.bc_conv = nn.Conv2d(c, c, 1)
            _add_gaussian_heads(self, "bc_", flat, cfg.inter_att_dims,
                                cfg.z_dims)
            self.bc_branch = BCBranch(cfg.z_dims)

    def draw_masks(self, batch: int, generator=None,
                   device="cpu") -> DropoutMasks:
        """The head's Bernoulli(0.9) channel keep mask [B, C/4]."""
        channels = out_channels(self.cfg.backbone) // 4
        return DropoutMasks(torch.rand(batch, channels, generator=generator,
                                       device=device) < KEEP)

    def _heads(self, x, masks, generator):
        if self.training and masks is None:
            masks = self.draw_masks(x.shape[0], generator, x.device)
        da = self.da_head(self.backbone(_nchw(x)),
                          masks.head if self.training else None)
        v_mu, v_logvar = _gaussian(self, "visual_",
                                   flatten_nchw(self.visual_conv(da)))
        if not self.cfg.pred_bc:
            return v_mu, v_logvar, None, None
        b_mu, b_logvar = _gaussian(self, "bc_",
                                   flatten_nchw(self.bc_conv(da)))
        return v_mu, v_logvar, b_mu, b_logvar

    def forward(self, x, masks: Optional[DropoutMasks] = None,
                generator: Optional[torch.Generator] = None) -> Heads:
        v_mu, v_logvar, b_mu, b_logvar = self._heads(x, masks, generator)
        out = self.visual_branch(_reparameterise(v_mu, v_logvar, generator))
        out["mu"] = v_mu
        out["logvar"] = v_logvar
        if self.cfg.pred_bc:
            bc = self.bc_branch(_reparameterise(b_mu, b_logvar, generator))
            out["steer"] = bc[:, 0]
            out["throttle"] = bc[:, 1]
            out["bc_mu"] = b_mu
            out["bc_logvar"] = b_logvar
        return out

    def latent(self, x, mode: str = "concate",
               masks: Optional[DropoutMasks] = None,
               generator: Optional[torch.Generator] = None):
        v_mu, _, b_mu, _ = self._heads(x, masks, generator)
        if b_mu is None:
            return v_mu
        if mode == "add":
            return v_mu + b_mu
        return torch.cat([v_mu, b_mu], dim=-1)


# the old stems' (out channels, kernel, stride, padding), LeakyReLU between
_OLD_STEM = ((32, 5, 2, 5), (64, 3, 2, 3), (64, 3, 2, 3), (64, 3, 2, 3))


class OldStem(nn.Module):
    """Four stride-2 convs, LeakyReLU between: 144x256 -> 64 x 13x20."""

    def __init__(self, in_channels: int):
        super().__init__()
        cin = in_channels
        for i, (c, k, s, p) in enumerate(_OLD_STEM):
            setattr(self, f"conv{i}", nn.Conv2d(cin, c, k, s, p))
            cin = c

    @staticmethod
    def flat_size(h: int, w: int) -> int:
        for _, k, s, p in _OLD_STEM:
            h, w = _conv_out(h, k, s, p), _conv_out(w, k, s, p)
        return _OLD_STEM[-1][0] * h * w

    def forward(self, x):
        for i in range(len(_OLD_STEM)):
            x = getattr(self, f"conv{i}")(x)
            if i < len(_OLD_STEM) - 1:
                x = leaky_relu(x)
        return x


class OldDeconv(nn.Module):
    """z -> fc 1024 -> fc to [B, 64, 9, 16] -> four ConvTranspose(4,
    stride 2, padding 1) stages to 144x256 (NCHW out)."""

    def __init__(self, z_dims: int, out_channels: int,
                 use_sigmoid: bool = False):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.fc1 = nn.Linear(z_dims, 1024)
        self.fc2 = nn.Linear(1024, 64 * 9 * 16)
        cin = 64
        for i, c in enumerate((64, 64, 32, out_channels)):
            setattr(self, f"deconv{i}", nn.ConvTranspose2d(cin, c, 4, 2, 1))
            cin = c

    def forward(self, z):
        h = leaky_relu(self.fc2(leaky_relu(self.fc1(z))))
        h = unflatten_nchw(h, 64, 9, 16)
        for i in range(3):
            h = leaky_relu(getattr(self, f"deconv{i}")(h))
        h = self.deconv3(h)
        return torch.sigmoid(h) if self.use_sigmoid else h


class OldVAE(nn.Module):
    """rgb stem (+ a stem over the other input planes) -> fc 1024 -> mu /
    logvar -> a deconv camera head (sigmoid rgb recon in v1; the camera
    channels of the config, with a route head and a light-state MLP where
    the config predicts them, in v2)."""

    v2 = False

    def __init__(self, cfg: DANetParams):
        super().__init__()
        self.cfg = cfg
        flat = OldStem.flat_size(cfg.image_height, cfg.image_width)
        self.rgb_stem = OldStem(3)
        self.aux_channels = max(cfg.input_channel - 3, 0)
        if self.aux_channels:
            self.aux_stem = OldStem(self.aux_channels)
        in_dim = flat * (2 if self.aux_channels else 1)
        _add_gaussian_heads(self, "fc_", in_dim, 1024, cfg.z_dims)
        out_ch = cfg.camera_output_channel if self.v2 else 3
        self.camera_head = OldDeconv(cfg.z_dims, out_ch,
                                     use_sigmoid=not self.v2)
        if self.v2 and cfg.pred_route:
            self.route_head = OldDeconv(cfg.z_dims, 1, use_sigmoid=True)
        if self.v2 and cfg.pred_light_state:
            self.light_fc_1 = nn.Linear(cfg.z_dims, 64)
            self.light_fc_2 = nn.Linear(64, cfg.light_classes_num)

    def encode(self, x):
        x = _nchw(x)
        h = flatten_nchw(self.rgb_stem(x[:, :3]))
        if self.aux_channels:
            h = torch.cat([h, flatten_nchw(self.aux_stem(x[:, 3:]))], dim=-1)
        return _gaussian(self, "fc_", h)

    def forward(self, x, masks: Optional[DropoutMasks] = None,
                generator: Optional[torch.Generator] = None) -> Heads:
        cfg = self.cfg
        mu, logvar = self.encode(x)
        z = _reparameterise(mu, logvar, generator)
        out = {"camera": self.camera_head(z).permute(0, 2, 3, 1),
               "mu": mu, "logvar": logvar}
        if self.v2 and cfg.pred_route:
            out["route"] = self.route_head(z).permute(0, 2, 3, 1)
        if self.v2 and cfg.pred_light_state:
            out["light_state"] = self.light_fc_2(
                leaky_relu(self.light_fc_1(z)))
        return out

    def latent(self, x):
        return self.encode(x)[0]


class OldV2VAE(OldVAE):
    """The config-driven multi-head variant (oldv2_vae)."""

    v2 = True
