"""Layers whose semantics the JAX package emulates in flax, given here in
PyTorch (the counterpart of cadre_tpu.models.torch_compat).

- `leaky_relu` with torch's default slope 0.01.
- `flatten_nchw` / `unflatten_nchw`: the JAX package keeps maps NHWC and
  flattens them in NCHW element order; the port's maps are NCHW, so both
  are plain reshapes here.
- `conv_transpose`: `nn.ConvTranspose2d(k=3, stride=2, padding=1,
  output_padding=...)`, whose semantics the JAX package's
  `conv_transpose_torch` reproduces (its HWIO kernel is torch's
  [I, O, kh, kw] transposed, not flipped).
- `BatchNorm2d`: flax's `nn.BatchNorm` (momentum 0.9, eps 1e-5). It
  normalises a training batch by its biased variance, as torch does, but
  folds that same biased variance into the running variance, where
  `torch.nn.BatchNorm2d` folds the unbiased one. Running statistics after
  training then match the JAX trainer's. Eval mode is torch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
BN_MOMENTUM = 0.1           # torch's convention: flax's momentum is 0.9


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


def flatten_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*H*W] in NCHW order (the JAX `flatten_nchw` of
    the same map held NHWC)."""
    return x.reshape(x.shape[0], -1)


def unflatten_nchw(x: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    """Inverse of flatten_nchw: [B, C*H*W] -> [B, C, H, W]."""
    return x.reshape(x.shape[0], c, h, w)


def conv_transpose(cin: int, cout: int, output_padding) -> nn.ConvTranspose2d:
    """One decoder stage: 3x3, stride 2, padding 1, the given
    output_padding (rows and columns added at the bottom and right)."""
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                              output_padding=output_padding)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW maps with flax's running-variance update (the
    biased batch variance); see the module docstring."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)
