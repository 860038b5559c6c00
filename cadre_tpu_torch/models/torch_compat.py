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
- `BatchNorm2d` / `BatchNorm1d`: flax's `nn.BatchNorm` (momentum 0.9,
  eps 1e-5) over NCHW maps / [B, F] vectors. It
  normalises a training batch by its biased variance, as torch does, but
  folds that same biased variance into the running variance, where
  `torch.nn.BatchNorm2d` folds the unbiased one. Running statistics after
  training then match the JAX trainer's. Eval mode is torch's.
  With a process group (`set_batch_norm_group`), a training batch is
  normalised by the statistics of every rank's batch, as flax's
  `nn.BatchNorm(axis_name=...)` normalises by its pmeaned statistics, and
  the biased variance over every rank's batch goes into the running
  variance. Flax pmeans E[x] and E[x^2] together and takes E[x^2] -
  E[x]^2, which cancels away digits in float32; here the mean is reduced
  first and then the mean squared deviation from it (two all_reduces;
  the same value in exact arithmetic). The backward all-reduces the two
  sums through which every rank's gradient reaches the shared
  statistics. Both directions compute in float64 and round their output
  once: in float32 the statistics' sums and the cancelling terms of the
  input gradient round enough to move the first layers' and the
  decoders' gradients by a percent on the card. (`torch.nn.SyncBatchNorm` keeps an unbiased running
  variance and takes CUDA tensors only, so it is not this.)
"""
from __future__ import annotations

import torch
import torch.distributed as dist
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


class _CrossReplicaBatchNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias over the batch of
    every rank of `group`; returns (y, mean, var), the statistics
    detached. It computes in float64 and rounds y and dx once to x's
    dtype (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        dims = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        world = dist.get_world_size(group)
        x64 = x.double()
        mean = x64.mean(dims)
        dist.all_reduce(mean, group=group)
        mean /= world
        centred = x64 - mean.view(shape)
        var = (centred * centred).mean(dims)
        dist.all_reduce(var, group=group)
        var /= world
        invstd = torch.rsqrt(var + eps)
        y = centred * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.dims, ctx.shape = group, dims, shape
        ctx.count = world * (x.numel() // x.shape[1])
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        dy64 = dy.double()
        xhat = (x.double() - mean.view(shape)) * invstd.view(shape)
        sums = torch.stack([dy64.sum(dims), (dy64 * xhat).sum(dims)])
        grad_bias, grad_weight = sums.to(dy.dtype, copy=True)  # this rank's
        dist.all_reduce(sums, group=ctx.group)           # every rank's
        sum_dy, sum_dy_xhat = sums / ctx.count
        dx = (dy64 - sum_dy.view(shape) - xhat * sum_dy_xhat.view(shape)) \
            * (weight * invstd).view(shape)
        return dx.to(dy.dtype), grad_weight, grad_bias, None, None


def _flax_batch_norm(bn, x: torch.Tensor) -> torch.Tensor:
    """Train mode: normalise by the batch's statistics over every axis but
    the channel axis 1 (every rank's batch when bn.group is set), folding
    its biased variance into running_var."""
    m = bn.momentum
    if bn.group is not None:
        y, mean, var = _CrossReplicaBatchNorm.apply(x, bn.weight, bn.bias,
                                                    bn.eps, bn.group)
    else:
        with torch.no_grad():
            dims = (0,) + tuple(range(2, x.dim()))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
        y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                         bn.eps)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
        bn.num_batches_tracked.add_(1)
    return y


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW maps with flax's running-variance update (the
    biased batch variance); see the module docstring."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over [B, F] features (flax's nn.BatchNorm on a vector),
    with flax's running-variance update."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x)


def set_batch_norm_group(model: nn.Module, group) -> None:
    """Give every BatchNorm of `model` the process group whose ranks'
    batches its training statistics span (None: this batch alone)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, BatchNorm1d)):
            m.group = group
