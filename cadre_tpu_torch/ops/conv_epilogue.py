"""A convolution with its bias, a residual add and the ReLU in its
epilogue: relu(conv2d(x, w) + bias [+ z]), the frozen encoder's every
convolution that a ReLU follows once its BatchNorm is folded in
(`models/resnet.py` `FoldedConv`).

Unfused, PyTorch runs the bias, the residual add and the ReLU as passes of
their own over the convolution's output (a cuDNN convolution's bias is a
separate `add_`), each a full read and write of an f32 map at the
rollout's batch. Fused, each output is written once, by the convolution,
and read once, by the next one. For CUDA tensors `conv_bias_relu` runs
cuDNN's fused convolution (`torch.cudnn_convolution_relu`, and
`torch.cudnn_convolution_add_relu` with the residual), which follows
`torch.backends.cudnn.allow_tf32` as `F.conv2d` does; for CPU tensors
`conv_bias_relu_ref`, the plain version. The JAX package has no such
kernel: XLA fuses these epilogues itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

launches = 0                # fused convolutions run (`conv_bias_relu`)


def conv_bias_relu_ref(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, stride: Tuple[int, int],
                       padding: Tuple[int, int],
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: relu(conv2d(x, weight, bias) [+ z])."""
    y = F.conv2d(x, weight, bias, stride, padding)
    if z is not None:
        y = y + z
    return torch.relu(y)


def conv_bias_relu(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, stride: Tuple[int, int],
                   padding: Tuple[int, int],
                   z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(conv2d(x, weight) + bias [+ z]): x [B, Cin, H, W], weight
    [Cout, Cin, kh, kw], bias [Cout], z the output's shape. The fused
    convolution on CUDA tensors, the plain version on CPU tensors."""
    if not x.is_cuda:
        return conv_bias_relu_ref(x, weight, bias, stride, padding, z)
    global launches
    launches += 1
    if z is None:
        return torch.cudnn_convolution_relu(x, weight, bias, stride, padding,
                                            (1, 1), 1)
    return torch.cudnn_convolution_add_relu(x, weight, z, 1.0, bias, stride,
                                            padding, (1, 1), 1)
