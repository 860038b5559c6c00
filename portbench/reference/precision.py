"""Where the reference computes: float32 with TF32 off, or a step lower
for the control. A lower step rounds every operand of a convolution or a
product (and its result) to that format and accumulates in float32, as
the tensor cores do: 'tf32' (10 explicit mantissa bits, round to
nearest) or 'bf16'."""
from __future__ import annotations

from contextlib import contextmanager

import torch

STEPS = ("f32", "tf32", "bf16")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _Round(torch.autograd.Function):
    """Rounds the value going forward and its gradient going back, so
    that a lower step rounds the backward's products too."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


class Rounding:
    """`r(x)` rounds a float32 operand to the step; 'f32' leaves it."""

    def __init__(self, step: str = "f32"):
        if step not in STEPS:
            raise ValueError(f"precision step {step!r}, not one of {STEPS}")
        self.step = step

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.step == "f32":
            return x
        return _Round.apply(x.float(), _ROUND[self.step])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


_ROUND = {"tf32": _tf32, "bf16": _bf16}


@contextmanager
def exact_f32():
    """TF32 off for every float32 convolution and matmul inside, restored
    after: the reference's own setting, never the program's."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
