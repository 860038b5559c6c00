"""The benchmark's weights: made on the device from the seed in one call
of a CUDA generator, in float32, for the names and shapes of a state_dict
(the port's checkpoint layout). Both the program and the plain reference
are handed these same tensors; neither takes the other's.

The recipe keeps the activations of a random network near unit scale, so
that attention is neither uniform nor one-hot and every layer matters:
He-scaled convolution and linear weights, BatchNorm near the identity
(the last one of each residual block at 0.3, as a trained network's
residual branches are small), running statistics 0 and 1, small random
biases, and both dual-attention gates at 0.5 +- 0.1 (zero would cut the
attention out of the forward and the q/k/v convolutions out of the
gradient)."""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Tuple

import torch

_LAST_BN = re.compile(r"(.*\.layer\d+\.\d+)\.bn(\d)\.weight$")


def _fan_in(name: str, shape: Tuple[int, ...]) -> float:
    if len(shape) == 4 and ".reverse_" in f".{name}":
        # a stride-2 transposed 3x3: each output sums about in * 9 / 4
        return shape[0] * shape[2] * shape[3] / 4.0
    if len(shape) == 4:
        return shape[1] * shape[2] * shape[3]
    return shape[-1]


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...], torch.dtype]],
                 seed: int, device, gain: float = math.sqrt(2.0)
                 ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every (name, shape, dtype) of a state_dict."""
    shapes = list(shapes)
    names = {n for n, _, _ in shapes}
    last_bn: Dict[str, int] = {}
    for n in names:
        m = _LAST_BN.match(n)
        if m:
            last_bn[m.group(1)] = max(last_bn.get(m.group(1), 0),
                                      int(m.group(2)))
    floats = [(n, s) for n, s, d in shapes if d.is_floating_point]
    total = sum(math.prod(s) for _, s in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    noise = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n, s in floats:
        k = math.prod(s)
        z = noise[at:at + k].view(s)
        at += k
        stem = n.rsplit(".", 1)[0]
        bn = f"{stem}.running_mean" in names
        if n.endswith("running_mean"):
            w = torch.zeros(s, device=device)
        elif n.endswith("running_var"):
            w = torch.ones(s, device=device)
        elif n.endswith("gamma"):
            w = 0.5 + 0.1 * z
        elif bn and n.endswith(".weight"):
            m = _LAST_BN.match(n)
            last = m is not None and int(m.group(2)) == last_bn[m.group(1)]
            w = (0.3 if last else 1.0) * (1.0 + 0.1 * z)
        elif bn and n.endswith(".bias"):
            w = 0.1 * z
        elif len(s) >= 2 and not n.endswith("bias"):
            w = z * (gain / math.sqrt(_fan_in(n, s)))
        else:
            w = 0.05 * z
        out[n] = w.contiguous()
    for n, s, d in shapes:
        if not d.is_floating_point:
            out[n] = torch.zeros(s, dtype=d, device=device)
    return out


def shapes_of(module: torch.nn.Module):
    """(name, shape, dtype) of every entry of a module's state_dict."""
    return [(n, tuple(t.shape), t.dtype)
            for n, t in module.state_dict().items()]
