"""Categorical action distribution over logits (last axis), and the
ordinal transform of the logits."""
from __future__ import annotations

import torch


def categorical_log_prob(logits: torch.Tensor, action: torch.Tensor
                         ) -> torch.Tensor:
    """log p(action); `action` is an integer tensor shaped logits[..., 0]."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action[..., None].long())[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def ordinal_logits(raw: torch.Tensor) -> torch.Tensor:
    """The ordinal-policy transform (the reference's distributions.py:68-79,
    its mask1 variant :58-64), as the JAX package computes it:
    logit_i = sum_{j<=i} log(sigmoid(raw_j) + 1e-8)
              + sum_{j>i} log(1 - sigmoid(raw_j) + 1e-8)."""
    s = torch.sigmoid(raw)
    n = raw.shape[-1]
    log_s = torch.log(s + 1e-8)
    log_1ms = torch.log(1 - s + 1e-8)
    mask = torch.tril(torch.ones(n, n, dtype=raw.dtype, device=raw.device))
    return torch.matmul(log_s, mask.T) + torch.matmul(log_1ms, 1.0 - mask.T)


def categorical_sample(logits: torch.Tensor, gumbel: torch.Tensor
                       ) -> torch.Tensor:
    """argmax(logits + gumbel): a draw from softmax(logits) given standard
    Gumbel noise shaped like `logits`. This is how jax.random.categorical
    samples, so handing both the same noise gives the same action."""
    return torch.argmax(logits + gumbel, dim=-1)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in (tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))
