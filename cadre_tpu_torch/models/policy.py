"""Command-banked policy: LSTM memory + categorical actor-critic.

PyTorch counterpart of cadre_tpu.models.policy for the device iteration.
One `PolicyBank` holds the parameters of all command banks of one signal
(steer or throttle) stacked on a leading command axis; `act_batch` and
`evaluate_masked` evaluate every bank densely over the batch and keep each
sample's own bank, as the JAX package's `PolicyBankDef` does.

  LSTMCell: torch nn.LSTMCell semantics (gates i, f, g, o; two biases),
            orthogonal weights, zero biases.
  actor:    F -> 128 -> 128 -> num_outputs, ReLU, orthogonal gain 0.01.
  critic:   F -> 128 -> 128 -> 1, ReLU, orthogonal gain 1.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from cadre_tpu_torch.rl.distributions import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
)

Carry = Tuple[torch.Tensor, torch.Tensor]


def _orthogonal_(weight: torch.Tensor, gain: float) -> None:
    with torch.no_grad():
        for w in weight:
            nn.init.orthogonal_(w, gain)


class BankedLinear(nn.Module):
    """C independent linear layers: [C, N, in] (or [N, in]) -> [C, N, out]."""

    def __init__(self, banks: int, in_features: int, out_features: int,
                 gain: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(banks, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(banks, out_features))
        _orthogonal_(self.weight, gain)

    def forward(self, x):
        return torch.matmul(x, self.weight.transpose(1, 2)) + self.bias[:, None]


class BankedLSTM(nn.Module):
    """C LSTM cells unrolled over a [T, N, F] sequence."""

    def __init__(self, banks: int, features: int):
        super().__init__()
        h = features
        self.weight_ih = nn.Parameter(torch.empty(banks, 4 * h, features))
        self.weight_hh = nn.Parameter(torch.empty(banks, 4 * h, h))
        self.bias_ih = nn.Parameter(torch.zeros(banks, 4 * h))
        self.bias_hh = nn.Parameter(torch.zeros(banks, 4 * h))
        _orthogonal_(self.weight_ih, 1.0)
        _orthogonal_(self.weight_hh, 1.0)

    def unroll(self, xs: torch.Tensor, carry: Carry) -> Carry:
        """xs [T, N, F], carry ([N, H], [N, H]) -> final (h, c), each
        [C, N, H]."""
        t, n, f = xs.shape
        banks = self.weight_ih.shape[0]
        x_proj = torch.matmul(xs.reshape(t * n, f),
                              self.weight_ih.transpose(1, 2))
        x_proj = (x_proj + self.bias_ih[:, None]).reshape(banks, t, n, -1)
        h = carry[0].expand(banks, n, -1)
        c = carry[1].expand(banks, n, -1)
        w_hh = self.weight_hh.transpose(1, 2)
        for step in range(t):
            gates = x_proj[:, step] + torch.matmul(h, w_hh) \
                + self.bias_hh[:, None]
            i, f_, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f_) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h, c


class PolicyOutput(NamedTuple):
    action: torch.Tensor       # [N] int64
    log_prob: torch.Tensor     # [N]
    value: torch.Tensor        # [N]
    logits: torch.Tensor       # [N, A]


class PolicyBank(nn.Module):
    """One signal's policy over `num_commands` stacked banks."""

    def __init__(self, num_commands: int, num_outputs: int, feature_dim: int,
                 hidsize: int = 128):
        super().__init__()
        c = num_commands
        self.lstm = BankedLSTM(c, feature_dim)
        self.control = nn.ModuleDict({
            "fc1": BankedLinear(c, feature_dim, hidsize, 0.01),
            "fc2": BankedLinear(c, hidsize, hidsize, 0.01),
            "fc3": BankedLinear(c, hidsize, num_outputs, 0.01)})
        self.critic_fc1 = BankedLinear(c, feature_dim, hidsize, 1.0)
        self.critic_fc2 = BankedLinear(c, hidsize, hidsize, 1.0)
        self.critic_fc3 = BankedLinear(c, hidsize, 1, 1.0)

    def _all_banks(self, obs_seq: torch.Tensor, carry: Carry):
        """Every bank on every env: (logits [C, N, A], values [C, N],
        carry ([C, N, F], [C, N, F]))."""
        h, c = self.lstm.unroll(obs_seq, carry)
        ctl = self.control
        x = torch.relu(ctl["fc1"](h))
        logits_c = ctl["fc3"](torch.relu(ctl["fc2"](x)))
        v = torch.relu(self.critic_fc1(h))
        values_c = self.critic_fc3(torch.relu(self.critic_fc2(v)))[..., 0]
        return logits_c, values_c, (h, c)

    def evaluate(self, obs_seq: torch.Tensor, commands: torch.Tensor,
                 carry: Carry):
        """All banks densely, then each env's own: obs_seq [T, N, F],
        commands [N] -> (logits [N, A], value [N], carry ([N, F], [N, F]))."""
        logits_c, values_c, (h, c) = self._all_banks(obs_seq, carry)
        idx = (commands.long(), torch.arange(obs_seq.shape[1],
                                             device=obs_seq.device))
        return logits_c[idx], values_c[idx], (h[idx], c[idx])

    def evaluate_masked(self, obs_seq: torch.Tensor, carry: Carry,
                        action: torch.Tensor, commands: torch.Tensor):
        """The update's forward pass (JAX `evaluate_masked`): every bank on
        every sample, each sample keeping its own bank's terms through a
        one-hot mask summed over banks, so every bank's parameters get a
        dense gradient (zero where no sample has its command).
        obs_seq [T, B, F], carry ([B, F], [B, F]), action and commands [B]
        -> (value, log_prob, entropy), each [B]."""
        logits_c, values_c, _ = self._all_banks(obs_seq, carry)
        lps = categorical_log_prob(logits_c,
                                   action.expand(logits_c.shape[:2]))
        ents = categorical_entropy(logits_c)
        onehot = torch.nn.functional.one_hot(
            commands.long(), logits_c.shape[0]).to(values_c.dtype).T
        return ((values_c * onehot).sum(0), (lps * onehot).sum(0),
                (ents * onehot).sum(0))

    def sample_members(self, members: int, obs_seq: torch.Tensor,
                       commands: torch.Tensor, carry: Carry,
                       gumbel: torch.Tensor) -> torch.Tensor:
        """Actions of `members` policies whose banks are stacked on this
        bank axis (member m's command c at bank m * C + c): every bank on
        every env in one pass, then each member's bank of each env's
        command. obs_seq [T, N, F], commands [N], gumbel [K, N, A] ->
        actions [K, N]."""
        logits_c, _, _ = self._all_banks(obs_seq, carry)      # [K*C, N, A]
        n = commands.shape[0]
        dev = logits_c.device
        banks = logits_c.shape[0] // members
        idx = torch.arange(members, device=dev)[:, None] * banks \
            + commands.long()[None]
        logits = logits_c[idx, torch.arange(n, device=dev)[None]]
        return categorical_sample(logits, gumbel)

    def act_batch(self, obs_seq: torch.Tensor, commands: torch.Tensor,
                  carry: Carry, gumbel: torch.Tensor
                  ) -> Tuple[PolicyOutput, Carry]:
        """Batched act: sample argmax(logits + gumbel) per env."""
        logits, value, new_carry = self.evaluate(obs_seq, commands, carry)
        action = categorical_sample(logits, gumbel)
        log_prob = categorical_log_prob(logits, action)
        return PolicyOutput(action, log_prob, value, logits), new_carry
