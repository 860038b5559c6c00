"""Command-banked policy: a memory + categorical actor-critic.

PyTorch counterpart of cadre_tpu.models.policy for the device iteration.
One `PolicyBank` holds the parameters of all command banks of one signal
(steer or throttle) stacked on a leading command axis. `act_batch`
evaluates every bank densely over the batch and keeps each sample's own
bank, as the JAX package's `PolicyBankDef` does; the update's
`evaluate_masked` routes each sample through its own command's bank
alone, which gives the same terms and gradients without the other banks'
work.

  memory:   'lstm' (the reference's): torch nn.LSTMCell semantics (gates
            i, f, g, o; two biases), orthogonal weights, zero biases;
            'transformer': flax's TransformerMemory, a causal pre-LN
            transformer over the frame window, one per bank; 'none': the
            newest frame's features as they are. `use_lstm=False` is the
            legacy spelling of 'none'. Only the LSTM reads or writes the
            carry; the other two hand it back untouched.
  actor:    F -> 128 -> 128 -> num_outputs, ReLU, orthogonal gain 0.01;
            with `ordinal`, the logits go through `ordinal_logits`.
  critic:   F -> 128 -> 128 -> 1, ReLU, orthogonal gain 1.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from cadre_tpu_torch.rl.distributions import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
    ordinal_logits,
)

Carry = Tuple[torch.Tensor, torch.Tensor]


def _orthogonal_(weight: torch.Tensor, gain: float) -> None:
    with torch.no_grad():
        for w in weight:
            nn.init.orthogonal_(w, gain)


def _lecun_normal_(weight: torch.Tensor, fan_in: int) -> None:
    """flax's default Dense kernel init: a normal of variance 1/fan_in
    truncated at two standard deviations."""
    std = 1.0 / math.sqrt(fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


class BankedLinear(nn.Module):
    """C independent linear layers: [C, N, in] (or [N, in]) -> [C, N, out];
    orthogonal weights of `gain`, or with no gain flax's default init."""

    def __init__(self, banks: int, in_features: int, out_features: int,
                 gain: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(banks, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(banks, out_features))
        if gain is None:
            _lecun_normal_(self.weight, in_features)
        else:
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


class BankedLayerNorm(nn.Module):
    """C flax LayerNorms over the last axis of [C, ..., F]: eps 1e-6 and
    flax's variance E[x^2] - E[x]^2."""

    def __init__(self, banks: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(banks, features))
        self.bias = nn.Parameter(torch.zeros(banks, features))
        self.eps = eps

    def forward(self, x):
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return (x - mean) * mul + self.bias.view(shape)


class _HeadsDense(nn.Module):
    """C flax DenseGenerals between F features and H heads of D: `weight`
    [C, H, D, F] into the heads (flax's kernel [F, H, D]) or [C, F, H, D]
    out of them (flax's [H, D, F]), torch's out-by-in order."""

    def __init__(self, banks: int, features: int, heads: int, into: bool):
        super().__init__()
        d = features // heads
        shape = (heads, d, features) if into else (features, heads, d)
        self.weight = nn.Parameter(torch.empty((banks,) + shape))
        _lecun_normal_(self.weight, features if into else heads * d)
        self.bias = nn.Parameter(torch.zeros(
            ((banks,) + shape[:-1]) if into else (banks, features)))

    def forward(self, x):
        """[C, M, in] -> [C, M, out], the heads flattened."""
        c = self.weight.shape[0]
        w = self.weight.reshape(c, -1, x.shape[-1])
        return torch.matmul(x, w.transpose(1, 2)) + self.bias.reshape(c, 1, -1)


class BankedAttention(nn.Module):
    """C flax SelfAttentions of `heads` heads over [C, N, T, F]: the query
    scaled by 1/sqrt(D) before the product, masked scores filled with the
    dtype's lowest value, as flax's dot_product_attention does."""

    def __init__(self, banks: int, features: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = _HeadsDense(banks, features, heads, True)
        self.key = _HeadsDense(banks, features, heads, True)
        self.value = _HeadsDense(banks, features, heads, True)
        self.out = _HeadsDense(banks, features, heads, False)

    def _split(self, proj, x):
        """x [C, N, T, F] -> [C, N, H, T, D]."""
        c, n, t, f = x.shape
        y = proj(x.reshape(c, n * t, f))
        return y.reshape(c, n, t, self.heads, -1).transpose(2, 3)

    def forward(self, x, last_only: bool = False):
        """x [C, N, T, F] -> [C, N, T, F] under a causal mask, or with
        `last_only` the newest position's row alone, [C, N, 1, F]."""
        q_in = x[:, :, -1:] if last_only else x
        q, k, v = (self._split(self.query, q_in), self._split(self.key, x),
                   self._split(self.value, x))
        q = q / math.sqrt(q.shape[-1])
        scores = torch.matmul(q, k.transpose(-1, -2))    # [C, N, H, Tq, T]
        if not last_only:
            t = x.shape[2]
            causal = torch.ones(t, t, dtype=torch.bool,
                                device=x.device).tril()
            scores = scores.masked_fill(~causal,
                                        torch.finfo(scores.dtype).min)
        y = torch.matmul(torch.softmax(scores, dim=-1), v)  # [C,N,H,Tq,D]
        c, n, tq = q_in.shape[:3]
        y = self.out(y.transpose(2, 3).reshape(c, n * tq, -1))
        return y.reshape(q_in.shape)


class BankedTransformer(nn.Module):
    """C copies of flax's TransformerMemory over a [T, N, F] window:
    in_proj plus a learned position embedding (max_len rows), `layers`
    pre-LN blocks (causal self-attention, then a 4F MLP with tanh-GELU),
    a final LayerNorm, and the newest frame's row."""

    def __init__(self, banks: int, features: int, layers: int = 2,
                 heads: int = 2, max_len: int = 32):
        super().__init__()
        f = features
        self.layers = layers
        self.in_proj = BankedLinear(banks, f, f)
        self.pos_embed = nn.Parameter(torch.empty(banks, max_len, f))
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, 0.0, 0.02)
        for i in range(layers):
            self.add_module(f"ln1_{i}", BankedLayerNorm(banks, f))
            self.add_module(f"attn_{i}", BankedAttention(banks, f, heads))
            self.add_module(f"ln2_{i}", BankedLayerNorm(banks, f))
            self.add_module(f"mlp1_{i}", BankedLinear(banks, f, 4 * f))
            self.add_module(f"mlp2_{i}", BankedLinear(banks, 4 * f, f))
        self.ln_out = BankedLayerNorm(banks, f)

    def _dense(self, name, x):
        """A BankedLinear on [C, N, T, F]."""
        c, n, t, f = x.shape
        return getattr(self, name)(x.reshape(c, n * t, f)).reshape(
            c, n, t, -1)

    def unroll(self, xs: torch.Tensor) -> torch.Tensor:
        """xs [T, N, F] -> the newest frame's features, [C, N, F]. The last
        block computes the newest position alone: every op after the keys
        and values works row by row, so the row is the one the whole
        window's pass would give."""
        t, n, f = xs.shape
        c = self.pos_embed.shape[0]
        x = self.in_proj(xs.transpose(0, 1).reshape(n * t, f))
        x = x.reshape(c, n, t, f) + self.pos_embed[:, None, :t]
        for i in range(self.layers):
            last = i == self.layers - 1
            y = getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x),
                                           last_only=last)
            x = (x[:, :, -1:] if last else x) + y
            y = self._dense(f"mlp1_{i}", getattr(self, f"ln2_{i}")(x))
            x = x + self._dense(f"mlp2_{i}",
                                nn.functional.gelu(y, approximate="tanh"))
        return self.ln_out(x)[:, :, -1]


MEMORIES = ("lstm", "transformer", "none")


def memory_kind(memory: str = "lstm", use_lstm: bool = True) -> str:
    """The memory a bank runs: `memory`, or 'none' when `use_lstm` is
    False (the JAX package's `PolicyBankDef._memory_kind`)."""
    if memory not in MEMORIES:
        raise ValueError(f"memory must be one of {MEMORIES}, not {memory!r}")
    return memory if use_lstm else "none"


def group_by_command(commands: torch.Tensor, banks: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows grouped by their command along the last axis: (order, counts),
    `order` the stable sort of `commands` (bank 0's rows first, each
    bank's in the order they came), `counts` [..., banks] each bank's
    rows. Neither waits for the device."""
    order = torch.sort(commands, dim=-1, stable=True).indices
    counts = nn.functional.one_hot(commands.long(), banks).sum(-2)
    return order, counts


def read_bank_rows(counts: torch.Tensor) -> list:
    """The routing's one host read: `counts` as nested lists of ints."""
    return counts.tolist()


class PolicyOutput(NamedTuple):
    action: torch.Tensor       # [N] int64
    log_prob: torch.Tensor     # [N]
    value: torch.Tensor        # [N]
    logits: torch.Tensor       # [N, A]


class PolicyBank(nn.Module):
    """One signal's policy over `num_commands` stacked banks; `memory`,
    `use_lstm` and `ordinal` as the JAX package's `PolicyBankDef` takes
    them. The memory's parameters sit under `lstm` whatever it is, as
    flax keeps them; 'none' has none."""

    def __init__(self, num_commands: int, num_outputs: int, feature_dim: int,
                 hidsize: int = 128, *, memory: str = "lstm",
                 use_lstm: bool = True, ordinal: bool = False):
        super().__init__()
        c = num_commands
        self.memory = memory_kind(memory, use_lstm)
        self.ordinal = ordinal
        if self.memory == "lstm":
            self.lstm = BankedLSTM(c, feature_dim)
        elif self.memory == "transformer":
            self.lstm = BankedTransformer(c, feature_dim)
        self.control = nn.ModuleDict({
            "fc1": BankedLinear(c, feature_dim, hidsize, 0.01),
            "fc2": BankedLinear(c, hidsize, hidsize, 0.01),
            "fc3": BankedLinear(c, hidsize, num_outputs, 0.01)})
        self.critic_fc1 = BankedLinear(c, feature_dim, hidsize, 1.0)
        self.critic_fc2 = BankedLinear(c, hidsize, hidsize, 1.0)
        self.critic_fc3 = BankedLinear(c, hidsize, 1, 1.0)

    @property
    def num_banks(self) -> int:
        return self.critic_fc3.weight.shape[0]

    def forward(self, obs_seq: torch.Tensor, carry: Carry):
        """Every bank on every env: (logits [C, N, A], values [C, N], the
        LSTM's carry ([C, N, F], [C, N, F]), None for the other memories).
        """
        new_carry: Optional[Carry] = None
        if self.memory == "lstm":
            h, c = self.lstm.unroll(obs_seq, carry)
            new_carry = (h, c)
        elif self.memory == "transformer":
            h = self.lstm.unroll(obs_seq)
        else:
            h = obs_seq[-1]                              # [N, F], all banks
        ctl = self.control
        x = torch.relu(ctl["fc1"](h))
        logits_c = ctl["fc3"](torch.relu(ctl["fc2"](x)))
        if self.ordinal:
            logits_c = ordinal_logits(logits_c)
        v = torch.relu(self.critic_fc1(h))
        values_c = self.critic_fc3(torch.relu(self.critic_fc2(v)))[..., 0]
        return logits_c, values_c, new_carry

    def evaluate(self, obs_seq: torch.Tensor, commands: torch.Tensor,
                 carry: Carry):
        """All banks densely, then each env's own: obs_seq [T, N, F],
        commands [N] -> (logits [N, A], value [N], carry ([N, F], [N, F]):
        the LSTM's, or `carry` itself for the other memories)."""
        logits_c, values_c, new_carry = self(obs_seq, carry)
        idx = (commands.long(), torch.arange(obs_seq.shape[1],
                                             device=obs_seq.device))
        if new_carry is not None:
            carry = (new_carry[0][idx], new_carry[1][idx])
        return logits_c[idx], values_c[idx], carry

    def evaluate_masked(self, obs_seq: torch.Tensor, carry: Carry,
                        action: torch.Tensor, commands: torch.Tensor,
                        bank_rows: Optional[Sequence[int]] = None):
        """The update's forward pass (JAX `evaluate_masked`): each sample
        through its own command's bank only. obs_seq [T, B, F], carry
        ([B, F], [B, F]), action and commands [B] -> (value, log_prob,
        entropy), each [B] in the samples' order.

        `bank_rows` (C host ints) says the samples come grouped by command:
        bank 0's first, then bank 1's, and so on. Without it, or where it
        does not add up to B, the samples are grouped here, with one host
        read of the counts. Bank c runs on its rows through its own
        parameters, `p[c:c + 1]`, and a bank with no rows is skipped, so
        every bank's parameters still get a dense gradient: exact zeros
        for a bank no sample uses, as the dense one-hot mask gives."""
        order = None
        if bank_rows is None or sum(bank_rows) != action.shape[0]:
            order, counts = group_by_command(commands, self.num_banks)
            bank_rows = read_bank_rows(counts)
            obs_seq, action = obs_seq[:, order], action[order]
            carry = (carry[0][order], carry[1][order])
        params = dict(self.named_parameters())
        terms, start = [], 0
        for c, n in enumerate(bank_rows):
            if not n:
                continue
            rows = slice(start, start + n)
            start += n
            logits, values, _ = torch.func.functional_call(
                self, {k: p[c:c + 1] for k, p in params.items()},
                (obs_seq[:, rows], (carry[0][rows], carry[1][rows])))
            terms.append(torch.stack([
                values[0], categorical_log_prob(logits[0], action[rows]),
                categorical_entropy(logits[0])]))
        terms = torch.cat(terms, dim=1)
        if order is not None:
            terms = terms[:, torch.argsort(order)]
        return terms[0], terms[1], terms[2]

    def sample_members(self, members: int, obs_seq: torch.Tensor,
                       commands: torch.Tensor, carry: Carry,
                       gumbel: torch.Tensor) -> torch.Tensor:
        """Actions of `members` policies whose banks are stacked on this
        bank axis (member m's command c at bank m * C + c): every bank on
        every env in one pass, then each member's bank of each env's
        command. obs_seq [T, N, F], commands [N], gumbel [K, N, A] ->
        actions [K, N]."""
        logits_c, _, _ = self(obs_seq, carry)      # [K*C, N, A]
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
