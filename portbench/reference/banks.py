"""CADRE's command-banked PPO written out plainly: per command an LSTM over
the 8-frame feature window (zero carry, gates i, f, g, o), an actor and a
critic MLP on its last state, each sample run through its own command's
bank; GAE; the whole-rollout advantage standardisation; the clipped
surrogate and clipped value loss; a global-norm clip; Adam. Every product
goes through `r`, the precision step."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

W = Dict[str, torch.Tensor]


def bank_forward(w: W, k: int, obs_seq: torch.Tensor, r
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bank `k` of one signal on windows obs_seq [seq, B, F] -> (logits
    [B, A], value [B])."""
    seq, b, f = obs_seq.shape
    wih, whh = r(w["lstm.weight_ih"][k]), r(w["lstm.weight_hh"][k])
    bias = w["lstm.bias_ih"][k] + w["lstm.bias_hh"][k]
    h = obs_seq.new_zeros(b, whh.shape[1])
    c = obs_seq.new_zeros(b, whh.shape[1])
    xw = r(r(obs_seq.reshape(seq * b, f)) @ wih.t()).view(seq, b, -1)
    for t in range(seq):
        gates = xw[t] + r(r(h) @ whh.t()) + bias
        i, fg, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)

    def lin(x, name):
        return r(r(x) @ r(w[f"{name}.weight"][k]).t()) + w[f"{name}.bias"][k]

    a = torch.relu(lin(h, "control.fc1"))
    logits = lin(torch.relu(lin(a, "control.fc2")), "control.fc3")
    v = torch.relu(lin(h, "critic_fc1"))
    value = lin(torch.relu(lin(v, "critic_fc2")), "critic_fc3")[:, 0]
    return logits, value


def evaluate(w: W, obs_seq: torch.Tensor, commands: torch.Tensor, r,
             banks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every sample through its own command's bank: (logits, value)."""
    b = obs_seq.shape[1]
    logits = value = None
    for k in range(banks):
        rows = torch.nonzero(commands == k)[:, 0]
        if rows.numel() == 0:
            continue
        lg, v = bank_forward(w, k, obs_seq[:, rows], r)
        if logits is None:
            logits = lg.new_zeros(b, lg.shape[1])
            value = v.new_zeros(b)
        logits = logits.index_copy(0, rows, lg)
        value = value.index_copy(0, rows, v)
    return logits, value


def log_prob(logits, action):
    return torch.log_softmax(logits, -1).gather(
        -1, action.long()[:, None])[:, 0]


def entropy(logits):
    lp = torch.log_softmax(logits, -1)
    return -(lp.exp() * lp).sum(-1)


def gae(reward, value, mask, next_value, gamma, tau):
    """delta_t = r_t + gamma V_{t+1} m_t - V_t, gae_t = delta_t + gamma tau
    m_t gae_{t+1}; returns (returns, advantages) [T, N]."""
    t_steps = reward.shape[0]
    adv = torch.zeros_like(reward)
    run = torch.zeros_like(next_value)
    for t in reversed(range(t_steps)):
        v_next = next_value if t == t_steps - 1 else value[t + 1]
        delta = reward[t] + gamma * v_next * mask[t] - value[t]
        run = delta + gamma * tau * mask[t] * run
        adv[t] = run
    return adv + value, adv


def standardise(adv):
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def signal_loss_sum(w, mb, r, banks, clip):
    """Sums over the rows of (value loss, action loss, entropy) terms."""
    logits, value = evaluate(w, mb["obs"], mb["command"], r, banks)
    lp = log_prob(logits, mb["action"])
    ratio = torch.exp(lp - mb["old_log_prob"])
    adv = mb["advantage"]
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
    v_clip = mb["old_value"] + torch.clamp(value - mb["old_value"], -clip,
                                           clip)
    vl = 0.5 * torch.maximum((value - mb["returns"]) ** 2,
                             (v_clip - mb["returns"]) ** 2)
    return vl.sum(), -surr.sum(), entropy(logits).sum()


class Adam:
    """torch.optim.Adam's update: m, v, bias-corrected step, eps outside
    the root, optional L2 decay added to the gradient first."""

    def __init__(self, params: Sequence[torch.Tensor], lr, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             lr=None) -> List[torch.Tensor]:
        """Updates params in place; returns the gradients as the moments
        got them (decay added)."""
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        self.t += 1
        seen = []
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, self.m, self.v):
                if self.wd:
                    g = g + self.wd * p
                seen.append(g)
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.t))
        return seen
