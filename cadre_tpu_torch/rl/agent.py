"""Cascade agent for the acting path: frozen CoPM encoder -> per-command
steer and throttle policy banks.

PyTorch counterpart of the device-path pieces of cadre_tpu.rl.agent:
`preprocess_obs`, `latent_features`, `CadreAgent.create` and
`act_from_hist` (the JAX package's `_act_from_hist`), the PPO
configuration, the policy snapshots (native torch files; reading the JAX
package's msgpack snapshots is not ported yet, nor are the host-env act
loops) and an ensemble of snapshots acting as one (`Ensemble`, the
`EnsembleAgent` of the device eval).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from cadre_tpu_torch.configs.agent_config import AgentConfig
from cadre_tpu_torch.configs.danet_config import DANetParams, danet_params
from cadre_tpu_torch.models.danet import DANet
from cadre_tpu_torch.models.policy import Carry, PolicyBank, PolicyOutput
from cadre_tpu_torch.rl.ppo import PPOConfig
from cadre_tpu_torch.utils.device import resolve_device


def preprocess_obs(rgb: torch.Tensor, route_fig: torch.Tensor,
                   blank_route: bool = False) -> torch.Tensor:
    """Encoder input [N, H, W, 4]: rgb [N, H, W, 3] / 255 and the route
    figure [N, W, H] normalised per frame by its max, transposed."""
    rgb = rgb.float() / 255.0
    route = route_fig.float()
    peak = route.amax(dim=(1, 2), keepdim=True)
    route = torch.where(peak > 0, route / peak, route)
    route = route.transpose(1, 2)[..., None]
    if blank_route:
        route = torch.zeros_like(route)
    return torch.cat([rgb, route], dim=-1)


def latent_features(encoder: DANet, x: torch.Tensor,
                    measurements: torch.Tensor) -> torch.Tensor:
    """Encoder latent (input cast to the encoder's dtype, latent returned
    in f32) ++ measurements tiled x6 -> [N, latent + 18]."""
    dtype = next(encoder.parameters()).dtype
    with torch.no_grad():
        z = encoder.latent(x.to(dtype)).float()
    meas = measurements.float().repeat(1, 6)
    return torch.cat([z, meas], dim=-1)


@dataclasses.dataclass
class CadreAgent:
    """Frozen encoder + steer and throttle policy banks on one device."""

    agent_cfg: AgentConfig
    danet_cfg: DANetParams
    encoder: DANet
    steer: PolicyBank
    throttle: PolicyBank
    device: torch.device
    ppo_cfg: PPOConfig = dataclasses.field(default_factory=PPOConfig)

    @property
    def obs_dim(self) -> int:
        return self.danet_cfg.latent_dim + self.agent_cfg.measurement_dim

    @classmethod
    def create(cls, danet_cfg: Optional[DANetParams] = None,
               agent_cfg: Optional[AgentConfig] = None,
               ppo_cfg: Optional[PPOConfig] = None, *, seed: int = 0,
               bf16_encoder: bool = False, device="cuda") -> "CadreAgent":
        """Random weights from `seed` (the global torch generator is left
        untouched); `bf16_encoder` casts the whole encoder to bf16."""
        agent_cfg = agent_cfg or AgentConfig()
        danet_cfg = danet_cfg or danet_params()
        dev = resolve_device(device)
        f = danet_cfg.latent_dim + agent_cfg.measurement_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            encoder = DANet(danet_cfg)
            steer = PolicyBank(agent_cfg.command_num,
                               agent_cfg.num_steer_outputs, f)
            throttle = PolicyBank(agent_cfg.command_num,
                                  agent_cfg.num_throttle_outputs, f)
        encoder = encoder.eval().to(dev, memory_format=torch.channels_last)
        if bf16_encoder:     # parameters and buffers, BN statistics too
            encoder = encoder.to(torch.bfloat16)
        encoder.requires_grad_(False)
        return cls(agent_cfg, danet_cfg, encoder, steer.to(dev),
                   throttle.to(dev), dev, ppo_cfg or PPOConfig())

    def policy_parameters(self) -> List[torch.nn.Parameter]:
        """The parameters of both banks, steer first: what the optimizer
        and the global-norm clip cover (the encoder is frozen)."""
        return [*self.steer.parameters(), *self.throttle.parameters()]

    def encode(self, obs: dict) -> torch.Tensor:
        """obs (rgb, route_fig, measurements) -> features [N, obs_dim]."""
        x = preprocess_obs(obs["rgb"], obs["route_fig"],
                           blank_route=self.danet_cfg.in_route_blank)
        return latent_features(self.encoder, x, obs["measurements"])

    def act_from_hist(self, feat_hist: torch.Tensor, commands: torch.Tensor,
                      hidden: Carry, steer_gumbel: torch.Tensor,
                      throttle_gumbel: torch.Tensor
                      ) -> Tuple[PolicyOutput, PolicyOutput, Carry]:
        """feat_hist [T, N, F] -> (steer out, throttle out, steer carry)."""
        with torch.no_grad():
            steer_out, hidden_s = self.steer.act_batch(
                feat_hist, commands, hidden, steer_gumbel)
            throttle_out, _ = self.throttle.act_batch(
                feat_hist, commands, hidden, throttle_gumbel)
        return steer_out, throttle_out, hidden_s

    def save_snapshot(self, path: str,
                      opt: Optional[torch.optim.Optimizer] = None) -> None:
        """Both banks' state dicts to `path` (torch.save); with `opt`, its
        state dict too, for an exact resume."""
        tree = {"steer": self.steer.state_dict(),
                "throttle": self.throttle.state_dict()}
        if opt is not None:
            tree["opt"] = opt.state_dict()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(tree, path)

    def load_snapshot(self, path: str,
                      opt: Optional[torch.optim.Optimizer] = None) -> None:
        """Load a `save_snapshot` file; with `opt`, restore its state too
        (the file must hold one)."""
        tree = torch.load(path, map_location=self.device, weights_only=True)
        self.steer.load_state_dict(tree["steer"])
        self.throttle.load_state_dict(tree["throttle"])
        if opt is not None:
            opt.load_state_dict(tree["opt"])


class Ensemble(NamedTuple):
    """K policy snapshots acting together on one feature history. Each
    signal's K members are folded into one PolicyBank of K * C banks, so
    one pass evaluates every member: as many launches as one member."""

    members: int
    steer: PolicyBank
    throttle: PolicyBank

    @classmethod
    def load(cls, agent: CadreAgent, snapshot_paths: Sequence[str]
             ) -> "Ensemble":
        """The `save_snapshot` files at `snapshot_paths`, stacked on the
        host and then copied to the agent's device once."""
        trees = [torch.load(p, map_location="cpu", weights_only=True)
                 for p in snapshot_paths]
        if not trees:
            raise ValueError("an ensemble needs at least one snapshot")
        k, cfg, f = len(trees), agent.agent_cfg, agent.obs_dim
        banks = []
        for name, outputs in (("steer", cfg.num_steer_outputs),
                              ("throttle", cfg.num_throttle_outputs)):
            with torch.device("meta"):
                bank = PolicyBank(k * cfg.command_num, outputs, f)
            bank.load_state_dict({key: torch.cat([t[name][key] for t in trees])
                                  for key in trees[0][name]}, assign=True)
            banks.append(bank.to(agent.device).requires_grad_(False))
        return cls(k, *banks)

    def act(self, feat_hist: torch.Tensor, commands: torch.Tensor,
            hidden: Carry, steer_gumbel: torch.Tensor,
            throttle_gumbel: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat_hist [T, N, F], Gumbel noise [K, N, A] per member ->
        (steer, throttle) actions, each [K, N]."""
        with torch.no_grad():
            return (self.steer.sample_members(self.members, feat_hist,
                                              commands, hidden, steer_gumbel),
                    self.throttle.sample_members(self.members, feat_hist,
                                                 commands, hidden,
                                                 throttle_gumbel))
