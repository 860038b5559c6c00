"""Cascade agent: frozen CoPM encoder -> per-command steer and throttle
policy banks.

PyTorch counterpart of cadre_tpu.rl.agent: `preprocess_obs`,
`latent_features`, `CadreAgent.create` (random encoder weights, or a
trained encoder's: the cascade's handoff from perception pretraining),
`act_from_hist` (the JAX package's `_act_from_hist`), the host-env act
paths (`act`, `act_vec`, `act_vec_incremental`, the fused tick
`act_vec_store` with `zero_pending`), the bootstrap value `get_value`,
`update_policy` on the agent's own optimizer (global-norm clip at
ppo_cfg.max_grad_norm, then Adam), the policy snapshots and an ensemble
of snapshots acting as one: `Ensemble`, which the device eval drives, and
`EnsembleAgent`, the JAX package's EnsembleAgent on one host env's tick.

A snapshot is the port's own torch file (`.pt`), the JAX package's flax
file (`.msgpack`: {'steer', 'throttle'} stacked banks, and beside it
`<path>.opt`, the optax chain(clip_by_global_norm, adam) state
{'0': {}, '1': {'0': {count, mu, nu}, '1': {}}}, mapped to and from
torch Adam's step / exp_avg / exp_avg_sq), or, for loading, a reference
ppo_model_<N>.pt of '{steer,throttle}_{ppo,lstm}_{k}' state_dicts (a
bank it lacks keeps the agent's value).

The host-env paths take numpy ticks: frames go to the agent's device as
uint8, measurements as float32 and commands as int64 (JAX converts
float64 to float32 and int64 to int32 where it takes them, with x64 off).
Their sampling is argmax(logits + Gumbel noise): the noise is an argument
(`gumbel`, a (steer [N, 33], throttle [N, 3]) pair) that the training
loops draw (`rl.train.agent_gumbel`) or a test injects. As in the
reference, the LSTM sees a stale zero carry on every act
(ppo_agent/agent.py:38-40, 123-124). The banks' memory (LSTM,
transformer or none) and ordinal head follow the AgentConfig, as in the
JAX package; only the API sets them (no CLI flag does).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import AgentConfig
from cadre_tpu_torch.configs.danet_config import DANetParams, danet_params
from cadre_tpu_torch.models.danet import DANet, fold_batch_norms
from cadre_tpu_torch.models.policy import (
    Carry,
    PolicyBank,
    PolicyOutput,
    memory_kind,
)
from cadre_tpu_torch.rl.distributions import gumbel as draw_gumbel
from cadre_tpu_torch.rl.ppo import PPOConfig, make_optimizer, update_step
from cadre_tpu_torch.rl.rollout import Minibatch, RolloutBuffer, insert
from cadre_tpu_torch.utils import checkpoint as ckpt
from cadre_tpu_torch.utils.convert import policy_from_flax, policy_to_flax
from cadre_tpu_torch.utils.device import resolve_device
from cadre_tpu_torch.utils.profiling import span

Gumbel = Tuple[torch.Tensor, torch.Tensor]      # (steer [N, A], throttle)
StateDict = Dict[str, torch.Tensor]


class ActResult(NamedTuple):
    features: torch.Tensor         # [T, F] latent + measurements
    steer_action: torch.Tensor     # scalar int64
    throttle_action: torch.Tensor
    steer_log_prob: torch.Tensor
    throttle_log_prob: torch.Tensor
    steer_value: torch.Tensor
    throttle_value: torch.Tensor
    hidden: Carry                  # ([1, F], [1, F]) steer carry


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

    def __post_init__(self):
        """The single-env carry (the reference's stale zeros, never
        updated) and the one optimizer of the banks, which `update_policy`
        and every training loop step."""
        f = self.obs_dim
        self.hidden_state: Carry = (
            torch.zeros(1, f, device=self.device),
            torch.zeros(1, f, device=self.device))
        self.opt = make_optimizer(self.policy_parameters(), self.ppo_cfg)

    @property
    def obs_dim(self) -> int:
        return self.danet_cfg.latent_dim + self.agent_cfg.measurement_dim

    @classmethod
    def create(cls, danet_cfg: Optional[DANetParams] = None,
               agent_cfg: Optional[AgentConfig] = None,
               ppo_cfg: Optional[PPOConfig] = None, *, seed: int = 0,
               bf16_encoder: bool = False, device="cuda",
               encoder_state: Optional[dict] = None) -> "CadreAgent":
        """Random weights from `seed` (the global torch generator is left
        untouched); `encoder_state`, a DANet state_dict (a trained
        encoder's, `utils.checkpoint.load_danet_checkpoint`), replaces the
        encoder's: every key of the latent path must be there, decoder and
        head keys are ignored. On a CUDA device the loaded encoder is then
        folded (`models.danet.fold_batch_norms`: BatchNorm folded into
        the convolutions, bias, residual add and ReLU in their epilogue),
        so it holds no BatchNorm and a training state_dict no longer
        loads into it; on the CPU it stays the unfolded module.
        `bf16_encoder` casts the whole encoder to bf16, after the fold."""
        agent_cfg = agent_cfg or AgentConfig()
        danet_cfg = danet_cfg or danet_params()
        dev = resolve_device(device)
        f = danet_cfg.latent_dim + agent_cfg.measurement_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            encoder = DANet(danet_cfg, latent_only=True)
            steer = policy_bank(agent_cfg, agent_cfg.command_num,
                                agent_cfg.num_steer_outputs, f)
            throttle = policy_bank(agent_cfg, agent_cfg.command_num,
                                   agent_cfg.num_throttle_outputs, f)
        if encoder_state is not None:
            keys = encoder.state_dict().keys()
            encoder.load_state_dict({k: v for k, v in encoder_state.items()
                                     if k in keys})
        encoder = encoder.eval()
        if dev.type == "cuda":      # in f32, before any cast
            encoder = fold_batch_norms(encoder)
        encoder = encoder.to(dev, memory_format=torch.channels_last)
        if bf16_encoder:     # parameters and buffers
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
        with span("encode"):
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

    # ---------------- host-env act paths ----------------

    def _on_device(self, x, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
        """A numpy array, number or tensor on the agent's device. A host
        array is copied synchronously, so the caller may reuse it (the
        env's history rings) as soon as this returns."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        return x.to(self.device, dtype)

    def _frames(self, tick: dict, last: bool) -> dict:
        """The rgb, route_fig and measurements of a tick on the device: the
        newest frame of each env ([N, ...]) or the whole window
        ([N * T, ...] for a batch, [T, ...] for one env)."""
        rgb, fig, meas = (np.asarray(tick[k]) for k in
                          ("rgb", "route_fig", "measurements"))
        if last:
            rgb, fig, meas = rgb[:, -1], fig[:, -1], meas[:, -1]
        elif rgb.ndim == 5:
            rgb, fig, meas = (a.reshape((-1,) + a.shape[2:])
                              for a in (rgb, fig, meas))
        return dict(rgb=self._on_device(rgb), route_fig=self._on_device(fig),
                    measurements=self._on_device(meas, torch.float32))

    def _noise(self, gumbel: Gumbel) -> Gumbel:
        return tuple(self._on_device(g, torch.float32) for g in gumbel)

    def act(self, tick: dict, gumbel: Gumbel) -> ActResult:
        """One env: tick 'rgb' [T,H,W,3], 'route_fig' [T,W,H],
        'measurements' [T,3], 'command' int. All T frame features unroll
        through the LSTM from `hidden_state` (ppo_agent/models.py:144-151)."""
        feats = self.encode(self._frames(tick, last=False))      # [T, F]
        cmd = self._on_device(np.asarray([tick["command"]]), torch.long)
        s_out, t_out, hidden_s = self.act_from_hist(
            feats[:, None], cmd, self.hidden_state, *self._noise(gumbel))
        return ActResult(feats, s_out.action[0], t_out.action[0],
                         s_out.log_prob[0], t_out.log_prob[0],
                         s_out.value[0], t_out.value[0], hidden_s)

    def act_vec(self, tick_batch: dict, hidden: Carry, gumbel: Gumbel):
        """N envs: 'rgb' [N,T,H,W,3], 'route_fig' [N,T,W,H], 'measurements'
        [N,T,3], 'command' [N]; hidden ([N,F], [N,F]). Returns (features
        [N,T,F], steer out, throttle out, steer carry)."""
        n, t = np.shape(tick_batch["rgb"])[:2]
        feats = self.encode(self._frames(tick_batch, last=False))
        feats = feats.reshape(n, t, -1)
        commands = self._on_device(tick_batch["command"], torch.long)
        s_out, t_out, hidden_s = self.act_from_hist(
            feats.transpose(0, 1), commands, hidden, *self._noise(gumbel))
        return feats, s_out, t_out, hidden_s

    def act_vec_incremental(self, tick_batch: dict,
                            feat_hist: Optional[torch.Tensor], hidden: Carry,
                            gumbel: Gumbel, refresh: bool = False):
        """N envs with the feature history [T, N, F] kept on the device:
        only the newest frame of each env is encoded and shifted in, or,
        with `refresh` or no history, the whole window is encoded (after an
        env reset). Returns (steer out, throttle out, carry, history)."""
        if feat_hist is None or refresh:
            feats, s_out, t_out, hidden_s = self.act_vec(tick_batch, hidden,
                                                         gumbel)
            return s_out, t_out, hidden_s, feats.transpose(0, 1)
        hist = torch.cat([feat_hist[1:],
                          self.encode(self._frames(tick_batch,
                                                     last=True))[None]])
        commands = self._on_device(tick_batch["command"], torch.long)
        s_out, t_out, hidden_s = self.act_from_hist(
            hist, commands, hidden, *self._noise(gumbel))
        return s_out, t_out, hidden_s, hist

    def zero_pending(self, num_envs: int):
        """The pending outputs of the first tick of an iteration (stored
        by no one: act_vec_store's store=False)."""
        n, dev, cfg = num_envs, self.device, self.agent_cfg

        def zeros(outputs):
            return PolicyOutput(torch.zeros(n, dtype=torch.long, device=dev),
                                torch.zeros(n, device=dev),
                                torch.zeros(n, device=dev),
                                torch.zeros(n, outputs, device=dev))

        f = self.obs_dim
        return (zeros(cfg.num_steer_outputs), zeros(cfg.num_throttle_outputs),
                torch.zeros(n, dtype=torch.long, device=dev),
                torch.zeros(n, 2, device=dev), torch.ones(n, device=dev),
                torch.ones(n, device=dev),
                (torch.zeros(n, f, device=dev), torch.zeros(n, f, device=dev)))

    def act_vec_store(self, tick_batch: dict,
                      feat_hist: Optional[torch.Tensor], hidden: Carry,
                      steer_buf: RolloutBuffer, throttle_buf: RolloutBuffer,
                      pending, store: bool, gumbel: Gumbel,
                      refresh: bool = False):
        """The fused tick: store the PREVIOUS tick's transition, then act.

        pending: (steer PolicyOutput, throttle PolicyOutput, commands [N],
        rewards [N,2], steer mask [N], throttle mask [N], the act-input
        carry (h [N,F], c [N,F])) of the previous tick, host arrays or
        device tensors (`zero_pending(n)` with store=False on the first
        tick of an iteration). The stored observation is the history that
        tick acted on, `feat_hist` as given. Then the newest frames are
        encoded and shifted in (the whole window with `refresh` or no
        history) and the banks act. Returns (steer out, throttle out,
        carry, history, steer_buf, throttle_buf)."""
        s_pend, t_pend, pend_cmd, rewards, s_mask, t_mask, pend_hidden = \
            pending
        if store:
            # every host array up before the first insert launches
            cmd = self._on_device(pend_cmd, torch.long)
            rewards, s_mask, t_mask = (self._on_device(x, torch.float32)
                                       for x in (rewards, s_mask, t_mask))
            feats_prev = feat_hist.transpose(0, 1)             # [N, T, F]
            steer_buf = insert(
                steer_buf, feats_prev, s_pend.action, s_pend.log_prob,
                s_pend.value, rewards[:, 0], s_mask, pend_hidden, cmd)
            throttle_buf = insert(
                throttle_buf, feats_prev, t_pend.action, t_pend.log_prob,
                t_pend.value, rewards[:, 1], t_mask, pend_hidden, cmd)
        refresh = refresh or feat_hist is None
        s_out, t_out, hidden_s, hist = self.act_vec_incremental(
            tick_batch, feat_hist, hidden, gumbel, refresh=refresh)
        return s_out, t_out, hidden_s, hist, steer_buf, throttle_buf

    def _bootstrap_value(self, steer_obs, steer_cmd, throttle_obs,
                         throttle_cmd, hidden: Carry):
        """Next-state values for GAE (ppo_agent/agent.py:143-164): each
        signal's stored [seq, F] observation unrolled through its command's
        LSTM from `hidden`, the value of the last step; with `use_lstm`
        False, the value of the last step's features.

        With `use_lstm` set and a memory other than the LSTM, the JAX
        package's `_bootstrap_value` unrolls that memory as an LSTM and
        fails (an AttributeError: a TransformerMemory has no `cell`, memory
        'none' has no module); this raises a ValueError instead."""
        cfg = self.agent_cfg
        if cfg.use_lstm and memory_kind(cfg.memory) != "lstm":
            raise ValueError(
                f"get_value with memory={cfg.memory!r} and use_lstm=True: "
                "the JAX package's _bootstrap_value unrolls every use_lstm "
                "memory as an LSTM and fails here; the device iteration "
                "bootstraps through act_from_hist instead")

        def one(bank, obs_seq, cmd):
            cmd = self._on_device(np.asarray([cmd]).reshape(1), torch.long)
            with torch.no_grad():
                return bank.evaluate(
                    self._on_device(obs_seq, torch.float32)[:, None], cmd,
                    hidden)[1][0]

        return (one(self.steer, steer_obs, steer_cmd),
                one(self.throttle, throttle_obs, throttle_cmd))

    def get_value(self, done: bool, steer_batch, throttle_batch):
        """Bootstrap values: zeros when done, else `_bootstrap_value` of
        the (obs [seq, F], command) pairs from `hidden_state`."""
        if done:
            zero = torch.zeros((), device=self.device)
            return zero, zero.clone()
        return self._bootstrap_value(*steer_batch, *throttle_batch,
                                     self.hidden_state)

    def update_policy(self, steer_mb: Minibatch,
                      throttle_mb: Minibatch) -> Tuple[float, float, float]:
        """One PPO minibatch step on the agent's optimizer; the (value,
        action, entropy) losses, read back."""
        aux = update_step(self.steer, self.throttle, self.opt, steer_mb,
                          throttle_mb, self.ppo_cfg)
        return tuple(float(x) for x in torch.stack(tuple(aux)).cpu())

    def banks(self) -> Dict[str, PolicyBank]:
        return {"steer": self.steer, "throttle": self.throttle}

    def save_snapshot(self, path: str,
                      opt: Optional[torch.optim.Optimizer] = None) -> None:
        """Both banks to `path`: a torch file, or with a `.msgpack` path
        the JAX package's snapshot. With `opt`, its state too, for an exact
        resume: inside the torch file, or as the optax state in
        `path + ".opt"`."""
        if path.endswith(".msgpack"):
            ckpt.save_pytree(path, {name: policy_to_flax(bank.state_dict())
                                    for name, bank in self.banks().items()})
            if opt is not None:
                ckpt.save_pytree(path + ".opt",
                                 adam_to_optax(opt, self.banks()))
            return
        tree = {name: bank.state_dict() for name, bank in self.banks().items()}
        if opt is not None:
            tree["opt"] = opt.state_dict()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(tree, path)

    def load_snapshot(self, path: str,
                      opt: Optional[torch.optim.Optimizer] = None) -> None:
        """Load a snapshot (any format `Ensemble.load` takes); with `opt`,
        restore its state too: from a torch file (which must hold it) or,
        as the JAX package does, from `path + ".opt"` where that exists."""
        for name, sd in snapshot_banks(path, self).items():
            self.banks()[name].load_state_dict(sd)
        if opt is None:
            return
        if path.endswith(".msgpack"):
            if os.path.exists(path + ".opt"):
                adam_from_optax(opt, self.banks(),
                                ckpt.load_pytree(path + ".opt"))
        else:
            opt.load_state_dict(ckpt.load_pt(path)["opt"])


def policy_bank(agent_cfg: AgentConfig, banks: int, outputs: int,
                features: int) -> PolicyBank:
    """A PolicyBank of `banks` command banks with the memory and head that
    `agent_cfg` asks for (the JAX package's `CadreAgent.create`)."""
    return PolicyBank(banks, outputs, features, memory=agent_cfg.memory,
                      use_lstm=agent_cfg.use_lstm, ordinal=agent_cfg.ordinal)


def snapshot_banks(path: str, agent: CadreAgent) -> Dict[str, StateDict]:
    """{'steer', 'throttle'} PolicyBank state_dicts (CPU tensors) of the
    snapshot at `path`: the port's `.pt`, the JAX package's `.msgpack`, or
    a reference ppo_model_<N>.pt, whose missing banks keep `agent`'s."""
    if path.endswith(".msgpack"):
        tree = ckpt.load_pytree(path)
        return {name: policy_from_flax(tree[name])
                for name in ("steer", "throttle")}
    blob = ckpt.load_pt(path)
    if isinstance(blob, dict) and {"steer", "throttle"} <= blob.keys():
        return {name: blob[name] for name in ("steer", "throttle")}
    if isinstance(blob, dict) and any(k.startswith(("steer_", "throttle_"))
                                      for k in blob):
        current = {name: policy_to_flax(bank.state_dict())
                   for name, bank in agent.banks().items()}
        banks, _ = ckpt.import_policy_torch(
            blob, current["steer"], current["throttle"],
            agent.agent_cfg.command_num)
        return {name: policy_from_flax(banks[name])
                for name in ("steer", "throttle")}
    raise ValueError(f"{path} is not a policy snapshot: neither the port's "
                     "{'steer', 'throttle'} nor the reference's "
                     "'{steer,throttle}_{ppo,lstm}_{k}' entries")


def adam_to_optax(opt: torch.optim.Optimizer,
                  banks: Dict[str, PolicyBank]) -> dict:
    """torch Adam's state over the banks' parameters as the JAX package's
    optax chain(clip_by_global_norm, adam) state (count int32, mu and nu
    in the banks' flax layout); zeros for a parameter not stepped yet."""
    def moments(key):
        return {name: policy_to_flax({
            n: opt.state[p][key] if p in opt.state else torch.zeros_like(p)
            for n, p in bank.named_parameters()})
            for name, bank in banks.items()}

    steps = [int(s["step"]) for s in opt.state.values()]
    count = np.asarray(max(steps, default=0), np.int32)
    return {"0": {}, "1": {"0": {"count": count, "mu": moments("exp_avg"),
                                 "nu": moments("exp_avg_sq")}, "1": {}}}


def adam_from_optax(opt: torch.optim.Optimizer, banks: Dict[str, PolicyBank],
                    tree: dict) -> None:
    """The inverse of adam_to_optax: `opt`'s state over the banks'
    parameters from an optax chain(clip_by_global_norm, adam) state."""
    adam = tree["1"]["0"]
    step = float(np.asarray(adam["count"]))
    for name, bank in banks.items():
        mu, nu = policy_from_flax(adam["mu"][name]), \
            policy_from_flax(adam["nu"][name])
        for n, p in bank.named_parameters():
            opt.state[p] = {"step": torch.tensor(step),
                            "exp_avg": mu[n].to(p.device),
                            "exp_avg_sq": nu[n].to(p.device)}


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
        """The snapshots at `snapshot_paths` (`snapshot_banks`' formats,
        mixed as they come), stacked on the host and then copied to the
        agent's device once."""
        trees = [snapshot_banks(p, agent) for p in snapshot_paths]
        if not trees:
            raise ValueError("an ensemble needs at least one snapshot")
        k, cfg, f = len(trees), agent.agent_cfg, agent.obs_dim
        banks = []
        for name, outputs in (("steer", cfg.num_steer_outputs),
                              ("throttle", cfg.num_throttle_outputs)):
            with torch.device("meta"):
                bank = policy_bank(cfg, k * cfg.command_num, outputs, f)
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


class EnsembleAgent:
    """K member snapshots driving one host env: the host-env twin of the
    JAX package's EnsembleAgent (eval.py's K agents as one).

    `act` encodes the tick's T frames once through the frozen encoder (one
    dual-attention call at B = T), samples all K members in one pass of
    the folded banks, and returns the K (steer, throttle) index pairs
    after one device-to-host copy. As in the JAX package, every member
    acts from the agent's stale zero carry, which the ensemble never
    advances."""

    def __init__(self, agent: CadreAgent, snapshot_paths: Sequence[str]):
        self.agent = agent
        self.ensemble = Ensemble.load(agent, snapshot_paths)
        self.k = self.ensemble.members

    def gumbel(self, gen: torch.Generator) -> Gumbel:
        """One act's noise from `gen`: (steer [K, 1, 33], throttle
        [K, 1, 3]) on the agent's device."""
        cfg, dev = self.agent.agent_cfg, self.agent.device
        return (draw_gumbel((self.k, 1, cfg.num_steer_outputs), gen, dev),
                draw_gumbel((self.k, 1, cfg.num_throttle_outputs), gen, dev))

    def act(self, tick_data: dict,
            noise: Union[torch.Generator, Gumbel]) -> List[Tuple[int, int]]:
        """tick_data: 'rgb' [T,H,W,3], 'route_fig' [T,W,H], 'measurements'
        [T,3], 'command' int. `noise`: a generator on the agent's device,
        or the (steer, throttle) Gumbel arrays [K, 1, A] themselves."""
        agent = self.agent
        if isinstance(noise, torch.Generator):
            noise = self.gumbel(noise)
        feats = agent.encode(agent._frames(tick_data, last=False))  # [T, F]
        cmd = agent._on_device(np.asarray([tick_data["command"]]), torch.long)
        steer, throttle = self.ensemble.act(feats[:, None], cmd,
                                            agent.hidden_state,
                                            *agent._noise(noise))
        pairs = torch.stack([steer[:, 0], throttle[:, 0]], dim=1).cpu()
        return [(int(s), int(t)) for s, t in pairs.tolist()]
