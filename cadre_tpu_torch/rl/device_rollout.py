"""The device-resident training iteration: a policy driving N device envs
for T steps on one GPU, then the PPO update on what they saw.

PyTorch counterpart of cadre_tpu.rl.device_rollout. `make_device_rollout`
is the acting half: per step, encode the newest observation with the
frozen CoPM encoder, roll it into the 8-frame feature history (re-tiled
from the first frame after an auto-reset), act with the per-command banks
from a zero LSTM carry (the reference's behaviour), and step the envs; then
one bootstrap evaluation whose values are zeroed where the last step ended
an episode. It returns the [T+1, N, ...] buffers the update reads.
`make_device_iteration` composes it with the fused PPO update
(rl/fused_update.py), and `train_device` loops iterations on the agent's
optimizer.

With a mesh (parallel/mesh.py) each rank runs the rollout of its own
envs (the caller gives each rank its share of N) and the update's
sharded branch; the banks start from rank 0's and stay equal on every
rank, and only rank 0 logs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from cadre_tpu_torch.configs.agent_config import (
    STEER_CONTROL,
    THROTTLE_CONTROL,
    RolloutConfig,
    TrainConfig,
)
from cadre_tpu_torch.envs.torch_env import DrivingEnv, EnvState, StepDraws
from cadre_tpu_torch.parallel.mesh import Mesh, broadcast_
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.distributions import gumbel
from cadre_tpu_torch.rl.fused_update import Perms, make_fused_iteration_update
from cadre_tpu_torch.rl.rollout import RolloutBuffer
from cadre_tpu_torch.utils.profiling import span


class DeviceCarry(NamedTuple):
    """State carried from one rollout to the next."""

    env_state: EnvState
    obs: dict                      # rgb / route_fig / measurements / command
    feat_hist: torch.Tensor        # [seq, N, F] frames before `obs`
    done_prev: torch.Tensor        # [N] bool, the last step ended an episode


class ActDraws(NamedTuple):
    """The random numbers of one rollout step."""

    steer_gumbel: torch.Tensor     # [N, 33] standard Gumbel
    throttle_gumbel: torch.Tensor  # [N, 3]
    env: StepDraws


class RolloutMetrics(NamedTuple):
    mean_steer_reward: torch.Tensor
    mean_throttle_reward: torch.Tensor
    episodes_done: torch.Tensor
    completion_sum: torch.Tensor   # sum of completion at done steps
    error_hist: torch.Tensor       # [10] done-step counts per error code
    red_lights: torch.Tensor       # red-light infractions of done episodes
    checksum: torch.Tensor         # data-dependent scalar


class IterationMetrics(NamedTuple):
    value_loss: torch.Tensor
    policy_loss: torch.Tensor
    entropy_loss: torch.Tensor
    mean_steer_reward: torch.Tensor
    mean_throttle_reward: torch.Tensor
    episodes_done: torch.Tensor
    completion_sum: torch.Tensor   # sum of completion at done steps
    error_hist: torch.Tensor       # [10] done-step counts per error code
    red_lights: torch.Tensor       # red-light infractions of done episodes
    checksum: torch.Tensor         # rewards + the first policy leaf's sum
    rollout_seconds: float         # host clock, rollout half synchronised
    # the update's rows per bank over every minibatch step, (steer,
    # throttle) [C] host ints: how the update routed its rows
    update_bank_rows: Optional[list] = None


def advance_hist(feat_hist: torch.Tensor, feats: torch.Tensor,
                 done_prev: torch.Tensor) -> torch.Tensor:
    """Roll the newest features in; after an auto-reset re-tile the window
    from the fresh first frame."""
    rolled = torch.cat([feat_hist[1:], feats[None]], dim=0)
    tiled = feats[None].expand_as(feat_hist)
    return torch.where(done_prev[None, :, None], tiled, rolled)


def make_device_rollout(agent: CadreAgent, env: DrivingEnv,
                        rollout_cfg: Optional[RolloutConfig] = None,
                        seed: int = 0):
    """Returns (rollout, init_carry):

    init_carry(draws=None) -> DeviceCarry
    rollout(carry, draws=None) -> (carry, steer RolloutBuffer, throttle
        RolloutBuffer, (steer, throttle) bootstrap values [N], metrics)

    `draws` (a StepDraws for init_carry, T ActDraws for rollout) replaces
    the generators: the action noise comes from a generator seeded with
    `seed`, the env's from the env's own.
    """
    rollout_cfg = rollout_cfg or RolloutConfig()
    n = env.num_envs
    seq = rollout_cfg.seq_length
    f = agent.obs_dim
    dev = agent.device
    steer_lut = torch.as_tensor(STEER_CONTROL, dtype=torch.float32,
                                device=dev)
    throttle_lut = torch.as_tensor(THROTTLE_CONTROL, dtype=torch.float32,
                                   device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_steer = agent.agent_cfg.num_steer_outputs
    n_throttle = agent.agent_cfg.num_throttle_outputs

    def draw_act() -> ActDraws:
        return ActDraws(gumbel((n, n_steer), gen, dev),
                        gumbel((n, n_throttle), gen, dev), env.draw_step())

    def zero_hidden():
        # the reference's act path reads a zero LSTM carry every step
        return (torch.zeros((n, f), device=dev),
                torch.zeros((n, f), device=dev))

    @torch.no_grad()
    def init_carry(draws: Optional[StepDraws] = None) -> DeviceCarry:
        env_state, obs = env.reset(draws)
        feats = agent.encode(obs)
        feat_hist = feats[None].expand(seq, n, f).clone()
        return DeviceCarry(env_state, obs, feat_hist,
                           torch.zeros((n,), dtype=torch.bool, device=dev))

    @torch.no_grad()
    def rollout(carry: DeviceCarry,
                draws: Optional[Sequence[ActDraws]] = None):
        env_state, obs, feat_hist, done_prev = carry
        t_steps = len(draws) if draws is not None else rollout_cfg.num_steps
        ys: List[dict] = []
        for t in range(t_steps):
            d = draws[t] if draws is not None else draw_act()
            feat_hist = advance_hist(feat_hist, agent.encode(obs), done_prev)
            hidden = zero_hidden()
            commands = obs["command"]
            s_out, t_out, _ = agent.act_from_hist(
                feat_hist, commands, hidden, d.steer_gumbel,
                d.throttle_gumbel)
            controls = torch.cat([steer_lut[s_out.action][:, None],
                                  throttle_lut[t_out.action]], dim=-1)
            env_state, out = env.step(env_state, controls, d.env)
            obs = dict(rgb=out.rgb, route_fig=out.route_fig,
                       measurements=out.measurements, command=out.command)
            ys.append(dict(
                obs=feat_hist.transpose(0, 1), s_out=s_out, t_out=t_out,
                reward=out.rewards, action_done=out.action_done,
                hn=hidden[0], cn=hidden[1], command=commands, done=out.done,
                completion=out.completion, error_code=out.error_code,
                red=out.infractions[:, 0]))
            done_prev = out.done

        def stack(get):
            x = torch.stack([get(y) for y in ys])
            return torch.cat([x, torch.zeros_like(x[:1])], dim=0)

        def buffer(key: str, col: int) -> RolloutBuffer:
            return RolloutBuffer(
                obs=stack(lambda y: y["obs"]),
                action=stack(lambda y: y[key].action),
                log_prob=stack(lambda y: y[key].log_prob),
                value=stack(lambda y: y[key].value),
                reward=stack(lambda y: y["reward"][:, col]),
                mask=stack(lambda y: 1.0 - y["action_done"][:, col].float()),
                command=stack(lambda y: y["command"]),
                hn=stack(lambda y: y["hn"]), cn=stack(lambda y: y["cn"]))

        steer_buf, throttle_buf = buffer("s_out", 0), buffer("t_out", 1)

        # bootstrap values of the post-rollout obs, zeroed on done; the carry
        # keeps the pre-bootstrap history (frames strictly before obs)
        fh = advance_hist(feat_hist, agent.encode(obs), done_prev)
        live = 1.0 - done_prev.float()
        next_values: Tuple[torch.Tensor, torch.Tensor] = tuple(
            bank.evaluate(fh, obs["command"], zero_hidden())[1] * live
            for bank in (agent.steer, agent.throttle))

        rewards = torch.stack([y["reward"] for y in ys])        # [T, N, 2]
        done_f = torch.stack([y["done"] for y in ys]).float()   # [T, N]
        errors = torch.stack([y["error_code"] for y in ys])
        red = torch.stack([y["red"] for y in ys]).float()
        completion = torch.stack([y["completion"] for y in ys])
        metrics = RolloutMetrics(
            mean_steer_reward=rewards[..., 0].mean(),
            mean_throttle_reward=rewards[..., 1].mean(),
            episodes_done=done_f.sum(),
            completion_sum=(completion * done_f).sum(),
            error_hist=(torch.nn.functional.one_hot(errors, 10).float()
                        * done_f[..., None]).sum(dim=(0, 1)),
            red_lights=(red * done_f).sum(),
            checksum=rewards.sum() + steer_buf.log_prob.sum())
        return (DeviceCarry(env_state, obs, feat_hist, done_prev),
                steer_buf, throttle_buf, next_values, metrics)

    return rollout, init_carry


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_device_iteration(agent: CadreAgent, env: DrivingEnv,
                          rollout_cfg: Optional[RolloutConfig] = None,
                          train_cfg: Optional[TrainConfig] = None,
                          seed: int = 0, mesh: Optional[Mesh] = None):
    """Returns (iteration, init_carry):

    init_carry(draws=None) -> DeviceCarry
    iteration(opt, carry, draws=None, perms=None) -> (carry,
        IterationMetrics); the banks' parameters and `opt` (the agent's
        own, `agent.opt`) are updated in place.

    One iteration is a T-step rollout and the fused PPO update on its
    buffers. `draws` (T ActDraws) and `perms` ((steer, throttle) [E*M, B]
    row indices) replace the generators, which are seeded from `seed`.
    The update runs agent.ppo_cfg with ppo_epoch from `train_cfg` and
    gamma / tau from `rollout_cfg`, as the JAX iteration does; with `mesh`,
    its sharded branch over this rank's envs.
    """
    rollout_cfg = rollout_cfg or RolloutConfig()
    train_cfg = train_cfg or TrainConfig()
    ppo_cfg = dataclasses.replace(agent.ppo_cfg,
                                  ppo_epoch=train_cfg.ppo_epoch,
                                  gamma=rollout_cfg.gamma,
                                  tau=rollout_cfg.tau)
    rollout, init_carry = make_device_rollout(agent, env, rollout_cfg, seed)
    update = make_fused_iteration_update(agent.steer, agent.throttle,
                                         ppo_cfg, rollout_cfg, seed, mesh)

    def iteration(opt: torch.optim.Optimizer, carry: DeviceCarry,
                  draws: Optional[Sequence[ActDraws]] = None,
                  perms: Optional[Perms] = None):
        t0 = time.perf_counter()
        carry, steer_buf, throttle_buf, next_values, m = rollout(carry, draws)
        _sync(agent.device)
        rollout_seconds = time.perf_counter() - t0
        with span("update"):
            aux = update(opt, steer_buf, throttle_buf, next_values, perms)
        with torch.no_grad():
            # the JAX checksum's first params leaf: steer control fc1 bias
            checksum = (steer_buf.reward.sum() + throttle_buf.reward.sum()
                        + agent.steer.control["fc1"].bias.sum())
        metrics = IterationMetrics(
            value_loss=aux.value_loss, policy_loss=aux.action_loss,
            entropy_loss=aux.entropy_loss,
            mean_steer_reward=m.mean_steer_reward,
            mean_throttle_reward=m.mean_throttle_reward,
            episodes_done=m.episodes_done, completion_sum=m.completion_sum,
            error_hist=m.error_hist, red_lights=m.red_lights,
            checksum=checksum, rollout_seconds=rollout_seconds,
            update_bank_rows=update.bank_rows)
        return carry, metrics

    return iteration, init_carry


def train_device(agent: CadreAgent, env: DrivingEnv, iterations: int = 10,
                 rollout_cfg: Optional[RolloutConfig] = None,
                 train_cfg: Optional[TrainConfig] = None,
                 seed: int = 0, log_fn=print,
                 mesh: Optional[Mesh] = None) -> List[dict]:
    """Train the agent's banks in place for `iterations` iterations on the
    agent's optimizer (Adam at agent.ppo_cfg.lr, clip at its
    max_grad_norm). Returns one metrics row per iteration (of this rank's
    envs); each row is timed to the device's end by reading the
    iteration's checksum. With `mesh`, the banks start as rank 0's, rank r
    draws its action noise from seed + r, and only rank 0 logs."""
    rollout_cfg = rollout_cfg or RolloutConfig()
    if mesh is not None:
        broadcast_(agent.policy_parameters(), mesh)
        seed += mesh.rank
        if mesh.rank:
            log_fn = None
    iteration, init_carry = make_device_iteration(agent, env, rollout_cfg,
                                                  train_cfg, seed, mesh)
    carry = init_carry()
    steps_per_iter = rollout_cfg.num_steps * env.num_envs
    out = []
    for i in range(iterations):
        t0 = time.perf_counter()
        carry, m = iteration(agent.opt, carry)
        checksum = float(m.checksum)            # waits for the device
        dt = time.perf_counter() - t0
        episodes = float(m.episodes_done)
        row = dict(iteration=i, env_steps_per_sec=steps_per_iter / dt,
                   rollout_seconds=m.rollout_seconds,
                   update_seconds=dt - m.rollout_seconds,
                   value_loss=float(m.value_loss),
                   policy_loss=float(m.policy_loss),
                   entropy_loss=float(m.entropy_loss),
                   episodes_done=episodes,
                   mean_completion=float(m.completion_sum)
                   / max(episodes, 1.0),
                   steer_reward=float(m.mean_steer_reward),
                   throttle_reward=float(m.mean_throttle_reward),
                   checksum=checksum)
        out.append(row)
        if log_fn is not None:
            log_fn(f"device iter {i}: {row['env_steps_per_sec']:.0f} "
                   f"env-steps/s, value {row['value_loss']:.4f}, "
                   f"eps {row['episodes_done']:.0f}, "
                   f"completion {row['mean_completion']:.2%}")
    return out
