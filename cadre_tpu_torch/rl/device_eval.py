"""On-device K-snapshot ensemble evaluation over the batched device env.

PyTorch counterpart of cadre_tpu.rl.device_eval. The reference eval
protocol (eval.py:12-64 + agent.py:83-95): every member acts on the same
observation from the same feature history and a zero LSTM carry, each
discrete (steer, throttle) pair converts through the control LUTs, the K
controls are averaged, and a mean brake below 0.5 is zeroed. The episode
outcomes stay on the device for the whole run and are read once at the
end; the host then scores each finished episode with the penalty table.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from cadre_tpu_torch.configs.agent_config import (
    STEER_CONTROL,
    THROTTLE_CONTROL,
    RolloutConfig,
)
from cadre_tpu_torch.envs.torch_env import (
    ERROR_CODES,
    DrivingEnv,
    StepDraws,
    draw_step,
)
from cadre_tpu_torch.rl.agent import CadreAgent, Ensemble
from cadre_tpu_torch.rl.device_rollout import ActDraws, advance_hist
from cadre_tpu_torch.rl.distributions import gumbel

# driving-score penalties (statistics_manager.py:22-26): collision with a
# static object, a vehicle, a pedestrian; then per red light and per stop
_PENALTY_BY_CODE = {1: 0.65, 2: 0.60, 3: 0.50}
_RED_PENALTY, _STOP_PENALTY = 0.70, 0.80


class EvalDraws(NamedTuple):
    """Every random number of one evaluation: the reset's env draws, then
    one ActDraws per step whose Gumbel noise is [K, N, A], one row per
    member."""

    reset: StepDraws
    steps: Sequence[ActDraws]


def evaluate_device(agent: CadreAgent, env: DrivingEnv,
                    snapshot_paths: Sequence[str], max_steps: int = 2000,
                    seed: int = 0, seq_length: Optional[int] = None,
                    route_ids: Optional[Sequence[int]] = None,
                    draws: Optional[EvalDraws] = None) -> List[dict]:
    """Load the member snapshots at `snapshot_paths` and run
    `evaluate_ensemble` with them."""
    return evaluate_ensemble(agent, env, Ensemble.load(agent, snapshot_paths),
                             max_steps, seed, seq_length, route_ids, draws)


def evaluate_ensemble(agent: CadreAgent, env: DrivingEnv, ensemble: Ensemble,
                      max_steps: int = 2000, seed: int = 0,
                      seq_length: Optional[int] = None,
                      route_ids: Optional[Sequence[int]] = None,
                      draws: Optional[EvalDraws] = None) -> List[dict]:
    """Run `max_steps` batched steps of the ensemble (len(draws.steps)
    with `draws`); returns one dict per finished episode: completion,
    error, steps, red_lights, stops and driving_score.

    With `route_ids` (one per env), env i is pinned to that route and only
    its first finished episode is reported, with `route_id` added: the
    sequential RouteIndexer protocol. A training-mode env is evaluated in
    eval mode. The draws come from a generator seeded by `seed` unless
    `draws` gives them. One ensemble serves several evaluations (the
    NoCrash protocol's towns and traffic tiers) with one load."""
    if env.cfg.training:
        # eval never ends episodes on the training-only rules (overspeed,
        # static collision) and widens d_max
        env = DrivingEnv(env.bank, num_envs=env.num_envs, device=env.device,
                         config=dataclasses.replace(env.cfg, training=False))
    k, n, f = ensemble.members, env.num_envs, agent.obs_dim
    seq = seq_length or RolloutConfig().seq_length
    dev = agent.device
    steer_lut = torch.as_tensor(STEER_CONTROL, dtype=torch.float32,
                                device=dev)
    throttle_lut = torch.as_tensor(THROTTLE_CONTROL, dtype=torch.float32,
                                   device=dev)
    n_routes = env.bank.routes.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = agent.agent_cfg

    def draw(t: int) -> ActDraws:
        if draws is not None:
            return draws.steps[t]
        return ActDraws(gumbel((k, n, cfg.num_steer_outputs), gen, dev),
                        gumbel((k, n, cfg.num_throttle_outputs), gen, dev),
                        draw_step(env.cfg, n_routes, n, gen, dev))

    steps = len(draws.steps) if draws is not None else max_steps
    reset = draws.reset if draws is not None else \
        draw_step(env.cfg, n_routes, n, gen, dev)
    hidden = (torch.zeros((n, f), device=dev),
              torch.zeros((n, f), device=dev))
    with torch.no_grad():
        if route_ids is not None:
            state, obs = env.reset_routes(route_ids, reset)
        else:
            state, obs = env.reset(reset)
        feat_hist = agent.encode(obs)[None].expand(seq, n, f).clone()
        done_prev = torch.zeros((n,), dtype=torch.bool, device=dev)
        outs = []
        for t in range(steps):
            d = draw(t)
            feat_hist = advance_hist(feat_hist, agent.encode(obs), done_prev)
            sa, ta = ensemble.act(feat_hist, obs["command"], hidden,
                                  d.steer_gumbel, d.throttle_gumbel)
            controls = torch.cat([steer_lut[sa][..., None], throttle_lut[ta]],
                                 dim=-1).mean(0)                # [N, 3]
            brake = controls[:, 2]
            controls = torch.cat([controls[:, :2], torch.where(
                brake < 0.5, 0.0, brake)[:, None]], dim=-1)
            state, out = env.step(state, controls, d.env)
            obs = dict(rgb=out.rgb, route_fig=out.route_fig,
                       measurements=out.measurements, command=out.command)
            done_prev = out.done
            outs.append((out.done, out.completion, out.error_code,
                         out.infractions))
    if not outs:
        return []
    done, completion, err, infractions = (
        torch.stack(x).cpu().numpy() for x in zip(*outs))
    return _score(done, completion, err, infractions, route_ids)


def _score(done: np.ndarray, completion: np.ndarray, err: np.ndarray,
           infractions: np.ndarray, route_ids: Optional[Sequence[int]]
           ) -> List[dict]:
    """One row per finished episode ([T, N] step outcomes), scored with
    the collision penalty of its error code composed with 0.70 per red
    light and 0.80 per stop infraction."""
    episodes = []
    n = done.shape[1]
    start = np.zeros(n, np.int64)
    finished = np.zeros(n, bool)
    for t in range(done.shape[0]):
        for i in np.nonzero(done[t])[0]:
            if route_ids is not None and finished[i]:
                continue          # sequential protocol: one episode a route
            finished[i] = True
            code = int(err[t, i])
            comp = float(completion[t, i])
            n_red, n_stop = (int(x) for x in infractions[t, i])
            pen = (_PENALTY_BY_CODE.get(code, 1.0) * _RED_PENALTY ** n_red
                   * _STOP_PENALTY ** n_stop)
            row = dict(completion=comp,
                       error=ERROR_CODES.get(code, str(code)),
                       steps=int(t - start[i]), red_lights=n_red,
                       stops=n_stop, driving_score=100.0 * comp * pen)
            if route_ids is not None:
                row["route_id"] = int(route_ids[i])
            episodes.append(row)
            start[i] = t
    return episodes
