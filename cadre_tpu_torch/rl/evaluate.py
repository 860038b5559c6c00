"""K-snapshot ensemble evaluation on a host env.

PyTorch counterpart of cadre_tpu.rl.evaluate (the reference's eval.py:12-64
protocol): load K member snapshots, act all of them on every tick, average
their controls with the brake thresholded (agent.py:83-95), and run
`eval_episode` episodes. Each episode is scored with the leaderboard's
penalty table; `result_file` gets one row of per-criterion values per
episode, and the env writes its own completion CSV.

The members' Gumbel noise comes from a generator on the agent's device
seeded by `seed`, or from `draws`: one (steer [K, 1, 33], throttle
[K, 1, 3]) pair per tick over the whole run.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from cadre_tpu_torch.configs.agent_config import EvalConfig, avg_action
from cadre_tpu_torch.envs.scoring import StatisticsManager, write_criteria_csv
from cadre_tpu_torch.rl.agent import CadreAgent, EnsembleAgent, Gumbel
from cadre_tpu_torch.utils.logger import logger


@dataclasses.dataclass
class EvalEpisodeResult:
    episode: int
    steps: int
    completion_ratio: float
    error_message: str
    driving_score: float = 0.0


def evaluate(env, agent: CadreAgent, snapshot_paths: Sequence[str],
             eval_cfg: Optional[EvalConfig] = None, seed: int = 0,
             max_steps: int = 6000, result_file: Optional[str] = None,
             draws: Optional[Sequence[Gumbel]] = None
             ) -> List[EvalEpisodeResult]:
    """Run the ensemble of `snapshot_paths` for `eval_cfg.eval_episode`
    episodes of at most `max_steps` ticks each. An episode cut by
    `max_steps` is scored on its live progress."""
    eval_cfg = eval_cfg or EvalConfig()
    ens = EnsembleAgent(agent, list(snapshot_paths))
    gen = torch.Generator(device=agent.device)
    gen.manual_seed(seed)
    ticks = iter(draws) if draws is not None else None
    results: List[EvalEpisodeResult] = []
    stats = StatisticsManager()
    for episode in range(eval_cfg.eval_episode):
        obs = env.reset()
        done, steps = False, 0
        msg = ""
        while not done and steps < max_steps:
            actions = ens.act(obs, next(ticks) if ticks is not None else gen)
            control = avg_action(actions, eval_cfg.brake_threshold)
            obs, _, done, info = env.step(control)
            msg = info.get("error_message", "")
            steps += 1
        ratio = getattr(env, "completion_ratio", 0.0)
        score = ratio
        criteria = getattr(env, "_criteria", None)
        if criteria:
            rec = stats.compute(str(getattr(env, "route_name", episode)),
                                criteria)
            score = rec.score
            if not done:  # episode cut by max_steps: use live progress
                ratio = rec.completion
            if result_file:
                write_criteria_csv(result_file, criteria)
        results.append(EvalEpisodeResult(episode, steps, ratio, msg, score))
        logger.log(f"eval episode {episode}: {steps} steps, completion "
                   f"{ratio:.1f}%, driving score {score:.1f}, end: {msg!r}")
    if stats.records:
        g = stats.global_record()
        logger.log(
            f"driving score over {g['routes']} routes: composed "
            f"{g['score_composed']:.1f} (route {g['score_route']:.1f} x "
            f"penalty {g['score_penalty']:.2f})")
    return results
