"""Episode recording and replay logs (the port's copy of the JAX
package's host `envs/recorder.py`).

`record_episodes` drives any BaseDrivingEnv-contract env with a controller
(expert or agent) and dumps the tick stream to an .npz log;
`load_replay_log` rehydrates it as a list of tick_data dicts that
FakeDrivingEnv replays — the offline cascade-inference eval seam.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def record_episodes(env, controller: Callable[[Any, Dict], List[float]],
                    n_steps: int, path: str) -> str:
    """controller(env, tick) -> [steer, throttle, brake]."""
    ticks: Dict[str, List[Any]] = {
        "rgb": [], "route_fig": [], "measurements": [], "command": [],
        "reward": [], "done": [],
    }
    tick = env.reset()
    for _ in range(n_steps):
        control = controller(env, tick)
        # histories are ring views — copy anything retained across steps
        ticks["rgb"].append(np.array(tick["rgb"]))
        ticks["route_fig"].append(np.array(tick["route_fig"]))
        ticks["measurements"].append(np.array(tick["measurements"]))
        ticks["command"].append(tick["command"])
        tick, reward, done, _ = env.step(control)
        ticks["reward"].append(np.asarray(reward))
        ticks["done"].append(done)
        if done:
            tick = env.reset()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in ticks.items()})
    return path


def load_replay_log(path: str) -> List[Dict[str, Any]]:
    with np.load(path) as z:
        n = len(z["command"])
        return [
            {"rgb": z["rgb"][i], "route_fig": z["route_fig"][i],
             "measurements": z["measurements"][i],
             "command": int(z["command"][i])}
            for i in range(n)
        ]


def make_replay_env(path: str, episode_length: Optional[int] = None):
    """FakeDrivingEnv replaying a recorded log."""
    from cadre_tpu_torch.envs.fake_env import FakeDrivingEnv

    log = load_replay_log(path)
    return FakeDrivingEnv(log=log,
                          episode_length=episode_length or len(log))
