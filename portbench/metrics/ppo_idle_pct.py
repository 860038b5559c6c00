"""ppo_idle_pct: the share of the traced iteration in which no operation
ran on the device."""


def read(obs):
    s = obs.get("trace")
    if obs.get("kind") != "ppo" or s is None:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s())
