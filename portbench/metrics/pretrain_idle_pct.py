"""pretrain_idle_pct: the share of the traced steps in which no operation
ran on the device."""


def read(obs):
    s = obs.get("trace")
    if obs.get("kind") != "pretrain" or s is None:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.window_s())
