"""pretrain_ops_per_step: device operations in the traced steps, per
step."""


def read(obs):
    s = obs.get("trace")
    if obs.get("kind") != "pretrain" or s is None or not obs["traced_steps"]:
        return None
    lo, hi = s.window()
    n = sum(1 for k in s.kernels if lo <= k["ts"] <= hi)
    return n / obs["traced_steps"] if n else None
