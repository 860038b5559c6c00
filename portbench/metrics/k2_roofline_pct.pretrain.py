"""k2_roofline_pct.pretrain: the f32 dual-attention forward of the traced
steps: least time from its shapes over its device time."""
from portbench.core.roofline import k2_least_s, share_pct


def read(obs):
    s = obs.get("trace")
    calls = (obs.get("calls") or {}).get("k2")
    if obs.get("kind") != "pretrain" or s is None or not calls:
        return None
    device = s.per_call_device_s("k2")
    if len(device) != len(calls) or sum(device) <= 0:
        return None
    return share_pct([k2_least_s(*c) for c in calls], device)
