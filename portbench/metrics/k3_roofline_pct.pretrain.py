"""k3_roofline_pct.pretrain: the dual-attention backward of the traced
steps: least time from its shapes over its device time."""
from portbench.core.roofline import k3_least_s, share_pct


def read(obs):
    s = obs.get("trace")
    calls = (obs.get("calls") or {}).get("k3")
    if obs.get("kind") != "pretrain" or s is None or not calls:
        return None
    device = s.per_call_device_s("k3")
    if len(device) != len(calls) or sum(device) <= 0:
        return None
    return share_pct([k3_least_s(*c) for c in calls], device)
