"""k2_roofline_pct.ppo: the fused dual-attention forward (in the
encoder's dtype, at B = N) of the traced iteration: least time from its shapes over its
device time (each call's launches' union), summed over the calls."""
from portbench.core.roofline import k2_least_s, share_pct


def read(obs):
    s = obs.get("trace")
    calls = (obs.get("calls") or {}).get("k2")
    if obs.get("kind") != "ppo" or s is None or not calls:
        return None
    device = s.per_call_device_s("k2")
    if len(device) != len(calls) or sum(device) <= 0:
        return None
    return share_pct([k2_least_s(*c) for c in calls], device)
