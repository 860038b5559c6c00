"""paint_roofline_pct.ppo: K1's least time (bytes of its canvas and table
at HBM speed) over its device time, summed over the traced iteration's
calls."""
from portbench.core.roofline import paint_least_s, share_pct


def read(obs):
    s = obs.get("trace")
    calls = (obs.get("calls") or {}).get("paint")
    if obs.get("kind") != "ppo" or s is None or not calls:
        return None
    device = s.per_call_device_s("paint")
    if len(device) != len(calls) or sum(device) <= 0:
        return None
    return share_pct([paint_least_s(*c) for c in calls], device)
