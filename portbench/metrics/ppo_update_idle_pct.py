"""ppo_update_idle_pct: the share of the traced window with no device op
whose gaps' midpoints fall inside the program's `cadre:update` span (the
fused update, its children included) on the window's thread."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    if sp is None or not sp.of_name("update"):
        return None
    return 100.0 * sp.idle_s("update") / sp.summary.window_s()
