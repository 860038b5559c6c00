"""ppo_env_idle_pct: the share of the traced window with no device op
whose gaps' midpoints fall inside the program's `cadre:env` span on the
window's thread: the idle time the env step's host-side launches leave."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    if sp is None or not sp.of_name("env"):
        return None
    return 100.0 * sp.idle_s("env") / sp.summary.window_s()
