"""ppo_env_ops_per_step: device operations launched inside the program's
`cadre:env` span (`DrivingEnv.step`, K1 included), over the traced
iteration's T env steps."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    each = [] if sp is None else sp.op_counts("env")
    return sum(each) / len(each) if each else None
