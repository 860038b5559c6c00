"""ppo_rollout_s: the rollout half of an iteration, the program's own
IterationMetrics.rollout_seconds (host clock, rollout synchronised),
mean over the window's untraced iterations."""


def read(obs):
    its = obs.get("plain_iterations") if obs.get("kind") == "ppo" else None
    if not its:
        return None
    return sum(i["rollout"] for i in its) / len(its)
