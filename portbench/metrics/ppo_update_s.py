"""ppo_update_s: an iteration's time to the read of its checksum less its
rollout_seconds, as train_device splits it; mean over the window's
untraced iterations."""


def read(obs):
    its = obs.get("plain_iterations") if obs.get("kind") == "ppo" else None
    if not its:
        return None
    return sum(i["seconds"] - i["rollout"] for i in its) / len(its)
