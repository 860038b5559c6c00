"""ppo_ops_per_step: device operations launched by the traced iteration's
rollout (everything up to the end of its bootstrap latent), per env
step."""


def read(obs):
    s = obs.get("trace")
    if obs.get("kind") != "ppo" or s is None or s.last_end("encode") is None:
        return None
    split = s.last_end("encode")
    lo, _ = s.window()
    n = sum(1 for k in s.kernels
            if (s.launched_at(k) or 0.0) >= lo
            and s.launched_at(k) is not None and s.launched_at(k) <= split)
    return n / obs["num_steps"] if n else None
