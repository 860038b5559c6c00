"""ppo_mfu: the iteration's model FLOPs (core/roofline.py, from the
configuration's shapes) over the mean untraced iteration's seconds, as a
share of the dense bf16 peak of 989 TFLOP/s."""
from portbench.core.roofline import MFU_PEAK


def read(obs):
    its = obs.get("plain_iterations") if obs.get("kind") == "ppo" else None
    if not its:
        return None
    seconds = sum(i["seconds"] for i in its) / len(its)
    return 100.0 * obs["flops_per_iteration"] / seconds / MFU_PEAK
