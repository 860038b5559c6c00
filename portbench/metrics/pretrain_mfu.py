"""pretrain_mfu: a step's model FLOPs (forward and backward, from the
configuration's shapes) over the median untraced step time, as a share
of the dense bf16 peak of 989 TFLOP/s."""
import statistics

from portbench.core.roofline import MFU_PEAK


def read(obs):
    ms = obs.get("step_ms") if obs.get("kind") == "pretrain" else None
    if not ms:
        return None
    return 100.0 * obs["flops_per_step"] / (statistics.median(ms) * 1e-3) \
        / MFU_PEAK
