"""ppo_update_backward_s: the device time of the program's
`cadre:update/backward` span, the gradients (`torch.autograd.grad`; on
CUDA the autograd engine launches its kernels from a thread of its own,
so they are matched by time): the union of the intervals of the ops
launched inside each minibatch step's span, summed over the traced
iteration's E x M steps."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    each = [] if sp is None else sp.device_s("update/backward")
    return sum(each) if each else None
