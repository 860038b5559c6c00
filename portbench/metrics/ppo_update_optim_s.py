"""ppo_update_optim_s: the device time of the program's
`cadre:update/optim` span, the global-norm clip, the gradients'
hand-over and the Adam step: the union of the intervals of the ops
launched inside each minibatch step's span, summed over the traced
iteration's E x M steps."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    each = [] if sp is None else sp.device_s("update/optim")
    return sum(each) if each else None
