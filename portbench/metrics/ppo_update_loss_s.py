"""ppo_update_loss_s: the device time of the program's `cadre:update/loss`
span, the loss forward (`ppo_loss`): the union of the intervals of the
ops launched inside each minibatch step's span, summed over the traced
iteration's E x M steps."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    each = [] if sp is None else sp.device_s("update/loss")
    return sum(each) if each else None
