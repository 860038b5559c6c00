"""ppo_encode_ms: the device time of one `CadreAgent.encode` (the
program's `cadre:encode` span: the union of the intervals of the ops
launched inside it), mean over the traced iteration's T+1 calls."""
from portbench.core import spans


def read(obs):
    sp = spans.of(obs)
    each = [] if sp is None else sp.device_s("encode")
    return 1e3 * sum(each) / len(each) if each else None
