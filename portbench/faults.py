"""Faults planted in the program underneath a run, to see `correct` come
out false (portbench/tests/test_portbench_faults.py on the CPU;
`control.py --fault` on the card at a cell's size). Each is a context
manager that patches the port and restores it:

- unchanged: every Adam step returns the state as it was;
- half: half of each batch left out, the mean taken over the rest (the
  PPO minibatch gather; the trainer's unpacked batch and its masks);
- altered: an answer altered where it is produced (a PPO action after
  its log-prob was taken; the trainer's total loss scaled by 1.01);
- painted: a frame altered where it is produced (one value of every
  canvas K1 paints raised by 1; PPO only)."""
from __future__ import annotations

from contextlib import contextmanager

import torch

from portbench.core.hooks import Patches

FAULTS = {"ppo_iteration": ("unchanged", "half", "altered", "painted"),
          "pretrain_step": ("unchanged", "half", "altered")}


@contextmanager
def planted(fault: str, kind: str):
    """`kind` is the traffic's generator: 'ppo_iteration' or
    'pretrain_step'."""
    patches = Patches()
    try:
        if fault == "unchanged":
            patches.wrap(torch.optim.Adam, "step",
                         lambda fn: lambda self, closure=None: None)
        elif fault == "half" and kind == "ppo_iteration":
            from cadre_tpu_torch.rl import fused_update

            patches.wrap(fused_update, "gather_minibatch_batched",
                         lambda fn: lambda buf, ret, adv, idx: fn(
                             buf, ret, adv, idx[:max(1, len(idx) // 2)]))
        elif fault == "half":
            from cadre_tpu_torch.perception import trainer

            def half(fn):
                def wrapped(batch):
                    out = fn(batch)
                    b = out["x"].shape[0]
                    return {k: v[:max(1, b // 2)] for k, v in out.items()}
                return wrapped

            patches.wrap(trainer, "unpack_batch", half)
        elif fault == "altered" and kind == "ppo_iteration":
            from cadre_tpu_torch.models import policy

            def alter(fn):
                def wrapped(self, obs_seq, commands, carry, gumbel):
                    out, c = fn(self, obs_seq, commands, carry, gumbel)
                    n = out.logits.shape[-1]
                    return out._replace(action=(out.action + 1) % n), c
                return wrapped

            patches.wrap(policy.PolicyBank, "act_batch", alter)
        elif fault == "altered":
            from cadre_tpu_torch.perception import trainer

            def scaled(fn):
                def wrapped(*args, **kwargs):
                    total, terms = fn(*args, **kwargs)
                    return total * 1.01, terms
                return wrapped

            patches.wrap(trainer, "total_danet_loss", scaled)
        elif fault == "painted" and kind == "ppo_iteration":
            from cadre_tpu_torch.ops import paint

            def painted(fn):
                def wrapped(base, shapes):
                    out = fn(base, shapes)
                    out[:, 0, 0, 0] += 1.0
                    return out
                return wrapped

            patches.wrap(paint, "paint_shapes", painted)
        elif fault != "none":
            raise ValueError(f"no fault {fault!r} for {kind}; one of "
                             f"{FAULTS[kind]}")
        yield
    finally:
        patches.undo()
