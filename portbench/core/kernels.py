"""Profiler ranges around the port's kernel entries, in the traced stretch
only: K1 `ops.paint.paint_shapes` (looked up on its module by the env),
K2 `fused_dual_attention` as `models.danet` calls it, K3
`ops.dual_attention.dual_attention_backward` as the autograd function
calls it. Each call's shapes are kept for its least time
(core/roofline.py); its device time is whatever its launches take, read
from the trace by the range."""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.core.hooks import Patches


def install(patches: Patches, calls: Dict[str, List[tuple]]) -> None:
    from cadre_tpu_torch.models import danet
    from cadre_tpu_torch.ops import dual_attention, paint

    def ranged(name, shape_of):
        def make(fn):
            def wrapped(*args, **kwargs):
                calls.setdefault(name, []).append(shape_of(*args))
                with torch.profiler.record_function(f"pb:{name}"):
                    return fn(*args, **kwargs)
            return wrapped
        return make

    patches.wrap(paint, "paint_shapes", ranged(
        "paint", lambda base, shapes: (base.numel(), shapes.numel())))
    patches.wrap(danet, "fused_dual_attention", ranged(
        "k2", lambda x, q, *rest: (x.shape[0], x.shape[1] * x.shape[2],
                                   x.shape[3], q.shape[3],
                                   x.dtype == torch.bfloat16)))
    patches.wrap(dual_attention, "dual_attention_backward", ranged(
        "k3", lambda q, k, v, gp, xc, *rest: (q.shape[0],
                                              q.shape[1] * q.shape[2],
                                              xc.shape[3], q.shape[3])))


def method_ranges(patches: Patches, owner, names: Dict[str, str]) -> None:
    """owner.<attr> inside range pb:<label>, for {attr: label}."""
    for attr, label in names.items():
        def make(fn, label=label):
            def wrapped(*args, **kwargs):
                with torch.profiler.record_function(f"pb:{label}"):
                    return fn(*args, **kwargs)
            return wrapped
        patches.wrap(owner, attr, make)
