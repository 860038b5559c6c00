"""Phase timing and trace spans of the training loops.

`span(name)` marks a stretch of the program as `cadre:<name>` in a
torch.profiler trace (a `record_function` range, on the clock of the
trace's device records), and only while a torch.profiler session is
recording: otherwise it enters nothing, so a span costs about a
microsecond of the host. The spans of the device iteration are
`cadre:encode` (`CadreAgent.encode`), `cadre:env` (`DrivingEnv.step`),
`cadre:update` (the fused update) and its children `cadre:update/loss`,
`cadre:update/backward` and `cadre:update/optim` (each minibatch step of
`rl/ppo.py` `update_step`).

`PhaseTimer`, wall-clock totals of named phases (act, env, update),
opens a span of each phase it times.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Iterator

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled


class span:
    """`with span(name):` a `cadre:<name>` range while a profiler records,
    nothing otherwise."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._range = torch.profiler.record_function(f"cadre:{self.name}")
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name]
                / max(self.counts[name], 1),
            }
            for name in self.totals
        }
