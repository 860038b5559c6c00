"""Phase timing of the training loops: `PhaseTimer`, wall-clock totals of
named phases (act, env, update)."""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Iterator


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
