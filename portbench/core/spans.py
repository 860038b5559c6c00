"""The program's own spans in a traced stretch: the `cadre:<name>` ranges
that `cadre_tpu_torch.utils.profiling.span` opens while a profiler
records (host `user_annotation` events of the trace, on the clock of its
device records).

- An instance is one span event that lies inside the `pb:window` range.
  Its parent is the innermost instance on its thread that encloses it.
- A device op belongs to the innermost instance open at its launch (the
  runtime call of its correlation id): one on the launching thread, or
  one of the `BLOCKING` spans on any thread. In those the caller waits
  while other threads launch: on CUDA the autograd engine launches the
  backward's kernels from its device thread, not the caller's.
- The ops launched inside an instance are its own and its descendants'.
- An idle gap (a stretch of the window with no device op) falls to the
  instances open at its midpoint on the window's thread.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional

from portbench.core.trace import TraceSummary, merge, union_seconds

PREFIX = "cadre:"
BLOCKING = frozenset({"update/backward"})


class Instance(NamedTuple):
    name: str
    tid: object
    start: float
    end: float


class Spans:
    """The `cadre:` instances of one trace and the device ops they
    launched."""

    def __init__(self, summary: TraceSummary):
        self.summary = summary
        lo, hi = summary.window()
        self.window_tid = summary.ranges["window"][0][0]
        found = []
        for tid, evs in summary.host.items():
            for e in evs:
                if e.get("cat") == "user_annotation" and \
                        e["name"].startswith(PREFIX):
                    a, b = e["ts"], e["ts"] + e.get("dur", 0.0)
                    if lo <= a and b <= hi:
                        found.append(Instance(e["name"][len(PREFIX):], tid,
                                              a, b))
        found.sort(key=lambda i: (i.start, -i.end))
        self.instances: List[Instance] = found
        self.parent: List[Optional[int]] = [None] * len(found)
        self.ops: List[List[dict]] = [[] for _ in found]
        self._attribute()

    def _attribute(self) -> None:
        """One sweep over span opens, launches and closes in time order:
        each thread's stack of open instances, and the open BLOCKING
        ones."""
        events = []
        for i, inst in enumerate(self.instances):
            events.append((inst.start, 0, -inst.end, i))
            events.append((inst.end, 2, -inst.start, i))
        for k in self.summary.kernels:
            at = self.summary.launch.get(
                (k.get("args") or {}).get("correlation"))
            if at is not None:
                events.append((at[1], 1, 0.0, (at[0], k)))
        events.sort(key=lambda e: e[:3])
        stacks: Dict[object, List[int]] = {}
        blocking: List[int] = []
        for _, kind, _, item in events:
            if kind == 0:
                inst = self.instances[item]
                stack = stacks.setdefault(inst.tid, [])
                self.parent[item] = stack[-1] if stack else None
                stack.append(item)
                if inst.name in BLOCKING:
                    blocking.append(item)
            elif kind == 2:
                stacks[self.instances[item].tid].remove(item)
                if item in blocking:
                    blocking.remove(item)
            else:
                tid, k = item
                own = stacks.get(tid)
                open_ = ([own[-1]] if own else []) + blocking[-1:]
                if open_:
                    i = max(open_, key=lambda j: self.instances[j].start)
                    while i is not None:
                        self.ops[i].append(k)
                        i = self.parent[i]

    # ------------------------------------------------------------ readers

    def of_name(self, name: str) -> List[int]:
        return [i for i, inst in enumerate(self.instances)
                if inst.name == name]

    def op_counts(self, name: str) -> List[int]:
        """Device ops launched inside each instance of `name`."""
        return [len(self.ops[i]) for i in self.of_name(name)]

    def device_s(self, name: str) -> List[float]:
        """Each instance's device time: the union of the intervals of the
        ops launched inside it."""
        return [union_seconds([(k["ts"], k["ts"] + k.get("dur", 0.0))
                               for k in self.ops[i]]) * 1e-6
                for i in self.of_name(name)]

    def idle_s(self, name: str) -> float:
        """Idle time of the window whose gaps' midpoints fall inside an
        instance of `name` on the window's thread."""
        s = self.summary
        lo, hi = s.window()
        spans = sorted((inst.start, inst.end) for inst in self.instances
                       if inst.name == name and inst.tid == self.window_tid)
        starts = [a for a, _ in spans]
        total, cur = 0.0, lo
        gaps = []
        for a, b in merge(s.device_spans(lo, hi)):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        for a, b in gaps:
            mid = 0.5 * (a + b)
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and mid <= spans[j][1]:
                total += b - a
        return total * 1e-6


def of(obs: dict) -> Optional[Spans]:
    """The spans of a PPO run's traced stretch, or None where it has no
    trace, no device op or no `cadre:` span (a program without spans)."""
    s = obs.get("trace")
    if obs.get("kind") != "ppo" or s is None or not s.kernels:
        return None
    spans = obs.get("_cadre_spans")
    if spans is None:
        spans = obs["_cadre_spans"] = Spans(s)
    return spans if spans.instances else None
