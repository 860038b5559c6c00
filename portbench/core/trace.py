"""The traced part of a `--trace 1` run: torch.profiler (CPU and CUDA
activities) over a stretch of the window that ends in a device sync, the
chrome trace written under the checkout's build/portbench/ and read back.

- Device operations are the trace's kernels, copies and sets. busy_s is
  the union of their intervals inside the traced stretch.
- The harness's ranges (`pb:<name>`, torch.profiler.record_function) are
  host intervals; a device operation belongs to a range when the runtime
  call that launched it (matched by its correlation id) lies inside the
  range on the same thread. So a range counts every launch made inside
  the call it wraps, whatever the kernels are named.
- Idle gaps are labelled with the innermost `pb:` range and host op that
  was open at the gap's middle on the launching thread.
"""
from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}


def merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) spans as disjoint sorted spans."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of spans (in their unit)."""
    return sum(b - a for a, b in merge(spans))


class TraceSummary:
    """What the readers take from one chrome trace."""

    def __init__(self, events: List[dict]):
        self.kernels: List[dict] = []       # device ops
        launch: Dict[int, Tuple[int, float]] = {}
        host: Dict[int, List[dict]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.kernels.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launch[args["correlation"]] = (e.get("tid"), e["ts"])
            if cat in HOST_CATS:
                host[e.get("tid")].append(e)
        self.launch = launch
        self.host = host
        self.ranges: Dict[str, List[Tuple[object, float, float]]] = \
            defaultdict(list)
        for tid, evs in host.items():
            for e in evs:
                if e.get("cat") == "user_annotation" and \
                        e["name"].startswith("pb:"):
                    self.ranges[e["name"][3:]].append(
                        (tid, e["ts"], e["ts"] + e.get("dur", 0.0)))
        for v in self.ranges.values():
            v.sort(key=lambda r: r[1])
        self._starts: Dict[str, List[float]] = {}

    # ------------------------------------------------------------ windows

    def window(self) -> Tuple[float, float]:
        """Host start and end of the traced stretch."""
        tid, a, b = self.ranges["window"][0]
        return a, b

    def device_spans(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        out = []
        for k in self.kernels:
            a, b = k["ts"], k["ts"] + k.get("dur", 0.0)
            a, b = max(a, lo), min(b, hi)
            if b > a:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        lo, hi = self.window()
        return union_seconds(self.device_spans(lo, hi)) * 1e-6

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) * 1e-6

    # ------------------------------------------------------------- ranges

    def _instance(self, name: str, corr) -> Optional[int]:
        """Which instance of range `name` launched the op of correlation id
        `corr` (instances of one name do not overlap), or None."""
        at = self.launch.get(corr)
        rs = self.ranges.get(name)
        if at is None or not rs:
            return None
        starts = self._starts.setdefault(name, [r[1] for r in rs])
        i = bisect.bisect_right(starts, at[1]) - 1
        if i >= 0 and rs[i][0] == at[0] and at[1] <= rs[i][2]:
            return i
        return None

    def in_range(self, name: str) -> List[List[dict]]:
        """The device ops launched inside each instance of range `name`."""
        out: List[List[dict]] = [[] for _ in self.ranges.get(name, [])]
        for k in self.kernels:
            i = self._instance(name, (k.get("args") or {}).get("correlation"))
            if i is not None:
                out[i].append(k)
        return out

    def per_call_device_s(self, name: str) -> List[float]:
        """Each call's device time: the union of its ops' intervals."""
        return [union_seconds([(k["ts"], k["ts"] + k.get("dur", 0.0))
                               for k in ks]) * 1e-6
                for ks in self.in_range(name)]

    # ---------------------------------------------------------- breakdown

    def label_of(self, k: dict, names: List[str]) -> str:
        """The first of `names` whose range launched op `k`, or 'other'."""
        corr = (k.get("args") or {}).get("correlation")
        for name in names:
            if self._instance(name, corr) is not None:
                return name
        return "other"

    def launched_at(self, k: dict) -> Optional[float]:
        at = self.launch.get((k.get("args") or {}).get("correlation"))
        return None if at is None else at[1]

    def last_end(self, name: str) -> Optional[float]:
        rs = self.ranges.get(name)
        return rs[-1][2] if rs else None

    def top_device_ops(self, names: List[str], top: int = 10,
                       after: Optional[Tuple[float, str]] = None,
                       rest: str = "other") -> List[List[object]]:
        """The device ops that took most time, by launching range and
        name; `after` = (t, label) labels every op launched after host
        time t."""
        lo, hi = self.window()
        sums: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            if lo <= k["ts"] <= hi:
                at = self.launched_at(k)
                if after is not None and at is not None and at > after[0]:
                    label = after[1]
                else:
                    label = self.label_of(k, names)
                    label = rest if label == "other" else label
                key = f"{label}/{k['name']}"[:64]
                sums[key] += k.get("dur", 0.0) * 1e-6
        rows = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[n, s] for n, s in rows]

    def idle_gaps(self, top: int = 10) -> List[List[object]]:
        """Idle stretches of the device inside the window, summed by the
        innermost `pb:` range and host op open at their middle on the
        thread that opened the window."""
        lo, hi = self.window()
        gaps, cur = [], lo
        for a, b in merge(self.device_spans(lo, hi)):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        tid = self.ranges["window"][0][0]
        evs = sorted(self.host.get(tid, []), key=lambda e: e["ts"])
        heaps: Dict[bool, list] = {True: [], False: []}
        sums: Dict[str, float] = defaultdict(float)
        j = 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while j < len(evs) and evs[j]["ts"] <= mid:
                e = evs[j]
                pb = e["name"].startswith("pb:")
                if pb or e.get("cat") == "cpu_op":
                    heapq.heappush(heaps[pb], (-e["ts"], j,
                                               e["ts"] + e.get("dur", 0.0),
                                               e["name"]))
                j += 1
            for h in heaps.values():
                while h and h[0][2] < mid:
                    heapq.heappop(h)
            op = heaps[False][0][3] if heaps[False] else "python"
            rng = heaps[True][0][3][3:] if heaps[True] else "window"
            rng = "outside" if rng == "window" else rng
            sums[f"{rng}/{op}"[:64]] += (b - a) * 1e-6
        rows = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[n, s] for n, s in rows]


class Tracer:
    """Profiles the stretch inside `part()` when on; a no-op when off."""

    def __init__(self, on: bool, out_dir: Path):
        self.on = on
        self.out_dir = out_dir
        self.summary: Optional[TraceSummary] = None

    @contextmanager
    def part(self, sync):
        """Profile the body; `sync()` waits for the device before the
        stretch starts and before it ends."""
        if not self.on or self.summary is not None:
            yield
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("pb:window"):
                yield
                sync()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.summary = TraceSummary(events)
        path.unlink()

