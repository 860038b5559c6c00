"""The measured window's arithmetic, kept apart from the clocks so that the
CPU tests hold it: a rate over all the work and all the time of the
window, a percentile of every sample, and the whole-iteration window."""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) of every value, linearly
    interpolated between order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def intervals(marks: Sequence[float]) -> List[float]:
    """The gaps between consecutive marks: the step times of a stream of
    events recorded between steps, the first mark being the window's
    start."""
    return [b - a for a, b in zip(marks, marks[1:])]


def whole_iterations(run_one: Callable[[], None], seconds: float,
                     clock: Callable[[], float]) -> Tuple[int, List[float],
                                                          float]:
    """Start iterations until `seconds` have passed since the window's
    start, finishing the one in flight: (count, each iteration's seconds,
    the window's seconds). `run_one` returns once its iteration has ended
    on the device, so the window ends at its last sync."""
    t0 = clock()
    ends = [t0]
    while ends[-1] - t0 < seconds:
        run_one()
        ends.append(clock())
    return len(ends) - 1, intervals(ends), ends[-1] - t0
