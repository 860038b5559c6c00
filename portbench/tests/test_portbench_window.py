"""The window's arithmetic: rates over all the work and time, the
percentile of every sample, the whole-iteration window."""
import numpy as np
import pytest

from portbench.core import window


def test_rate_is_all_work_over_all_time():
    assert window.rate(51200 * 3, 24.0) == pytest.approx(6400.0)
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)


@pytest.mark.parametrize("n", [1, 2, 7, 200, 1001])
def test_percentile_matches_numpy_linear(n):
    xs = np.random.default_rng(n).gamma(2.0, 20.0, n)
    for q in (50.0, 95.0, 100.0):
        assert window.percentile(list(xs), q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_step_times_are_the_gaps_between_marks():
    assert window.intervals([0.0, 1.5, 4.0, 4.5]) == [1.5, 2.5, 0.5]


def test_whole_iterations_finish_the_one_in_flight():
    now = [100.0]

    def clock():
        return now[0]

    def one():
        now[0] += 3.0

    count, each, total = window.whole_iterations(one, 10.0, clock)
    assert (count, total) == (4, 12.0)
    assert each == [3.0] * 4


def test_whole_iterations_start_at_least_one():
    now = [0.0]

    def one():
        now[0] += 50.0

    assert window.whole_iterations(one, 10.0, lambda: now[0])[0] == 1


def test_trace_union_and_ranges():
    """Busy time is the union of device intervals; an op belongs to the
    range whose instance launched it (by correlation id, same thread)."""
    from portbench.core.trace import TraceSummary, union_seconds

    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb:window",
         "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "pb:k2", "tid": 1,
         "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "pb:k2", "tid": 1,
         "ts": 50.0, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 11.0, "dur": 1.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 12.0, "dur": 1.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 30.0, "dur": 1.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "a", "tid": 7, "ts": 20.0,
         "dur": 10.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "b", "tid": 8, "ts": 25.0,
         "dur": 10.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "c", "tid": 7, "ts": 40.0,
         "dur": 20.0, "args": {"correlation": 9}},
    ]
    s = TraceSummary(ev)
    assert abs(s.window_s() - 100e-6) < 1e-12
    assert abs(s.busy_s() - 35e-6) < 1e-12
    assert [len(k) for k in s.in_range("k2")] == [2, 0]
    assert abs(s.per_call_device_s("k2")[0] - 15e-6) < 1e-12
    ops = dict((n, t) for n, t in s.top_device_ops(["k2"]))
    assert abs(ops["k2/a"] - 10e-6) < 1e-12 and "other/c" in ops
    gaps = dict((n, t) for n, t in s.idle_gaps())
    assert abs(sum(gaps.values()) - 65e-6) < 1e-12
