"""The readers of the program's `cadre:` spans (core/spans.py and the
metrics that use it) on a hand-built chrome trace: innermost attribution
of nested spans, a backward launched from another thread, idle gaps split
by their midpoint, and nothing read where the trace has no span."""
import pytest

from portbench.core import spans, spec
from portbench.core.trace import TraceSummary

MAIN, AUTOGRAD = 1, 2


def host(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
            "ts": float(ts), "dur": float(dur)}


def launched(corr, at, start, dur, tid=MAIN):
    """A launch at host time `at` on `tid` and its kernel on the device."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "tid": tid, "ts": float(at), "dur": 1.0,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7,
             "ts": float(start), "dur": float(dur),
             "args": {"correlation": corr}}]


def trace(with_spans=True):
    """A window of 0-300 us: one env step (100-140, its two launches on
    the main thread, a third launched from another thread inside it), an
    update (150-290) with a loss step (160-180) and a backward (200-240)
    whose kernels the second thread launches."""
    ev = [host("pb:window", 0, 300)]
    if with_spans:
        ev += [host("cadre:env", 100, 40),
               host("cadre:update", 150, 140),
               host("cadre:update/loss", 160, 20),
               host("cadre:update/backward", 200, 40)]
    ev += launched(1, 105, 110, 10)           # env
    ev += launched(2, 110, 125, 5)            # env
    ev += launched(3, 120, 130, 5, AUTOGRAD)  # not env: env does not block
    ev += launched(4, 165, 170, 10)           # update/loss
    ev += launched(5, 185, 185, 5)            # update, outside its children
    ev += launched(6, 205, 210, 20, AUTOGRAD)  # update/backward
    ev += launched(7, 215, 230, 20, AUTOGRAD)  # update/backward (overlaps 6)
    ev += launched(8, 250, 280, 10, AUTOGRAD)  # nothing: backward has ended
    return TraceSummary(ev)


def obs_of(summary):
    return dict(kind="ppo", trace=summary, num_steps=1)


def test_innermost_span_takes_the_op_and_its_parents_count_it():
    sp = spans.of(obs_of(trace()))
    names = [i.name for i in sp.instances]
    assert names == ["env", "update", "update/loss", "update/backward"]
    assert sp.parent == [None, None, 1, 1]
    assert sp.op_counts("update/loss") == [1]
    # the loss's op, the one between the children, the backward's two
    assert sp.op_counts("update") == [4]
    assert sp.device_s("update/loss") == [pytest.approx(10e-6)]
    assert sp.device_s("update") == [pytest.approx((10 + 5 + 40) * 1e-6)]


def test_backward_counts_launches_from_another_thread():
    sp = spans.of(obs_of(trace()))
    assert sp.op_counts("update/backward") == [2]
    # the union of [210, 230) and [230, 250)
    assert sp.device_s("update/backward") == [pytest.approx(40e-6)]
    # env is matched on its own thread: the other thread's launch is not its
    assert sp.op_counts("env") == [2]


def test_idle_gaps_go_to_the_span_at_their_midpoint():
    """Device busy 110-120, 125-135, 170-180, 185-190, 210-250, 280-290;
    gaps 0-110 (mid 55), 120-125 (122.5, env), 135-170 (152.5, update),
    180-185 (182.5, update), 190-210 (200, update), 250-280 (265, update),
    290-300 (295)."""
    s = trace()
    sp = spans.of(obs_of(s))
    assert sp.idle_s("env") == pytest.approx(5e-6)
    assert sp.idle_s("update") == pytest.approx((35 + 5 + 20 + 30) * 1e-6)
    assert s.busy_s() == pytest.approx(85e-6)
    env = spec.metric_reader("ppo_env_idle_pct").read(obs_of(s))
    upd = spec.metric_reader("ppo_update_idle_pct").read(obs_of(s))
    idle = spec.metric_reader("ppo_idle_pct").read(obs_of(s))
    assert env == pytest.approx(100 * 5 / 300)
    assert upd == pytest.approx(100 * 90 / 300)
    assert env + upd <= idle


READERS = ("ppo_encode_ms", "ppo_env_ops_per_step", "ppo_env_idle_pct",
           "ppo_update_loss_s", "ppo_update_backward_s",
           "ppo_update_optim_s", "ppo_update_idle_pct")


def test_readers_read_nothing_without_spans():
    """A program without spans (and a span that did not run: encode,
    optim) reads None; the others read their spans."""
    bare = obs_of(trace(with_spans=False))
    assert spans.of(bare) is None
    for name in READERS:
        assert spec.metric_reader(name).read(bare) is None, name
        assert spec.metric_reader(name).read(dict(kind="ppo")) is None
    got = {name: spec.metric_reader(name).read(obs_of(trace()))
           for name in READERS}
    assert got["ppo_encode_ms"] is None and got["ppo_update_optim_s"] is None
    assert got["ppo_env_ops_per_step"] == 2.0
    assert got["ppo_update_loss_s"] == pytest.approx(10e-6)
    assert got["ppo_update_backward_s"] == pytest.approx(40e-6)
