"""The port's trace spans (`cadre_tpu_torch.utils.profiling.span`), on the
CPU: off without a profiler, the device iteration's spans in the counts
the benchmark's readers expect under one, `PhaseTimer`'s phases as
spans, and the gate that follows the profiler."""
import pytest
import torch

from cadre_tpu_torch.configs.agent_config import RolloutConfig, TrainConfig
from cadre_tpu_torch.configs.danet_config import danet_params
from cadre_tpu_torch.envs import torch_env
from cadre_tpu_torch.rl.agent import CadreAgent
from cadre_tpu_torch.rl.device_rollout import make_device_iteration
from cadre_tpu_torch.utils import profiling
from cadre_tpu_torch.utils.profiling import PhaseTimer, span

SMALL = dict(da_feature_channel=32, inter_att_dims=24, z_dims=16)
T_STEPS = 2
UPDATE_CHILDREN = ("update/loss", "update/backward", "update/optim")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_iteration():
    """A small encoder, 2 envs, T=2, one epoch: (run one iteration,
    minibatch steps per iteration)."""
    agent = CadreAgent.create(danet_params(**SMALL), seed=3, device="cpu")
    env = torch_env.DrivingEnv(
        torch_env.make_route_bank(3, seed=0, device="cpu"), 2, seed=4,
        device="cpu")
    rollout_cfg = RolloutConfig(num_steps=T_STEPS)
    iteration, init_carry = make_device_iteration(
        agent, env, rollout_cfg, TrainConfig(ppo_epoch=1))
    carry = init_carry()
    steps = min(rollout_cfg.mini_batch_num, T_STEPS * env.num_envs)
    return (lambda: iteration(agent.opt, carry)), steps


def spans_of(prof):
    """{name: [(start, end)]} of the `cadre:` ranges a profile recorded."""
    out = {}
    for e in prof.events():
        if e.name.startswith("cadre:"):
            out.setdefault(e.name[len("cadre:"):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


def test_no_profiler_enters_no_range(monkeypatch):
    """Without a profiler neither a span nor a whole iteration's spans
    enter record_function (torch's optimizer enters its own, which
    this leaves alone)."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("encode"):
        pass
    run, _ = small_iteration()
    run()


def test_iteration_emits_each_span_in_its_count():
    """One iteration: T+1 encodes (each step's and the bootstrap's), T env
    steps, one update, and E*M of each update child, each inside the
    update."""
    run, steps = small_iteration()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    got = spans_of(prof)
    assert {k: len(v) for k, v in got.items()} == {
        "encode": T_STEPS + 1, "env": T_STEPS, "update": 1,
        **{child: steps for child in UPDATE_CHILDREN}}
    (lo, hi), = got["update"]
    for child in UPDATE_CHILDREN:
        assert all(lo <= a <= b <= hi for a, b in got[child])
    for name in ("encode", "env"):
        assert all(b <= lo for _, b in got[name])


def test_phase_timer_phase_is_a_span_and_still_totals():
    timer = PhaseTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.phase("act"):
            torch.ones(4).sum()
    with timer.phase("act"):
        pass
    assert len(spans_of(prof)["act"]) == 1
    assert timer.counts["act"] == 2 and timer.totals["act"] > 0
    assert timer.report()["act"]["count"] == 2


def test_gate_follows_the_profiler():
    """The gate reads the profiler's own state: off, on while a profile
    records, off after it stops (a torch that renames the state fails
    here)."""
    assert not profiling._profiler_enabled()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert profiling._profiler_enabled()
        with span("probe"):
            torch.ones(2).sum()
    finally:
        prof.stop()
    assert not profiling._profiler_enabled()
    assert len(spans_of(prof)["probe"]) == 1
