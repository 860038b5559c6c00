"""`correct` comes out false when the timed path is broken underneath: the
rest of a run is driven (on the CPU, at tiny sizes, the chip's look
skipped) with a fault of portbench/faults.py planted in the program, once
for each fault a cell can have (one chip: no exchange between chips to
leave out), and once with none."""
import pytest

from conftest import PRETRAIN, run_small

from portbench.faults import FAULTS, planted

KINDS = {"ppo.r18.n2048": "ppo_iteration", PRETRAIN: "pretrain_step"}


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_sound_runs_are_correct(small, cell, capsys):
    assert run_small(small, cell, capsys=capsys)["correct"] is True


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(KINDS)
                                        for f in FAULTS[KINDS[c]]])
def test_a_planted_fault_makes_the_run_incorrect(small, cell, fault, capsys):
    with planted(fault, KINDS[cell]):
        line = run_small(small, cell, capsys=capsys)
    assert line["correct"] is False
    over = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert over
