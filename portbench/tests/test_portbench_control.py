"""The control (the reference a precision step below the configuration's,
in the program's place) fails a limit of each cell, and the program
passes them all: on the CPU at tiny sizes, and on the card at the cell's
own size (`card`; `python -m pytest portbench/tests -m card` there)."""
import io
import json

import pytest

from conftest import PRETRAIN

from portbench.control import readings
from portbench.core import spec

CELLS = ["ppo.r18.n2048", "ppo.r50.n2048"]


def _verdict(rows, cell, pb=spec.PB):
    limits = json.loads((pb / "limits" / f"{cell}.json").read_text())
    for row in rows:
        over = [k for k, lim in limits.items() if row[k] > lim]
        if row["side"] == "program":
            assert not over, (cell, row)
        else:
            assert over, (cell, row)


@pytest.mark.parametrize("cell", ["ppo.r18.n2048", PRETRAIN])
def test_control_fails_at_tiny_sizes_on_the_cpu(small, cell):
    rows = readings(cell, [2147483811, 2147483812], device="cpu",
                    root=small, out=io.StringIO())
    _verdict(rows, cell, small / "portbench")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(card, cell):
    rows = readings(cell, [2147483821, 2147483822, 2147483823],
                    out=io.StringIO())
    _verdict(rows, cell)
