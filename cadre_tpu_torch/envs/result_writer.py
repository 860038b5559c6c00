"""Scenario result report: the srunner ResultOutputProvider analog (the
port's copy of the JAX package's host `envs/result_writer.py`).

The reference gathers each scenario's criteria into a terminal/file/JUnit
report (scenario_runner/srunner/scenariomanager/result_writer.py:19-178:
scenario name + overall result, simulation timing table, per-criterion
rows with status and actual values, plus a timeout row). This module
renders the same report over our simulator-agnostic `envs.criteria`
state machines.

Differences by design: criteria carry no per-actor CARLA ids (the
synthetic env has one ego), and "expected value" is the criterion's
success threshold where one exists (`expected` attribute) else 0.

The JAX module draws its tables with the `tabulate` package, which the
port does not need: `fancy_grid` draws the same text.
"""
from __future__ import annotations

import math
import re
import time
import xml.etree.ElementTree as ET
from functools import reduce
from typing import Any, List, Optional, Sequence

from cadre_tpu_torch.envs.criteria import Criterion

# tabulate's column types, from least to most generic
_NONE, _BOOL, _INT, _FLOAT, _BYTES, _STR = range(6)
_THOUSANDS = re.compile(
    r"^(([+-]?[0-9]{1,3})(?:,([0-9]{3}))*)?(?(1)\.[0-9]*|\.[0-9]+)?$")


def _converts(conv, x) -> bool:
    try:
        conv(x)
        return True
    except (ValueError, TypeError):
        return False


def _is_number(x) -> bool:
    """A float or int, or a string of one (not an over- or underflow)."""
    if type(x) in (float, int):
        return True
    if not _converts(float, x):
        return False
    if not isinstance(x, (str, bytes)):
        return True
    v = float(x)
    return not (math.isinf(v) or math.isnan(v)) or \
        x.lower() in ("inf", "-inf", "nan")


def _is_int(x) -> bool:
    return type(x) is int or (
        (hasattr(x, "is_integer") or hasattr(x, "__array__"))
        and str(type(x)).startswith("<class 'numpy.int")) or (
        isinstance(x, (bytes, str)) and _converts(int, x))


def _with_thousands(x) -> bool:
    return isinstance(x, str) and bool(_THOUSANDS.match(x))


def _cell_type(x) -> int:
    if x is None or (isinstance(x, (bytes, str)) and not x):
        return _NONE
    if hasattr(x, "isoformat"):
        return _STR
    if type(x) is bool or (isinstance(x, (bytes, str))
                           and x in ("True", "False")):
        return _BOOL
    if _is_int(x) or (_with_thousands(x) and "." not in x):
        return _INT
    if _is_number(x) or _with_thousands(x):
        return _FLOAT
    return _BYTES if isinstance(x, bytes) else _STR


def _cell_text(x, kind: int) -> str:
    if x is None:
        return ""
    if isinstance(x, (bytes, str)) and not x:
        return ""
    if kind == _INT:
        return format(x, "")
    if kind == _BYTES:
        try:
            return str(x, "ascii")
        except (TypeError, UnicodeDecodeError):
            return str(x)
    if kind == _FLOAT:
        if isinstance(x, str) and "," in x:
            x = x.replace(",", "")
        try:
            return format(float(x), "g")
        except (ValueError, TypeError):
            return f"{x}"
    return f"{x}"


def _after_point(s: str) -> int:
    """Digits after the decimal point (or the exponent) of a number, -1
    for an integer or a non-number."""
    if not (_is_number(s) or _with_thousands(s)) or _is_int(s):
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1 if pos >= 0 else -1


def fancy_grid(rows: Sequence[Sequence[Any]], firstrow: bool = False) -> str:
    """`tabulate(rows, tablefmt="fancy_grid")`, or with `firstrow`
    `tabulate(rows, headers="firstrow", tablefmt="fancy_grid")`, for
    single-line cells of printable text without ANSI codes: numeric
    columns aligned on the decimal point (floats as format(x, 'g')),
    others left-aligned, missing cells blank."""
    rows = [list(r) for r in rows]
    headers: List[str] = []
    if firstrow and rows:
        headers, rows = [str(h) for h in rows[0]], rows[1:]
    ncols = max((len(r) for r in rows), default=0)
    if not ncols:              # no data cells: the headers alone, if any
        rows, ncols = [], len(headers)
    elif headers:
        # blank headers over leading columns of the first data row; a
        # column without a header, or a header without a column, is cut
        if rows:
            headers = [""] * (len(rows[0]) - len(headers)) + headers
        ncols = min(ncols, len(headers))
        headers = headers[:ncols]
    if not ncols:
        return ""
    rows = [(r + [None] * (ncols - len(r)))[:ncols] for r in rows]
    cols = [[r[i] for r in rows] for i in range(ncols)]
    kinds = [reduce(max, (_cell_type(x) for x in col), _BOOL)
             for col in cols]
    texts = [[_cell_text(x, k) for x in col] for col, k in zip(cols, kinds)]
    numeric = [k in (_INT, _FLOAT) for k in kinds]
    widths = []
    for i, col in enumerate(texts):
        if numeric[i]:
            decs = [_after_point(s) for s in col]
            col = [s + (max(decs) - d) * " " for s, d in zip(col, decs)]
        else:
            col = [s.strip() for s in col]
        minw = len(headers[i]) + 2 if headers else 0
        w = max([len(s) for s in col] + [minw])
        texts[i] = [s.rjust(w) if numeric[i] else s.ljust(w) for s in col]
        widths.append(max(w, len(headers[i])) if headers else w)

    def line(begin, fill, sep, end):
        return begin + sep.join(fill * (w + 2) for w in widths) + end

    def row(cells):
        return "│" + "│".join(f" {c} " for c in cells) + "│"

    out = [line("╒", "═", "╤", "╕")]
    if headers:
        out.append(row(h.rjust(w) if num else h.ljust(w)
                       for h, w, num in zip(headers, widths, numeric)))
        out.append(line("╞", "═", "╪", "╡"))
    body = [row(cells) for cells in zip(*texts)]
    for i, r in enumerate(body):
        if i:
            out.append(line("├", "─", "┼", "┤"))
        out.append(r)
    out.append(line("╘", "═", "╧", "╛"))
    return "\n".join(out)


class ResultOutputProvider:
    """Render one scenario run's criteria as terminal / file / JUnit output
    (result_writer.py:19-178)."""

    def __init__(self, scenario_name: str, criteria: Sequence[Criterion],
                 duration_game: float, duration_system: float,
                 timeout: Optional[float] = None,
                 timed_out: bool = False,
                 start_system_time: Optional[float] = None,
                 ego_name: str = "hero",
                 other_actors: Sequence[str] = ()):
        self.scenario_name = scenario_name
        self.criteria = list(criteria)
        self.duration_game = duration_game
        self.duration_system = duration_system
        self.timeout = timeout
        self.timed_out = timed_out
        self.ego_name = ego_name
        self.other_actors = list(other_actors)
        end = time.time()
        start = start_system_time if start_system_time is not None \
            else end - duration_system
        self._start_time = time.strftime("%Y-%m-%d %H:%M:%S",
                                         time.localtime(start))
        self._end_time = time.strftime("%Y-%m-%d %H:%M:%S",
                                       time.localtime(end))

    # -- status helpers -------------------------------------------------
    @staticmethod
    def _status(crit: Criterion) -> str:
        """Status mapping per the reference's conventions: RUNNING at
        report time counts as FAILURE (result_writer.py:110); INIT (the
        criterion ran the episode and never recorded a violation) renders
        as SUCCESS like a terminated reference criterion; ACCEPTABLE
        passes through."""
        status = getattr(crit, "test_status", "INIT")
        if status == "RUNNING":
            return "FAILURE"
        if status == "INIT":
            return "SUCCESS"
        return status

    def result(self) -> str:
        if self.timed_out:
            return "FAILURE"
        for crit in self.criteria:
            if self._status(crit) == "FAILURE":
                return "FAILURE"
        return "SUCCESS"

    # -- outputs --------------------------------------------------------
    def create_output_text(self) -> str:
        out = "\n"
        out += (f" ======= Results of Scenario: {self.scenario_name} "
                f"---- {self.result()} =======\n\n")
        out += f" > Ego vehicles:\n{self.ego_name};\n\n"
        out += " > Other actors:\n"
        out += "".join(f"{a}; " for a in self.other_actors) + "\n\n"
        out += " > Simulation Information\n"
        ratio = round(self.duration_game / self.duration_system, 3) \
            if self.duration_system else 0.0
        stats = [["Start Time", self._start_time],
                 ["End Time", self._end_time],
                 ["Duration (System Time)",
                  f"{round(self.duration_system, 2)}s"],
                 ["Duration (Game Time)", f"{round(self.duration_game, 2)}s"],
                 ["Ratio (Game Time / System Time)", f"{ratio}s"]]
        out += fancy_grid(stats) + "\n\n"
        out += " > Criteria Information\n"
        rows = [["Actor", "Criterion", "Result", "Actual Value",
                 "Expected Value"]]
        for crit in self.criteria:
            rows.append([self.ego_name,
                         f"{type(crit).__name__} (Req.)",
                         self._status(crit),
                         getattr(crit, "actual_value", 0.0),
                         getattr(crit, "expected", 0)])
        if self.timeout is not None:
            rows.append(["", "Timeout (Req.)",
                         "FAILURE" if self.timed_out else "SUCCESS",
                         round(self.duration_game, 2),
                         round(self.timeout, 2)])
        out += fancy_grid(rows, firstrow=True)
        out += "\n"
        return out

    def _write_junit(self, path: str) -> None:
        suite = ET.Element(
            "testsuite", name=self.scenario_name,
            tests=str(len(self.criteria)),
            failures=str(sum(1 for c in self.criteria
                             if self._status(c) == "FAILURE")),
            time=str(round(self.duration_system, 2)))
        for crit in self.criteria:
            case = ET.SubElement(suite, "testcase",
                                 name=type(crit).__name__,
                                 classname=self.scenario_name)
            if self._status(crit) == "FAILURE":
                ET.SubElement(
                    case, "failure",
                    message=f"actual={getattr(crit, 'actual_value', 0.0)}")
        if self.timeout is not None:
            case = ET.SubElement(suite, "testcase", name="Timeout",
                                 classname=self.scenario_name)
            if self.timed_out:
                ET.SubElement(case, "failure",
                              message=f"game time {self.duration_game:.1f}s"
                                      f" > timeout {self.timeout:.1f}s")
        ET.ElementTree(suite).write(path, encoding="unicode",
                                    xml_declaration=True)

    def write(self, stdout: bool = True, filename: Optional[str] = None,
              junit: Optional[str] = None) -> str:
        text = self.create_output_text()
        if filename:
            with open(filename, "w") as f:
                f.write(text)
        if junit:
            self._write_junit(junit)
        if stdout:
            print(text)
        return text
