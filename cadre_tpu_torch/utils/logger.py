"""Structured logging: a text log and a tabular CSV per worker directory.

Copy of the JAX package's logger (the role of the reference's rllab-style
singleton, utils/logger.py:260-495): `setup(work_dir)` opens the outputs,
`log(msg)` writes timestamped lines, `record_tabular(key, val)` and
`dump_tabular()` append CSV rows.
"""
from __future__ import annotations

import csv
import datetime
import os
import sys
from typing import Any, Dict, List, Optional, TextIO


class Logger:
    def __init__(self):
        self._text_files: List[TextIO] = []
        self._tabular_path: Optional[str] = None
        self._tabular_keys: Optional[List[str]] = None
        self._row: Dict[str, Any] = {}
        self._prefix = ""
        self.work_dir: Optional[str] = None

    def setup(self, work_dir: str, text_name: str = "debug.log",
              tabular_name: str = "progress.csv") -> None:
        os.makedirs(work_dir, exist_ok=True)
        self.close()
        self.work_dir = work_dir
        self._text_files = [open(os.path.join(work_dir, text_name), "a")]
        self._tabular_path = os.path.join(work_dir, tabular_name)
        self._tabular_keys = None

    def set_prefix(self, prefix: str) -> None:
        self._prefix = prefix

    def log(self, msg: str, stdout: bool = True) -> None:
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        line = f"{ts} | {self._prefix}{msg}"
        if stdout:
            print(line, file=sys.stderr)
        for f in self._text_files:
            f.write(line + "\n")
            f.flush()

    def record_tabular(self, key: str, val: Any) -> None:
        self._row[self._prefix + key] = val

    def dump_tabular(self) -> None:
        if not self._row or self._tabular_path is None:
            self._row = {}
            return
        new_file = not os.path.exists(self._tabular_path) or \
            os.path.getsize(self._tabular_path) == 0
        if self._tabular_keys is None:
            self._tabular_keys = list(self._row.keys())
        with open(self._tabular_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._tabular_keys,
                               extrasaction="ignore")
            if new_file:
                w.writeheader()
            w.writerow(self._row)
        self._row = {}

    def close(self) -> None:
        for f in self._text_files:
            f.close()
        self._text_files = []


logger = Logger()


def setup_logger(work_dir: str, rank: int = 0) -> Logger:
    """The logger writing under <work_dir>/<rank>/."""
    logger.setup(os.path.join(work_dir, str(rank)))
    return logger
