"""Wrapping a public call of the program, and undoing it: an instance's
method (set on the instance, removed after) or a module's attribute (put
back after). The harness wraps calls only to record what they returned
in set-up, or to put them in profiler ranges in the traced stretch; the
untraced window runs the program untouched."""
from __future__ import annotations

from typing import Callable, List, Tuple


class Patches:
    def __init__(self):
        self._undo: List[Tuple[object, str, object, bool]] = []

    def wrap(self, owner, name: str, make: Callable) -> None:
        """owner.name = make(original); `owner` is an object or a module."""
        had = name in vars(owner) if hasattr(owner, "__dict__") else True
        original = getattr(owner, name)
        self._undo.append((owner, name, vars(owner).get(name), had))
        setattr(owner, name, make(original))

    def undo(self) -> None:
        while self._undo:
            owner, name, value, had = self._undo.pop()
            if had and value is not None:
                setattr(owner, name, value)
            else:
                delattr(owner, name)
