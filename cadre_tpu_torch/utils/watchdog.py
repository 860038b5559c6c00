"""Liveness watchdog (a copy of cadre_tpu.utils.watchdog) — enabled,
unlike the reference's
(srunner/scenariomanager/watchdog.py exists but its instantiation is
commented out, leaderboard/.../scenario_manager.py:67-71).

A thread timer that must be `pause()`d/`update()`d periodically; on expiry
it invokes a callback (default: raise in the owning thread via a flag the
training loop checks). Used around env steps to detect hung simulators
(SURVEY §5.3: a dead worker hangs the reference's barrier forever).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class Watchdog:
    def __init__(self, timeout: float, on_timeout: Optional[Callable] = None,
                 name: str = "watchdog"):
        self.timeout = timeout
        self._on_timeout = on_timeout
        self._name = name
        self._timer: Optional[threading.Timer] = None
        self._failed = threading.Event()
        self._stopped = True

    def start(self) -> None:
        self._stopped = False
        self._failed.clear()
        self._arm()

    def _arm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.timeout, self._expire)
        self._timer.daemon = True
        self._timer.start()

    def _expire(self) -> None:
        if self._stopped:
            return
        self._failed.set()
        if self._on_timeout is not None:
            self._on_timeout()

    def update(self) -> None:
        """Pet the dog; call once per loop iteration.

        Each pet opens a FRESH timing window: a previously latched failure
        is cleared, so one healthy gap longer than the timeout (first-step
        JIT compile, checkpoint save, world loading) cannot poison every
        subsequent check. Callers that want the failure to be observed must
        check `.failed` before the next pet — the env does so immediately
        after the guarded `world.tick` returns.
        """
        if not self._stopped:
            self._failed.clear()
            self._arm()

    def pause(self) -> None:
        """Disarm the timer without stopping the watchdog.

        Use to bracket only the monitored section (the simulator round
        trip): `update()` immediately before, `pause()` right after the
        call returns, so agent-side time between env steps is never
        counted against the timeout.
        """
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    @property
    def failed(self) -> bool:
        return self._failed.is_set()

    def get_status(self) -> bool:
        return not self._failed.is_set()
