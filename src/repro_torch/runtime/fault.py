"""Liveness and straggler monitoring for the training runtime (the port's own
copy of ``Heartbeat`` and ``StragglerMonitor`` from
``repro/runtime/fault.py``, which is framework-free but part of the JAX
package).

  * :class:`Heartbeat` — liveness file other processes/watchdogs can monitor.
  * :class:`StragglerMonitor` — per-step deadline tracking against a rolling
    median; flags slow steps and calls a mitigation hook.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Callable, List, Optional


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0) -> None:
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int, **info) -> None:
        now = time.time()
        if now - self._last < self.interval_s:
            return
        self._last = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": now, "step": step, **info}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, timeout_s: float = 60.0) -> bool:
        try:
            with open(path) as f:
                beat = json.load(f)
            return time.time() - beat["time"] < timeout_s
        except (OSError, ValueError, KeyError):
            return False


class StragglerMonitor:
    """Rolling-median step-time watchdog."""

    def __init__(self, threshold: float = 2.0, window: int = 32,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None) -> None:
        self.threshold = threshold
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []
        self.on_straggler = on_straggler

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            if dt > self.threshold * med:
                is_straggler = True
                self.flagged.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler

    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
