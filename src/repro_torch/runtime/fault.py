"""Fault tolerance and straggler monitoring for the training runtime (the
port's own copy of ``repro/runtime/fault.py``, which is framework-free but
part of the JAX package).

  * :class:`RetryPolicy` / :class:`FaultTolerantRunner` — run a step function
    under checkpoint/restart semantics: on failure, restore the latest
    committed checkpoint and continue.  Exceptions count against a failure
    budget; exceeding it re-raises (a real deployment would escalate to the
    cluster scheduler).
  * :class:`Heartbeat` — liveness file other processes/watchdogs can monitor.
  * :class:`StragglerMonitor` — per-step deadline tracking against a rolling
    median; flags slow steps and calls a mitigation hook.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time
from typing import Any, Callable, List, Optional


@dataclasses.dataclass
class RetryPolicy:
    max_failures: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0


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


class FaultTolerantRunner:
    """Checkpoint/restart wrapper around a stateful step loop.

    The caller supplies:
      * ``make_state()``      — build fresh state (init or restore),
      * ``step_fn(state, i)`` — one training step, returns new state,
      * ``save(state, i)``    — checkpoint hook,
      * ``restore()``         — returns (state, step) from the latest
                                committed checkpoint, or None.
    ``inject_failure`` lets tests (and chaos drills) raise at a chosen step.
    """

    def __init__(self, make_state: Callable[[], Any],
                 step_fn: Callable[[Any, int], Any],
                 save: Callable[[Any, int], None],
                 restore: Callable[[], Optional[tuple]],
                 policy: RetryPolicy = RetryPolicy(),
                 save_every: int = 50,
                 heartbeat: Optional[Heartbeat] = None,
                 straggler: Optional[StragglerMonitor] = None) -> None:
        self.make_state = make_state
        self.step_fn = step_fn
        self.save = save
        self.restore = restore
        self.policy = policy
        self.save_every = save_every
        self.heartbeat = heartbeat
        self.straggler = straggler or StragglerMonitor()
        self.failures = 0
        self.restarts = 0

    def run(self, num_steps: int,
            inject_failure: Optional[Callable[[int], None]] = None) -> Any:
        restored = self.restore()
        if restored is not None:
            state, start = restored
            start += 1
        else:
            state, start = self.make_state(), 0
        i = start
        backoff = self.policy.backoff_s
        while i < num_steps:
            try:
                if inject_failure is not None:
                    inject_failure(i)
                t0 = time.time()
                state = self.step_fn(state, i)
                self.straggler.record(i, time.time() - t0)
                if self.heartbeat:
                    self.heartbeat.beat(i)
                if (i + 1) % self.save_every == 0 or i + 1 == num_steps:
                    self.save(state, i)
                i += 1
                backoff = self.policy.backoff_s
            except Exception:
                self.failures += 1
                if self.failures > self.policy.max_failures:
                    raise
                time.sleep(backoff)
                backoff *= self.policy.backoff_mult
                restored = self.restore()
                if restored is not None:
                    state, last = restored
                    i = last + 1
                else:
                    state, i = self.make_state(), 0
                self.restarts += 1
        return state
