"""Seeded fault processes producing a reproducible ``FaultTimeline``.

Three primitive event kinds cover the failure modes the goodput simulator
models:

``fail``       fail-stop worker failure (exponential inter-arrival at a
               per-worker MTBF).  The job rolls back to its last committed
               checkpoint and pays the recovery pipeline.
``preempt``    a capacity window: ``count`` workers disappear at ``time`` and
               return ``duration`` seconds later.  Preemptions are graceful
               (proactive checkpoint), so they cost availability, not work.
``straggler``  a transient slowdown window: the synchronous step dilates by
               ``slowdown`` for ``duration`` seconds.

Generators draw every stream from ``random.Random`` seeded with a
``"{seed}:{kind}:{worker}"`` string, which CPython hashes stably (sha512),
so timelines are bit-identical across processes and insensitive to
``PYTHONHASHSEED`` — and each worker's stream is independent of the total
worker count, so growing the cluster does not reshuffle existing streams.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Tuple

__all__ = [
    "FaultEvent",
    "FaultTimeline",
    "exponential_failures",
    "preemption_windows",
    "transient_stragglers",
]

_KINDS = ("fail", "preempt", "straggler")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One fault episode on the timeline (ordered by time)."""

    time: float
    kind: str = dataclasses.field(compare=False)
    worker: int = dataclasses.field(default=0, compare=False)
    #: window length for preempt/straggler episodes (0 for fail-stop)
    duration: float = dataclasses.field(default=0.0, compare=False)
    #: step-time dilation factor for straggler windows
    slowdown: float = dataclasses.field(default=1.0, compare=False)
    #: workers taken by a preemption window
    count: int = dataclasses.field(default=1, compare=False)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.time < 0:
            raise ValueError(f"fault event at negative time {self.time}")
        if self.duration < 0:
            raise ValueError(f"negative duration {self.duration}")

    @property
    def end(self) -> float:
        return self.time + self.duration


@dataclasses.dataclass(frozen=True)
class FaultTimeline:
    """An immutable, time-sorted sequence of fault events.

    Construct with any iterable of events (sorted on construction) and
    combine independent processes with ``|`` / :meth:`merge`.
    """

    events: Tuple[FaultEvent, ...] = ()
    horizon_s: float = 0.0

    def __post_init__(self) -> None:
        evs = tuple(sorted(self.events, key=lambda e: (e.time, e.kind,
                                                       e.worker)))
        object.__setattr__(self, "events", evs)
        horizon = self.horizon_s
        if evs and horizon <= 0:
            horizon = max(e.end for e in evs)
        object.__setattr__(self, "horizon_s", float(horizon))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __or__(self, other: "FaultTimeline") -> "FaultTimeline":
        return self.merge(other)

    def merge(self, *others: "FaultTimeline") -> "FaultTimeline":
        evs = list(self.events)
        horizon = self.horizon_s
        for tl in others:
            evs.extend(tl.events)
            horizon = max(horizon, tl.horizon_s)
        return FaultTimeline(tuple(evs), horizon)

    def of_kind(self, kind: str) -> Tuple[FaultEvent, ...]:
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        return tuple(e for e in self.events if e.kind == kind)

    def until(self, horizon_s: float) -> "FaultTimeline":
        """Clip to events starting before ``horizon_s``."""
        return FaultTimeline(tuple(e for e in self.events
                                   if e.time < horizon_s), horizon_s)


def _stream(seed: int, kind: str, worker: int) -> random.Random:
    return random.Random(f"{seed}:{kind}:{worker}")


def exponential_failures(n_workers: int, mtbf_s: float, horizon_s: float,
                         seed: int = 0) -> FaultTimeline:
    """Fail-stop failures: per-worker Poisson process at 1/``mtbf_s``.

    ``mtbf_s`` is the *per-worker* mean time between failures; the job-level
    MTBF is ``mtbf_s / n_workers``.  ``mtbf_s <= 0`` means no failures.
    """
    if n_workers < 1:
        raise ValueError(f"need >= 1 worker, got {n_workers}")
    events = []
    if mtbf_s > 0:
        rate = 1.0 / mtbf_s
        for w in range(n_workers):
            rng = _stream(seed, "fail", w)
            t = rng.expovariate(rate)
            while t < horizon_s:
                events.append(FaultEvent(time=t, kind="fail", worker=w))
                t += rng.expovariate(rate)
    return FaultTimeline(tuple(events), horizon_s)


def preemption_windows(period_s: float, duration_s: float, horizon_s: float,
                       offset_s: float = 0.0,
                       workers: int = 1) -> FaultTimeline:
    """Deterministic periodic preemption: ``workers`` vanish for
    ``duration_s`` every ``period_s`` seconds, first window at ``offset_s``.
    """
    events = []
    if period_s > 0 and duration_s > 0 and workers > 0:
        if duration_s >= period_s:
            raise ValueError("preemption duration must be < period")
        t = offset_s
        while t < horizon_s:
            events.append(FaultEvent(time=t, kind="preempt",
                                     duration=duration_s, count=workers))
            t += period_s
    return FaultTimeline(tuple(events), horizon_s)


def transient_stragglers(rate_per_hour: float, slowdown: float,
                         duration_s: float, horizon_s: float,
                         seed: int = 0) -> FaultTimeline:
    """Transient straggler windows arriving as a Poisson process.

    Each window dilates the synchronous step time by ``slowdown`` for
    ``duration_s`` seconds; overlapping windows take the max dilation, not
    the product (one slow lane gates the step, two slow lanes do not gate it
    twice).
    """
    events = []
    if rate_per_hour > 0 and slowdown > 1.0 and duration_s > 0:
        rate = rate_per_hour / 3600.0
        rng = _stream(seed, "straggler", 0)
        t = rng.expovariate(rate)
        while t < horizon_s:
            events.append(FaultEvent(time=t, kind="straggler",
                                     duration=duration_s, slowdown=slowdown))
            t += rng.expovariate(rate)
    return FaultTimeline(tuple(events), horizon_s)
