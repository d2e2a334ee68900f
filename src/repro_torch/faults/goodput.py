"""Renewal-style goodput simulation: steady-state steps + fault episodes.

The simulator owns a tiny amount of state — current step/checkpoint phase,
steps since the last commit, the set of down workers — and advances it event
by event over a :class:`~repro_torch.faults.events.FaultTimeline`.  Between fault
events progress is closed-form: a checkpoint block is ``K`` steps at ``s``
seconds plus one synchronous write of ``c`` seconds, so a quiet span of
``T`` seconds completes ``T // (K*s + c)`` whole blocks in O(1).  Total
cost is O(fault events), independent of the number of steps simulated —
simulating a week at a 2-second step costs the same as simulating an hour.

Semantics (see the package docstring for the full assumption list):

* A *failure* rolls back to the last committed step: everything since the
  last finished checkpoint (steps, partial step, partial checkpoint write)
  is lost, so lost work per failure is bounded by the checkpoint interval.
* A *preemption* is graceful: completed steps commit via a proactive
  checkpoint, the capacity disappears for the window, nothing is lost.
* A *straggler window* dilates the synchronous step by its slowdown factor;
  overlapping windows take the max.  ``straggler_mitigation`` caps the
  dilation at ``mitigation_cap`` but pays ``mitigation_overhead`` on every
  step — which is exactly why "does it pay?" needs simulating.
* An *elastic* job drops failed/preempted workers and keeps stepping at
  reduced capacity (per-step time from ``step_s(active)``); a non-elastic
  job halts until full capacity is restored.  ``hot_spares`` short-circuit
  replacement acquisition; a consumed spare is restocked once the failed
  machine is repaired.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional, Tuple, Union

from repro_torch.faults.events import FaultTimeline
from repro_torch.faults.recovery import RecoveryModel

__all__ = ["GoodputReport", "simulate_goodput", "young_daly_interval",
           "young_daly_steps"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class GoodputReport:
    """What a fault-injected run of ``horizon_s`` seconds produced."""

    n_workers: int
    horizon_s: float
    ckpt_interval_steps: int
    #: fault-free full-cluster step seconds (before dilation/overhead)
    step_s_full: float

    useful_steps: int           # surviving executed steps
    committed_steps: int        # steps durably committed by a checkpoint
    lost_steps: int             # steps rolled back by failures
    failures: int
    preemptions: int
    straggler_windows: int

    useful_s: float             # time spent on surviving steps
    ckpt_s: float               # time spent writing (surviving) checkpoints
    lost_s: float               # rolled-back step + partial-ckpt time
    stalled_s: float            # detection, repair, restore, remesh, idle

    max_lost_steps_per_failure: int
    #: (time, active running workers) — piecewise-constant capacity
    capacity_samples: Tuple[Tuple[float, int], ...]
    #: (time, committed steps) — durable-progress curve
    progress_samples: Tuple[Tuple[float, int], ...]

    @property
    def goodput_steps_per_hour(self) -> float:
        return self.useful_steps / self.horizon_s * 3600.0

    @property
    def fault_free_steps_per_hour(self) -> float:
        return 3600.0 / self.step_s_full

    @property
    def goodput_fraction(self) -> float:
        """Useful throughput as a fraction of fault-free throughput."""
        return self.goodput_steps_per_hour / self.fault_free_steps_per_hour

    @property
    def availability(self) -> float:
        """Fraction of the horizon spent making surviving progress."""
        return self.useful_s / self.horizon_s if self.horizon_s > 0 else 0.0

    @property
    def lost_work_per_failure_s(self) -> float:
        return self.lost_s / self.failures if self.failures else 0.0

    def describe(self) -> str:
        return (f"{self.goodput_steps_per_hour:,.1f} useful steps/h "
                f"({self.goodput_fraction:.1%} of fault-free), "
                f"availability {self.availability:.1%}, "
                f"{self.failures} failures, {self.lost_steps} steps lost")


def young_daly_interval(ckpt_write_s: float, job_mtbf_s: float) -> float:
    """Young/Daly first-order optimal checkpoint interval, in seconds.

    ``tau_opt = sqrt(2 * delta * M)`` with ``delta`` the checkpoint write
    cost and ``M`` the *job-level* MTBF (per-worker MTBF / N workers).
    """
    if ckpt_write_s <= 0 or job_mtbf_s <= 0 or math.isinf(job_mtbf_s):
        return math.inf
    return math.sqrt(2.0 * ckpt_write_s * job_mtbf_s)


def young_daly_steps(ckpt_write_s: float, job_mtbf_s: float,
                     step_s: float) -> int:
    """Young/Daly optimum expressed as a whole number of steps (>= 1)."""
    tau = young_daly_interval(ckpt_write_s, job_mtbf_s)
    if math.isinf(tau):
        return 1 << 30
    return max(1, int(round(tau / step_s)))


class _Engine:
    """Event-by-event goodput state machine (module-private)."""

    def __init__(self, *, n_workers, horizon_s, recovery, k,
                 step_fn, elastic, hot_spares, straggler_mitigation,
                 mitigation_overhead, mitigation_cap, min_workers):
        self.n = n_workers
        self.horizon = horizon_s
        self.rec = recovery
        self.K = k
        self.step_fn = step_fn
        self.elastic = elastic
        self.spares = hot_spares
        self.mitigate = straggler_mitigation
        self.mit_overhead = mitigation_overhead
        self.mit_cap = mitigation_cap
        self.min_workers = min_workers

        self.cw = recovery.checkpoint_write_s

        # progress state
        self.phase = "step"          # "step" | "ckpt"
        self.frac = 0.0              # work fraction of the current unit
        self.unit_spent = 0.0        # wall seconds invested in current unit
        self.executed = 0            # surviving steps (rolled back on fail)
        self.committed = 0
        self.since_ckpt = 0
        self.uncommitted_s = 0.0

        # availability state
        self.halted_until = 0.0
        self.down: set = set()       # failed workers awaiting replacement
        self.preempted = 0           # workers inside a preemption window
        self.dilations: List[float] = []

        # counters
        self.useful_s = 0.0
        self.ckpt_s = 0.0
        self.lost_s = 0.0
        self.lost_steps = 0
        self.failures = 0
        self.preemptions = 0
        self.straggler_windows = 0
        self.max_lost_one = 0

        self.cap_samples: List[Tuple[float, int]] = []
        self.prog_samples: List[Tuple[float, int]] = [(0.0, 0)]
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = 0

    # ---------------------------------------------------------- state --
    def active(self) -> int:
        if self.elastic:
            return self.n - len(self.down) - self.preempted
        return self.n

    def runnable(self, t: float) -> bool:
        if t + _EPS < self.halted_until:
            return False
        if self.elastic:
            return self.active() >= self.min_workers
        return not self.down and self.preempted == 0

    def step_seconds(self) -> float:
        dil = max(self.dilations) if self.dilations else 1.0
        if self.mitigate:
            dil = min(dil, self.mit_cap)
        s = self.step_fn(self.active()) * dil
        if self.mitigate:
            s *= 1.0 + self.mit_overhead
        return s

    def _push(self, t: float, kind: str, payload=None) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def _sample_capacity(self, t: float) -> None:
        cap = self.active() if self.runnable(t + _EPS) else 0
        if not self.cap_samples or self.cap_samples[-1][1] != cap:
            self.cap_samples.append((t, cap))

    def _sample_progress(self, t: float) -> None:
        if self.prog_samples[-1][1] != self.committed:
            self.prog_samples.append((t, self.committed))

    # ------------------------------------------------------- progress --
    def _finish_step(self) -> None:
        self.executed += 1
        self.since_ckpt += 1
        self.uncommitted_s += self.unit_spent
        self.frac = 0.0
        self.unit_spent = 0.0
        if self.since_ckpt >= self.K:
            self.phase = "ckpt"

    def _commit(self) -> None:
        self.useful_s += self.uncommitted_s
        self.uncommitted_s = 0.0
        self.committed = self.executed
        self.since_ckpt = 0
        self.phase = "step"
        self.frac = 0.0
        self.unit_spent = 0.0

    def _finish_ckpt(self) -> None:
        self.ckpt_s += self.unit_spent
        self._commit()

    def _rollback(self) -> None:
        lost_now = self.since_ckpt
        self.lost_s += self.uncommitted_s + self.unit_spent
        self.lost_steps += lost_now
        self.max_lost_one = max(self.max_lost_one, lost_now)
        self.executed = self.committed
        self.since_ckpt = 0
        self.uncommitted_s = 0.0
        self.phase = "step"
        self.frac = 0.0
        self.unit_spent = 0.0

    def _commit_graceful(self) -> None:
        """Proactive checkpoint before a preemption window: whole steps
        commit, an in-flight step stays frozen and resumes afterwards."""
        if self.phase == "ckpt":
            self.ckpt_s += self.unit_spent
            self._commit()
        elif self.since_ckpt > 0:
            part_frac, part_spent = self.frac, self.unit_spent
            self._commit()
            self.frac, self.unit_spent = part_frac, part_spent

    def _advance(self, span: float, s: float) -> None:
        """Consume ``span`` running seconds at step cost ``s``."""
        c, k = self.cw, self.K
        rem = span
        while rem > _EPS:
            if self.phase == "ckpt":
                need = (1.0 - self.frac) * c
                if need > rem + _EPS:
                    self.frac += rem / c
                    self.unit_spent += rem
                    return
                rem -= need
                self.unit_spent += need
                self._finish_ckpt()
                continue
            if self.frac > 0.0:
                need = (1.0 - self.frac) * s
                if need > rem + _EPS:
                    self.frac += rem / s
                    self.unit_spent += rem
                    return
                rem -= need
                self.unit_spent += need
                self._finish_step()
                continue
            # clean step boundary: closed-form over whole blocks
            to_commit = k - self.since_ckpt
            t_block = to_commit * s + c
            if rem + _EPS >= t_block:
                self._bulk_steps(to_commit, s)
                self.unit_spent = c
                self.phase = "ckpt"
                self._finish_ckpt()
                rem -= t_block
                block = k * s + c
                nb = int((rem + _EPS) // block)
                if nb > 0:
                    self.executed += nb * k
                    self.useful_s += nb * k * s
                    self.ckpt_s += nb * c
                    self.committed = self.executed
                    rem -= nb * block
                continue
            m = min(to_commit, int((rem + _EPS) // s))
            if m > 0:
                self._bulk_steps(m, s)
                rem -= m * s
            if self.since_ckpt >= k:
                self.phase = "ckpt"
                continue
            if rem > _EPS:
                self.frac = rem / s
                self.unit_spent = rem
            return

    def _bulk_steps(self, m: int, s: float) -> None:
        self.executed += m
        self.since_ckpt += m
        self.uncommitted_s += m * s

    # --------------------------------------------------------- events --
    def _on_fail(self, t: float, worker: int) -> None:
        if worker in self.down:
            return  # already dead; its repair is in flight
        self.failures += 1
        self._rollback()
        rec = self.rec
        if self.elastic:
            self.down.add(worker)
            if self.spares > 0:
                self.spares -= 1
                back = t + rec.detection_s + rec.spare_activation_s
                self._push(t + rec.detection_s + rec.repair_s,
                           "spare_restock")
            else:
                back = t + rec.detection_s + rec.repair_s
            self._push(back, "rejoin", worker)
            self.halted_until = max(self.halted_until,
                                    t + rec.downtime_s(elastic=True))
        else:
            self.down.add(worker)
            if self.spares > 0:
                self.spares -= 1
                wait = rec.spare_activation_s
                self._push(t + rec.detection_s + rec.repair_s,
                           "spare_restock")
            else:
                wait = rec.repair_s
            resume = (t + rec.detection_s + wait + rec.restore_s
                      + rec.restart_s)
            self._push(resume, "resume", worker)
            self.halted_until = max(self.halted_until, resume)

    def _on_rejoin(self, t: float, worker: int) -> None:
        self.down.discard(worker)
        # scale-up re-mesh pauses the (running) job briefly
        self.halted_until = max(self.halted_until, t + self.rec.remesh_s)

    def _on_preempt_start(self, t: float, count: int) -> None:
        self.preemptions += 1
        self._commit_graceful()
        if self.elastic:
            self.preempted += count
            self.halted_until = max(self.halted_until,
                                    t + self.rec.remesh_s)
        else:
            self.preempted += count

    def _on_preempt_end(self, t: float, count: int) -> None:
        self.preempted = max(0, self.preempted - count)
        if self.elastic:
            self.halted_until = max(self.halted_until,
                                    t + self.rec.remesh_s)

    # ------------------------------------------------------------ run --
    def run(self, timeline: FaultTimeline) -> GoodputReport:
        for ev in timeline.until(self.horizon):
            if ev.kind == "fail":
                self._push(ev.time, "fail", ev.worker)
            elif ev.kind == "preempt":
                self._push(ev.time, "preempt_start", ev.count)
                self._push(ev.end, "preempt_end", ev.count)
            elif ev.kind == "straggler":
                self._push(ev.time, "strag_start", ev.slowdown)
                self._push(ev.end, "strag_end", ev.slowdown)
        self._sample_capacity(0.0)

        t = 0.0
        while True:
            te = self._heap[0][0] if self._heap else self.horizon
            te = min(te, self.horizon)
            # run (or idle through) the quiet segment [t, te)
            while te - t > _EPS:
                if t + _EPS < self.halted_until:
                    t = min(te, self.halted_until)
                    self._sample_capacity(t)
                    continue
                if not self.runnable(t):
                    t = te
                    break
                seg_end = te
                if self.halted_until > t:  # pragma: no cover - guard
                    seg_end = min(seg_end, self.halted_until)
                self._advance(seg_end - t, self.step_seconds())
                t = seg_end
            self._sample_progress(t)
            if not self._heap or self._heap[0][0] >= self.horizon - _EPS:
                break
            tev, _, kind, payload = heapq.heappop(self._heap)
            t = max(t, tev)
            if kind == "fail":
                self._on_fail(t, payload)
            elif kind == "rejoin":
                self._on_rejoin(t, payload)
            elif kind == "resume":
                self.down.discard(payload)
            elif kind == "spare_restock":
                self.spares += 1
            elif kind == "preempt_start":
                self._on_preempt_start(t, payload)
            elif kind == "preempt_end":
                self._on_preempt_end(t, payload)
            elif kind == "strag_start":
                self.straggler_windows += 1
                self.dilations.append(payload)
            elif kind == "strag_end":
                self.dilations.remove(payload)
            self._sample_capacity(t)

        return self._finalize()

    def _finalize(self) -> GoodputReport:
        # steps executed but not yet committed still count as useful: no
        # failure claimed them inside the horizon.
        useful_s = self.useful_s + self.uncommitted_s
        ckpt_s = self.ckpt_s
        if self.phase == "ckpt":
            ckpt_s += self.unit_spent
            inprog = 0.0
        else:
            inprog = self.unit_spent
        stalled = max(0.0, self.horizon - useful_s - ckpt_s - self.lost_s
                      - inprog)
        self._sample_progress(self.horizon)
        step_full = self.step_fn(self.n)
        return GoodputReport(
            n_workers=self.n,
            horizon_s=self.horizon,
            ckpt_interval_steps=self.K,
            step_s_full=step_full,
            useful_steps=self.executed,
            committed_steps=self.committed,
            lost_steps=self.lost_steps,
            failures=self.failures,
            preemptions=self.preemptions,
            straggler_windows=self.straggler_windows,
            useful_s=useful_s,
            ckpt_s=ckpt_s,
            lost_s=self.lost_s,
            stalled_s=stalled,
            max_lost_steps_per_failure=self.max_lost_one,
            capacity_samples=tuple(self.cap_samples),
            progress_samples=tuple(self.prog_samples),
        )


def simulate_goodput(*, n_workers: int, horizon_s: float,
                     timeline: FaultTimeline, recovery: RecoveryModel,
                     ckpt_interval_steps: int,
                     step_s: Union[float, Callable[[int], float]],
                     elastic: bool = False, hot_spares: int = 0,
                     straggler_mitigation: bool = False,
                     mitigation_overhead: float = 0.02,
                     mitigation_cap: float = 1.2,
                     min_workers: int = 1) -> GoodputReport:
    """Simulate ``horizon_s`` seconds of training under ``timeline``.

    ``step_s`` is either the constant steady-state step makespan or a
    callable ``active_workers -> seconds`` (elastic jobs query it at
    reduced worker counts).  Deterministic: the same inputs produce a
    bit-identical :class:`GoodputReport`.
    """
    if n_workers < 1:
        raise ValueError(f"need >= 1 worker, got {n_workers}")
    if horizon_s <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon_s}")
    if ckpt_interval_steps < 1:
        raise ValueError(f"checkpoint interval must be >= 1 step, "
                         f"got {ckpt_interval_steps}")
    if callable(step_s):
        step_fn = step_s
    else:
        const = float(step_s)
        if const <= 0:
            raise ValueError(f"step_s must be > 0, got {const}")
        step_fn = lambda active: const  # noqa: E731
    eng = _Engine(n_workers=n_workers, horizon_s=horizon_s,
                  recovery=recovery, k=ckpt_interval_steps,
                  step_fn=step_fn, elastic=elastic, hot_spares=hot_spares,
                  straggler_mitigation=straggler_mitigation,
                  mitigation_overhead=mitigation_overhead,
                  mitigation_cap=mitigation_cap,
                  min_workers=max(1, min_workers))
    return eng.run(timeline)
