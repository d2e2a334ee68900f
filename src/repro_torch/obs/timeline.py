"""Counter timelines: time-resolved telemetry derived from simulated results.

A :class:`SimResult` collapses a timeline to scalars (makespan, per-lane
busy seconds) plus per-task start/finish instants.  This module re-expands
those instants into piecewise-constant *counter* series — the view a
practitioner actually inspects when asking "why does this lane idle at
t=4ms?" or "when does activation memory peak?":

* per-lane **busy** (0/1) and per-worker **utilization** (busy-lane
  fraction, 0..1),
* per-worker **ready-queue depth** (tasks whose dependencies have resolved
  but whose lane has not dispatched them yet),
* per-worker **COMM bytes in flight** (outstanding COLLECTIVE/COMM payload),
* per-worker **live memory** (activations alloc'd at the last forward task
  of a layer and freed at its last backward consumer; gradients alloc'd at
  the last backward task and freed at the last collective/update consumer
  — sized from the Scenario byte maps).

The busy-interval helpers (:func:`interval_union`, :func:`interval_overlap`,
:func:`lane_utilization`) are THE single implementation; ``core/simulate``
imports them back so the engine's host/device breakdown and every serving
``lane_utilization`` consumer share one definition.

This module deliberately imports nothing from ``repro_torch.*`` at module scope
(only inside functions) so ``repro_torch.obs`` can be imported from anywhere in
the package — including ``core.simulate`` itself — without cycles.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Sequence, Tuple)

__all__ = [
    "Timeline", "TimelineSet", "interval_union", "interval_overlap",
    "lane_utilization", "check_result_fresh", "compute_timelines",
    "format_timeline_report",
]


# ------------------------------------------------------- interval helpers
def interval_union(intervals: List[Tuple[float, float]]
                   ) -> List[Tuple[float, float]]:
    """Merge overlapping/touching ``(start, end)`` intervals (sorted out)."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for s, e in intervals[1:]:
        ls, le = out[-1]
        if s <= le:
            out[-1] = (ls, max(le, e))
        else:
            out.append((s, e))
    return out


def interval_overlap(a: List[Tuple[float, float]],
                     b: List[Tuple[float, float]]) -> float:
    """Total overlap seconds between two *disjoint-sorted* interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def lane_utilization(result: Any) -> Dict[str, float]:
    """Per-lane busy fraction of the makespan, from ``thread_busy``.

    A lane (simulator thread) at 1.0 worked the entire timeline; serving
    predictions report this per batch-slot lane to show how a policy keeps
    (or starves) its slots.  Zero-makespan results report 0.0 everywhere.
    """
    if result.makespan <= 0:
        return {th: 0.0 for th in result.thread_busy}
    return {th: busy / result.makespan
            for th, busy in result.thread_busy.items()}


# ---------------------------------------------------------------- Timeline
@dataclasses.dataclass(frozen=True)
class Timeline:
    """A piecewise-constant counter series on ``[0, end]``.

    ``values[i]`` holds on ``[times[i], times[i+1])`` (and ``values[-1]``
    to ``end``); the value before ``times[0]`` is 0.  Rollups are
    time-weighted over the full ``[0, end]`` horizon so an early spike and
    a long tail weigh what they actually cost in wall-clock.
    """

    times: Tuple[float, ...]
    values: Tuple[float, ...]
    end: float

    @staticmethod
    def from_deltas(deltas: Iterable[Tuple[float, float]],
                    end: float) -> "Timeline":
        """Build from ``(time, +/-delta)`` events (e.g. +1 at task start,
        -1 at finish).  Same-instant deltas merge, zero-net points drop."""
        acc: Dict[float, float] = {}
        for t, dv in deltas:
            if dv:
                acc[t] = acc.get(t, 0.0) + dv
        times: List[float] = []
        values: List[float] = []
        v = 0.0
        for t in sorted(acc):
            dv = acc[t]
            if dv == 0.0:
                continue
            v += dv
            times.append(t)
            values.append(v)
        hi = max(float(end), times[-1] if times else 0.0)
        return Timeline(tuple(times), tuple(values), hi)

    def __len__(self) -> int:
        return len(self.times)

    def value_at(self, t: float) -> float:
        """Series value at instant ``t`` (0 before the first change)."""
        i = bisect.bisect_right(self.times, t) - 1
        return self.values[i] if i >= 0 else 0.0

    def segments(self) -> Iterator[Tuple[float, float, float]]:
        """Yield ``(t0, t1, value)`` covering ``[0, end]`` gaplessly."""
        if not self.times:
            yield (0.0, self.end, 0.0)
            return
        if self.times[0] > 0.0:
            yield (0.0, self.times[0], 0.0)
        for i, t0 in enumerate(self.times):
            t1 = self.times[i + 1] if i + 1 < len(self.times) else self.end
            yield (t0, t1, self.values[i])

    @property
    def peak(self) -> float:
        hi = max(self.values, default=0.0)
        return max(hi, 0.0) if (not self.times or self.times[0] > 0.0) \
            else hi

    @property
    def peak_time(self) -> float:
        """First instant at which :attr:`peak` is attained."""
        peak = self.peak
        if not self.times or peak == 0.0 and self.times[0] > 0.0:
            return 0.0
        for t, v in zip(self.times, self.values):
            if v == peak:
                return t
        return 0.0

    def integral(self) -> float:
        """Time integral over ``[0, end]`` (e.g. byte-seconds)."""
        return sum((t1 - t0) * v for t0, t1, v in self.segments())

    def mean(self) -> float:
        """Time-weighted mean over ``[0, end]``."""
        return self.integral() / self.end if self.end > 0 else 0.0

    def percentile(self, q: float) -> float:
        """Time-weighted percentile: smallest value v such that the series
        is <= v for at least ``q`` of the horizon (``q`` in [0, 1])."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"percentile q must be in [0, 1], got {q}")
        if self.end <= 0:
            return 0.0
        segs = sorted(((v, t1 - t0) for t0, t1, v in self.segments()
                       if t1 > t0), key=lambda s: s[0])
        target = q * self.end
        acc = 0.0
        for v, w in segs:
            acc += w
            if acc >= target:
                return v
        return segs[-1][0] if segs else 0.0

    def samples(self) -> List[Tuple[float, float]]:
        """``(t, value)`` at each change point plus a closing sample at
        ``end`` — the exact payload of a Chrome/Perfetto counter track."""
        out = [(0.0, 0.0)] if (not self.times or self.times[0] > 0.0) \
            else []
        out.extend(zip(self.times, self.values))
        if not out or out[-1][0] < self.end:
            out.append((self.end, out[-1][1] if out else 0.0))
        return out


# ------------------------------------------------------------- TimelineSet
@dataclasses.dataclass
class TimelineSet:
    """All counter timelines derived from one simulated timeline.

    Lane keys are simulator thread names; worker keys are integer worker
    indices (``w3/device`` -> 3; un-namespaced single-graph lanes -> 0).
    ``memory`` is empty when the scenario carries no byte maps.
    """

    makespan: float
    lane_busy: Dict[str, "Timeline"]
    utilization: Dict[int, "Timeline"]
    queue_depth: Dict[int, "Timeline"]
    comm_bytes: Dict[int, "Timeline"]
    memory: Dict[int, "Timeline"]
    lanes_per_worker: Dict[int, int]

    @property
    def workers(self) -> List[int]:
        keys = (set(self.utilization) | set(self.queue_depth)
                | set(self.comm_bytes) | set(self.memory))
        return sorted(keys)

    def lane_utilization(self) -> Dict[str, float]:
        """Busy fraction per lane, from the busy timelines (agrees with
        :func:`lane_utilization` on the result up to float noise)."""
        if self.makespan <= 0:
            return {th: 0.0 for th in self.lane_busy}
        return {th: tl.integral() / self.makespan
                for th, tl in self.lane_busy.items()}

    def peak_memory(self, worker: Optional[int] = None) -> float:
        """Peak live bytes for one worker (or the max across workers)."""
        if worker is not None:
            tl = self.memory.get(worker)
            return tl.peak if tl is not None else 0.0
        return max((tl.peak for tl in self.memory.values()), default=0.0)


# ------------------------------------------------------------ construction
def check_result_fresh(graph: Any, result: Any) -> None:
    """Raise if ``result`` no longer describes ``graph``'s timeline.

    Sweeps retune one shared build in place between points; deriving
    timelines from a stale pairing would silently describe a *different
    point's* schedule.  Same discipline (and tolerance) as
    ``traceio.chrome.predicted_worker_events``.
    """
    res = getattr(result, "global_result", result)
    try:
        for t in graph.tasks():
            start, finish = res.start[t.uid], res.finish[t.uid]
            tol = 1e-12 * (abs(finish) + abs(t.duration)) + 1e-18
            if abs((finish - start) - t.duration) > tol:
                raise ValueError(
                    f"result is stale for task {t.name!r} (uid {t.uid}): "
                    f"simulated span {finish - start!r}s vs current "
                    f"duration {t.duration!r}s — the graph was retuned "
                    f"after this simulation; re-simulate before deriving "
                    f"timelines")
    except KeyError as e:
        raise ValueError(
            f"result is stale: task uid {e.args[0]} is not in the "
            f"simulated start/finish maps (graph changed structurally "
            f"after this simulation)") from e


def _worker_of(thread: str, split: Callable[[str], Tuple[Optional[int], str]]
               ) -> int:
    w, _ = split(thread)
    return 0 if w is None else w


def compute_timelines(graph: Any, result: Any, *,
                      activation_bytes: Optional[Mapping[str, float]] = None,
                      layer_grad_bytes: Optional[Mapping[str, float]] = None,
                      check_fresh: bool = True) -> TimelineSet:
    """Derive a :class:`TimelineSet` from a simulated graph.

    ``result`` is a ``SimResult`` or ``ClusterResult`` (its global result
    is used).  Byte maps are the Scenario's ``activation_bytes`` /
    ``layer_grad_bytes``; omit them and the memory timelines are empty.

    Live-memory semantics (per worker ``w``, layer ``L``):

    * **activation** (``activation_bytes[L]``): alloc at the finish of the
      last ``phase == "fwd"`` task of ``(w, L)``; freed at the finish of
      the last ``phase == "bwd"`` task of ``(w, L)`` (its final consumer),
      else held to the makespan.
    * **gradient** (``layer_grad_bytes[L]``): alloc at the finish of the
      last ``phase == "bwd"`` task of ``(w, L)``; freed at the latest
      finish among ``(w, L)`` COLLECTIVE/COMM or ``phase == "update"``
      tasks at-or-after the alloc (all-reduce legs and the optimizer step
      both read the gradient), else held to the makespan.

    O(V + E) over the graph; bench-gated in ``benchmarks/bench_obs.py``.
    """
    from repro_torch.core.task import TaskKind, split_worker_thread
    res = getattr(result, "global_result", result)
    if check_fresh:
        check_result_fresh(graph, res)
    makespan = res.makespan
    comm_kinds = (TaskKind.COLLECTIVE, TaskKind.COMM)

    lane_deltas: Dict[str, List[Tuple[float, float]]] = {}
    util_deltas: Dict[int, List[Tuple[float, float]]] = {}
    queue_deltas: Dict[int, List[Tuple[float, float]]] = {}
    comm_deltas: Dict[int, List[Tuple[float, float]]] = {}
    worker_lanes: Dict[int, set] = {}
    # (worker, layer) -> [last fwd finish, last bwd finish, last consumer]
    produce: Dict[Tuple[int, str], List[Optional[float]]] = {}

    want_mem = bool(activation_bytes) or bool(layer_grad_bytes)
    for t in graph.tasks():
        if t.duration <= 0 and not (want_mem and t.layer):
            continue
        start, finish = res.start[t.uid], res.finish[t.uid]
        w = _worker_of(t.thread, split_worker_thread)
        if t.duration > 0:
            lane_deltas.setdefault(t.thread, []).extend(
                ((start, 1.0), (finish, -1.0)))
            util_deltas.setdefault(w, []).extend(
                ((start, 1.0), (finish, -1.0)))
            worker_lanes.setdefault(w, set()).add(t.thread)
            if t.kind in comm_kinds and t.comm_bytes > 0:
                comm_deltas.setdefault(w, []).extend(
                    ((start, t.comm_bytes), (finish, -t.comm_bytes)))
            # queued: all dependencies resolved but the lane has not
            # dispatched it yet (zero-duration barriers are structure,
            # not work — they never queue)
            ready = 0.0
            for p in graph.parents(t):
                r = res.finish[p.uid] + p.gap
                if r > ready:
                    ready = r
            if start > ready:
                queue_deltas.setdefault(w, []).extend(
                    ((ready, 1.0), (start, -1.0)))
        if want_mem and t.layer:
            slot = produce.setdefault((w, t.layer), [None, None, None])
            if t.phase == "fwd":
                if slot[0] is None or finish > slot[0]:
                    slot[0] = finish
            elif t.phase == "bwd":
                if slot[1] is None or finish > slot[1]:
                    slot[1] = finish
            if t.phase == "update" or t.kind in comm_kinds:
                if slot[2] is None or finish > slot[2]:
                    slot[2] = finish

    mem_deltas: Dict[int, List[Tuple[float, float]]] = {}
    for (w, layer), (fwd, bwd, consume) in produce.items():
        act = float((activation_bytes or {}).get(layer, 0.0) or 0.0)
        if act > 0.0 and fwd is not None:
            free = bwd if (bwd is not None and bwd > fwd) else makespan
            mem_deltas.setdefault(w, []).extend(((fwd, act), (free, -act)))
        grad = float((layer_grad_bytes or {}).get(layer, 0.0) or 0.0)
        if grad > 0.0 and bwd is not None:
            free = consume if (consume is not None and consume > bwd) \
                else makespan
            mem_deltas.setdefault(w, []).extend(((bwd, grad), (free, -grad)))

    def build(deltas: Dict[int, List[Tuple[float, float]]],
              scale: Optional[Dict[int, float]] = None
              ) -> Dict[int, Timeline]:
        out = {}
        for k in sorted(deltas):
            ds = deltas[k]
            if scale is not None:
                f = scale.get(k, 1.0)
                ds = [(t, dv / f) for t, dv in ds]
            out[k] = Timeline.from_deltas(ds, makespan)
        return out

    lanes_per_worker = {w: len(ls) for w, ls in worker_lanes.items()}
    return TimelineSet(
        makespan=makespan,
        lane_busy={th: Timeline.from_deltas(lane_deltas[th], makespan)
                   for th in sorted(lane_deltas)},
        utilization=build(util_deltas,
                          {w: float(max(n, 1))
                           for w, n in lanes_per_worker.items()}),
        queue_depth=build(queue_deltas),
        comm_bytes=build(comm_deltas),
        memory=build(mem_deltas),
        lanes_per_worker=lanes_per_worker,
    )


# ---------------------------------------------------------------- report
def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def format_timeline_report(ts: TimelineSet, *, top_lanes: int = 8) -> str:
    """Human-readable per-worker rollup table (perf_report/diagnose
    ``--timeline``): utilization, peak live memory (+instant), ready-queue
    depth, and peak COMM bytes in flight."""
    ms = ts.makespan * 1e3
    lines = [f"== timelines: makespan {ms:.3f} ms, "
             f"{len(ts.workers)} worker(s) =="]
    hdr = (f"{'worker':<8} {'util-mean':>9} {'util-p95':>8} "
           f"{'peak-mem':>10} {'@ms':>9} {'queue-peak':>10} "
           f"{'queue-mean':>10} {'comm-peak':>10}")
    lines.append(hdr)
    empty = Timeline((), (), ts.makespan)
    for w in ts.workers:
        util = ts.utilization.get(w, empty)
        mem = ts.memory.get(w, empty)
        q = ts.queue_depth.get(w, empty)
        comm = ts.comm_bytes.get(w, empty)
        mem_s = _fmt_bytes(mem.peak) if len(mem) else "-"
        mem_at = f"{mem.peak_time * 1e3:.3f}" if len(mem) else "-"
        comm_s = _fmt_bytes(comm.peak) if len(comm) else "-"
        lines.append(
            f"{'w%d' % w:<8} {util.mean():>9.3f} "
            f"{util.percentile(0.95):>8.3f} {mem_s:>10} {mem_at:>9} "
            f"{q.peak:>10.0f} {q.mean():>10.2f} {comm_s:>10}")
    lane_util = sorted(ts.lane_utilization().items(),
                       key=lambda kv: -kv[1])
    if lane_util:
        shown = ", ".join(f"{th} {u:.2f}" for th, u in
                          lane_util[:top_lanes])
        extra = len(lane_util) - top_lanes
        tail = f" (+{extra} more)" if extra > 0 else ""
        lines.append(f"busiest lanes: {shown}{tail}")
    return "\n".join(lines)
