"""Critical-path extraction: *why* is the makespan what it is.

A simulated makespan is one number; practitioners act on the chain of
tasks that produced it (dPRO's critical-path diagnosis, Skyline's
interactive breakdowns).  :func:`simulate` optionally records, per task,
the *binding predecessor* — the task whose completion set its effective
start (the lane predecessor when the thread was the constraint, the
last-finishing dependency otherwise).  Walking that chain backwards from
the makespan-defining task yields the critical path in O(path length) on
top of the O(E log V) simulation, for single-worker graphs and global
:class:`~repro_torch.core.cluster.ClusterGraph`\\ s alike.

The chain is gap-free by construction: each segment starts exactly when
its binder completes, so the segment ``duration + gap`` values accumulate
to the makespan to float precision — the invariant the test suite and the
golden file anchor on.  Segments are attributed into **compute / comm /
host / offload** by task kind, with ``gap`` time (Daydream §4.2.1 untraced
runtime — host tails, trace start skews) reported as **idle**, and split
per worker on cluster graphs.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.graph import DependencyGraph
from repro_torch.core.simulate import ScheduleFn, SimResult, simulate
from repro_torch.core.task import TaskKind, split_worker_thread

# TaskKind -> critical-path attribution category.  Durations land in these
# buckets; gap time (untraced runtime / start skew) is always "idle".
KIND_CATEGORY = {
    TaskKind.COMPUTE: "compute",
    TaskKind.MEMORY: "compute",
    TaskKind.COLLECTIVE: "comm",
    TaskKind.COMM: "comm",
    TaskKind.HOST: "host",
    TaskKind.DATA: "host",
    TaskKind.SYNC: "host",
    TaskKind.OFFLOAD: "offload",
}

CATEGORIES = ("compute", "comm", "host", "offload", "idle")


@dataclasses.dataclass(frozen=True)
class PathSegment:
    """One task on the makespan-defining chain."""

    uid: int
    name: str
    kind: str                  # TaskKind value string
    thread: str                # global thread name (worker-namespaced)
    worker: Optional[int]      # None for single-worker graphs / barriers
    start: float
    duration: float
    gap: float                 # trailing untraced time, attributed as idle
    category: str              # compute | comm | host | offload

    @property
    def end(self) -> float:
        return self.start + self.duration + self.gap


@dataclasses.dataclass
class CriticalPath:
    """The makespan-defining chain plus its attributions.

    ``segments`` run origin (t=0) to makespan in time order; each segment
    starts exactly when its predecessor on the chain completes.
    """

    segments: List[PathSegment]
    makespan: float

    def breakdown(self) -> Dict[str, float]:
        """Seconds per category (plus ``idle`` = summed gaps); the values
        sum to the makespan to float precision."""
        out = {c: 0.0 for c in CATEGORIES}
        for seg in self.segments:
            out[seg.category] += seg.duration
            out["idle"] += seg.gap
        return out

    def fractions(self) -> Dict[str, float]:
        """Category share of the makespan (0..1; zeros kept so reports and
        goldens are shape-stable)."""
        total = self.makespan or 1.0
        return {c: v / total for c, v in self.breakdown().items()}

    def per_worker(self) -> Dict[Optional[int], float]:
        """Seconds of the path spent on each worker's resources
        (duration + gap; ``None`` collects worker-less lanes such as
        cluster barriers)."""
        out: Dict[Optional[int], float] = collections.defaultdict(float)
        for seg in self.segments:
            out[seg.worker] += seg.duration + seg.gap
        return dict(out)

    def per_class(self, classes) -> Dict[Optional[int], float]:
        """:meth:`per_worker` folded over symmetry classes.

        ``classes`` is the ``WorkerClass`` list of a folded cluster graph
        (``FoldedClusterGraph.classes``): on a folded graph the worker
        index of each segment is a *class* index, and this maps it back to
        the class representative's real worker id — so attributions stay
        comparable with a materialized run's :meth:`per_worker` without
        expanding all members.  ``None`` (cluster barriers) passes
        through.  Expand a class entry to its members on demand via
        ``classes[i].members``: every member shares the representative's
        on-path time by symmetry.
        """
        out: Dict[Optional[int], float] = collections.defaultdict(float)
        for ci, secs in self.per_worker().items():
            out[classes[ci].representative if ci is not None
                else None] += secs
        return dict(out)

    def targeted_share(self, uids) -> float:
        """Fraction of the makespan spent in segments whose uid is in
        ``uids`` — the critical-path attribution signal opportunity
        ranking reports next to its Amdahl bounds."""
        if not self.makespan:
            return 0.0
        uids = set(uids)
        return sum(seg.duration for seg in self.segments
                   if seg.uid in uids) / self.makespan

    # ------------------------------------------------------------- report
    def format(self, *, top: int = 8, unit: float = 1e3,
               unit_name: str = "ms") -> str:
        """Human-readable report: attribution line, per-worker split, and
        the ``top`` longest segments."""
        frac = self.fractions()
        lines = [f"== critical path: {self.makespan * unit:.3f} {unit_name} "
                 f"over {len(self.segments)} task(s) =="]
        lines.append("  " + "  ".join(
            f"{c} {frac[c] * 100:5.1f}%" for c in CATEGORIES
            if frac[c] > 0 or c in ("compute", "comm")))
        pw = self.per_worker()
        if len(pw) > 1 or (pw and next(iter(pw)) is not None):
            lines.append("  on-path time per worker: " + "  ".join(
                f"{'w%d' % w if w is not None else 'sync'}:"
                f"{pw[w] * unit:.3f}"
                for w in sorted(pw, key=lambda x: (x is None, x))))
        longest = sorted(self.segments, key=lambda s: -(s.duration + s.gap))
        for seg in longest[:top]:
            lines.append(
                f"  {(seg.duration + seg.gap) * unit:9.3f} {unit_name}  "
                f"{seg.category:8s} {seg.thread:18s} {seg.name}")
        return "\n".join(lines)


def _worker_of(thread: str) -> Optional[int]:
    return split_worker_thread(thread)[0]


def extract_critical_path(graph: DependencyGraph,
                          result: Optional[SimResult] = None,
                          schedule: Optional[ScheduleFn] = None
                          ) -> CriticalPath:
    """Extract the makespan-defining chain of ``graph``.

    ``result`` must carry binding predecessors
    (``simulate(record_binding=True)``); when it is missing or was produced
    without recording, the graph is re-simulated with recording on (same
    engine, bit-identical timeline).  The walk itself is O(path length);
    end to end the extraction is O(E log V) — dominated by the simulation.
    """
    provided = result
    if result is None or result.binding is None:
        result = simulate(graph, schedule, record_binding=True)
        if provided is not None and \
                abs(provided.makespan - result.makespan) > \
                1e-9 * max(abs(result.makespan), 1e-30):
            # the caller's result describes durations the graph no longer
            # has (a sweep retuned the shared build in place): re-deriving
            # would silently return a *different point's* path
            raise RuntimeError(
                f"provided result (makespan {provided.makespan}) no longer "
                f"matches the graph (makespan {result.makespan}): it was "
                f"retuned after the result was produced — re-simulate "
                f"before extracting the critical path")
    if not result.start:
        return CriticalPath(segments=[], makespan=0.0)
    binding = result.binding
    finish = result.finish

    def done(uid: int) -> float:
        return finish[uid] + graph.get(uid).gap

    end_uid = max(finish, key=lambda u: (done(u), -u))
    chain: List[int] = []
    seen = set()
    uid: Optional[int] = end_uid
    while uid is not None:
        if uid in seen:          # defensive: a cycle here is an engine bug
            raise RuntimeError("binding chain loops — simulator invariant "
                               "violated")
        seen.add(uid)
        chain.append(uid)
        uid = binding.get(uid)
    chain.reverse()
    segments = []
    t_acc = 0.0
    for u in chain:
        t = graph.get(u)
        # contiguity check doubles as a staleness guard: with a fresh
        # result every chain task starts exactly when its binder completes
        # (same float ops), so a drift beyond noise means the graph's
        # durations/gaps were retuned after ``result`` was simulated
        if abs(result.start[u] - t_acc) > \
                1e-12 * (abs(t_acc) + abs(result.start[u])) + 1e-18:
            raise RuntimeError(
                f"binding chain is discontiguous at task {t.name!r} "
                f"(start {result.start[u]} vs chain time {t_acc}): the "
                f"graph was retuned after this result was produced — "
                f"re-simulate before extracting the critical path")
        t_acc = t_acc + t.duration
        t_acc = t_acc + t.gap
        segments.append(PathSegment(
            uid=u, name=t.name, kind=t.kind.value, thread=t.thread,
            worker=_worker_of(t.thread), start=result.start[u],
            duration=t.duration, gap=t.gap,
            category=KIND_CATEGORY.get(t.kind, "compute")))
    return CriticalPath(segments=segments, makespan=done(end_uid))


def cluster_critical_path(cluster_graph, result=None) -> CriticalPath:
    """:func:`extract_critical_path` over a
    :class:`~repro_torch.core.cluster.ClusterGraph`.

    ``result`` is the :class:`~repro_torch.core.cluster.ClusterResult` of
    ``cluster_graph.simulate(record_binding=True)``; without one (or
    without recording) the global graph is re-simulated with recording.
    Segments carry worker indices, so :meth:`CriticalPath.per_worker`
    answers "whose resources is the makespan made of".
    """
    res = getattr(result, "global_result", result)
    return extract_critical_path(cluster_graph.graph, res,
                                 cluster_graph.schedule)
