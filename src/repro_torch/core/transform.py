"""Graph-transformation primitives (paper §4.4).

The paper's what-if interface is a small set of primitives over the dependency
graph — ``Select``, ``Scale``/``Shrink``, ``Insert``, ``Remove``, and overriding
the simulator's ``Schedule`` policy.  :class:`GraphTransform` packages them as a
fluent API used by every optimization model in :mod:`repro_torch.core.whatif`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Iterable, List, Optional, Sequence

from .graph import DependencyGraph
from .simulate import ScheduleFn, make_priority_schedule, simulate, SimResult
from .task import Task, TaskKind, DEVICE_STREAM, HOST_THREAD

Predicate = Callable[[Task], bool]


# ---------------------------------------------------------------- selectors
def by_kind(*kinds: TaskKind) -> Predicate:
    ks = set(kinds)
    return lambda t: t.kind in ks


def by_name(pattern: str) -> Predicate:
    """Select by keyword/regex in task names (paper: 'sgemm' / 'elementwise')."""
    rx = re.compile(pattern)
    return lambda t: bool(rx.search(t.name))


def by_layer(pattern: str) -> Predicate:
    """Select by the task->layer mapping (paper: select-by-layer)."""
    rx = re.compile(pattern)
    return lambda t: t.layer is not None and bool(rx.search(t.layer))


def by_phase(*phases: str) -> Predicate:
    ps = set(phases)
    return lambda t: t.phase in ps


def on_device(t: Task) -> bool:
    return t.thread == DEVICE_STREAM


def all_of(*preds: Predicate) -> Predicate:
    return lambda t: all(p(t) for p in preds)


def any_of(*preds: Predicate) -> Predicate:
    return lambda t: any(p(t) for p in preds)


class GraphTransform:
    """Mutable what-if session over a *copy* of a baseline graph.

    Usage (paper Algorithm 3, AMP):

        tf = GraphTransform(baseline)
        tf.scale(all_of(on_device, by_name("dot|conv")), 1/3)
        tf.scale(all_of(on_device, by_name("fusion|elementwise")), 1/2)
        result = tf.simulate()
    """

    def __init__(self, graph: DependencyGraph, *, copy: bool = True) -> None:
        self.graph = graph.copy() if copy else graph
        self.schedule: Optional[ScheduleFn] = None

    # ------------------------------------------------------------ primitives
    def select(self, pred: Predicate) -> List[Task]:
        return self.graph.select(pred)

    def scale(self, pred: Predicate, factor: float) -> int:
        """Multiply matching task durations by ``factor`` (shrink if < 1)."""
        n = 0
        for t in self.select(pred):
            t.duration *= factor
            n += 1
        return n

    def shrink(self, pred: Predicate, factor: float) -> int:
        """Paper's shrink: divide durations by ``factor`` (e.g. 2x faster)."""
        return self.scale(pred, 1.0 / factor)

    def set_duration(self, pred: Predicate, seconds: float) -> int:
        n = 0
        for t in self.select(pred):
            t.duration = seconds
            n += 1
        return n

    def insert_after(self, anchor: Task, task: Task,
                     extra_parents: Sequence[Task] = (),
                     extra_children: Sequence[Task] = ()) -> Task:
        """Insert ``task`` into its thread lane right after ``anchor`` if they
        share a thread, otherwise append to the task's lane and add the
        dependency edge anchor->task (paper Fig. 4 'insert a GPU task': the
        companion host launch task is the caller's responsibility — helpers in
        whatif.py add it when modeling launch-bound inserts)."""
        if anchor.thread == task.thread:
            self.graph.add_task(task, after=anchor)
        else:
            self.graph.add_task(task)
            self.graph.add_edge(anchor, task)
        for p in extra_parents:
            self.graph.add_edge(p, task)
        for c in extra_children:
            self.graph.add_edge(task, c)
        return task

    def insert_before(self, anchor: Task, task: Task,
                      extra_parents: Sequence[Task] = (),
                      extra_children: Sequence[Task] = ()) -> Task:
        """Splice ``task`` into the lane right before ``anchor`` (same thread)."""
        if anchor.thread != task.thread:
            raise ValueError("insert_before requires same-thread anchor")
        lane = self.graph.lanes[anchor.thread]
        idx = lane.index(anchor.uid)
        if idx == 0:
            # becomes new lane head: add without lane link, wire to anchor
            self.graph.add_task(task, link_lane=False)
            lane.remove(task.uid)
            lane.insert(0, task.uid)
            self.graph.add_edge(task, anchor)
        else:
            prev = self.graph.get(lane[idx - 1])
            self.graph.add_task(task, after=prev)
        for p in extra_parents:
            self.graph.add_edge(p, task)
        for c in extra_children:
            self.graph.add_edge(task, c)
        return task

    def append(self, task: Task, parents: Sequence[Task] = (),
               children: Sequence[Task] = ()) -> Task:
        self.graph.add_task(task)
        for p in parents:
            self.graph.add_edge(p, task)
        for c in children:
            self.graph.add_edge(task, c)
        return task

    def remove(self, pred_or_task) -> int:
        """Remove matching tasks, bridging parents to children (paper Fig. 4)."""
        if isinstance(pred_or_task, Task):
            self.graph.remove_task(pred_or_task)
            return 1
        n = 0
        for t in self.select(pred_or_task):
            self.graph.remove_task(t)
            n += 1
        return n

    def override_schedule(self, schedule: ScheduleFn) -> None:
        self.schedule = schedule

    def prioritize(self, priority: Callable[[Task], float]) -> None:
        """Convenience: schedule override by a priority function (P3-style)."""
        self.schedule = make_priority_schedule(priority)

    # ------------------------------------------------------------- execution
    def simulate(self) -> SimResult:
        return simulate(self.graph, self.schedule)

    def cluster(self, workers, **kwargs):
        """Replicate the transformed graph across ``workers`` and return the
        :class:`repro_torch.core.cluster.ClusterGraph` (schedule carried over)."""
        from .cluster import ClusterGraph
        kwargs.setdefault("schedule", self.schedule)
        return ClusterGraph.build(self.graph, workers, **kwargs)


def predicted_speedup(baseline: DependencyGraph,
                      build: Callable[[GraphTransform], None],
                      schedule: Optional[ScheduleFn] = None) -> float:
    """Simulate baseline vs a transformed copy; return predicted speedup."""
    base = simulate(baseline)
    tf = GraphTransform(baseline)
    build(tf)
    if schedule is not None:
        tf.override_schedule(schedule)
    opt = tf.simulate()
    return base.makespan / opt.makespan
