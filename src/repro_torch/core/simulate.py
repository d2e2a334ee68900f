"""Daydream's runtime simulation — paper Algorithm 1, two engines.

:func:`simulate` is a heap-based *event-driven* engine: ready tasks live in a
priority queue keyed by effective start time, so each scheduling decision is
O(log V) instead of the naive frontier scan's O(F) (plus an O(F)
``list.remove``).  Total cost is O(E log V) on lane-ordered graphs, which is
what lets the cluster simulator (:mod:`repro_torch.core.cluster`) run global graphs
with hundreds of thousands of tasks.  :func:`simulate_reference` keeps the
original O(V·F) frontier-scan loop verbatim as the equivalence oracle used by
the property tests and the benchmark harness.

Engine invariants (relied on by tests/test_engine_equivalence.py):

* Effective start times are monotone: a task's ``max(thread progress,
  dependency-ready time)`` only ever grows, so a heap entry's key is a valid
  *lower bound* and stale entries can be lazily re-keyed on pop.
* With the default policy, popping the minimum ``(eff, ready, uid)`` entry
  reproduces :func:`default_schedule`'s tie-breaking exactly — both engines
  produce bit-identical start times and makespans.
* A pluggable :data:`ScheduleFn` must be *eff-minimal*: it returns a task
  whose effective start is within ``SCHED_EPS`` of the frontier minimum.
  Both built-ins (:func:`default_schedule`, :func:`make_priority_schedule`)
  satisfy this; a policy that deliberately idles a resource should use
  :func:`simulate_reference`, which passes the entire frontier.

The ``schedule`` function that picks among ready tasks is pluggable exactly
as in the paper (§4.4 "Schedule"): the default picks the task with the
earliest effective start time; what-ifs like P3 override it with priority
policies.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .graph import DependencyGraph
from .task import Task, TaskKind, DEVICE_STREAM, HOST_THREAD

# schedule(frontier, progress, earliest_start) -> chosen task
ScheduleFn = Callable[[List[Task], Dict[str, float], Dict[int, float]], Task]

# Tie window inside which a custom schedule may reorder ready tasks; matches
# make_priority_schedule's candidate filter so both engines see the same set.
SCHED_EPS = 1e-12


def default_schedule(frontier: List[Task], progress: Dict[str, float],
                     earliest: Dict[int, float]) -> Task:
    """Paper default: pick the ready task with the earliest effective start.

    Effective start = max(thread progress, task's dependency-ready time).
    Ties break on dependency-ready time then uid for determinism.
    """
    def key(t: Task) -> Tuple[float, float, int]:
        eff = max(progress.get(t.thread, 0.0), earliest[t.uid])
        return (eff, earliest[t.uid], t.uid)
    return min(frontier, key=key)


def make_priority_schedule(priority: Callable[[Task], float]) -> ScheduleFn:
    """Priority override used by P3-style what-ifs (paper Algorithm 7).

    Among the tasks tied for earliest effective start, prefer the one with the
    highest ``priority(task)``.
    """
    def sched(frontier: List[Task], progress: Dict[str, float],
              earliest: Dict[int, float]) -> Task:
        def eff(t: Task) -> float:
            return max(progress.get(t.thread, 0.0), earliest[t.uid])
        best_eff = min(eff(t) for t in frontier)
        candidates = [t for t in frontier if eff(t) <= best_eff + SCHED_EPS]
        return max(candidates, key=lambda t: (priority(t), -t.uid))
    return sched


@dataclasses.dataclass
class SimResult:
    makespan: float
    start: Dict[int, float]                  # uid -> start time (paper output)
    finish: Dict[int, float]                 # uid -> start + duration (no gap)
    thread_busy: Dict[str, float]            # per-thread busy seconds
    _breakdown: Optional[Dict[str, float]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _breakdown_fn: Optional[Callable[[], Dict[str, float]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _binding: Optional[Dict[int, Optional[int]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _binding_fn: Optional[Callable[[], Dict[int, Optional[int]]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    # incremental-replay carry: per-thread busy intervals, per-thread final
    # completion (finish + gap of the lane's last task), and per-thread uid
    # execution order.  simulate_incremental() reads them off ``prev`` to
    # freeze clean lanes in O(threads) instead of re-deriving them in O(V),
    # and writes them on its merged result so sweep chains stay cheap.
    _intervals: Optional[Dict[str, List[Tuple[float, float]]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _lane_done: Optional[Dict[str, float]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _lanes: Optional[Dict[str, List[int]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _lanes_fn: Optional[Callable[[], Dict[str, List[int]]]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def breakdown(self) -> Dict[str, float]:
        """Paper Fig. 6 runtime breakdown: host-only / device-only /
        parallel / idle seconds.

        Materialized lazily on first access (the :attr:`binding` pattern):
        the interval unions behind it are O(V log V) and most sweep points
        never read them — deferring keeps both the engine and the
        incremental replay path free of the cost.
        """
        if self._breakdown is None and self._breakdown_fn is not None:
            self._breakdown = self._breakdown_fn()
            self._breakdown_fn = None    # drop: pins the interval lists
        return self._breakdown or {}

    @property
    def lane_order(self) -> Optional[Dict[str, List[int]]]:
        """Per-thread uids in execution order, or ``None`` when this
        result cannot provide them (hand-built instances).  Derived
        lazily from the engine's pop order and cached."""
        if self._lanes is None and self._lanes_fn is not None:
            self._lanes = self._lanes_fn()
            self._lanes_fn = None
        return self._lanes

    @property
    def binding(self) -> Optional[Dict[int, Optional[int]]]:
        """uid -> uid of the *binding predecessor* (the task whose
        completion set this task's effective start: the lane predecessor
        when the thread was the constraint, the last-finishing dependency
        otherwise; None for tasks that started at t=0).

        Available only from ``simulate(record_binding=True)`` —
        :mod:`repro_torch.analysis` walks it to extract the makespan-defining
        critical path.  Materialized lazily on first access (the
        ``ClusterResult.per_worker`` pattern): the engine's hot loop only
        stores one conditional observation per released edge, and the
        O(V log V) map derivation runs here, outside the simulation —
        which is what keeps the instrumented run within the
        ``bench_sim.py`` 10% gate.
        """
        if self._binding is None and self._binding_fn is not None:
            self._binding = self._binding_fn()
            # drop the closure: it pins the engine's O(V) working dicts
            self._binding_fn = None
        return self._binding

    def speedup_over(self, other: "SimResult") -> float:
        return other.makespan / self.makespan if self.makespan > 0 else float("inf")


# Busy-interval math lives in repro_torch.obs.timeline (one implementation for
# the engine breakdown, serving lane reports, and counter timelines); the
# historical names stay importable from here.
from repro_torch.obs.timeline import interval_overlap as _overlap          # noqa: E402
from repro_torch.obs.timeline import interval_union as _interval_union     # noqa: E402
from repro_torch.obs.timeline import lane_utilization                      # noqa: E402,F401


def _host_device_breakdown(busy_intervals: Dict[str, List[Tuple[float, float]]],
                           makespan: float,
                           is_host: Callable[[str], bool]) -> Dict[str, float]:
    """Paper Fig. 6 runtime breakdown: host-only / device-only / parallel."""
    host_iv = _interval_union(
        [iv for th, ivs in busy_intervals.items() if is_host(th) for iv in ivs])
    dev_iv = _interval_union(
        [iv for th, ivs in busy_intervals.items() if not is_host(th) for iv in ivs])
    host_busy = sum(e - s for s, e in host_iv)
    dev_busy = sum(e - s for s, e in dev_iv)
    par = _overlap(host_iv, dev_iv)
    return {
        "host_only_s": host_busy - par,
        "device_only_s": dev_busy - par,
        "parallel_s": par,
        "idle_s": max(0.0, makespan - (host_busy + dev_busy - par)),
    }


def _assemble(graph: DependencyGraph, executed: int,
              progress: Dict[str, float], start: Dict[int, float],
              finish: Dict[int, float], busy: Dict[str, float],
              busy_intervals: Dict[str, List[Tuple[float, float]]],
              binding_fn: Optional[Callable[[], Dict[int, Optional[int]]]]
              = None) -> SimResult:
    if executed != len(graph):
        raise RuntimeError(
            f"simulation deadlock: executed {executed}/{len(graph)} tasks (cycle?)")
    makespan = max(progress.values(), default=0.0)
    ivs = dict(busy_intervals)
    lane_done = dict(progress)
    by_uid = graph._tasks

    def lanes_fn() -> Dict[str, List[int]]:
        # ``start`` insertion order is the engine's pop order, so one
        # grouping pass recovers each lane's execution order
        lanes: Dict[str, List[int]] = {th: [] for th in lane_done}
        for uid in start:
            lanes[by_uid[uid].thread].append(uid)
        return lanes

    return SimResult(makespan=makespan, start=start, finish=finish,
                     thread_busy=dict(busy),
                     _breakdown_fn=lambda: _host_device_breakdown(
                         ivs, makespan, lambda th: th == HOST_THREAD),
                     _binding_fn=binding_fn,
                     _intervals=ivs, _lane_done=lane_done,
                     _lanes_fn=lanes_fn)


def _derive_binding(by_uid: Dict[int, Task], start: Dict[int, float],
                    finish: Dict[int, float], earliest: Dict[int, float],
                    dep_binder: Dict[int, int]) -> Dict[int, Optional[int]]:
    """Binding predecessors, derived *after* the simulation loop.

    A task's effective start is ``max(thread progress, dependency-ready)``.
    When the thread was the constraint (``start > earliest``) the binder is
    the thread task that completed (``finish + gap``) exactly at our start;
    otherwise the dependency that last raised the ready time
    (``dep_binder``, the only thing the hot loop records), or None for a
    t=0 start.

    Per-thread execution order is recovered by sorting on ``(start, uid)``:
    thread progress is monotone, so start order matches execution order
    except among same-instant ties, where the backward scan for the exact
    completion time picks the true constraint (completion times here are
    bitwise reproductions of the progress values the engine compared
    against, so ``==`` is the right test).  The scan is bounded by the
    same-instant run plus one earlier-start task — tasks with a strictly
    earlier start all executed before us, so the first one reached is the
    latest of them.
    """
    lanes: Dict[str, List[Tuple[float, int]]] = collections.defaultdict(list)
    for uid, s in start.items():
        lanes[by_uid[uid].thread].append((s, uid))
    binding: Dict[int, Optional[int]] = {}
    get_dep = dep_binder.get
    for lane in lanes.values():
        lane.sort()
        for i, (s, u) in enumerate(lane):
            if s <= earliest[u]:
                binding[u] = get_dep(u)
                continue
            b = lane[i - 1][1] if i > 0 else None
            j = i - 1
            while j >= 0:
                sc, c = lane[j]
                if finish[c] + by_uid[c].gap == s:
                    b = c
                    break
                if sc < s:
                    break
                j -= 1
            binding[u] = b
    return binding


def simulate(graph: DependencyGraph, schedule: Optional[ScheduleFn] = None,
             *, record_binding: bool = False) -> SimResult:
    """Event-driven engine (default): paper Algorithm 1 semantics in O(E log V).

    Ready tasks sit in a min-heap keyed by ``(effective start, ready time,
    uid)``.  Keys are lower bounds (effective starts only grow), so a popped
    entry whose key is stale is re-pushed with its current effective start;
    a fresh minimum is executed directly.  When a custom ``schedule`` is
    supplied, every entry within ``SCHED_EPS`` of the minimum is popped and
    handed to the policy — the same candidate set the legacy loop's built-in
    policies select from — and the losers are re-pushed.

    ``record_binding=True`` additionally makes :attr:`SimResult.binding`
    available — each task's binding predecessor, what
    :mod:`repro_torch.analysis` walks for critical paths.  The recording is
    designed to be free when off (the child-release loop is duplicated so
    the disabled path runs the byte-identical original body) and cheap
    when on: the hot loop stores exactly one observation per released edge
    that raises a ready time (``dep_binder``), and the full binding map is
    derived lazily on first ``.binding`` access (:func:`_derive_binding`).
    ``benchmarks/bench_sim.py`` gates the instrumented run within 10% of
    the plain run.
    """
    # direct adjacency access (uid sets) — the engine is the hottest loop in
    # the system and per-call Task-list materialization doubles its cost
    by_uid = graph._tasks
    children_of = graph._children
    parents_of = graph._parents
    ref: Dict[int, int] = {}
    earliest: Dict[int, float] = {}          # "u.start" accumulator of Algorithm 1
    heap: List[Tuple[float, float, int]] = []
    for uid in by_uid:
        n = len(parents_of[uid]) if uid in parents_of else 0
        ref[uid] = n
        earliest[uid] = 0.0
        if n == 0:
            heap.append((0.0, 0.0, uid))
    heapq.heapify(heap)

    progress: Dict[str, float] = collections.defaultdict(float)   # P
    start: Dict[int, float] = {}
    finish: Dict[int, float] = {}
    busy: Dict[str, float] = collections.defaultdict(float)
    busy_intervals: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    executed = 0
    dep_binder: Dict[int, int] = {}

    heappush, heappop = heapq.heappush, heapq.heappop
    while heap:
        eff_key, _, uid = heappop(heap)
        u = by_uid[uid]
        e = earliest[uid]
        p = progress[u.thread]
        eff = p if p > e else e
        if eff > eff_key:                     # stale lower bound: re-key
            heappush(heap, (eff, e, uid))
            continue
        if schedule is not None:
            candidates = [u]
            spill: List[Tuple[float, float, int]] = []
            while heap and heap[0][0] <= eff_key + SCHED_EPS:
                _, _, uid2 = heapq.heappop(heap)
                t2 = by_uid[uid2]
                eff2 = max(progress[t2.thread], earliest[uid2])
                if eff2 <= eff_key + SCHED_EPS:
                    candidates.append(t2)
                else:
                    spill.append((eff2, earliest[uid2], uid2))
            if len(candidates) > 1:
                u = schedule(candidates, progress, earliest)
                for t2 in candidates:
                    if t2.uid != u.uid:
                        eff2 = max(progress[t2.thread], earliest[t2.uid])
                        spill.append((eff2, earliest[t2.uid], t2.uid))
            for item in spill:
                heapq.heappush(heap, item)

        th = u.thread
        uu = u.uid
        e = earliest[uu]
        p = progress[th]
        s = p if p > e else e
        start[uu] = s
        end = s + u.duration
        finish[uu] = end
        done = end + u.gap
        progress[th] = done
        busy[th] += u.duration
        if u.duration > 0:
            busy_intervals[th].append((s, end))
        executed += 1
        if uu in children_of:
            if not record_binding:
                for cuid in children_of[uu]:
                    r = ref[cuid] - 1
                    ref[cuid] = r
                    if earliest[cuid] < done:
                        earliest[cuid] = done
                    if r == 0:
                        ec = earliest[cuid]
                        pc = progress[by_uid[cuid].thread]
                        heappush(heap, (pc if pc > ec else ec, ec, cuid))
            else:
                for cuid in children_of[uu]:
                    r = ref[cuid] - 1
                    ref[cuid] = r
                    if earliest[cuid] < done:
                        earliest[cuid] = done
                        dep_binder[cuid] = uu
                    if r == 0:
                        ec = earliest[cuid]
                        pc = progress[by_uid[cuid].thread]
                        heappush(heap, (pc if pc > ec else ec, ec, cuid))

    binding_fn = (lambda: _derive_binding(by_uid, start, finish, earliest,
                                          dep_binder)) \
        if record_binding else None
    return _assemble(graph, executed, progress, start, finish, busy,
                     busy_intervals, binding_fn)


def simulate_incremental(graph: DependencyGraph, prev: SimResult,
                         dirty, schedule: Optional[ScheduleFn] = None,
                         *, max_cone_frac: float = 0.75
                         ) -> Optional[SimResult]:
    """Re-simulate only the downstream *cone* of ``dirty`` tasks.

    ``prev`` is the result of simulating ``graph`` before the durations/gaps
    of the ``dirty`` task uids were changed in place (a
    :meth:`~repro_torch.core.cluster.ClusterGraph.retune` records exactly that
    set).  Everything outside the cone — the dependency-closure of ``dirty``
    unioned with each affected lane's execution-order suffix — kept its
    start/finish times, so only the cone is replayed through the heap
    engine, seeded with the frozen boundary: per-lane progress resumes from
    the last clean task and ready times come from clean parents' previous
    completion times.  On sweeps that touch a small fraction of the graph
    this is the difference between O(cone) and O(E log V) per point.

    Returns a :class:`SimResult` **bit-identical** to a full
    :func:`simulate` replay, or ``None`` when incremental replay cannot
    guarantee that and the caller must fall back to :func:`simulate`:

    * a custom ``schedule`` is supplied (its SCHED_EPS tie window may
      reorder tasks across the frozen boundary),
    * ``prev`` does not cover this graph's task set,
    * the cone exceeds ``max_cone_frac`` of the graph (replay would not
      pay for the merge),
    * a cone task's new ready time falls *before* its previous start AND
      at-or-before the last frozen task's start on its lane — the re-tune
      could legally reorder that lane, so the frozen prefix is no longer
      trustworthy.  (Either condition alone keeps the previous order
      under the default policy: a ready time ``>=`` the previous start
      means the heap key ``(eff, ready, uid)`` only ever grew, and a
      ready time strictly after every prefix start means the prefix pops
      first regardless — heap pop times are nondecreasing.)

    An empty ``dirty`` set returns ``prev`` unchanged.
    """
    if schedule is not None:
        return None
    by_uid = graph._tasks
    dirty = {u for u in dirty if u in by_uid}
    if not dirty:
        return prev
    start_prev, finish_prev = prev.start, prev.finish
    if len(start_prev) != len(by_uid) or \
            any(u not in start_prev for u in dirty):
        return None

    # per-lane execution order: results straight off the engine (and
    # merged incremental results, which maintain the carry) expose it as
    # ``prev.lane_order`` — position indices are then built only for the
    # lanes the cone actually reaches.  Hand-built results fall back to a
    # one-pass membership scan; a scanned lane whose recorded order is
    # non-monotone in start (cone entries of an in-place-merged dict keep
    # stale insertion positions) is re-sorted by (start, uid) — starts are
    # monotone per lane and same-instant ties are zero-duration runs where
    # any order is equivalent
    prev_lanes = prev.lane_order
    members: Optional[Dict[str, List[int]]] = None
    if prev_lanes is None:
        members = collections.defaultdict(list)
        for uid in start_prev:
            members[by_uid[uid].thread].append(uid)
    lanes: Dict[str, List[int]] = {}
    pos: Dict[int, int] = {}

    def lane_of(th: str) -> List[int]:
        lane = lanes.get(th)
        if lane is None:
            if prev_lanes is not None:
                lane = prev_lanes[th]
            else:
                lane = members[th]
                last = float("-inf")
                for u in lane:
                    s = start_prev[u]
                    if s < last:
                        lane = sorted(lane,
                                      key=lambda u: (start_prev[u], u))
                        break
                    last = s
            lanes[th] = lane
            for i, u in enumerate(lane):
                pos[u] = i
        return lane

    # cone closure: dependency children + lane successors
    children_of = graph._children
    parents_of = graph._parents
    cone = set()
    stack = list(dirty)
    while stack:
        u = stack.pop()
        if u in cone:
            continue
        cone.add(u)
        lane = lane_of(by_uid[u].thread)
        i = pos[u]
        if i + 1 < len(lane) and lane[i + 1] not in cone:
            stack.append(lane[i + 1])
        for c in children_of.get(u, ()):
            if c not in cone:
                stack.append(c)
    if len(cone) > max_cone_frac * len(by_uid):
        return None

    # frozen boundary per affected lane: progress resumes from the last
    # clean task (the cone's lane slice is an execution-order suffix)
    first_cone: Dict[str, int] = {}
    for u in cone:
        th = by_uid[u].thread
        i = pos[u]
        if i < first_cone.get(th, len(lanes[th])):
            first_cone[th] = i
    # lane completion is not monotone under the (start, uid) sort inside a
    # zero-duration same-instant tie run, so boundaries are maxes, not
    # last-element reads
    progress: Dict[str, float] = {}
    bound_start: Dict[str, float] = {}
    for th, i in first_cone.items():
        p = 0.0
        if i > 0:
            lane = lanes[th]
            bs = start_prev[lane[i - 1]]    # latest frozen-prefix start
            bound_start[th] = bs
            # completion (finish + gap) is nondecreasing along execution
            # order except inside a same-instant tie run, and every task
            # before the trailing tie run completed at or before ``bs``
            # (itself <= any tie-run completion) — so the boundary max
            # only needs the tie run, not the whole prefix
            j = i - 1
            while j >= 0 and start_prev[lane[j]] == bs:
                u = lane[j]
                d = finish_prev[u] + by_uid[u].gap
                if d > p:
                    p = d
                j -= 1
        progress[th] = p

    # seed ready times from clean parents' previous completions; replay
    # releases propagate the in-cone ones
    earliest: Dict[int, float] = {}
    ref: Dict[int, int] = {}
    heap: List[Tuple[float, float, int]] = []
    for u in cone:
        e = 0.0
        r = 0
        for pu in parents_of.get(u, ()):
            if pu in cone:
                r += 1
            else:
                d = finish_prev[pu] + by_uid[pu].gap
                if d > e:
                    e = d
            # a clean task's children are all clean by closure, so every
            # parent of a cone task is either in the cone or frozen
        earliest[u] = e
        ref[u] = r
        if r == 0:
            p = progress[by_uid[u].thread]
            heap.append((p if p > e else e, e, u))
    heapq.heapify(heap)

    start = dict(start_prev)
    finish = dict(finish_prev)
    exec_seq: Dict[str, List[int]] = {th: [] for th in first_cone}
    executed = 0
    heappush, heappop = heapq.heappush, heapq.heappop
    while heap:
        eff_key, _, uid = heappop(heap)
        u = by_uid[uid]
        th = u.thread
        e = earliest[uid]
        p = progress[th]
        eff = p if p > e else e
        if eff > eff_key:                     # stale lower bound: re-key
            heappush(heap, (eff, e, uid))
            continue
        if first_cone[th] > 0 and e < start_prev[uid] \
                and e <= bound_start[th]:
            # this task became ready before its old start AND at-or-before
            # the last frozen-prefix start on its lane: a full replay
            # could slot it ahead of the frozen prefix — bail out.  Either
            # disjunct alone is safe: e >= old start keeps the previous
            # heap order (the (eff, ready, uid) key only grew), and
            # e > every prefix start means the prefix pops first anyway
            # (pop times are nondecreasing)
            return None
        start[uid] = eff
        end = eff + u.duration
        finish[uid] = end
        done = end + u.gap
        progress[th] = done
        exec_seq[th].append(uid)
        executed += 1
        for cuid in children_of.get(uid, ()):
            r = ref[cuid] - 1
            ref[cuid] = r
            if earliest[cuid] < done:
                earliest[cuid] = done
            if r == 0:
                ec = earliest[cuid]
                pc = progress[by_uid[cuid].thread]
                heappush(heap, (pc if pc > ec else ec, ec, cuid))
    if executed != len(cone):
        raise RuntimeError(
            f"incremental simulation deadlock: executed {executed}/"
            f"{len(cone)} cone task(s) (cycle?)")

    # merge: clean lanes keep their previous totals verbatim; affected
    # lanes re-fold busy/intervals in execution order (frozen prefix, then
    # replay order) so the sums are bit-identical to a full replay.  With
    # the ``prev`` carry (intervals / lane finals / lane order) the clean
    # side is O(threads) dict copies sharing prev's per-lane lists;
    # without it, a one-pass fallback over the membership scan.
    fast = (prev_lanes is not None and prev._intervals is not None
            and prev._lane_done is not None)
    if fast:
        busy = dict(prev.thread_busy)
        busy_intervals = dict(prev._intervals)
        lane_done = dict(prev._lane_done)
        res_lanes: Optional[Dict[str, List[int]]] = dict(prev_lanes)
    else:
        busy = {}
        busy_intervals = {}
        lane_done = {}
        res_lanes = None
    for th in first_cone:
        order = lanes[th][:first_cone[th]] + exec_seq[th]
        acc = 0.0
        ivs: List[Tuple[float, float]] = []
        for u in order:
            d = by_uid[u].duration
            acc += d
            if d > 0:
                ivs.append((start[u], finish[u]))
        busy[th] = acc
        busy_intervals[th] = ivs
        lane_done[th] = progress[th]
        if res_lanes is not None:
            res_lanes[th] = order
    if not fast:
        if members is None:
            members = collections.defaultdict(list)
            for uid in start_prev:
                members[by_uid[uid].thread].append(uid)
        for th, mem in members.items():
            if th in first_cone:
                continue
            busy[th] = prev.thread_busy.get(th, 0.0)
            lane_done[th] = max(finish_prev[u] + by_uid[u].gap
                                for u in mem)
            # membership order is fine: _host_device_breakdown re-sorts
            busy_intervals[th] = [(start_prev[u], finish_prev[u])
                                  for u in mem if by_uid[u].duration > 0]
    makespan = max(lane_done.values(), default=0.0)
    return SimResult(makespan=makespan, start=start, finish=finish,
                     thread_busy=busy,
                     _breakdown_fn=lambda: _host_device_breakdown(
                         busy_intervals, makespan,
                         lambda th: th == HOST_THREAD),
                     _intervals=busy_intervals, _lane_done=lane_done,
                     _lanes=res_lanes)


def simulate_reference(graph: DependencyGraph,
                       schedule: Optional[ScheduleFn] = None,
                       *, record_binding: bool = False) -> SimResult:
    """Legacy frontier-scan loop (paper Algorithm 1 verbatim) — the oracle.

    Maintains the frontier ``F`` of dependency-ready tasks and per-thread
    progress ``P``; each iteration picks ``u = schedule(F)``, sets
    ``u.start = max(P[t], u.start)`` and advances
    ``P[t] = u.start + u.duration + u.gap``, then releases children whose
    remaining-parent refcount hits zero, propagating ready times.  O(V·F) —
    kept for arbitrary (non-eff-minimal) schedules and as the equivalence
    oracle for :func:`simulate`.
    """
    sched = schedule or default_schedule
    ref: Dict[int, int] = {}
    earliest: Dict[int, float] = {}
    frontier: List[Task] = []
    for t in graph.tasks():
        ref[t.uid] = len(graph.parents(t))
        earliest[t.uid] = 0.0
        if ref[t.uid] == 0:
            frontier.append(t)

    progress: Dict[str, float] = collections.defaultdict(float)
    start: Dict[int, float] = {}
    finish: Dict[int, float] = {}
    busy: Dict[str, float] = collections.defaultdict(float)
    busy_intervals: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    executed = 0
    dep_binder: Dict[int, int] = {}

    while frontier:
        u = sched(frontier, progress, earliest)
        frontier.remove(u)
        t = u.thread
        s = max(progress[t], earliest[u.uid])
        start[u.uid] = s
        end = s + u.duration
        finish[u.uid] = end
        progress[t] = end + u.gap
        busy[t] += u.duration
        if u.duration > 0:
            busy_intervals[t].append((s, end))
        executed += 1
        done = end + u.gap
        for c in graph.children(u):
            ref[c.uid] -= 1
            if earliest[c.uid] < done:
                earliest[c.uid] = done
                if record_binding:
                    dep_binder[c.uid] = u.uid
            if ref[c.uid] == 0:
                frontier.append(c)

    binding_fn = (lambda: _derive_binding(
        {t.uid: t for t in graph.tasks()}, start, finish, earliest,
        dep_binder)) if record_binding else None
    return _assemble(graph, executed, progress, start, finish, busy,
                     busy_intervals, binding_fn)
