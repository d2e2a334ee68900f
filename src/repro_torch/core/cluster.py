"""Cluster simulation: a global dependency graph spanning N workers.

Daydream (the paper) predicts distributed training by splicing analytical
collective-cost tasks into *one* worker's graph (``what_if_distributed``).
That collapses every worker onto one timeline, so per-worker questions —
"what if worker 3 is 2x slower?", "what if half the ring crosses a pod
boundary?", "what does a mixed v5e/v4 fleet look like?" — are unanswerable.
dPRO (arXiv:2205.02473) showed the fix: build a *global* graph whose nodes
are every worker's tasks and whose cross-worker edges encode collective
synchronization, then simulate it once.

:class:`ClusterGraph` does exactly that, from either of two sources:

* :meth:`ClusterGraph.build` replicates a profiled single-worker
  :class:`~repro_torch.core.graph.DependencyGraph` across N (possibly
  heterogeneous) :class:`WorkerSpec` replicas.  Replica ``i``'s resources are
  namespaced ``w<i>/<thread>`` (:func:`~repro_torch.core.task.worker_thread`);
  non-collective durations and gaps scale by ``compute_scale`` (stragglers,
  mixed device generations).

* :meth:`ClusterGraph.from_worker_graphs` builds the same global graph from
  N *different* per-worker graphs — the asymmetric general case the
  replicate path is a special case of.  Collectives are matched across
  workers by (name, occurrence) — :func:`match_collective_groups` — and each
  matched group is wired with the same mode-selected cross-worker structure.
  :meth:`ClusterGraph.from_traces` feeds it from real per-worker profiler
  traces via :mod:`repro_torch.traceio` (Chrome trace-event JSON / native JSONL,
  dPRO-style clock alignment).

* Collectives become cross-worker structures, mode-selectable:

  - ``"ring"`` (default): each all-reduce is 2(n-1) per-worker *leg* tasks
    (reduce-scatter legs then all-gather legs); leg k of worker i depends on
    leg k-1 of ring predecessor i-1, which is what makes a straggler's delay
    propagate around the ring exactly as the analytical model predicts.  Leg
    time is (payload/n)/link_bw + hop latency; a link crossing pods uses DCN
    bandwidth, and a slow worker's ``bandwidth_scale`` throttles its links.
    With uniform workers, per-worker leg sums telescope to exactly
    ``CollectiveModel.group_time`` — the single-graph DDP prediction.

  - ``"hierarchical"`` (BlueConnect-style): intra-pod reduce-scatter, a
    cross-pod all-reduce among pod leaders over DCN, intra-pod all-gather —
    the decomposition of ``CollectiveModel.hierarchical_all_reduce``.  The
    cross-pod stage exchanges one equal shard per pod, so the pod layout
    must have equal-size pods; :meth:`build` rejects inconsistent layouts
    instead of producing a silently mis-grouped graph.

  - ``"fused"``: one synchronized task per worker keeping the analytical
    (or traced) duration (a zero-cost barrier provides the "wait for all"
    semantics).

  Point-to-point push/pull pairs (P3, parameter server) are synchronized at
  the aggregation boundary: every worker's push feeds a barrier that gates
  every worker's pull.  Pairing works on both build paths: the replicate
  path reads the shared base structure, the asymmetric trace path matches
  unnamed push/pull pairs across worker graphs by (layer, occurrence)
  (:func:`match_push_pull_groups`).

* The comm-primitive layer is *scoped*: :meth:`ClusterGraph.wire_collective_group`
  wires a matched collective over any subset of workers (``worker_ids``) —
  how hybrid pipeline x data parallelism gets its per-stage DDP rings — and
  :meth:`ClusterGraph.wire_p2p` wires a provenance-carrying point-to-point
  leg (:class:`~repro_torch.core.task.TaskKind` ``COMM``) between tasks on two
  workers, its duration derived from the same link-bandwidth model as ring
  legs (pods -> DCN, ``bandwidth_scale`` throttling) and retunable like
  them.  :mod:`repro_torch.parallel.plan` places pipeline stages with exactly
  these two primitives.

* :meth:`ClusterGraph.simulate` runs the event-driven engine
  (:func:`repro_torch.core.simulate.simulate` — the O(E log V) heap engine makes
  these N-times-larger graphs tractable) and splits the result into a
  :class:`ClusterResult` with a per-worker :class:`SimResult` breakdown.

**Symmetry folding — the equivalence-class contract.**  Replicating every
worker is O(workers); :mod:`repro_torch.core.fold` instead partitions workers
into *equivalence classes* and materializes one representative subgraph
per class, closing the collective structures algebraically over class
sizes (O(classes) tasks).  Folding is **exact** — bit-identical makespans
and per-worker timelines — precisely when every worker in a class is
guaranteed the same timeline as its representative:

* ``"ring"`` collectives fold only for a *fully uniform* group (identical
  :class:`WorkerSpec` including ``pod``): uniform legs make the
  cross-worker ring edges tie with each member's own channel
  serialization, so one representative leg chain reproduces every
  member's timeline.  A heterogeneous or multi-pod ring has
  position-dependent leg times (a DCN boundary link is slower), member
  timelines diverge, and the group *cannot* fold.
* ``"hierarchical"`` collectives fold per (pod, leader/member role) for
  any layout whose pods are internally spec-uniform — the pod-uniform
  case: stage durations depend only on pod membership, and the barrier
  structure takes maxima that are invariant under collapsing identical
  members.
* ``"fused"`` collectives and push/pull pairs fold for any per-spec
  partition (the barrier max over identical members is the max over
  representatives) — this is what makes straggler what-ifs cheap: N-1
  identical workers fold into one class, the straggler is its own class.

Anything that breaks per-class timeline identity — non-uniform specs
inside a would-be class, multi-pod rings, per-worker traces
(:meth:`ClusterGraph.from_worker_graphs` never folds), custom wiring the
fold layer does not recognize — makes :func:`repro_torch.core.fold.fold_cluster`
return ``None`` and the caller falls back to full materialization, so
folding is a pure optimization, never a semantics change.  Retunes that
preserve the partition (same members per class) stay folded; ones that
split a class (e.g. perturbing one member of a uniform ring) are rejected
by ``FoldedClusterGraph.can_retune`` and trigger a rebuild.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch.obs.spans import span as _obs_span

from .costmodel import CollectiveModel, CostModel
from .graph import DependencyGraph, GraphError
from .simulate import (ScheduleFn, SimResult, _host_device_breakdown,
                       simulate, simulate_incremental)
from .task import (Task, TaskKind, HOST_THREAD, p2p_channel,
                   split_worker_thread, worker_thread)

# Ring-decomposable collectives -> number of leg rounds as a multiple of (n-1).
_RING_ROUNDS = {"all-reduce": 2, "reduce-scatter": 1, "all-gather": 1}

_SYNC_THREAD = "cluster/sync"

# Worker-local thread carrying the trace-import start skew (a zero-duration
# task whose gap models the worker joining the step late).
_SKEW_THREAD = "trace/skew"


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One worker (chip/replica) in the cluster.

    ``compute_scale`` multiplies every non-collective duration and gap of the
    replica (2.0 == a 2x-slower straggler or an older device generation).
    ``bandwidth_scale`` scales the bandwidth of links adjacent to this worker
    (0.5 == a worker behind a congested/slow NIC).  ``pod`` groups workers
    into pods: ring links between different pods travel over DCN instead of
    ICI, and the hierarchical mode builds its two-level decomposition from it.
    """

    compute_scale: float = 1.0
    bandwidth_scale: float = 1.0
    pod: int = 0


def _as_specs(workers: Union[int, Sequence[WorkerSpec]]) -> List[WorkerSpec]:
    if isinstance(workers, int):
        if workers < 1:
            raise GraphError(f"cluster needs >= 1 worker, got {workers}")
        return [WorkerSpec() for _ in range(workers)]
    specs = list(workers)
    if not specs:
        raise GraphError("cluster needs >= 1 worker")
    return specs


def _validate_hierarchical_pods(specs: Sequence[WorkerSpec]) -> None:
    """Reject pod layouts the hierarchical decomposition cannot express.

    The cross-pod stage all-reduces one equal shard per pod (each pod's
    reduce-scatter leaves ``payload / pod_size`` on its leader), so pods of
    different sizes would exchange mismatched shards — a silently
    mis-grouped graph.  Fail loudly instead.
    """
    sizes: Dict[int, int] = collections.Counter(s.pod for s in specs)
    if len(set(sizes.values())) > 1:
        raise GraphError(
            "hierarchical collective mode needs equal-size pods (the "
            "cross-pod all-reduce exchanges one equal shard per pod); got "
            f"pod sizes {dict(sorted(sizes.items()))} — fix the WorkerSpec "
            "pod layout or use collective_mode='ring'")


def match_collective_groups(graphs: Sequence[DependencyGraph]
                            ) -> List[Tuple[str, List[Task]]]:
    """Match named collectives across per-worker graphs.

    Workers of a data-parallel job run the same program, so the k-th
    occurrence of collective name X on each worker is the same logical
    collective (dPRO matches traced collectives the same way).  Tasks count
    as collectives when ``kind == COLLECTIVE`` and ``attrs["collective"]``
    names the op.  Scans lanes in sorted-thread order so the occurrence
    index is deterministic for any graph construction order.

    Returns ``[(op, [worker0_task, worker1_task, ...]), ...]`` in worker-0
    scan order.  Raises :class:`~repro_torch.core.graph.GraphError` when any
    worker is missing a collective the others have (or has extras) — a
    mismatched trace set cannot be synchronized.
    """
    per_worker: List[Dict[Tuple[str, int], Task]] = []
    orders: List[List[Tuple[str, int]]] = []
    for wg in graphs:
        seen: Dict[str, int] = collections.defaultdict(int)
        keyed: Dict[Tuple[str, int], Task] = {}
        order: List[Tuple[str, int]] = []
        for thread in sorted(wg.lanes):
            for uid in wg.lanes[thread]:
                t = wg.get(uid)
                if t.kind == TaskKind.COLLECTIVE \
                        and t.attrs.get("collective") \
                        and t.attrs.get("coll_gid") is None:
                    # gid-carrying collectives (our own exports) belong to
                    # match_collective_gid_groups — they may legitimately
                    # exist on a worker *subset* (per-stage rings), which
                    # the every-worker consistency check below would
                    # misread as a corrupt trace set
                    key = (t.name, seen[t.name])
                    seen[t.name] += 1
                    keyed[key] = t
                    order.append(key)
        per_worker.append(keyed)
        orders.append(order)
    union = set().union(*(set(k) for k in per_worker)) if per_worker else set()
    for i, keyed in enumerate(per_worker):
        missing = union - set(keyed)
        if missing:
            names = sorted(f"{n}#{k}" for n, k in missing)[:5]
            raise GraphError(
                f"worker {i} trace is missing collective(s) present on "
                f"other workers: {', '.join(names)}"
                f"{' ...' if len(missing) > 5 else ''} — cannot match "
                f"collectives across an inconsistent trace set")
    groups: List[Tuple[str, List[Task]]] = []
    for key in orders[0]:
        members = [keyed[key] for keyed in per_worker]
        ops = {m.attrs["collective"] for m in members}
        if len(ops) > 1:
            raise GraphError(
                f"collective {key[0]!r}#{key[1]} has conflicting ops across "
                f"workers: {sorted(ops)}")
        groups.append((ops.pop(), members))
    return groups


def match_collective_gid_groups(graphs: Sequence[DependencyGraph]
                                ) -> List[Tuple[str, Tuple[int, ...],
                                                List[Task]]]:
    """Match exported collectives across per-worker graphs by ``coll_gid``.

    Traces this repo exports stamp every collapsed collective with the
    graph-unique gid of the structure it came from, which identifies the
    logical collective *exactly* — including collectives that exist only
    on a worker subset (hybrid PP x DP per-stage gradient rings), which
    (name, occurrence) matching cannot express because it requires every
    worker to carry every key.  Returns ``(op, worker_ids, members)`` per
    gid shared by >= 2 workers, ordered by gid (the original build's
    wiring order); single-worker gids stay local (a truncated set degrades
    instead of crashing).  Foreign captures carry no gids and fall through
    to :func:`match_collective_groups` untouched.
    """
    by_gid: Dict[int, List[Tuple[int, Task]]] = {}
    for w, wg in enumerate(graphs):
        for thread in sorted(wg.lanes):
            for uid in wg.lanes[thread]:
                t = wg.get(uid)
                if t.kind == TaskKind.COLLECTIVE \
                        and t.attrs.get("collective") \
                        and t.attrs.get("coll_gid") is not None:
                    by_gid.setdefault(int(t.attrs["coll_gid"]),
                                      []).append((w, t))
    groups: List[Tuple[str, Tuple[int, ...], List[Task]]] = []
    for gid in sorted(by_gid):
        group = by_gid[gid]
        if len(group) < 2:
            continue
        ids = tuple(w for w, _ in group)
        if len(set(ids)) != len(ids):
            raise GraphError(
                f"collective gid {gid} appears more than once in one "
                f"worker's trace — corrupt or re-stamped trace set")
        ops = {t.attrs["collective"] for _, t in group}
        if len(ops) > 1:
            raise GraphError(
                f"collective gid {gid} has conflicting ops across "
                f"workers: {sorted(ops)}")
        groups.append((ops.pop(), ids, [t for _, t in group]))
    return groups


def _is_unnamed_collective(t: Task) -> bool:
    return t.kind == TaskKind.COLLECTIVE and not t.attrs.get("collective")


def match_push_pull_groups(graphs: Sequence[DependencyGraph]
                           ) -> List[List[Tuple[Task, List[Task]]]]:
    """Match P3/parameter-server push->pull pairs across per-worker graphs.

    A *push* is an unnamed point-to-point collective (``kind == COLLECTIVE``
    with no ``attrs["collective"]`` group op) that has at least one
    unnamed-collective child — its *pulls*.  Workers of a data-parallel job
    run the same program, so the k-th push of a layer on each worker is the
    same logical slice transfer: pushes are keyed by (layer, occurrence) in
    sorted-lane scan order, the same discipline
    :func:`match_collective_groups` uses for named collectives.  This is
    what extends parameter-server synchronization to the asymmetric
    trace-import path (:meth:`ClusterGraph.from_worker_graphs`), which used
    to leave imported push/pull pairs unsynchronized.

    Returns one group per matched key, in worker-0 scan order:
    ``groups[k][w] == (push, pulls)`` for worker w.  Raises
    :class:`~repro_torch.core.graph.GraphError` when any worker is missing a pair
    the others have — an inconsistent trace set cannot be synchronized.
    """
    per_worker: List[Dict[Tuple[Optional[str], int],
                          Tuple[Task, List[Task]]]] = []
    orders: List[List[Tuple[Optional[str], int]]] = []
    for wg in graphs:
        seen: Dict[Optional[str], int] = collections.defaultdict(int)
        keyed: Dict[Tuple[Optional[str], int], Tuple[Task, List[Task]]] = {}
        order: List[Tuple[Optional[str], int]] = []
        for thread in sorted(wg.lanes):
            for uid in wg.lanes[thread]:
                t = wg.get(uid)
                if not _is_unnamed_collective(t):
                    continue
                pulls = [v for v in wg.children(t)
                         if _is_unnamed_collective(v)]
                if not pulls:
                    continue
                key = (t.layer, seen[t.layer])
                seen[t.layer] += 1
                keyed[key] = (t, pulls)
                order.append(key)
        per_worker.append(keyed)
        orders.append(order)
    union = set().union(*(set(k) for k in per_worker)) if per_worker else set()
    for i, keyed in enumerate(per_worker):
        missing = union - set(keyed)
        if missing:
            names = sorted(f"{l or '?'}#{k}" for l, k in missing)[:5]
            raise GraphError(
                f"worker {i} is missing push/pull pair(s) present on other "
                f"workers: {', '.join(names)}"
                f"{' ...' if len(missing) > 5 else ''} — cannot pair "
                f"parameter-server transfers across an inconsistent set")
    return [[keyed[key] for keyed in per_worker] for key in orders[0]]


def max_imported_gid(graphs: Sequence[DependencyGraph]) -> int:
    """Largest collective/p2p gid any imported task still carries.

    Re-imported tasks keep exported ``coll_gid`` / ``p2p_gid`` /
    ``p2p_in`` attrs (fused-mode members and unmatched hop legs keep them
    verbatim through wiring), while a fresh :class:`ClusterGraph` hands
    out gids from 1 — so a rebuild over imported graphs must seed its
    counter above this value or a fresh gid can collide with a stale one
    and the next export cycle collapses/wires the wrong tasks together.
    """
    m = 0
    for wg in graphs:
        for t in wg.tasks():
            for g in (t.attrs.get("coll_gid"), t.attrs.get("p2p_gid")):
                if isinstance(g, (int, float)):
                    m = max(m, int(g))
            for g in t.attrs.get("p2p_in", ()):
                m = max(m, int(g))
    return m


def match_wired_p2p(graphs: Sequence[DependencyGraph]
                    ) -> List[Tuple[int, int, Task, int, Task]]:
    """Match exported point-to-point hops across per-worker graphs.

    A hop wired by :meth:`ClusterGraph.wire_p2p` exports with
    ``attrs["p2p_gid"]`` on the sender-side leg and the same gid in the
    receiver task's ``attrs["p2p_in"]`` — provenance that survives the
    per-worker Chrome/JSONL round trip even though the cross-worker edge
    itself is dropped at export.  Returns ``(gid, src_worker, leg_task,
    dst_worker, recv_task)`` per matched hop, ordered by gid (the wiring
    order of the original build, so re-wiring is deterministic).  Hops
    whose other side is absent (foreign or truncated traces) are skipped —
    they stay plain worker-local timeline events, the pre-provenance
    behavior.
    """
    legs: Dict[int, Tuple[int, Task]] = {}
    recvs: Dict[int, Tuple[int, Task]] = {}
    for w, wg in enumerate(graphs):
        for thread in sorted(wg.lanes):
            for uid in wg.lanes[thread]:
                t = wg.get(uid)
                gid = t.attrs.get("p2p_gid")
                if gid is not None and t.kind == TaskKind.COMM:
                    if int(gid) in legs:
                        raise GraphError(
                            f"p2p gid {gid} appears on more than one hop "
                            f"leg across the trace set — corrupt or "
                            f"re-stamped traces cannot be re-wired")
                    legs[int(gid)] = (w, t)
                for g in t.attrs.get("p2p_in", ()):
                    if int(g) in recvs:
                        raise GraphError(
                            f"p2p gid {g} is claimed by more than one "
                            f"receiver across the trace set — corrupt or "
                            f"re-stamped traces cannot be re-wired")
                    recvs[int(g)] = (w, t)
    out: List[Tuple[int, int, Task, int, Task]] = []
    for gid in sorted(set(legs) & set(recvs)):
        (sw, leg), (dw, recv) = legs[gid], recvs[gid]
        if sw != dw:
            out.append((gid, sw, leg, dw, recv))
    return out


@dataclasses.dataclass
class ClusterResult:
    """Global simulation outcome plus the per-worker breakdown.

    ``per_worker`` is computed lazily on first access: a sweep that only
    reads global makespans (``Scenario.sweep`` points) never pays for
    projecting the global result onto every worker's local resources.
    """

    makespan: float
    global_result: SimResult
    workers: List[WorkerSpec]
    _per_worker: Optional[Dict[int, SimResult]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _split_fn: Optional[Callable[[], Dict[int, SimResult]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    # uid -> (duration, gap) as of this result — lets a chained
    # simulate_incremental() refresh its own snapshot with just the dirty
    # deltas instead of an O(V) pass over the graph's tasks
    _snap: Optional[Dict[int, Tuple[float, float]]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def per_worker(self) -> Dict[int, SimResult]:
        if self._per_worker is None:
            self._per_worker = self._split_fn() if self._split_fn else {}
        return self._per_worker

    def speedup_over(self, other: "ClusterResult") -> float:
        return (other.makespan / self.makespan
                if self.makespan > 0 else float("inf"))

    def straggler(self) -> int:
        """Worker index with the largest local makespan."""
        return max(self.per_worker, key=lambda i: self.per_worker[i].makespan)

    def worker_makespans(self) -> List[float]:
        return [self.per_worker[i].makespan for i in sorted(self.per_worker)]


class ClusterGraph:
    """A global N-worker dependency graph built from per-worker profiles."""

    def __init__(self, graph: DependencyGraph, workers: List[WorkerSpec],
                 cost: CostModel, schedule: Optional[ScheduleFn] = None,
                 collective_mode: str = "ring") -> None:
        self.graph = graph
        self.workers = workers
        self.cost = cost
        self.schedule = schedule
        self.collective_mode = collective_mode
        # provenance records for :meth:`retune` — (kind, task, *base values);
        # tasks later detached from the graph are skipped.
        self._prov: List[Tuple] = []
        self._tasks_by_worker: Optional[Dict[int, List[Task]]] = None
        # monotone id shared by all pieces (legs/stages) of one wired
        # collective (attrs["coll_gid"]) — the trace exporter collapses
        # pieces back into one per-worker collective event by this id.
        self._gid = 0
        # uids whose duration/gap the most recent retune() actually changed
        # — the dirty set simulate_incremental() replays.
        self.last_retune_dirty: set = set()

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, base: DependencyGraph,
              workers: Union[int, Sequence[WorkerSpec]],
              *, cost: Optional[CostModel] = None,
              collective_mode: str = "ring",
              schedule: Optional[ScheduleFn] = None) -> "ClusterGraph":
        """Replicate ``base`` across ``workers`` and link the collectives.

        ``base`` is a single-worker graph whose collective tasks (typically
        inserted by :func:`repro_torch.core.whatif.what_if_distributed` /
        ``what_if_zero``) carry ``attrs["collective"]``; each such task is
        replaced, per replica, by the cross-worker structure selected by
        ``collective_mode`` ("ring" | "hierarchical" | "fused").  This is
        the symmetric special case of :meth:`from_worker_graphs` — every
        worker runs the same profile.
        """
        specs = _as_specs(workers)
        cls._check_mode(collective_mode, specs)
        cost = cost or CostModel()
        n = len(specs)
        with _obs_span("cluster.build", workers=n, base_tasks=len(base),
                       mode=collective_mode):
            g = DependencyGraph()
            cg = cls(g, specs, cost, schedule, collective_mode)

            # 1. replicate: clone every task per worker, scale compute
            #    durations.
            replicas = [cg._clone_worker(i, spec, base)
                        for i, spec in enumerate(specs)]
            if n > 1:
                # 2. wire each base collective's replica group cross-worker.
                for c in base.tasks():
                    if c.kind == TaskKind.COLLECTIVE \
                            and c.attrs.get("collective"):
                        members = [remap[c.uid] for remap in replicas]
                        cg._wire_group(c.attrs["collective"], members,
                                       collective_mode)
                cg._sync_push_pull(
                    [[(remap[push.uid], [remap[v.uid] for v in pulls])
                      for remap in replicas]
                     for ((push, pulls),) in match_push_pull_groups([base])])
            return cg._finish()

    @classmethod
    def from_worker_graphs(cls, graphs: Sequence[DependencyGraph],
                           workers: Optional[Union[int, Sequence[WorkerSpec]]]
                           = None,
                           *, cost: Optional[CostModel] = None,
                           collective_mode: str = "ring",
                           schedule: Optional[ScheduleFn] = None,
                           start_skews: Optional[Sequence[float]] = None
                           ) -> "ClusterGraph":
        """Build an asymmetric global graph from N *different* worker graphs.

        This is the trace-import path (dPRO §4, Daydream §4.1 applied per
        worker): each graph comes from one worker's own profile, so
        durations, gaps, and even task sets may differ.  Collectives are
        matched across workers by (name, occurrence)
        (:func:`match_collective_groups`) and wired with the mode-selected
        cross-worker structure; P3-style unnamed push/pull pairs are
        matched by (layer, occurrence) (:func:`match_push_pull_groups`) and
        synchronized at the aggregation barrier; everything else stays
        worker-local.

        ``workers`` defaults to uniform specs (the traces already encode
        each worker's real speed); pass explicit :class:`WorkerSpec` lists
        to layer what-if scaling *on top of* the traced durations.
        ``start_skews`` (seconds per worker, from clock alignment) models
        workers that started the step late: a zero-duration task with that
        gap gates each worker's roots.

        With N references to one identical graph this reduces to
        :meth:`build` (minus push/pull pairing) — the property tests hold
        the two paths equal to float precision.
        """
        graphs = list(graphs)
        if not graphs:
            raise GraphError("from_worker_graphs needs >= 1 worker graph")
        specs = [WorkerSpec() for _ in graphs] if workers is None \
            else _as_specs(workers)
        if len(specs) != len(graphs):
            raise GraphError(
                f"{len(graphs)} worker graph(s) but {len(specs)} worker "
                f"spec(s); they must pair up 1:1")
        cls._check_mode(collective_mode, specs)
        cost = cost or CostModel()
        with _obs_span("cluster.from_worker_graphs", workers=len(graphs),
                       tasks=sum(len(wg) for wg in graphs),
                       mode=collective_mode):
            return cls._from_worker_graphs(graphs, specs, cost,
                                           collective_mode, schedule,
                                           start_skews)

    @classmethod
    def _from_worker_graphs(cls, graphs: List[DependencyGraph],
                            specs: List[WorkerSpec], cost: CostModel,
                            collective_mode: str,
                            schedule: Optional[ScheduleFn],
                            start_skews: Optional[Sequence[float]]
                            ) -> "ClusterGraph":
        g = DependencyGraph()
        cg = cls(g, specs, cost, schedule, collective_mode)
        # fresh gids must not collide with gids the traces carried in
        cg._gid = max_imported_gid(graphs)
        remaps = [cg._clone_worker(i, spec, wg)
                  for i, (wg, spec) in enumerate(zip(graphs, specs))]
        if start_skews:
            for i, skew in enumerate(start_skews):
                if skew > 0:
                    cg._add_start_skew(i, skew, remaps[i], graphs[i])
        if len(graphs) > 1:
            # exported collectives match exactly by gid (subset-scoped:
            # hybrid PP x DP per-stage rings re-wire over just their
            # stage's workers); gid-less ones by (name, occurrence)
            for op, ids, members in match_collective_gid_groups(graphs):
                cg.wire_collective_group(
                    op, [remaps[w][m.uid] for w, m in zip(ids, members)],
                    worker_ids=ids)
            for op, members in match_collective_groups(graphs):
                cg._wire_group(op, [remaps[i][m.uid]
                                    for i, m in enumerate(members)],
                               collective_mode)
            cg._sync_push_pull(
                [[(remaps[w][push.uid], [remaps[w][v.uid] for v in pulls])
                  for w, (push, pulls) in enumerate(group)]
                 for group in match_push_pull_groups(graphs)])
            # point-to-point hops (pipeline stage boundaries) re-wire from
            # their exported provenance: the leg keeps its traced lane and
            # regains both its cross-worker edge and its link-derived
            # duration/retune record
            for _, sw, leg, dw, recv in match_wired_p2p(graphs):
                cg.wire_p2p(None, remaps[dw][recv.uid], sw, dw,
                            leg=remaps[sw][leg.uid])
        return cg._finish()

    @classmethod
    def from_traces(cls, traces: Any,
                    workers: Optional[Union[int, Sequence[WorkerSpec]]] = None,
                    *, cost: Optional[CostModel] = None,
                    collective_mode: str = "ring",
                    schedule: Optional[ScheduleFn] = None,
                    align: bool = True) -> "ClusterGraph":
        """Import per-worker profiler traces into one global cluster graph.

        ``traces`` is a trace directory (one Chrome trace-event JSON or
        native JSONL file per worker — see :mod:`repro_torch.traceio` for the
        format contract) or an already-loaded
        :class:`repro_torch.traceio.ImportedCluster`.  Traces are clock-aligned
        (dPRO-style: least-squares offset+drift per worker anchored on
        matched collective ends) unless ``align=False``, then routed through
        :meth:`from_worker_graphs`.
        """
        from repro_torch.traceio import ImportedCluster, load_trace_dir
        imp = traces if isinstance(traces, ImportedCluster) \
            else load_trace_dir(str(traces), align=align)
        return cls.from_worker_graphs(
            imp.graphs, workers, cost=cost, collective_mode=collective_mode,
            schedule=schedule, start_skews=imp.start_skews)

    # ----------------------------------------------------------- build pieces
    @staticmethod
    def _check_mode(mode: str, specs: Sequence[WorkerSpec]) -> None:
        if mode not in ("ring", "hierarchical", "fused"):
            raise GraphError(f"unknown collective_mode {mode!r}")
        if mode == "hierarchical":
            _validate_hierarchical_pods(specs)

    def _clone_worker(self, i: int, spec: WorkerSpec,
                      src: DependencyGraph, *,
                      comm_prov: bool = True) -> Dict[int, Task]:
        """Clone ``src`` into the global graph as worker ``i``'s subgraph.

        ``comm_prov=False`` leaves :data:`TaskKind.COMM` tasks without a
        provenance record (and unscaled): the caller is about to wire them
        as point-to-point legs (:meth:`wire_p2p`), which derives their
        duration from the actual placed link and records p2p provenance
        itself.  The default treats a traced COMM task like a traced
        collective — its duration throttles with the worker's
        ``bandwidth_scale``.
        """
        g = self.graph
        remap: Dict[int, Task] = {}
        for thread, lane in src.lanes.items():
            for uid in lane:
                t = src.get(uid)
                nt = t.clone()
                nt.thread = worker_thread(i, t.thread)
                if t.kind == TaskKind.COLLECTIVE or (
                        t.kind == TaskKind.COMM and comm_prov):
                    nt.duration = t.duration / max(spec.bandwidth_scale,
                                                   1e-12)
                    self._prov.append(("coll", nt, i, t.duration))
                elif t.kind != TaskKind.COMM:
                    # per-kind calibration scale on the duration only: gaps
                    # are untraced host time, not modeled task cost
                    nt.duration = t.duration * spec.compute_scale \
                        * self.cost.kind_scale(t.kind)
                    nt.gap = t.gap * spec.compute_scale
                    self._prov.append(("compute", nt, i, t.duration, t.gap))
                g.add_task(nt, link_lane=False)
                remap[uid] = nt
        for t in src.tasks():
            for c in src.children(t):
                g.add_edge(remap[t.uid], remap[c.uid])
        return remap

    def _add_start_skew(self, i: int, skew: float, remap: Dict[int, Task],
                        src: DependencyGraph) -> None:
        """Gate worker ``i``'s roots behind its trace-aligned start skew."""
        sk = self.graph.add_task(
            Task(name=f"w{i}:start-skew", kind=TaskKind.SYNC,
                 thread=worker_thread(i, _SKEW_THREAD), duration=0.0,
                 gap=skew, phase="comm"), link_lane=False)
        for t in src.tasks():
            if not src.parents(t):
                self.graph.add_edge(sk, remap[t.uid])

    def _finish(self) -> "ClusterGraph":
        self.graph.validate()
        # collective wiring detached some replica tasks: prune their records
        # once so retune() does no per-call membership checks
        self._prov = [r for r in self._prov if r[1] in self.graph]
        return self

    # ------------------------------------------------------- collective wiring
    def _link_bandwidth(self, i: int, j: int) -> float:
        """Bandwidth of the ring link worker i -> worker j."""
        wi, wj = self.workers[i], self.workers[j]
        bw = self.cost.link_bandwidth(
            "dcn" if wi.pod != wj.pod else "ici")
        # floor like every other scale use: a 0.0 scale (dead NIC) models as
        # an astronomically slow link rather than a ZeroDivisionError
        return bw * max(min(wi.bandwidth_scale, wj.bandwidth_scale), 1e-12)

    def _leg_duration(self, ids: Tuple[int, ...], pos: int,
                      payload: float) -> float:
        """One ring-leg's time for the member at ``pos`` of the ring over
        workers ``ids`` — shared by build and retune so a retuned sweep
        point is bit-identical to a fresh build.  ``ids`` is the full
        worker list for a global collective, or a subset (e.g. one pipeline
        stage's data-parallel replicas)."""
        k = len(ids)
        return ((payload / k)
                / self._link_bandwidth(ids[pos], ids[(pos + 1) % k])
                + self.cost.collectives.hop_latency)

    def _p2p_duration(self, i: int, j: int, payload: float) -> float:
        """One point-to-point hop worker i -> worker j (build == retune)."""
        return self.cost.collectives.p2p_time(payload,
                                              self._link_bandwidth(i, j))

    def _detach(self, task: Task) -> Tuple[List[Task], List[Task]]:
        """Remove ``task`` keeping (parents, children) for re-wiring."""
        parents = self.graph.parents(task)
        children = self.graph.children(task)
        self.graph.remove_task(task, bridge=False)
        return parents, children

    def _barrier(self, name: str) -> Task:
        return self.graph.add_task(
            Task(name=name, kind=TaskKind.SYNC, thread=_SYNC_THREAD,
                 duration=0.0, phase="comm"), link_lane=False)

    @staticmethod
    def _group_payload(members: Sequence[Task]) -> float:
        return max(max(m.comm_bytes for m in members), 0.0)

    def wire_collective_group(self, op: str, members: List[Task],
                              worker_ids: Optional[Sequence[int]] = None,
                              mode: Optional[str] = None) -> None:
        """Wire one matched collective over a (sub)group of workers.

        ``members[k]`` is the collective task of worker ``worker_ids[k]``
        (default: the full worker list in order — the classic data-parallel
        group).  Scoped groups are what hybrid parallelism is made of: a
        pipeline stage's DDP ring is a collective over just that stage's
        replicas, wired with exactly the same mode-selected structure as a
        global all-reduce.
        """
        ids = tuple(worker_ids) if worker_ids is not None \
            else tuple(range(len(self.workers)))
        if len(ids) != len(members):
            raise GraphError(
                f"collective group has {len(members)} member task(s) but "
                f"{len(ids)} worker id(s)")
        mode = mode or self.collective_mode
        self._gid += 1
        if mode == "hierarchical" and op == "all-reduce":
            # BlueConnect decomposition is an all-reduce rewrite; a bare
            # reduce-scatter / all-gather is already single-stage and
            # keeps its ring legs
            self._hierarchical_decompose(members, ids)
        elif mode in ("ring", "hierarchical") and op in _RING_ROUNDS:
            self._ring_decompose(op, members, ids)
        else:
            self._fused_sync(members)

    def _wire_group(self, op: str, members: List[Task], mode: str) -> None:
        """Wire one matched full-group collective (``members[i]`` = worker
        i's task) — the unscoped form used by the build paths."""
        self.wire_collective_group(op, members, mode=mode)

    def wire_p2p(self, src: Task, dst: Task, src_worker: int,
                 dst_worker: int, *, payload: Optional[float] = None,
                 leg: Optional[Task] = None, name: str = "p2p") -> Task:
        """Wire a point-to-point leg: ``src`` (on ``src_worker``) sends
        ``payload`` bytes to ``dst`` (on ``dst_worker``).

        The leg is a :data:`TaskKind.COMM` task on the sender's per-link
        channel (:func:`~repro_torch.core.task.p2p_channel` — consecutive sends
        over one link serialize, exactly like ring legs on an ICI link);
        its duration comes from :meth:`_link_bandwidth` (pods -> DCN,
        ``bandwidth_scale`` throttling) plus the per-hop latency, and is
        recorded in provenance so :meth:`retune` recomputes it like a ring
        leg.  Pass ``leg`` to adopt an existing COMM task (e.g. a pipeline
        stage template's hop, cloned by :meth:`_clone_worker` with
        ``comm_prov=False``) instead of creating one; ``payload`` defaults
        to the adopted leg's ``comm_bytes``.

        Every wired hop gets round-trippable provenance: ``attrs["p2p"]``
        (src/dst worker) plus a graph-unique ``attrs["p2p_gid"]`` on the
        leg, mirrored in the receiver's ``attrs["p2p_in"]`` list.  Both
        sides survive the per-worker trace export, which is what lets
        :meth:`from_worker_graphs` re-wire imported hops
        (:func:`match_wired_p2p`) and :mod:`repro_torch.analysis.diff` match them
        task-by-task — previously hops exported as plain timeline events
        and cross-stage coupling was lost on re-import.
        """
        i, j = src_worker, dst_worker
        if payload is None:
            payload = leg.comm_bytes if leg is not None else 0.0
        if leg is None:
            if src is None:
                raise GraphError(
                    "wire_p2p needs a src task (to create a leg) or an "
                    "existing leg task to adopt")
            leg = self.graph.add_task(
                Task(name=f"{name}:w{i}>w{j}", kind=TaskKind.COMM,
                     thread=worker_thread(i, p2p_channel(j)), duration=0.0,
                     comm_bytes=payload, phase="comm"), link_lane=False)
            self.graph.add_edge(src, leg)
        self._gid += 1
        # rebind (never mutate) the receiver's gid list: clone() copies
        # attrs dicts shallowly, so in-place list edits would leak into the
        # source graph a trace scenario re-evaluates from.  Re-wiring an
        # imported hop retires the stale imported gid, so repeated
        # export -> import cycles do not grow the list.
        ins = [g for g in dst.attrs.get("p2p_in", ())
               if g != leg.attrs.get("p2p_gid")]
        leg.attrs["p2p"] = (i, j)
        leg.attrs["p2p_gid"] = self._gid
        dst.attrs["p2p_in"] = ins + [self._gid]
        leg.duration = self._p2p_duration(i, j, payload)
        self._prov.append(("p2p", leg, i, j, payload))
        self.graph.add_edge(leg, dst)
        return leg

    def _ring_decompose(self, op: str, members: List[Task],
                        ids: Tuple[int, ...]) -> None:
        """Per-member ring legs with cross-worker pipeline edges.

        Leg round k of the member at position p waits on round k-1 of ring
        predecessor p-1 (the chunk it is about to forward) and on its own
        round k-1 (channel serialization).  Per-worker totals telescope to
        ``group_time`` for uniform workers.  ``ids[p]`` is the global
        worker index of member p — the ring spans exactly those workers.
        """
        n = len(members)
        rounds = _RING_ROUNDS[op] * (n - 1)
        payload = self._group_payload(members)
        legs: List[List[Task]] = []
        for pos, rc in enumerate(members):
            parents, children = self._detach(rc)
            leg_dur = self._leg_duration(ids, pos, payload)
            worker_legs: List[Task] = []
            prev: Optional[Task] = None
            for k in range(rounds):
                leg = rc.clone()
                leg.name = f"{rc.name}:leg{k}"
                leg.duration = leg_dur
                leg.comm_bytes = payload / n
                leg.attrs = dict(rc.attrs, ring_round=k, coll_gid=self._gid)
                self._prov.append(("ring", leg, ids, pos, payload))
                self.graph.add_task(leg, link_lane=False)
                for p in (parents if prev is None else [prev]):
                    self.graph.add_edge(p, leg)
                prev = leg
                worker_legs.append(leg)
            for ch in children:
                self.graph.add_edge(prev, ch)
            legs.append(worker_legs)
        for i in range(n):
            for k in range(1, rounds):
                self.graph.add_edge(legs[(i - 1) % n][k - 1], legs[i][k])

    def _hierarchical_decompose(self, members: List[Task],
                                ids: Tuple[int, ...]) -> None:
        """BlueConnect-style: pod-local reduce-scatter, cross-pod all-reduce
        among pod leaders over DCN, pod-local all-gather.

        The cross-pod stage is itself a collective among leaders, so it is
        gated on *every* pod's reduce-scatter finishing; the all-gather stage
        is gated on every leader's cross-pod leg.  Total per-worker time for
        uniform pods equals ``CollectiveModel.hierarchical_all_reduce``.
        Scoped groups (``ids`` a subset) build the pod structure from the
        group's workers only.
        """
        coll = self.cost.collectives
        payload = self._group_payload(members)
        cname = members[0].name
        pods: Dict[int, List[int]] = collections.defaultdict(list)
        member_pos = {w: pos for pos, w in enumerate(ids)}
        for w in ids:
            pods[self.workers[w].pod].append(w)
        _validate_hierarchical_pods([self.workers[w] for w in ids])
        pod_ids = sorted(pods)
        num_pods = len(pod_ids)

        bounds = {w: self._detach(members[member_pos[w]]) for w in ids}

        proto = {w: members[member_pos[w]] for w in ids}
        leaders_bar = self._barrier(f"{cname}:leaders-barrier")
        for p in pod_ids:
            pod_members = tuple(pods[p])
            m = len(pod_members)
            scale = min(self.workers[i].bandwidth_scale for i in pod_members)
            rs_dur = coll.axis_time("reduce-scatter", payload, m, "ici")
            rs_dur /= max(scale, 1e-12)
            bar = self._barrier(f"{cname}:pod{p}:rs-barrier")
            rs_tasks = []
            for i in pod_members:
                parents, _ = bounds[i]
                for par in parents:
                    self.graph.add_edge(par, bar)
                rs = self._add_comm(i, proto[i], f"pod{p}:reduce-scatter",
                                    rs_dur, payload)
                self._prov.append(("hrs", rs, pod_members, payload))
                self.graph.add_edge(bar, rs)
                rs_tasks.append(rs)
            for rs in rs_tasks:
                self.graph.add_edge(rs, leaders_bar)

        if num_pods > 1:
            gather_bar = self._barrier(f"{cname}:gather-barrier")
            for p in pod_ids:
                pod_members = pods[p]
                leader = pod_members[0]
                shard = payload / max(len(pod_members), 1)
                cross_dur = coll.axis_time("all-reduce", shard, num_pods,
                                           "dcn")
                cross_dur /= max(self.workers[leader].bandwidth_scale, 1e-12)
                cross = self._add_comm(leader, proto[leader],
                                       f"pod{p}:cross-all-reduce",
                                       cross_dur, shard)
                self._prov.append(("hcross", cross, leader, shard, num_pods))
                self.graph.add_edge(leaders_bar, cross)
                self.graph.add_edge(cross, gather_bar)
            gate = gather_bar
        else:
            gate = leaders_bar
        for p in pod_ids:
            self._pod_all_gather(proto, coll, payload, p, pods[p], gate,
                                 bounds)

    def _pod_all_gather(self, proto: Dict[int, Task], coll: CollectiveModel,
                        payload: float, p: int, pod_members: List[int],
                        gate: Task, bounds) -> None:
        m = len(pod_members)
        scale = min(self.workers[i].bandwidth_scale for i in pod_members)
        ag_dur = coll.axis_time("all-gather", payload, m, "ici")
        ag_dur /= max(scale, 1e-12)
        for i in pod_members:
            ag = self._add_comm(i, proto[i], f"pod{p}:all-gather", ag_dur,
                                payload)
            self._prov.append(("hag", ag, tuple(pod_members), payload))
            self.graph.add_edge(gate, ag)
            _, children = bounds[i]
            for ch in children:
                self.graph.add_edge(ag, ch)

    def _add_comm(self, i: int, proto: Task, label: str, dur: float,
                  nbytes: float) -> Task:
        t = Task(name=f"{proto.name}:{label}", kind=TaskKind.COLLECTIVE,
                 thread=worker_thread(i, split_worker_thread(proto.thread)[1]),
                 duration=dur, comm_bytes=nbytes, phase="comm",
                 attrs=dict(proto.attrs, stage=label, coll_gid=self._gid))
        return self.graph.add_task(t, link_lane=False)

    def _fused_sync(self, members: List[Task]) -> None:
        """Keep one analytical/traced-duration task per worker, gated by a
        barrier so no worker's collective starts before every worker is
        ready.  Members are stamped with the group's ``coll_gid`` so the
        exporter/importer identify the group exactly, like ring legs and
        hierarchical stages."""
        bar = self._barrier(f"{members[0].name}:barrier")
        for rc in members:
            rc.attrs["coll_gid"] = self._gid
            for p in self.graph.parents(rc):
                self.graph.add_edge(p, bar)
            self.graph.add_edge(bar, rc)

    def _sync_push_pull(self, groups: List[List[Tuple[Task, List[Task]]]]
                        ) -> None:
        """Parameter-server semantics for P3-style push/pull pairs.

        ``groups[k][w]`` is worker w's ``(push, pulls)`` for the k-th
        matched pair, already remapped into the global graph.  A pull
        returns the *aggregated* value, so every worker's pull of a slice
        waits (via one barrier per matched push) for every worker's push of
        that slice.  Pushes themselves stay local — that preserves P3's
        overlap of early pushes with the tail of backprop.
        """
        for group in groups:
            bar = self._barrier(f"{group[0][0].name}:aggregate")
            for push, pulls in group:
                self.graph.add_edge(push, bar)
                for v in pulls:
                    self.graph.add_edge(bar, v)

    # --------------------------------------------------------------- retune
    @property
    def retunable(self) -> bool:
        """Whether :meth:`retune` can re-parameterize this build in place.

        Every collective mode records enough provenance for a duration-only
        retune (ring legs and fused durations always; hierarchical stage
        durations are recomputable from the recorded pod membership).  A
        *pod-layout* change is still structural for hierarchical graphs —
        use :meth:`can_retune` to check a concrete target spec.
        """
        return True

    def can_retune(self, workers: Union[int, Sequence[WorkerSpec]]) -> bool:
        """True when :meth:`retune` accepts ``workers`` for this build:
        same worker count, and (hierarchical mode) the same pod layout."""
        try:
            specs = _as_specs(workers)
        except GraphError:
            return False
        if len(specs) != len(self.workers):
            return False
        if self.collective_mode == "hierarchical":
            return [s.pod for s in specs] == [w.pod for w in self.workers]
        return True

    def retune(self, workers: Union[int, Sequence[WorkerSpec]]
               ) -> "ClusterGraph":
        """Re-parameterize this build for new same-length worker specs.

        Recomputes every scaled duration (compute/gap by ``compute_scale``,
        replica collectives by ``bandwidth_scale``, ring legs from the link
        bandwidths, hierarchical stage durations from the recorded pod
        membership) from the recorded base values — the same expressions
        :meth:`build` used, so the result is bit-identical to a fresh build
        with ``workers``.  This is what lets :meth:`Scenario.sweep
        <repro_torch.core.optimize.Scenario.sweep>` evaluate bandwidth/straggler
        grids without re-replicating and re-wiring the global graph per
        point.  Hierarchical graphs additionally require the pod layout to
        stay fixed (stage *structure* depends on it); changing pods raises.
        """
        specs = _as_specs(workers)
        if len(specs) != len(self.workers):
            raise GraphError(
                f"retune needs the same worker count (have "
                f"{len(self.workers)}, got {len(specs)}); rebuild instead")
        if self.collective_mode == "hierarchical" and \
                [s.pod for s in specs] != [w.pod for w in self.workers]:
            raise GraphError(
                "changing the pod layout is structural for hierarchical "
                "cluster graphs (stage membership depends on it); rebuild "
                "instead")
        self.workers = specs
        coll = self.cost.collectives
        with _obs_span("cluster.retune", workers=len(specs),
                       records=len(self._prov)) as sp:
            self.last_retune_dirty = self._retune_records(specs, coll)
            sp.note(dirty=len(self.last_retune_dirty))
        return self

    def _retune_records(self, specs: Sequence[WorkerSpec],
                        coll: CollectiveModel) -> set:
        """Recompute every provenance-recorded duration/gap for ``specs``.

        Returns the set of task uids whose duration or gap actually
        changed — the dirty set :meth:`simulate_incremental` replays.  The
        CostModel accessors behind the expressions are pure functions of
        their keys, so each distinct lookup is resolved once per retune
        (per kind, per (i, j) link pair, per (ids, pos, payload) leg, per
        pod) instead of once per task — same float expressions as
        :meth:`build`, just memoized.
        """
        kscale: Dict[Any, float] = {}         # TaskKind -> kind_scale
        link_bw: Dict[Tuple[int, int], float] = {}   # (i, j) -> bandwidth
        leg_dur: Dict[Tuple, float] = {}      # (ids, pos, payload)
        pod_scale: Dict[Tuple[int, ...], float] = {}  # pod members -> min bw
        hop = coll.hop_latency
        dirty: set = set()

        def bw(i: int, j: int) -> float:
            b = link_bw.get((i, j))
            if b is None:
                b = link_bw[(i, j)] = self._link_bandwidth(i, j)
            return b

        for rec in self._prov:
            kind, t = rec[0], rec[1]
            gap = t.gap
            if kind == "compute":
                _, _, i, dur, g0 = rec
                ks = kscale.get(t.kind)
                if ks is None:
                    ks = kscale[t.kind] = self.cost.kind_scale(t.kind)
                d = dur * specs[i].compute_scale * ks
                gap = g0 * specs[i].compute_scale
            elif kind == "coll":
                _, _, i, dur = rec
                d = dur / max(specs[i].bandwidth_scale, 1e-12)
            elif kind == "ring":
                _, _, ids, pos, payload = rec
                key = (ids, pos, payload)
                d = leg_dur.get(key)
                if d is None:
                    k = len(ids)
                    d = leg_dur[key] = \
                        (payload / k) / bw(ids[pos], ids[(pos + 1) % k]) + hop
            elif kind == "p2p":
                _, _, i, j, payload = rec
                d = coll.p2p_time(payload, bw(i, j))
            elif kind in ("hrs", "hag"):
                _, _, pod_members, payload = rec
                op = "reduce-scatter" if kind == "hrs" else "all-gather"
                scale = pod_scale.get(pod_members)
                if scale is None:
                    scale = pod_scale[pod_members] = \
                        min(specs[i].bandwidth_scale for i in pod_members)
                d = coll.axis_time(op, payload, len(pod_members),
                                   "ici") / max(scale, 1e-12)
            else:                   # hcross
                _, _, leader, shard, num_pods = rec
                d = coll.axis_time("all-reduce", shard, num_pods,
                                   "dcn") \
                    / max(specs[leader].bandwidth_scale, 1e-12)
            if d != t.duration or gap != t.gap:
                t.duration = d
                t.gap = gap
                dirty.add(t.uid)
        return dirty

    # -------------------------------------------------------------- simulate
    def simulate(self, schedule: Optional[ScheduleFn] = None, *,
                 record_binding: bool = False) -> ClusterResult:
        res = simulate(self.graph, schedule or self.schedule,
                       record_binding=record_binding)
        # snapshot durations/gaps: a later retune() (sweeps) must not bleed
        # into this result's lazily-computed per-worker breakdown
        snap = {t.uid: (t.duration, t.gap) for t in self.graph.tasks()}
        return ClusterResult(makespan=res.makespan, global_result=res,
                             workers=list(self.workers),
                             _split_fn=lambda: self._split_result(res, snap),
                             _snap=snap)

    def simulate_incremental(self, prev: ClusterResult,
                             dirty: Optional[set] = None,
                             schedule: Optional[ScheduleFn] = None
                             ) -> Optional[ClusterResult]:
        """Replay only the downstream cone of the tasks a retune changed.

        ``prev`` is this graph's :class:`ClusterResult` from *before* the
        retune; ``dirty`` defaults to :attr:`last_retune_dirty` (the uids
        whose duration/gap the most recent :meth:`retune` actually
        changed).  Returns a result bit-identical to :meth:`simulate`, or
        ``None`` when the cone replay cannot guarantee that (custom
        schedule, oversized cone, or a boundary reorder hazard — see
        :func:`repro_torch.core.simulate.simulate_incremental`) and the caller
        should fall back to a full :meth:`simulate`.
        """
        if dirty is None:
            dirty = self.last_retune_dirty
        res = simulate_incremental(self.graph, prev.global_result, dirty,
                                   schedule or self.schedule)
        if res is None:
            return None
        if prev._snap is not None:
            # the incremental contract says only ``dirty`` changed since
            # ``prev`` — refresh just those entries
            snap = dict(prev._snap)
            by_uid = self.graph._tasks
            for uid in dirty:
                t = by_uid.get(uid)
                if t is not None:     # provenance of detached tasks
                    snap[uid] = (t.duration, t.gap)
        else:
            snap = {t.uid: (t.duration, t.gap)
                    for t in self.graph.tasks()}
        return ClusterResult(makespan=res.makespan, global_result=res,
                             workers=list(self.workers),
                             _split_fn=lambda: self._split_result(res, snap),
                             _snap=snap)

    def _worker_partition(self) -> Dict[int, List[Task]]:
        """Tasks grouped by worker, cached — the grouping only depends on
        the graph's structure, which retune keeps fixed across sweeps."""
        if self._tasks_by_worker is None:
            by_worker: Dict[int, List[Task]] = collections.defaultdict(list)
            for t in self.graph.tasks():
                w, _ = split_worker_thread(t.thread)
                if w is not None:
                    by_worker[w].append(t)
            self._tasks_by_worker = dict(by_worker)
        return self._tasks_by_worker

    def _split_result(self, res: SimResult,
                      snap: Dict[int, Tuple[float, float]]
                      ) -> Dict[int, SimResult]:
        """Project the global result onto each worker's local resources."""
        tasks_by_worker = self._worker_partition()
        out: Dict[int, SimResult] = {}
        for i in range(len(self.workers)):
            ts = tasks_by_worker.get(i, [])
            start = {t.uid: res.start[t.uid] for t in ts}
            finish = {t.uid: res.finish[t.uid] for t in ts}
            busy: Dict[str, float] = collections.defaultdict(float)
            intervals: Dict[str, List[Tuple[float, float]]] = \
                collections.defaultdict(list)
            makespan = 0.0
            for t in ts:
                duration, gap = snap[t.uid]
                local = split_worker_thread(t.thread)[1]
                busy[local] += duration
                if duration > 0:
                    intervals[local].append((start[t.uid], finish[t.uid]))
                makespan = max(makespan, finish[t.uid] + gap)
            breakdown = _host_device_breakdown(
                intervals, makespan, lambda th: th == HOST_THREAD)
            out[i] = SimResult(makespan=makespan, start=start, finish=finish,
                               thread_busy=dict(busy), _breakdown=breakdown)
        return out
