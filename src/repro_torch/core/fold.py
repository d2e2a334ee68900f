"""Symmetry folding: O(classes) cluster simulation instead of O(workers).

A 4k-worker data-parallel job replicates the *same* per-worker subgraph
4k times and wires 4k-member collectives — yet with uniform workers every
replica has a provably identical timeline, so simulating all of them is
pure redundancy.  This module partitions workers into **equivalence
classes** (:func:`partition_workers`), materializes one representative
subgraph per class, and closes the collective structures *algebraically*
over the class sizes: a uniform ring keeps one representative leg chain
whose 2(n-1) legs carry the full-group leg duration, hierarchical
(BlueConnect) stages keep one representative per (pod, leader/member)
role, fused collectives and push/pull pairs keep one representative per
spec class.  The folded graph simulates bit-identically to the fully
materialized one (the property tests in ``tests/test_fold.py`` hold the
two equal) at a cost proportional to classes, not workers — this is what
makes predict/sweep/hillclimb interactive at 10k-worker scale (dPRO-style
replica-level simulation; see the equivalence-class contract in
:mod:`repro_torch.core.cluster`'s module docstring).

Foldability is checked, never assumed: :func:`fold_cluster` /
:func:`fold_plan` return ``None`` whenever per-class timeline identity
cannot be guaranteed (heterogeneous ring groups, multi-pod rings,
non-uniform pipeline stages...), and the caller falls back to full
materialization.  A straggler what-if *does* fold: the N-1 identical
workers form one class and the straggler its own, exact under ``"fused"``
collectives and under hierarchical pod-uniform layouts.

Retunes that keep the partition (same members per class) stay folded and
feed :meth:`FoldedClusterGraph.simulate_incremental` — cone replay over
the already-folded graph, the two optimizations compose.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union)

from repro_torch.obs.spans import span as _obs_span

from .cluster import (ClusterGraph, ClusterResult, WorkerSpec, _RING_ROUNDS,
                      _as_specs, match_push_pull_groups)
from .costmodel import CostModel
from .graph import DependencyGraph, GraphError
from .simulate import (ScheduleFn, SimResult, simulate, simulate_incremental)
from .task import Task, TaskKind


@dataclasses.dataclass(frozen=True)
class WorkerClass:
    """One equivalence class of workers: identical spec, identical wiring
    role, provably identical timeline.  ``members`` are original worker
    indices (ascending); ``members[0]`` is the materialized
    representative."""

    members: Tuple[int, ...]
    spec: WorkerSpec
    role: str = "worker"        # "worker" | "leader" | "member" | "stage"

    @property
    def representative(self) -> int:
        return self.members[0]

    @property
    def count(self) -> int:
        return len(self.members)


def partition_workers(specs: Sequence[WorkerSpec], mode: str
                      ) -> Optional[List[WorkerClass]]:
    """Partition ``specs`` into fold classes valid for ``mode``.

    Returns ``None`` when no exact fold exists for the mode (see the
    contract in :mod:`repro_torch.core.cluster`):

    * ``"ring"``: one class iff every spec (including pod) is identical —
      heterogeneous or multi-pod rings have position-dependent legs.
    * ``"hierarchical"``: per-(pod, leader/member) classes iff each pod is
      internally uniform (the pod-uniform case; pods may differ).
    * ``"fused"``: one class per distinct spec, always foldable.
    """
    specs = list(specs)
    n = len(specs)
    if mode == "ring":
        first = specs[0]
        if any(s != first for s in specs[1:]):
            return None
        return [WorkerClass(members=tuple(range(n)), spec=first)]
    if mode == "fused":
        groups: Dict[WorkerSpec, List[int]] = {}
        for i, s in enumerate(specs):
            groups.setdefault(s, []).append(i)
        return [WorkerClass(members=tuple(ms), spec=specs[ms[0]])
                for ms in sorted(groups.values())]
    if mode == "hierarchical":
        pods: Dict[int, List[int]] = {}
        for i, s in enumerate(specs):
            pods.setdefault(s.pod, []).append(i)
        classes: List[WorkerClass] = []
        for p in sorted(pods):
            ms = pods[p]
            first = specs[ms[0]]
            if any(specs[i] != first for i in ms[1:]):
                return None     # pod not internally uniform
            classes.append(WorkerClass(members=(ms[0],), spec=first,
                                       role="leader"))
            if len(ms) > 1:
                classes.append(WorkerClass(members=tuple(ms[1:]), spec=first,
                                           role="member"))
        return classes
    raise GraphError(f"unknown collective_mode {mode!r}")


@dataclasses.dataclass
class FoldedClusterResult(ClusterResult):
    """A :class:`~repro_torch.core.cluster.ClusterResult` whose per-worker view
    expands lazily from the per-class one: class members share (by
    reference) their representative's :class:`SimResult`, so reading
    ``per_worker`` on a 4k-worker fold costs O(classes) simulation work
    plus an O(workers) dict, not O(workers) timeline projections."""

    classes: List[WorkerClass] = dataclasses.field(default_factory=list)
    _class_fn: Optional[Callable[[], Dict[int, SimResult]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _per_class: Optional[Dict[int, SimResult]] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def per_class(self) -> Dict[int, SimResult]:
        """class index -> the representative's local :class:`SimResult`."""
        if self._per_class is None:
            self._per_class = self._class_fn() if self._class_fn else {}
        return self._per_class

    @property
    def per_worker(self) -> Dict[int, SimResult]:
        if self._per_worker is None:
            pc = self.per_class
            self._per_worker = {m: pc[ci]
                                for ci, c in enumerate(self.classes)
                                for m in c.members}
        return self._per_worker


class FoldedClusterGraph:
    """Duck-types :class:`~repro_torch.core.cluster.ClusterGraph` over a folded
    build: the inner graph has one worker slot per :class:`WorkerClass`
    (worker thread ``w<class>/...``), while :attr:`workers` stays the full
    original spec list.  ``simulate``/``retune``/``can_retune``/
    ``simulate_incremental`` match the materialized API so
    :class:`~repro_torch.core.optimize.Scenario` and the analysis layer use
    either interchangeably."""

    def __init__(self, cg: ClusterGraph, classes: Sequence[WorkerClass],
                 specs: Sequence[WorkerSpec],
                 partition_fn: Callable[[Sequence[WorkerSpec]],
                                        Optional[List[WorkerClass]]]) -> None:
        self.cg = cg
        self.classes = list(classes)
        self.workers = list(specs)
        self._partition_fn = partition_fn
        self._class_of = {m: ci for ci, c in enumerate(self.classes)
                          for m in c.members}
        # fold-closed structures (ring legs / hierarchical stages) whose
        # durations are functions of the *original* specs; everything else
        # retunes through the inner graph's own provenance.
        self._fprov: List[Tuple] = []
        self.last_retune_dirty: set = set()

    # ------------------------------------------------------ delegated surface
    @property
    def graph(self) -> DependencyGraph:
        return self.cg.graph

    @property
    def schedule(self) -> Optional[ScheduleFn]:
        return self.cg.schedule

    @property
    def cost(self) -> CostModel:
        return self.cg.cost

    @property
    def collective_mode(self) -> str:
        return self.cg.collective_mode

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def retunable(self) -> bool:
        return True

    # -------------------------------------------------------------- folding
    def _orig_link_bandwidth(self, i: int, j: int,
                             specs: Optional[Sequence[WorkerSpec]] = None
                             ) -> float:
        """Link bandwidth between *original* workers i and j — the same
        expression as ``ClusterGraph._link_bandwidth`` evaluated against
        the unfolded spec list, so folded durations are bit-identical to
        materialized ones."""
        w = self.workers if specs is None else specs
        wi, wj = w[i], w[j]
        bw = self.cg.cost.link_bandwidth(
            "dcn" if wi.pod != wj.pod else "ici")
        return bw * max(min(wi.bandwidth_scale, wj.bandwidth_scale), 1e-12)

    def _fold_collective(self, op: str, members: List[Task],
                         group_size: int) -> None:
        """Close one matched collective over the class representatives —
        the fold counterpart of ``ClusterGraph.wire_collective_group``.
        ``members[ci]`` is class ci's cloned collective task;
        ``group_size`` is the original member count the algebra closes
        over."""
        cg = self.cg
        cg._gid += 1
        mode = cg.collective_mode
        if mode == "hierarchical" and op == "all-reduce":
            self._fold_hierarchical(members)
        elif mode in ("ring", "hierarchical") and op in _RING_ROUNDS:
            # valid only for a fully uniform single-pod group (the caller
            # guarantees it): every member's chain is identical, so each
            # class representative keeps its own full leg chain and the
            # cross-worker ring edges — which provably never bind for
            # uniform legs — are dropped
            for rc in members:
                self._fold_ring(op, rc, group_size, (0, 1))
        else:
            cg._fused_sync(members)

    def _fold_ring(self, op: str, rc: Task, n: int,
                   link: Tuple[int, int]) -> None:
        """One representative's ring-leg chain for a uniform n-member
        group; ``link`` is an adjacent pair of *original* worker ids whose
        (uniform) link sets every leg's duration."""
        cg = self.cg
        rounds = _RING_ROUNDS[op] * (n - 1)
        payload = max(rc.comm_bytes, 0.0)
        parents, children = cg._detach(rc)
        i0, i1 = link
        leg_dur = (payload / n) / self._orig_link_bandwidth(i0, i1) \
            + cg.cost.collectives.hop_latency
        prev: Optional[Task] = None
        for k in range(rounds):
            leg = rc.clone()
            leg.name = f"{rc.name}:leg{k}"
            leg.duration = leg_dur
            leg.comm_bytes = payload / n
            leg.attrs = dict(rc.attrs, ring_round=k, coll_gid=cg._gid)
            self._fprov.append(("ring", leg, n, payload, i0, i1))
            cg.graph.add_task(leg, link_lane=False)
            for p in (parents if prev is None else [prev]):
                cg.graph.add_edge(p, leg)
            prev = leg
        for ch in children:
            cg.graph.add_edge(prev, ch)

    def _fold_hierarchical(self, members: List[Task]) -> None:
        """BlueConnect closure over (pod, role) classes: same barrier
        skeleton as ``ClusterGraph._hierarchical_decompose`` but with one
        reduce-scatter/all-gather per class instead of per worker; stage
        durations are computed from the original pod memberships."""
        cg = self.cg
        coll = cg.cost.collectives
        payload = max(max(m.comm_bytes for m in members), 0.0)
        cname = members[0].name
        pods: Dict[int, List[int]] = {}
        for w, s in enumerate(self.workers):
            pods.setdefault(s.pod, []).append(w)
        pod_classes: Dict[int, List[int]] = {}
        for ci, c in enumerate(self.classes):
            pod_classes.setdefault(c.spec.pod, []).append(ci)
        pod_ids = sorted(pods)
        num_pods = len(pod_ids)

        bounds = {ci: cg._detach(m) for ci, m in enumerate(members)}

        leaders_bar = cg._barrier(f"{cname}:leaders-barrier")
        for p in pod_ids:
            pod_members = tuple(pods[p])
            m = len(pod_members)
            scale = min(self.workers[i].bandwidth_scale for i in pod_members)
            rs_dur = coll.axis_time("reduce-scatter", payload, m, "ici")
            rs_dur /= max(scale, 1e-12)
            bar = cg._barrier(f"{cname}:pod{p}:rs-barrier")
            rs_tasks = []
            for ci in pod_classes[p]:
                parents, _ = bounds[ci]
                for par in parents:
                    cg.graph.add_edge(par, bar)
                rs = cg._add_comm(ci, members[ci], f"pod{p}:reduce-scatter",
                                  rs_dur, payload)
                self._fprov.append(("hrs", rs, pod_members, payload))
                cg.graph.add_edge(bar, rs)
                rs_tasks.append(rs)
            for rs in rs_tasks:
                cg.graph.add_edge(rs, leaders_bar)

        if num_pods > 1:
            gather_bar = cg._barrier(f"{cname}:gather-barrier")
            for p in pod_ids:
                pod_members = pods[p]
                leader = pod_members[0]
                ci = self._class_of[leader]
                shard = payload / max(len(pod_members), 1)
                cross_dur = coll.axis_time("all-reduce", shard, num_pods,
                                           "dcn")
                cross_dur /= max(self.workers[leader].bandwidth_scale, 1e-12)
                cross = cg._add_comm(ci, members[ci],
                                     f"pod{p}:cross-all-reduce",
                                     cross_dur, shard)
                self._fprov.append(("hcross", cross, leader, shard,
                                    num_pods))
                cg.graph.add_edge(leaders_bar, cross)
                cg.graph.add_edge(cross, gather_bar)
            gate = gather_bar
        else:
            gate = leaders_bar
        for p in pod_ids:
            pod_members = tuple(pods[p])
            m = len(pod_members)
            scale = min(self.workers[i].bandwidth_scale for i in pod_members)
            ag_dur = coll.axis_time("all-gather", payload, m, "ici")
            ag_dur /= max(scale, 1e-12)
            for ci in pod_classes[p]:
                ag = cg._add_comm(ci, members[ci], f"pod{p}:all-gather",
                                  ag_dur, payload)
                self._fprov.append(("hag", ag, pod_members, payload))
                cg.graph.add_edge(gate, ag)
                _, children = bounds[ci]
                for ch in children:
                    cg.graph.add_edge(ag, ch)

    # --------------------------------------------------------------- retune
    def can_retune(self, workers: Union[int, Sequence[WorkerSpec]]) -> bool:
        """True when ``workers`` keeps the fold partition: same worker
        count, same members per class (specs may change freely within
        that).  A partition-changing what-if (perturbing one member of a
        uniform ring) needs a rebuild — ``Scenario.sweep`` handles the
        fallback."""
        try:
            specs = _as_specs(workers)
        except GraphError:
            return False
        if len(specs) != len(self.workers):
            return False
        new = self._partition_fn(specs)
        if new is None or len(new) != len(self.classes):
            return False
        return all(a.members == b.members and a.role == b.role
                   for a, b in zip(new, self.classes))

    def retune(self, workers: Union[int, Sequence[WorkerSpec]]
               ) -> "FoldedClusterGraph":
        """Re-parameterize the folded build in place (same contract as
        :meth:`ClusterGraph.retune`, plus the partition-stability
        requirement of :meth:`can_retune`)."""
        specs = _as_specs(workers)
        if not self.can_retune(specs):
            raise GraphError(
                "retune would change the fold partition (different worker "
                "count or class membership); rebuild — Scenario.sweep does "
                "this automatically")
        self.workers = list(specs)
        self.classes = self._partition_fn(specs)
        with _obs_span("cluster.fold_retune", workers=len(specs),
                       classes=len(self.classes)) as sp:
            self.cg.retune([c.spec for c in self.classes])
            dirty = set(self.cg.last_retune_dirty)
            dirty |= self._retune_fold_records(specs)
            self.last_retune_dirty = dirty
            sp.note(dirty=len(dirty))
        return self

    def _retune_fold_records(self, specs: Sequence[WorkerSpec]) -> set:
        coll = self.cg.cost.collectives
        hop = coll.hop_latency
        link_bw: Dict[Tuple[int, int], float] = {}
        pod_scale: Dict[Tuple[int, ...], float] = {}
        dirty: set = set()

        def bw(i: int, j: int) -> float:
            b = link_bw.get((i, j))
            if b is None:
                b = link_bw[(i, j)] = self._orig_link_bandwidth(i, j, specs)
            return b

        for rec in self._fprov:
            kind, t = rec[0], rec[1]
            if kind == "ring":
                _, _, n, payload, i0, i1 = rec
                d = (payload / n) / bw(i0, i1) + hop
            elif kind in ("hrs", "hag"):
                _, _, pod_members, payload = rec
                op = "reduce-scatter" if kind == "hrs" else "all-gather"
                scale = pod_scale.get(pod_members)
                if scale is None:
                    scale = pod_scale[pod_members] = \
                        min(specs[i].bandwidth_scale for i in pod_members)
                d = coll.axis_time(op, payload, len(pod_members),
                                   "ici") / max(scale, 1e-12)
            else:               # hcross
                _, _, leader, shard, num_pods = rec
                d = coll.axis_time("all-reduce", shard, num_pods,
                                   "dcn") \
                    / max(specs[leader].bandwidth_scale, 1e-12)
            if d != t.duration:
                t.duration = d
                dirty.add(t.uid)
        return dirty

    # ------------------------------------------------------------- simulate
    def _wrap(self, res: SimResult) -> FoldedClusterResult:
        cg = self.cg
        snap = {t.uid: (t.duration, t.gap) for t in cg.graph.tasks()}
        return FoldedClusterResult(
            makespan=res.makespan, global_result=res,
            workers=list(self.workers), classes=list(self.classes),
            _class_fn=lambda: cg._split_result(res, snap))

    def simulate(self, schedule: Optional[ScheduleFn] = None, *,
                 record_binding: bool = False) -> FoldedClusterResult:
        res = simulate(self.cg.graph, schedule or self.cg.schedule,
                       record_binding=record_binding)
        return self._wrap(res)

    def simulate_incremental(self, prev: ClusterResult,
                             dirty: Optional[set] = None,
                             schedule: Optional[ScheduleFn] = None
                             ) -> Optional[FoldedClusterResult]:
        """Cone replay over the folded graph (see
        :meth:`ClusterGraph.simulate_incremental`); the two optimizations
        compose — a sweep point replays a small cone of an
        O(classes)-sized graph."""
        if dirty is None:
            dirty = self.last_retune_dirty
        res = simulate_incremental(self.cg.graph, prev.global_result, dirty,
                                   schedule or self.cg.schedule)
        if res is None:
            return None
        return self._wrap(res)


def fold_cluster(base: DependencyGraph,
                 workers: Union[int, Sequence[WorkerSpec]],
                 *, cost: Optional[CostModel] = None,
                 collective_mode: str = "ring",
                 schedule: Optional[ScheduleFn] = None
                 ) -> Optional[FoldedClusterGraph]:
    """Folded counterpart of :meth:`ClusterGraph.build`.

    Returns ``None`` when the (specs, mode, base) combination admits no
    exact fold — same-signature fallback to ``ClusterGraph.build`` is the
    caller's job (``Scenario`` does it automatically).  Raises exactly
    where ``build`` would raise (invalid mode / pod layout), so swapping
    the two never changes error behavior.
    """
    specs = _as_specs(workers)
    ClusterGraph._check_mode(collective_mode, specs)
    cost = cost or CostModel()
    n = len(specs)
    classes = partition_workers(specs, collective_mode)
    if classes is None or len(classes) >= n:
        return None
    if collective_mode == "hierarchical" and len({s.pod for s in specs}) > 1:
        # a bare reduce-scatter / all-gather keeps ring legs even in
        # hierarchical mode, and a multi-pod ring cannot fold
        for c in base.tasks():
            op = c.attrs.get("collective")
            if c.kind == TaskKind.COLLECTIVE and op \
                    and op != "all-reduce" and op in _RING_ROUNDS:
                return None
    with _obs_span("cluster.fold", workers=n, classes=len(classes),
                   base_tasks=len(base), mode=collective_mode):
        g = DependencyGraph()
        cg = ClusterGraph(g, [c.spec for c in classes], cost, schedule,
                          collective_mode)
        fg = FoldedClusterGraph(
            cg, classes, specs,
            partition_fn=lambda s: partition_workers(s, collective_mode))
        replicas = [cg._clone_worker(ci, c.spec, base)
                    for ci, c in enumerate(classes)]
        for c in base.tasks():
            if c.kind == TaskKind.COLLECTIVE and c.attrs.get("collective"):
                fg._fold_collective(c.attrs["collective"],
                                    [remap[c.uid] for remap in replicas], n)
        # push/pull pairs: one aggregation barrier over the class
        # representatives (the barrier max over identical members is the
        # max over representatives)
        cg._sync_push_pull(
            [[(remap[push.uid], [remap[v.uid] for v in pulls])
              for remap in replicas]
             for ((push, pulls),) in match_push_pull_groups([base])])
        cg._finish()
        fg._fprov = [r for r in fg._fprov if r[1] in g]
        return fg


def fold_plan(plan, workers: Optional[Union[int, Sequence[WorkerSpec]]]
              = None, *, cost: Optional[CostModel] = None,
              collective_mode: str = "ring",
              sched_fn: Optional[ScheduleFn] = None,
              templates: Optional[Sequence[DependencyGraph]] = None
              ) -> Optional[FoldedClusterGraph]:
    """Folded counterpart of :meth:`ParallelPlan.place` for hybrid PP x DP.

    Folds each stage's ``dp`` data-parallel replicas into one class (one
    worker slot per *stage*) when every stage is internally spec-uniform:
    stage-boundary p2p hops wire representative-to-representative (replica
    r's hop is identical to replica 0's), and each stage's gradient ring
    closes as a representative leg chain over the original ``dp``.
    Returns ``None`` — fall back to ``place()`` — for ``dp < 2``,
    hierarchical mode (a folded stage cannot host a per-pod
    decomposition), non-uniform stages, or malformed templates (``place``
    then raises the proper error).
    """
    S, M, dp = plan.num_stages, plan.microbatches, plan.dp
    if dp < 2 or collective_mode == "hierarchical":
        return None
    specs = [WorkerSpec() for _ in range(plan.num_workers)] \
        if workers is None else _as_specs(workers)
    if len(specs) != plan.num_workers:
        return None

    def part(s: Sequence[WorkerSpec]) -> Optional[List[WorkerClass]]:
        s = list(s)
        if len(s) != S * dp:
            return None
        out = []
        for st in range(S):
            grp = s[st * dp:(st + 1) * dp]
            if any(x != grp[0] for x in grp[1:]):
                return None
            out.append(WorkerClass(members=tuple(range(st * dp,
                                                       (st + 1) * dp)),
                                   spec=grp[0], role="stage"))
        return out

    classes = part(specs)
    if classes is None:
        return None
    cost = cost or CostModel()
    tmpls = list(templates) if templates is not None \
        else plan.stage_templates(cost)
    if len(tmpls) != S:
        return None
    with _obs_span("cluster.fold_plan", workers=len(specs), classes=S,
                   stages=S, dp=dp):
        cg = ClusterGraph(DependencyGraph(), [c.spec for c in classes],
                          cost, sched_fn, collective_mode)
        fg = FoldedClusterGraph(cg, classes, specs, partition_fn=part)
        remaps = [cg._clone_worker(s, classes[s].spec, tmpls[s],
                                   comm_prov=False) for s in range(S)]
        # index each template's schedule tasks by role/microbatch — the
        # same discipline as ParallelPlan.place
        fwds: List[Dict[int, Task]] = []
        bwds: List[Dict[int, Task]] = []
        acts: List[Dict[int, Task]] = []
        grads: List[Dict[int, Task]] = []
        ars: List[Optional[Task]] = []
        for g in tmpls:
            f: Dict[int, Task] = {}
            b: Dict[int, Task] = {}
            a: Dict[int, Task] = {}
            gr: Dict[int, Task] = {}
            ar: Optional[Task] = None
            for t in g.tasks():
                m = t.attrs.get("microbatch")
                if t.kind == TaskKind.COMM and t.attrs.get("p2p_role"):
                    (a if t.attrs["p2p_role"] == "act" else gr)[m] = t
                elif t.kind == TaskKind.COLLECTIVE \
                        and t.attrs.get("collective") \
                        and "stage" in t.attrs:
                    ar = t
                elif t.phase == "fwd" and m is not None:
                    f[m] = t
                elif t.phase == "bwd" and m is not None:
                    b[m] = t
            fwds.append(f)
            bwds.append(b)
            acts.append(a)
            grads.append(gr)
            ars.append(ar)
        for s in range(S):
            if any(m not in fwds[s] or m not in bwds[s] for m in range(M)) \
                    or (s < S - 1 and len(acts[s]) != M) \
                    or (s > 0 and len(grads[s]) != M) or ars[s] is None:
                return None     # malformed template: place() raises properly
        for s in range(S - 1):
            for m in range(M):
                cg.wire_p2p(None, remaps[s + 1][fwds[s + 1][m].uid],
                            s, s + 1, leg=remaps[s][acts[s][m].uid])
        for s in range(1, S):
            for m in range(M):
                cg.wire_p2p(None, remaps[s - 1][bwds[s - 1][m].uid],
                            s, s - 1, leg=remaps[s][grads[s][m].uid])
        for s in range(S):
            op = ars[s].attrs["collective"]
            rc = remaps[s][ars[s].uid]
            cg._gid += 1
            if collective_mode == "ring" and op in _RING_ROUNDS:
                fg._fold_ring(op, rc, dp, (s * dp, s * dp + 1))
            else:               # "fused" (or a non-ring op): barrier + rep
                cg._fused_sync([rc])
        cg._finish()
        fg._fprov = [r for r in fg._fprov if r[1] in cg.graph]
        return fg
