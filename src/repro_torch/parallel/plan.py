"""Parallelism plans: pipeline/hybrid parallelism through the real simulator.

Daydream's claim is that one dependency graph plus graph-transformation
primitives models "a wide variety of optimizations" — and a *parallelism
plan* is just another graph construction.  This module closes the gap the
old analytic pipeline toy left open: instead of a fwd-only closed-form
schedule, a :class:`ParallelPlan` places real per-stage subgraphs onto
:class:`~repro_torch.core.cluster.WorkerSpec` workers and wires them with the
cluster simulator's comm primitives, so pipeline questions route through
the same machinery as every other what-if (heterogeneous pods, skewed
links, retunable sweeps, per-worker breakdowns).

Three pieces:

* :func:`partition_stages` — split a profiled single-worker graph by layer
  into S contiguous stage profiles, balanced by per-layer device time
  (fwd+bwd), with activation/gradient payloads drawn from the scenario's
  layer byte maps.
* :func:`schedule_order` — the per-stage microbatch op order for GPipe
  (all forwards, then all backwards) and 1F1B (warmup forwards, steady
  one-forward-one-backward, cooldown backwards).  The order *is* the
  schedule: each stage's device lane chains its ops in program order, and
  the simulator does the rest.
* :meth:`ParallelPlan.place` — build the global
  :class:`~repro_torch.core.cluster.ClusterGraph`: one worker per (stage,
  replica), cross-stage activation/gradient hops as point-to-point COMM
  legs (:meth:`~repro_torch.core.cluster.ClusterGraph.wire_p2p` — duration from
  the placed link's bandwidth, pods -> DCN, retunable), and, when
  ``dp > 1``, a per-stage gradient all-reduce wired over just that stage's
  replicas (:meth:`~repro_torch.core.cluster.ClusterGraph.wire_collective_group`)
  — hybrid PP x DP.

The classic closed forms fall out of the simulation instead of being baked
in: balanced-stage GPipe makespan is ``(M + S - 1) * t_stage`` (asserted
to float precision in tests/test_plan.py), and the bubble fraction is
``(S - 1) / (M + S - 1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.cluster import ClusterGraph, WorkerSpec, _as_specs
from repro_torch.core.costmodel import CostModel
from repro_torch.core.graph import DependencyGraph, GraphError
from repro_torch.core.simulate import ScheduleFn
from repro_torch.core.task import (Task, TaskKind, DEVICE_STREAM, ici_channel)

SCHEDULES = ("gpipe", "1f1b")

# Worker-local channel resources for the cross-stage hops: activations flow
# stage s -> s+1, gradients s -> s-1, on independent (bidirectional-link)
# channels, so consecutive microbatch hops serialize per direction exactly
# like ring legs on an ICI link.
ACT_CHANNEL = ici_channel("pp:act")
GRAD_CHANNEL = ici_channel("pp:grad")
# Per-stage data-parallel gradient ring (hybrid PP x DP).
DP_CHANNEL = ici_channel("dp:grad")


@dataclasses.dataclass(frozen=True)
class StageProfile:
    """One pipeline stage's aggregate profile (per minibatch).

    ``fwd_s``/``bwd_s``/``update_s`` are the stage's summed device times by
    phase; flops/bytes aggregates let roofline-style what-ifs (AMP) classify
    the stage's microbatch tasks.  ``act_bytes`` is the activation payload
    *leaving* this stage (the byte-map entry of its last layer);
    ``grad_bytes`` is the stage's parameter-gradient payload (the per-stage
    DDP ring's traffic).
    """

    index: int
    layers: Tuple[str, ...]
    fwd_s: float
    bwd_s: float
    update_s: float = 0.0
    fwd_flops: float = 0.0
    fwd_bytes: float = 0.0
    bwd_flops: float = 0.0
    bwd_bytes: float = 0.0
    update_flops: float = 0.0
    update_bytes: float = 0.0
    act_bytes: float = 0.0
    grad_bytes: float = 0.0


def partition_stages(graph: DependencyGraph, num_stages: int, *,
                     activation_bytes: Optional[Dict[str, float]] = None,
                     layer_grad_bytes: Optional[Dict[str, float]] = None
                     ) -> List[StageProfile]:
    """Split a profiled single-worker graph into S contiguous stage profiles.

    Layers are taken in device-lane forward order (first appearance) and
    assigned greedily so cumulative per-layer weight (fwd + bwd device
    time) tracks the balanced target — the standard contiguous-partition
    heuristic.  Only layer-mapped device-lane compute/memory tasks are
    counted: collectives are dropped (the plan wires its own communication)
    and host/data lanes stay behind — the plan models the *device program*,
    so on a host-dispatch-bound profile the predicted pipeline makespan
    omits that bottleneck (compare against a DP baseline, not wall clock).
    Raises when the profile maps fewer layers than stages.
    """
    if num_stages < 1:
        raise GraphError(f"pipeline needs >= 1 stage, got {num_stages}")
    acts = activation_bytes or {}
    grads = layer_grad_bytes or {}
    order: List[str] = []
    agg: Dict[str, Dict[str, float]] = {}
    for t in graph.lane_tasks(DEVICE_STREAM):
        if t.layer is None or t.kind in (TaskKind.COLLECTIVE, TaskKind.COMM):
            continue
        if t.layer not in agg:
            order.append(t.layer)
            agg[t.layer] = {"fwd_s": 0.0, "bwd_s": 0.0, "update_s": 0.0,
                            "fwd_flops": 0.0, "fwd_bytes": 0.0,
                            "bwd_flops": 0.0, "bwd_bytes": 0.0,
                            "update_flops": 0.0, "update_bytes": 0.0}
        a = agg[t.layer]
        phase = t.phase if t.phase in ("bwd", "update") else "fwd"
        a[f"{phase}_s"] += t.duration
        a[f"{phase}_flops"] += t.flops
        a[f"{phase}_bytes"] += t.bytes_accessed
    if not order:
        raise GraphError(
            "cannot partition: the profile has no layer-mapped device "
            "tasks (see repro_torch.core.layermap)")
    if len(order) < num_stages:
        raise GraphError(
            f"cannot split {len(order)} mapped layer(s) into {num_stages} "
            f"pipeline stages")
    weight = {l: agg[l]["fwd_s"] + agg[l]["bwd_s"] for l in order}
    total = sum(weight.values())
    target = total / num_stages
    stages: List[List[str]] = [[]]
    cum = 0.0
    remaining = len(order)
    for l in order:
        s = len(stages) - 1
        # close the stage once it reaches its balanced share, as long as
        # every remaining stage can still get >= 1 layer
        if (stages[-1] and cum >= target * len(stages)
                and len(stages) < num_stages
                and remaining >= num_stages - s):
            stages.append([])
        stages[-1].append(l)
        cum += weight[l]
        remaining -= 1
    while len(stages) < num_stages:      # degenerate weights: pad from tail
        for i in range(len(stages) - 1, -1, -1):
            if len(stages[i]) > 1:
                stages.insert(i + 1, [stages[i].pop()])
                break
    profiles = []
    for s, layers in enumerate(stages):
        tot = {k: sum(agg[l][k] for l in layers) for k in agg[layers[0]]}
        profiles.append(StageProfile(
            index=s, layers=tuple(layers),
            act_bytes=acts.get(layers[-1], 0.0),
            grad_bytes=sum(grads.get(l, 0.0) for l in layers), **tot))
    return profiles


def schedule_order(num_stages: int, stage: int, microbatches: int,
                   schedule: str = "gpipe") -> List[Tuple[str, int]]:
    """Per-stage op order: ``[("F"|"B", microbatch), ...]``.

    ``"gpipe"`` runs every forward then every backward; ``"1f1b"``
    (PipeDream-flush / Megatron) runs ``min(S - 1 - stage, M)`` warmup
    forwards, then alternates one forward / one backward, then drains the
    remaining backwards.  Same work, same bubble on balanced stages —
    1F1B's win is activation memory — but the simulated orders differ and
    unbalanced stages separate them.
    """
    S, M = num_stages, microbatches
    if schedule == "gpipe":
        return [("F", m) for m in range(M)] + [("B", m) for m in range(M)]
    if schedule == "1f1b":
        warmup = min(max(S - 1 - stage, 0), M)
        order = [("F", m) for m in range(warmup)]
        f, b = warmup, 0
        while b < M:
            if f < M:
                order.append(("F", f))
                f += 1
            order.append(("B", b))
            b += 1
        return order
    raise GraphError(
        f"unknown pipeline schedule {schedule!r}; expected one of "
        f"{SCHEDULES}")


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """A placement of S pipeline stages x ``dp`` data-parallel replicas.

    Worker ``stage * dp + replica`` runs stage ``stage``'s microbatch
    schedule; :meth:`place` builds the global cluster graph.  The plan is
    frozen so sweeps can cache partitions and rebuild only the O(S * M)
    schedule graph per point.
    """

    profiles: Tuple[StageProfile, ...]
    microbatches: int
    schedule: str = "gpipe"
    dp: int = 1

    def __post_init__(self) -> None:
        if not self.profiles:
            raise GraphError("ParallelPlan needs >= 1 stage profile")
        if self.microbatches < 1:
            raise GraphError(
                f"pipeline needs >= 1 microbatch, got {self.microbatches}")
        if self.dp < 1:
            raise GraphError(f"pipeline needs dp >= 1, got {self.dp}")
        if self.schedule not in SCHEDULES:
            raise GraphError(
                f"unknown pipeline schedule {self.schedule!r}; expected "
                f"one of {SCHEDULES}")

    @classmethod
    def from_profile(cls, graph: DependencyGraph, stages: int,
                     microbatches: int, *, schedule: str = "gpipe",
                     dp: int = 1,
                     activation_bytes: Optional[Dict[str, float]] = None,
                     layer_grad_bytes: Optional[Dict[str, float]] = None
                     ) -> "ParallelPlan":
        """Partition ``graph`` into ``stages`` and wrap it in a plan."""
        return cls(tuple(partition_stages(
            graph, stages, activation_bytes=activation_bytes,
            layer_grad_bytes=layer_grad_bytes)), microbatches, schedule, dp)

    # ------------------------------------------------------------- layout
    @property
    def num_stages(self) -> int:
        return len(self.profiles)

    @property
    def num_workers(self) -> int:
        return len(self.profiles) * self.dp

    def worker_index(self, stage: int, replica: int) -> int:
        return stage * self.dp + replica

    # ---------------------------------------------------------- templates
    def stage_templates(self, cost: Optional[CostModel] = None
                        ) -> List[DependencyGraph]:
        """One single-worker graph per stage, lane-ordered by the schedule.

        Each template is an ordinary :class:`DependencyGraph`: device-lane
        F/B microbatch tasks in :func:`schedule_order`, per-microbatch COMM
        hop tasks on the act/grad channels (payloads from the stage
        profile; durations are filled in at placement from the real link),
        the weight update, and — when ``dp > 1`` — the stage's gradient
        all-reduce.  Because templates are plain graphs, registered
        optimizations apply to them unchanged (``pipeline | amp | dgc``)
        before :meth:`place` wires them across workers.
        """
        cost = cost or CostModel()
        S, M = self.num_stages, self.microbatches
        out: List[DependencyGraph] = []
        for p in self.profiles:
            s = p.index
            g = DependencyGraph()
            fwd: Dict[int, Task] = {}
            for op, m in schedule_order(S, s, M, self.schedule):
                if op == "F":
                    t = g.add_task(Task(
                        name=f"stage{s}:fwd:mb{m}", kind=TaskKind.COMPUTE,
                        thread=DEVICE_STREAM, duration=p.fwd_s / M,
                        layer=f"stage{s}", phase="fwd", flops=p.fwd_flops / M,
                        bytes_accessed=p.fwd_bytes / M,
                        attrs={"stage": s, "microbatch": m}))
                    fwd[m] = t
                    if s < S - 1:
                        send = g.add_task(Task(
                            name=f"stage{s}:act:mb{m}", kind=TaskKind.COMM,
                            thread=ACT_CHANNEL, duration=0.0,
                            comm_bytes=p.act_bytes / M, phase="comm",
                            attrs={"p2p_role": "act", "stage": s,
                                   "microbatch": m}))
                        g.add_edge(fwd[m], send)
                else:
                    b = g.add_task(Task(
                        name=f"stage{s}:bwd:mb{m}", kind=TaskKind.COMPUTE,
                        thread=DEVICE_STREAM, duration=p.bwd_s / M,
                        layer=f"stage{s}", phase="bwd", flops=p.bwd_flops / M,
                        bytes_accessed=p.bwd_bytes / M,
                        attrs={"stage": s, "microbatch": m}))
                    g.add_edge(fwd[m], b)        # stashed-activation dep
                    if s > 0:
                        send = g.add_task(Task(
                            name=f"stage{s}:grad:mb{m}", kind=TaskKind.COMM,
                            thread=GRAD_CHANNEL, duration=0.0,
                            comm_bytes=self.profiles[s - 1].act_bytes / M,
                            phase="comm",
                            attrs={"p2p_role": "grad", "stage": s,
                                   "microbatch": m}))
                        g.add_edge(b, send)
            last_bwd = g.lane_tasks(DEVICE_STREAM)[-1]
            upd = g.add_task(Task(
                name=f"stage{s}:update", kind=TaskKind.COMPUTE,
                thread=DEVICE_STREAM, duration=p.update_s,
                layer=f"stage{s}", phase="update", flops=p.update_flops,
                bytes_accessed=p.update_bytes, attrs={"stage": s}))
            if self.dp > 1:
                ar = g.add_task(Task(
                    name=f"stage{s}:allreduce", kind=TaskKind.COLLECTIVE,
                    thread=DP_CHANNEL,
                    duration=cost.collectives.group_time(
                        "all-reduce", p.grad_bytes, self.dp),
                    comm_bytes=p.grad_bytes, phase="comm",
                    attrs={"collective": "all-reduce",
                           "group_size": self.dp, "stage": s}))
                g.add_edge(last_bwd, ar)
                g.add_edge(ar, upd)
            out.append(g)
        return out

    # ------------------------------------------------------------ placing
    def place(self, workers: Optional[Union[int, Sequence[WorkerSpec]]]
              = None, *, cost: Optional[CostModel] = None,
              collective_mode: str = "ring",
              sched_fn: Optional[ScheduleFn] = None,
              templates: Optional[Sequence[DependencyGraph]] = None
              ) -> ClusterGraph:
        """Place the plan onto workers and return the global cluster graph.

        ``workers`` must provide one :class:`WorkerSpec` per (stage,
        replica) slot — ``stages * dp`` total (default: uniform).  Stage
        boundaries become provenance-carrying point-to-point COMM legs
        (DCN when the placed link crosses pods), per-stage gradient
        all-reduces become scoped cross-worker structures in
        ``collective_mode``, and the whole build retunes like any other
        :class:`ClusterGraph` — bandwidth/straggler sweeps reuse it.
        Pass ``templates`` (e.g. transformed by a what-if stack) to place
        pre-built stage graphs; they must match this plan's layout.
        """
        specs = [WorkerSpec() for _ in range(self.num_workers)] \
            if workers is None else _as_specs(workers)
        if len(specs) != self.num_workers:
            raise GraphError(
                f"plan places {self.num_stages} stage(s) x {self.dp} "
                f"replica(s) = {self.num_workers} worker(s), got "
                f"{len(specs)} WorkerSpec(s)")
        if collective_mode not in ("ring", "hierarchical", "fused"):
            raise GraphError(f"unknown collective_mode {collective_mode!r}")
        cost = cost or CostModel()
        S, M, dp = self.num_stages, self.microbatches, self.dp
        tmpls = list(templates) if templates is not None \
            else self.stage_templates(cost)
        if len(tmpls) != S:
            raise GraphError(
                f"plan has {S} stage(s) but {len(tmpls)} template(s)")
        cg = ClusterGraph(DependencyGraph(), specs, cost, sched_fn,
                          collective_mode)
        remaps = [cg._clone_worker(w, specs[w], tmpls[w // dp],
                                   comm_prov=False)
                  for w in range(self.num_workers)]
        # index each template's schedule tasks by role/microbatch
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
                    # the template's own gradient ring ("stage" attr), not a
                    # collective a post-placement what-if stack inserted
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
            missing = [m for m in range(M)
                       if m not in fwds[s] or m not in bwds[s]]
            if missing or (s < S - 1 and len(acts[s]) != M) \
                    or (s > 0 and len(grads[s]) != M):
                raise GraphError(
                    f"stage {s} template does not cover all {M} "
                    f"microbatch(es) of this plan")
        for r in range(dp):
            for s in range(S - 1):
                src_w = self.worker_index(s, r)
                dst_w = self.worker_index(s + 1, r)
                for m in range(M):
                    cg.wire_p2p(None, remaps[dst_w][fwds[s + 1][m].uid],
                                src_w, dst_w,
                                leg=remaps[src_w][acts[s][m].uid])
            for s in range(1, S):
                src_w = self.worker_index(s, r)
                dst_w = self.worker_index(s - 1, r)
                for m in range(M):
                    cg.wire_p2p(None, remaps[dst_w][bwds[s - 1][m].uid],
                                src_w, dst_w,
                                leg=remaps[src_w][grads[s][m].uid])
        if dp > 1:
            for s in range(S):
                if ars[s] is None:
                    raise GraphError(
                        f"stage {s} template lost its gradient all-reduce; "
                        f"dp={dp} placement cannot wire the stage ring")
                ids = [self.worker_index(s, r) for r in range(dp)]
                cg.wire_collective_group(
                    "all-reduce", [remaps[w][ars[s].uid] for w in ids],
                    worker_ids=ids)
        return cg._finish()

    def fold_place(self, workers: Optional[Union[int, Sequence[WorkerSpec]]]
                   = None, *, cost: Optional[CostModel] = None,
                   collective_mode: str = "ring",
                   sched_fn: Optional[ScheduleFn] = None,
                   templates: Optional[Sequence[DependencyGraph]] = None):
        """Symmetry-folded :meth:`place`: one representative per stage.

        When every replica of a stage shares an identical
        :class:`WorkerSpec`, the ``dp`` data-parallel replicas are
        equivalence classes — folding materializes ``stages`` workers
        instead of ``stages * dp`` and closes the gradient rings
        algebraically over the class size.  Returns ``None`` whenever the
        exactness contract does not hold (``dp < 2``, hierarchical mode,
        non-uniform stage replicas); callers fall back to :meth:`place`.
        """
        from repro_torch.core.fold import fold_plan
        return fold_plan(self, workers, cost=cost,
                         collective_mode=collective_mode,
                         sched_fn=sched_fn, templates=templates)
