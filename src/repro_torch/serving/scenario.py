"""ServingScenario: request-level what-ifs through the optimization registry.

This is the routing layer that makes serving policies first-class citizens
of the unified what-if API: ``continuous_batching``, ``chunked_prefill``,
``tp``, ``kv_offload`` and ``static_slots`` are *registered optimizations*
like ``amp`` or ``ddp`` — they parse from CLI stack specs, compose with
``|`` / ``Stack``, sweep over parameter grids, and report headroom bounds —
but instead of rewriting an existing graph they *adjust the
serving policy* and the scenario regenerates the request graph from the
workload (a policy change rewires which task waits on which; it is not
expressible as a duration rewrite).

Stack semantics on a :class:`ServingScenario`: serving-policy members fold
into the policy left-to-right, every other member (``bandwidth``, graph
rewrites, headroom wrappers) applies as a normal
:class:`~repro_torch.core.transform.GraphTransform` over the regenerated graph.
``tp:degree=8`` shards the cost model and routes the graph through
:meth:`repro_torch.core.cluster.ClusterGraph.build`, which wires each per-step
all-reduce task into real ring legs across the 8 workers — the same
cluster machinery training what-ifs use.

Results are :class:`ServingPrediction`\\ s — a :class:`Prediction` plus
p50/p99 TTFT, per-output-token latency (TPOT), end-to-end latency,
goodput (generated tokens per simulated second) and per-lane utilization —
so ``.speedup``, ``.critical_path`` and the report/diff tooling work
unchanged.

Headroom bounds: the serving-policy optimizations target every *engine*
task (prefill/decode/collective/DMA/gates) but never the arrival process,
so erasing the targets leaves the open-loop arrival chain intact and the
idealized makespan is exactly the last arrival — a floor no policy can
beat, which makes ``opportunity_bound`` >= any realizable policy's speedup
(the acceptance criterion golden-tested in ``tests/test_serving.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.cluster import ClusterGraph, WorkerSpec
from repro_torch.core.graph import DependencyGraph
from repro_torch.core.optimize import (Optimization, OptimizationError,
                                       Prediction, Scenario, Stack, register)
from repro_torch.core.simulate import SimResult, lane_utilization, simulate
from repro_torch.core.task import Task
from repro_torch.core.transform import GraphTransform
from .costs import ServingCostModel
from .graphgen import (ServingGraph, ServingPolicy, build_serving_graph,
                       slot_lane_classes)
from .workload import Workload

# attrs["serving"] values of engine work (everything but the arrival
# process) — the serving optimizations' headroom-erasure target set
_ENGINE_WORK = ("prefill", "decode", "coll", "dma", "gate")


def _engine_task(t: Task) -> bool:
    return t.attrs.get("serving") in _ENGINE_WORK


# ==================================================== serving optimizations
class ServingOptimization(Optimization):
    """Base for registered optimizations that adjust the serving policy.

    They cannot transform an arbitrary training graph (a batching policy
    is a graph *generator* choice), so :meth:`build` raises — the
    :class:`PipelineParallel` pattern — and :class:`ServingScenario`
    intercepts them via :meth:`adjust` before graph generation instead.
    """

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        raise OptimizationError(
            f"{self.name!r} is a serving-policy optimization; evaluate it "
            f"via a repro_torch.serving.ServingScenario (it regenerates the "
            f"request graph rather than rewriting an existing one)")

    def adjust(self, policy: ServingPolicy) -> ServingPolicy:
        raise NotImplementedError

    def headroom_targets(self, s: Scenario
                         ) -> Optional[Callable[[Task], bool]]:
        """Erase all engine work, keep arrivals: the idealized makespan is
        the last arrival — the open-loop floor every policy obeys, so the
        bound always covers the realized speedup.  On non-serving graphs
        the predicate matches nothing (bound exactly 1.0x, ranked out)."""
        return _engine_task


@register("continuous_batching", "cb")
@dataclasses.dataclass(frozen=True)
class ContinuousBatching(ServingOptimization):
    """Admit/retire requests at every decode-step boundary instead of
    draining whole static batches.  ``slots=0`` keeps the scenario
    policy's slot count."""

    slots: int = 0

    def adjust(self, policy: ServingPolicy) -> ServingPolicy:
        kw: Dict[str, Any] = {"mode": "continuous"}
        if self.slots:
            kw["slots"] = self.slots
        return dataclasses.replace(policy, **kw)


@register("static_slots")
@dataclasses.dataclass(frozen=True)
class StaticSlots(ServingOptimization):
    """Seed-engine semantics: admit a batch, drain it completely.
    ``slots=0`` keeps the scenario policy's slot count."""

    slots: int = 0

    def adjust(self, policy: ServingPolicy) -> ServingPolicy:
        kw: Dict[str, Any] = {"mode": "static"}
        if self.slots:
            kw["slots"] = self.slots
        return dataclasses.replace(policy, **kw)

    def headroom_targets(self, s: Scenario
                         ) -> Optional[Callable[[Task], bool]]:
        return None     # restructures batching; no shrink-only bound


@register("chunked_prefill")
@dataclasses.dataclass(frozen=True)
class ChunkedPrefill(ServingOptimization):
    """Split prompts into ``chunk``-token pieces that ride along decode
    steps instead of stalling them (TTFT interference removal)."""

    chunk: int = 512

    def __post_init__(self) -> None:
        if self.chunk < 1:
            raise OptimizationError(
                f"chunked_prefill needs chunk >= 1 tokens, got {self.chunk}")

    def adjust(self, policy: ServingPolicy) -> ServingPolicy:
        return dataclasses.replace(policy, prefill_chunk=self.chunk)


@register("tp", "tensor_parallel")
@dataclasses.dataclass(frozen=True)
class TensorParallelServing(ServingOptimization):
    """Shard the model over ``degree`` chips: per-chip FLOPs/weights/KV
    divide, and each decode step gains an all-reduce that the cluster
    simulator wires into a real ring across the workers."""

    degree: int = 8

    def __post_init__(self) -> None:
        if self.degree < 1:
            raise OptimizationError(
                f"tp needs degree >= 1, got {self.degree}")

    def adjust(self, policy: ServingPolicy) -> ServingPolicy:
        return dataclasses.replace(policy, tp_degree=self.degree)


@register("kv_offload")
@dataclasses.dataclass(frozen=True)
class KVOffload(ServingOptimization):
    """Admit past the device KV capacity and stream the excess residency
    over PCIe every step (adds DMA work; trades latency for admission)."""

    def adjust(self, policy: ServingPolicy) -> ServingPolicy:
        return dataclasses.replace(policy, kv_offload=True)

    def headroom_targets(self, s: Scenario
                         ) -> Optional[Callable[[Task], bool]]:
        return None     # adds work / restructures admission; no bound


def _split_serving(opt: Optimization
                   ) -> Tuple[List[ServingOptimization],
                              Optional[Optimization]]:
    """Partition a (possibly stacked) optimization into the serving-policy
    members (folded into the policy, in order) and the residual
    graph-transforming stack (``None`` when empty).  Headroom wrappers and
    other non-stack composites stay whole in the residual."""
    members = opt.opts if isinstance(opt, Stack) else (opt,)
    serving = [o for o in members if isinstance(o, ServingOptimization)]
    rest = [o for o in members if not isinstance(o, ServingOptimization)]
    if not serving:
        return [], opt
    if not rest:
        return serving, None
    return serving, (rest[0] if len(rest) == 1 else Stack(*rest))


# ============================================================== prediction
@dataclasses.dataclass
class ServingPrediction(Prediction):
    """A :class:`Prediction` plus request-level latency/goodput metrics.

    Latency percentiles are nearest-rank over per-request samples; TTFT is
    first-token finish minus arrival, TPOT the mean inter-token time of a
    request's decode stream, latency the full arrival->last-token span.
    ``goodput`` is generated tokens per simulated second of makespan.
    """

    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    tpot_p50: float = 0.0
    tpot_p99: float = 0.0
    latency_p50: float = 0.0
    latency_p99: float = 0.0
    goodput: float = 0.0
    tokens_generated: int = 0
    requests_completed: int = 0
    lane_util: Dict[str, float] = dataclasses.field(default_factory=dict)
    # folded slot-lane view: "slot:<rep> x<count>" -> utilization, one
    # entry per symmetry class (see graphgen.slot_lane_classes)
    slot_classes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:
        return (f"ServingPrediction({self.optimization.spec()}: "
                f"ttft p50/p99 {self.ttft_p50*1e3:.2f}/"
                f"{self.ttft_p99*1e3:.2f}ms, "
                f"goodput {self.goodput:.1f} tok/s, "
                f"{self.speedup:.2f}x)")


def _pct(samples: List[float], q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))
    return s[k]


def serving_metrics(graph: DependencyGraph, result: SimResult,
                    workload: Workload, *, prefix: str = ""
                    ) -> Dict[str, Any]:
    """Extract request-level metrics from a simulated serving graph.

    Scans DECODE tasks by their ``attrs`` (rid/tok), so it works on the
    single-graph route and — with ``prefix="w0/"`` — on the cluster
    route's namespaced global graph (every worker replays the same decode
    stream; worker 0 is representative).
    """
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    count: Dict[int, int] = {}
    total = 0
    for t in graph.tasks():
        if t.attrs.get("serving") != "decode":
            continue
        if prefix and not t.thread.startswith(prefix):
            continue
        rid = t.attrs["rid"]
        f = result.finish[t.uid]
        total += 1
        count[rid] = count.get(rid, 0) + 1
        if rid not in first or f < first[rid]:
            first[rid] = f
        if rid not in last or f > last[rid]:
            last[rid] = f
    ttft: List[float] = []
    tpot: List[float] = []
    latency: List[float] = []
    completed = 0
    for r in workload.requests:
        if r.rid not in first:
            continue
        ttft.append(first[r.rid] - r.arrival)
        latency.append(last[r.rid] - r.arrival)
        n = count[r.rid]
        if n > 1:
            tpot.append((last[r.rid] - first[r.rid]) / (n - 1))
        if n >= r.output_tokens:
            completed += 1
    util = lane_utilization(result)
    if prefix:
        util = {th[len(prefix):]: u for th, u in util.items()
                if th.startswith(prefix)}
    slot_classes = {
        f"slot:{members[0]}" + (f" x{len(members)}"
                                if len(members) > 1 else ""):
        util.get(f"slot:{members[0]}", 0.0)
        for members in slot_lane_classes(result, prefix=prefix)}
    return {
        "ttft_p50": _pct(ttft, 0.50), "ttft_p99": _pct(ttft, 0.99),
        "tpot_p50": _pct(tpot, 0.50), "tpot_p99": _pct(tpot, 0.99),
        "latency_p50": _pct(latency, 0.50),
        "latency_p99": _pct(latency, 0.99),
        "goodput": total / result.makespan if result.makespan > 0 else 0.0,
        "tokens_generated": total,
        "requests_completed": completed,
        "lane_util": util,
        "slot_classes": slot_classes,
    }


# ================================================================ scenario
@dataclasses.dataclass
class ServingScenario(Scenario):
    """A :class:`Scenario` whose baseline graph is *generated* from an
    open-loop workload under a serving policy.

    ``workload``/``serving_cost``/``policy`` replace the training
    scenario's profiled graph as ground truth; ``predict``/``evaluate``/
    ``sweep``/``diff_against``/``opportunity`` all work, returning
    :class:`ServingPrediction`\\ s.  ``workers`` stays 1 — multi-chip
    routing is decided by the (possibly what-if-adjusted) policy's
    ``tp_degree``, which builds the namespaced cluster graph with real
    collective rings.
    """

    workload: Optional[Workload] = None
    policy: ServingPolicy = dataclasses.field(default_factory=ServingPolicy)
    serving_cost: ServingCostModel = dataclasses.field(
        default_factory=ServingCostModel)

    def __post_init__(self) -> None:
        if self.workload is None:
            raise OptimizationError(
                "ServingScenario needs a repro_torch.serving.Workload")
        self._sgraph = build_serving_graph(self.workload, self.serving_cost,
                                           self.policy)
        if self.graph is None:
            self.graph = self._sgraph.graph
        super().__post_init__()

    # ------------------------------------------------------------- routing
    def _evaluate(self, opt: Optimization, *,
                  baseline: Optional[float] = None,
                  point: Optional[Dict[str, Any]] = None,
                  reuse: bool = True
                  ) -> Tuple[ServingPrediction, GraphTransform,
                             Optional[ClusterGraph]]:
        base = self.baseline().makespan if baseline is None else baseline
        serving, residual = _split_serving(opt)
        policy = self.policy
        for so in serving:
            policy = so.adjust(policy)
        fresh = policy != self.policy
        sg = build_serving_graph(self.workload, self.serving_cost, policy) \
            if fresh else self._sgraph
        # a fresh graph is ours to mutate; the cached baseline graph must
        # be copied before a residual stack rewrites it
        tf = GraphTransform(sg.graph,
                            copy=(not fresh) and residual is not None)
        if residual is not None:
            residual.build(self, tf)
        pt = dict(point or {})
        if policy.tp_degree > 1:
            cg = ClusterGraph.build(
                tf.graph, [WorkerSpec() for _ in range(policy.tp_degree)],
                cost=self.cost, collective_mode=self.collective_mode,
                schedule=tf.schedule)
            cres = cg.simulate()
            metrics = serving_metrics(cg.graph, cres.global_result,
                                      self.workload, prefix="w0/")
            return (ServingPrediction(opt, base, cres.makespan,
                                      cres.global_result, cres, pt,
                                      graph=cg.graph, schedule=cg.schedule,
                                      byte_maps=self._byte_maps(),
                                      **metrics), tf, cg)
        res = simulate(tf.graph, tf.schedule)
        metrics = serving_metrics(tf.graph, res, self.workload)
        return (ServingPrediction(opt, base, res.makespan, res, None, pt,
                                  graph=tf.graph, schedule=tf.schedule,
                                  byte_maps=self._byte_maps(),
                                  **metrics), tf, None)

    def sweep(self, opt, grid, *, reuse: bool = True
              ) -> List[ServingPrediction]:
        """Grid sweep; serving points never share builds (a policy change
        regenerates the graph, and the base sweep's reuse fast paths
        construct plain :class:`Prediction`\\ s that would drop the
        latency metrics), so ``reuse`` is forced off."""
        return super().sweep(opt, grid, reuse=False)

    # ------------------------------------------------------------- helpers
    def serving_graph(self, opt: Union[str, Optimization, None] = None
                      ) -> ServingGraph:
        """The generated :class:`ServingGraph` for the baseline policy or
        for a (possibly stacked) what-if's folded policy — bookkeeping
        (tokens emitted, step counts) for tests and reports."""
        if opt is None:
            return self._sgraph
        from repro_torch.core.optimize import _resolve
        serving, _ = _split_serving(_resolve(opt))
        policy = self.policy
        for so in serving:
            policy = so.adjust(policy)
        if policy == self.policy:
            return self._sgraph
        return build_serving_graph(self.workload, self.serving_cost, policy)


# ================================================================= report
def format_serving_table(preds: List[ServingPrediction]) -> str:
    """Fixed-width latency/goodput table for the serve_sim CLI."""
    hdr = (f"{'what-if':<44} {'ttft p50':>9} {'ttft p99':>9} "
           f"{'tpot p50':>9} {'lat p99':>9} {'goodput':>10} {'speedup':>8}")
    lines = [hdr, "-" * len(hdr)]
    for p in preds:
        spec = p.optimization.spec()
        if len(spec) > 43:
            spec = spec[:40] + "..."
        lines.append(
            f"{spec:<44} {p.ttft_p50*1e3:>7.2f}ms {p.ttft_p99*1e3:>7.2f}ms "
            f"{p.tpot_p50*1e3:>7.2f}ms {p.latency_p99*1e3:>7.2f}ms "
            f"{p.goodput:>6.1f}t/s {p.speedup:>7.2f}x")
    return "\n".join(lines)
