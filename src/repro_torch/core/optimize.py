"""Unified optimization / scenario API: composable what-ifs over one registry.

Daydream's promise is that optimizations are *graph-transformation
primitives* practitioners can stack and compare (paper §4.4, §5).  This
module is the one entry point for that promise:

* :class:`Optimization` — a named, typed-parameter graph transformation
  (``apply(scenario) -> GraphTransform``).  Every modeled optimization is a
  frozen dataclass registered under a string name via :func:`register`, so
  CLIs and search drivers construct them from ``name:param=value`` specs
  (:func:`parse_stack`).
* :class:`Scenario` — the context an optimization is evaluated in: the
  baseline graph, :class:`~repro_torch.core.costmodel.CostModel`, per-layer
  gradient/activation byte maps, and a worker spec.  Per-optimization
  kwargs (``layer_grad_bytes`` here, ``activation_bytes`` there,
  ``num_workers`` vs ``workers``) are no longer threaded by hand.
* :class:`Stack` / the ``|`` operator — composition with well-defined
  ordering: ``A | B`` applies A to the baseline, then B to A's output
  (left-to-right).  Stacks flatten, so composition is associative.
* :class:`Prediction` — the unified result: baseline/predicted makespan,
  ``speedup``, and (on the cluster route) the per-worker
  :class:`~repro_torch.core.cluster.ClusterResult` breakdown.
* :meth:`Scenario.sweep` — parameter-grid evaluation (bandwidth scales,
  straggler slowdowns, bucket sizes, worker counts) that reuses one
  :class:`~repro_torch.core.cluster.ClusterGraph` build and one base-graph copy
  across points (via :meth:`ClusterGraph.retune`) instead of rebuilding
  per point.

Cluster routing is decided by the scenario's worker spec, not by which
function you called: ``workers=N`` (an int) takes the paper's analytical
single-graph route (collective costs spliced into one timeline), while
``workers=[WorkerSpec(...), ...]`` routes through the dPRO-style global
:class:`ClusterGraph` and yields a per-worker breakdown.

Paper-algorithm -> registered-name map (Algorithms 3-12, §5 + Appendix A):

    ======  =======================  ===============================
    Alg  3  AMP                      ``amp``
    Alg  4  FusedAdam                ``fused_optimizer`` / ``fusedadam``
    Alg  5  Reconstructing BN        ``fused_norm``
    Alg  6  DDP insertion            ``ddp`` / ``distributed``
    Alg  7  P3                       ``p3``
    Alg  8  BlueConnect              ``blueconnect``
    Alg  9  MetaFlow                 ``remove_layer``, ``scale_layer``
    Alg 10  vDNN                     ``offload`` / ``vdnn``
    Alg 11  Gist                     ``gist``
    Alg 12  DGC                      ``dgc``
    beyond  ZeRO sharding            ``zero``
    beyond  async collectives        ``overlap`` / ``overlap_collectives``
    beyond  straggler                ``straggler``
    beyond  bandwidth scaling        ``bandwidth``
    beyond  gradient accumulation    ``grad_accum``
    beyond  pipeline / hybrid PPxDP  ``pipeline`` / ``pp``
    beyond  identity / baseline      ``noop``
    ======  =======================  ===============================

``pipeline`` is a *placement*, not a graph rewrite: the scenario's profile
is partitioned into stages (:mod:`repro_torch.parallel.plan`) and placed onto
``stages * dp`` workers through the real cluster simulator.  In a stack,
optimizations *before* ``pipeline`` transform the single-worker profile
(so the partition sees their effect); optimizations *after* it transform
each stage's schedule template (so ``pipeline|amp|dgc`` speeds stage
compute, shrinks hop payloads, and compresses the per-stage gradient
rings) before the plan wires the global graph.  A pre-stack that *inserts*
communication (``ddp|pipeline``, ``zero|pipeline``) is rejected loudly —
the compute-only partition would silently drop it; use ``pipeline:dp=N``
for data parallelism.

Scenarios built from *real traces* (``Scenario(trace_dir=...)`` — see
:mod:`repro_torch.traceio`) run every registered optimization on the imported
per-worker graphs: the stack transforms each worker's graph and the
prediction comes from the asymmetric global
:meth:`ClusterGraph.from_worker_graphs` build.

The legacy ``repro_torch.core.whatif.what_if_*`` / ``cluster_what_if_*`` functions
are thin wrappers over these registered optimizations.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
import math
import typing
from typing import (Any, Callable, ClassVar, Dict, List, Optional, Sequence,
                    Tuple, Union)

from repro_torch.obs.spans import span as _span

from .cluster import ClusterGraph, ClusterResult, WorkerSpec, _as_specs
from .costmodel import CollectiveModel, CostModel
from .graph import DependencyGraph
from .layermap import bucket_layers
from .simulate import SimResult, simulate
from .task import (Task, TaskKind, DEVICE_STREAM, DMA_CHANNEL, HOST_THREAD,
                   ici_channel)
from .transform import (GraphTransform, all_of, by_layer, by_name, by_phase,
                        on_device)

GRAD_CHANNEL = ici_channel("grad")

# Scenario fields a CLI stack spec / sweep grid may override per point.
_SCENARIO_OVERRIDES = ("workers", "collective_mode")

# "auto" symmetry folding kicks in at this cluster size: below it the
# materialized build is already interactive and stays byte-identical with
# historical behavior; above it O(classes) simulation is what keeps
# predict/sweep interactive (see repro_torch.core.fold).
_FOLD_AUTO_MIN_WORKERS = 64


class OptimizationError(ValueError):
    """Bad optimization name, parameter, or scenario for the optimization."""


# ============================================================== registry
_REGISTRY: Dict[str, type] = {}


def register(name: str, *aliases: str, algorithm: str = ""
             ) -> Callable[[type], type]:
    """Class decorator: register an :class:`Optimization` under ``name``.

    ``algorithm`` records the paper-algorithm label for docs/reports.
    """
    def deco(cls: type) -> type:
        cls.name = name
        cls.algorithm = algorithm
        for n in (name,) + aliases:
            key = n.lower()
            if key in _REGISTRY:
                raise OptimizationError(f"duplicate optimization name {n!r}")
            _REGISTRY[key] = cls
        return cls
    return deco


def get_optimization(name: str) -> type:
    """Look up a registered :class:`Optimization` class by name or alias."""
    cls = _REGISTRY.get(name.lower())
    if cls is None:
        raise OptimizationError(
            f"unknown optimization {name!r}; available: "
            f"{', '.join(available())}")
    return cls


def available() -> List[str]:
    """Primary (non-alias) registered optimization names, sorted."""
    return sorted({cls.name for cls in _REGISTRY.values()})


# ============================================================== scenario
@dataclasses.dataclass
class Scenario:
    """Everything an optimization needs to be evaluated, in one object.

    ``workers`` decides the routing: an ``int`` keeps the paper's analytical
    single-graph route; a sequence of :class:`WorkerSpec` routes through the
    global :class:`ClusterGraph` (per-worker breakdown, heterogeneous
    clusters, ``collective_mode`` selectable).

    ``trace_dir`` (or a pre-loaded ``traces``
    :class:`repro_torch.traceio.ImportedCluster`) takes the *trace route*: N
    per-worker profiler traces (Chrome trace-event JSON / native JSONL) are
    clock-aligned and imported as per-worker graphs, every optimization in
    the stack is applied to each worker's graph, and the prediction comes
    from the asymmetric global graph
    (:meth:`ClusterGraph.from_worker_graphs`).  ``workers`` then defaults to
    uniform specs matching the trace count — the traces already encode real
    per-worker speeds — and explicit specs layer what-if scaling on top.
    """

    graph: Optional[DependencyGraph] = None
    cost: Optional[CostModel] = None
    layer_grad_bytes: Optional[Dict[str, float]] = None
    activation_bytes: Optional[Dict[str, float]] = None
    workers: Union[int, Sequence[WorkerSpec]] = 1
    collective_mode: str = "ring"
    trace_dir: Optional[str] = None
    traces: Optional[Any] = None       # repro_torch.traceio.ImportedCluster
    # symmetry folding (repro_torch.core.fold): True forces it, False disables,
    # "auto" (default) folds clusters of >= _FOLD_AUTO_MIN_WORKERS workers.
    # Folding is exact (bit-identical results) and silently falls back to
    # full materialization when the worker mix cannot fold.
    fold: Any = "auto"

    _baseline: Optional[SimResult] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # stage-partition cache for the pipeline route: (pre-stack spec, stages)
    # -> StageProfile tuple.  Partitioning scans the whole profile (O(V));
    # microbatch/schedule sweep points reuse it and rebuild only the
    # O(S*M) schedule graph.
    _plan_cache: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.cost is None:
            self.cost = CostModel()
        if self.trace_dir is not None and self.traces is None:
            from repro_torch.traceio import load_trace_dir
            self.traces = load_trace_dir(self.trace_dir)
        if self.traces is not None:
            n = len(self.traces.graphs)
            if isinstance(self.workers, int):
                if self.workers not in (1, n):
                    raise OptimizationError(
                        f"scenario has {n} trace worker(s) but workers="
                        f"{self.workers}; leave workers unset or pass one "
                        f"WorkerSpec per trace")
                self.workers = [WorkerSpec() for _ in range(n)]
            elif len(list(self.workers)) != n:
                raise OptimizationError(
                    f"scenario has {n} trace worker(s) but "
                    f"{len(list(self.workers))} WorkerSpec(s)")
            if self.graph is None:
                self.graph = self.traces.graphs[0]
        if self.graph is None:
            raise OptimizationError(
                "Scenario needs a baseline graph or trace_dir/traces")

    # ------------------------------------------------------------ routing
    @property
    def is_cluster(self) -> bool:
        return self.traces is not None or not isinstance(self.workers, int)

    @property
    def specs(self) -> List[WorkerSpec]:
        return _as_specs(self.workers)

    @property
    def num_workers(self) -> int:
        return self.workers if isinstance(self.workers, int) \
            else len(list(self.workers))

    def _fold_enabled(self, n: Optional[int] = None) -> bool:
        """Whether to try symmetry folding for an ``n``-worker build."""
        if self.fold is True:
            return True
        if self.fold == "auto":
            return (self.num_workers if n is None else n) \
                >= _FOLD_AUTO_MIN_WORKERS
        return False

    # ----------------------------------------------------------- accessors
    @property
    def grads(self) -> Dict[str, float]:
        if self.layer_grad_bytes is None:
            raise OptimizationError(
                "this optimization needs Scenario.layer_grad_bytes "
                "(per-layer gradient payload bytes)")
        return self.layer_grad_bytes

    @property
    def acts(self) -> Dict[str, float]:
        if self.activation_bytes is None:
            raise OptimizationError(
                "this optimization needs Scenario.activation_bytes "
                "(per-layer activation bytes)")
        return self.activation_bytes

    def transform(self) -> GraphTransform:
        """A fresh mutable what-if session over a copy of the baseline."""
        return GraphTransform(self.graph)

    def baseline(self) -> SimResult:
        """Simulated baseline, cached.

        Single-graph and replicate-cluster routes simulate the one baseline
        graph; the trace route simulates the imported (untransformed)
        cluster — the traces *are* the distributed baseline.
        """
        if self._baseline is None:
            if self.traces is not None:
                self._baseline = self._trace_cluster(
                    self.traces.graphs).simulate().global_result
            else:
                self._baseline = simulate(self.graph)
        return self._baseline

    def _trace_cluster(self, graphs: Sequence[DependencyGraph],
                       schedule: Any = None) -> ClusterGraph:
        return ClusterGraph.from_worker_graphs(
            graphs, self.specs, cost=self.cost,
            collective_mode=self.collective_mode, schedule=schedule,
            start_skews=self.traces.start_skews)

    # ----------------------------------------------------------- evaluate
    def predict(self, opt: Union[str, "Optimization"],
                **params: Any) -> "Prediction":
        """Apply ``opt`` (instance, name, or ``name:param=value`` spec) and
        simulate; routing per the worker spec."""
        pred, _, _ = self._evaluate(_resolve(opt, params))
        return pred

    def evaluate(self, opt: Union[str, "Optimization"], **params: Any
                 ) -> Tuple["Prediction", GraphTransform,
                            Optional[ClusterGraph]]:
        """:meth:`predict` plus the applied transform and (cluster routes)
        the built :class:`ClusterGraph` — for exporters and drivers that
        need the predicted graph itself (e.g. ``perf_report
        --export-trace``)."""
        return self._evaluate(_resolve(opt, params))

    def diff_against(self, traces: Any,
                     opt: Union[str, "Optimization"] = "noop"):
        """Diff this scenario's predicted timeline against a captured
        per-worker trace set, task-by-task (paper §6's validation
        methodology as a reusable tool — see :mod:`repro_torch.analysis.diff`).

        ``traces`` is a trace directory or a pre-loaded
        :class:`repro_torch.traceio.ImportedCluster`; ``opt`` defaults to
        ``"noop"`` (how faithfully does the simulator reproduce the
        capture), and any registered stack answers "how far is reality
        from the predicted optimized timeline".  Returns a
        :class:`repro_torch.analysis.TraceDiff`.
        """
        from repro_torch.analysis import diff_prediction
        pred, tf, cg = self.evaluate(opt)
        return diff_prediction(pred, tf, cg, traces)

    def calibrate(self, traces: Any = None, **kwargs):
        """Fit this scenario's :class:`CostModel` constants against a
        captured trace set (default: the scenario's own capture) by
        iterating simulate → :meth:`diff_against` → refit through the real
        simulator — dPRO's trace-fitted-replayer loop (see
        :mod:`repro_torch.analysis.calibrate`).

        Returns ``(calibrated_scenario, CalibrationReport)``; this
        scenario is not mutated, so before/after what-ifs can be compared
        side by side.  Keyword arguments (``constants``, ``max_rounds``,
        ``tol``, ``probes_per_constant``) pass through to
        :func:`repro_torch.analysis.calibrate.calibrate_scenario`.
        """
        from repro_torch.analysis.calibrate import calibrate_scenario
        return calibrate_scenario(self, traces, **kwargs)

    def _byte_maps(self) -> Tuple[Optional[Dict[str, float]],
                                  Optional[Dict[str, float]]]:
        """What every Prediction carries so ``.timelines`` can size its
        live-memory series without re-threading the scenario."""
        return (self.activation_bytes, self.layer_grad_bytes)

    def _evaluate(self, opt: "Optimization", *,
                  baseline: Optional[float] = None,
                  point: Optional[Dict[str, Any]] = None,
                  reuse: bool = True
                  ) -> Tuple["Prediction", GraphTransform,
                             Optional[ClusterGraph]]:
        base = self.baseline().makespan if baseline is None else baseline
        pre, pipe, post = _split_pipeline(opt)
        if pipe is not None:
            return self._evaluate_pipeline(opt, pre, pipe, post, base,
                                           point or {}, reuse)
        if self.traces is not None:
            # trace route: the optimization transforms *each* worker's own
            # graph (workers run the same program, so the same rewrite
            # applies per worker), then the asymmetric global graph is
            # rebuilt from the transformed per-worker graphs.
            tfs = []
            for wg in self.traces.graphs:
                tf = GraphTransform(wg)
                opt.build(self, tf)
                tfs.append(tf)
            cg = self._trace_cluster([tf.graph for tf in tfs],
                                     schedule=tfs[0].schedule)
            cres = cg.simulate()
            return (Prediction(opt, base, cres.makespan, cres.global_result,
                               cres, point or {}, graph=cg.graph,
                               schedule=cg.schedule,
                               byte_maps=self._byte_maps()), tfs[0], cg)
        tf = opt.apply(self)
        if self.is_cluster:
            cg = None
            if self._fold_enabled():
                from .fold import fold_cluster
                cg = fold_cluster(tf.graph, self.specs, cost=self.cost,
                                  collective_mode=self.collective_mode,
                                  schedule=tf.schedule)
            if cg is None:
                cg = ClusterGraph.build(tf.graph, self.specs,
                                        cost=self.cost,
                                        collective_mode=self.collective_mode,
                                        schedule=tf.schedule)
            cres = cg.simulate()
            return (Prediction(opt, base, cres.makespan, cres.global_result,
                               cres, point or {}, graph=cg.graph,
                               schedule=cg.schedule,
                               byte_maps=self._byte_maps()), tf, cg)
        res = tf.simulate()
        return Prediction(opt, base, res.makespan, res, None, point or {},
                          graph=tf.graph, schedule=tf.schedule,
                          byte_maps=self._byte_maps()), \
            tf, None

    # ------------------------------------------------------ pipeline route
    def _evaluate_pipeline(self, opt: "Optimization",
                           pre: Optional["Optimization"],
                           pipe: "PipelineParallel",
                           post: Optional["Optimization"], base: float,
                           point: Dict[str, Any], reuse: bool
                           ) -> Tuple["Prediction", GraphTransform,
                                      Optional[ClusterGraph]]:
        """Place a pipeline/hybrid plan and simulate it on the cluster path.

        Stack semantics: ``pre`` (everything left of ``pipeline``)
        transforms the single-worker profile before partitioning; ``post``
        (everything right of it) transforms each stage's schedule template
        before placement — so AMP shrinks hop payloads and DGC compresses
        the per-stage gradient rings.  The stage partition is cached per
        (pre-stack, stages) so microbatch/schedule sweep points skip the
        O(V) profile scan (``reuse=False`` bypasses the cache).
        """
        from repro_torch.parallel.plan import ParallelPlan, partition_stages
        if self.traces is not None:
            raise OptimizationError(
                "pipeline placement re-partitions a single-worker profile; "
                "it is not supported on the trace route")
        key = (pre.spec() if pre is not None else "", pipe.stages)
        profiles = self._plan_cache.get(key) if reuse else None
        tf: Optional[GraphTransform] = None
        if profiles is None:
            tf = pre.apply(self) if pre is not None else self.transform()
            if pre is not None and \
                    _num_comm_tasks(tf.graph) > _num_comm_tasks(self.graph):
                # the partition places compute only; silently dropping
                # comm the pre-stack just inserted would make ddp|pipeline
                # a no-op that *looks* faster (greedy_search would pick it)
                raise OptimizationError(
                    f"optimization(s) before 'pipeline' insert "
                    f"communication tasks ({pre.spec()}) that the stage "
                    f"partition would drop; express data parallelism with "
                    f"pipeline:dp=N and stack communication what-ifs "
                    f"*after* the placement instead")
            profiles = tuple(partition_stages(
                tf.graph, pipe.stages,
                activation_bytes=self.activation_bytes,
                layer_grad_bytes=self.layer_grad_bytes))
            if reuse:
                self._plan_cache[key] = profiles
        plan = ParallelPlan(profiles, pipe.microbatches, pipe.schedule,
                            pipe.dp)
        templates = plan.stage_templates(self.cost)
        sched_fn = None
        if post is not None:
            stfs = [GraphTransform(tmpl, copy=False) for tmpl in templates]
            for stf in stfs:
                post.build(self, stf)
            sched_fn = next((stf.schedule for stf in stfs
                             if stf.schedule is not None), None)
        pspecs = self._pipeline_specs(plan)
        cg = None
        if self._fold_enabled(plan.num_workers):
            from .fold import fold_plan
            cg = fold_plan(plan, pspecs, cost=self.cost,
                           collective_mode=self.collective_mode,
                           sched_fn=sched_fn, templates=templates)
        if cg is None:
            cg = plan.place(pspecs, cost=self.cost,
                            collective_mode=self.collective_mode,
                            sched_fn=sched_fn, templates=templates)
        cres = cg.simulate()
        out_tf = tf if tf is not None \
            else GraphTransform(templates[0], copy=False)
        return (Prediction(opt, base, cres.makespan, cres.global_result,
                           cres, dict(point), graph=cg.graph,
                           schedule=cg.schedule,
                           byte_maps=self._byte_maps()), out_tf, cg)

    def _pipeline_specs(self, plan: Any) -> List[WorkerSpec]:
        """Worker specs for a plan: the scenario's list must pair 1:1 with
        the (stage, replica) slots; an int spec must be 1 (default) or the
        plan's worker count; otherwise uniform workers."""
        n = plan.num_workers
        if isinstance(self.workers, int):
            if self.workers not in (1, n):
                raise OptimizationError(
                    f"pipeline places {plan.num_stages} stage(s) x "
                    f"{plan.dp} replica(s) = {n} worker(s), but the "
                    f"scenario pins workers={self.workers}; leave workers "
                    f"unset or pass one WorkerSpec per slot")
            return [WorkerSpec() for _ in range(n)]
        specs = list(self.workers)
        if len(specs) != n:
            raise OptimizationError(
                f"pipeline places {n} worker(s) (stage-major: worker = "
                f"stage*dp + replica) but the scenario has "
                f"{len(specs)} WorkerSpec(s)")
        return specs

    # --------------------------------------------------------------- sweep
    def sweep(self, opt: Union[str, "Optimization"],
              grid: Union[Dict[str, Sequence[Any]],
                          Sequence[Dict[str, Any]]],
              *, reuse: bool = True) -> List["Prediction"]:
        """Evaluate ``opt`` across a parameter grid.

        ``grid`` maps names to value lists (evaluated as a cartesian
        product) or is an explicit sequence of point dicts.  Keys are either
        parameters of ``opt`` or the scenario fields ``workers`` /
        ``collective_mode``.

        With ``reuse=True`` (default) consecutive points share work instead
        of rebuilding from scratch: on the cluster route, points that only
        change worker specs (bandwidth scales, straggler slowdowns) retune
        one :class:`ClusterGraph` build in place
        (:meth:`ClusterGraph.retune` — exact, not approximate) and replay
        only the dirty downstream cone of the retuned tasks
        (:func:`simulate_incremental`, falling back to a full event replay
        when the cone grows too large); on the
        single-graph route, optimizations that support cheap
        re-parameterization (:meth:`Optimization.retune`) rescale the
        applied transform.  Structural changes (bucket sizes, worker
        counts) fall back to a full rebuild for that point.
        """
        base_opt = _resolve(opt)
        opt_names = set(base_opt.param_names())
        points = _expand_grid(grid)
        base = self.baseline().makespan
        preds: List[Prediction] = []
        cache: Dict[str, Any] = {"opt": None, "scn": None, "tf": None,
                                 "cg": None, "cres": None}
        for i, pt in enumerate(points):
            opt_params = {k: v for k, v in pt.items() if k in opt_names}
            over = {k: v for k, v in pt.items()
                    if k in _SCENARIO_OVERRIDES and k not in opt_names}
            unknown = set(pt) - set(opt_params) - set(over)
            if unknown:
                raise OptimizationError(
                    f"sweep grid key(s) {sorted(unknown)} are neither "
                    f"parameters of {base_opt.name!r} "
                    f"({sorted(opt_names)}) nor scenario fields "
                    f"{list(_SCENARIO_OVERRIDES)}")
            popt = base_opt.with_params(**opt_params)
            scn = dataclasses.replace(self, **over) if over else self
            with _span("scenario.sweep_point", opt=base_opt.name,
                       index=i, total=len(points)) as sp:
                pred = None
                if reuse and cache["cg"] is not None \
                        and self._cluster_reusable(popt, scn, cache):
                    cg = cache["cg"]
                    cg.retune(scn.specs)
                    cres = None
                    if cache["cres"] is not None:
                        cres = cg.simulate_incremental(cache["cres"])
                    if cres is not None:
                        sp.note(route="cluster_retune", sim="incremental",
                                dirty=len(cg.last_retune_dirty))
                    else:
                        cres = cg.simulate()
                        sp.note(route="cluster_retune", sim="full",
                                dirty=len(cg.last_retune_dirty))
                    pred = Prediction(popt, base, cres.makespan,
                                      cres.global_result, cres, dict(pt),
                                      graph=cg.graph,
                                      schedule=cg.schedule,
                                      byte_maps=scn._byte_maps())
                    cache["opt"], cache["scn"] = popt, scn
                    cache["cres"] = cres
                elif reuse and cache["tf"] is not None and not over \
                        and scn is self and not scn.is_cluster \
                        and type(popt) is type(cache["opt"]) \
                        and popt.retune(scn, cache["tf"], cache["opt"]):
                    sp.note(route="transform_retune")
                    res = simulate(cache["tf"].graph, cache["tf"].schedule)
                    pred = Prediction(popt, base, res.makespan, res, None,
                                      dict(pt), graph=cache["tf"].graph,
                                      schedule=cache["tf"].schedule,
                                      byte_maps=scn._byte_maps())
                    cache["opt"] = popt
                if pred is None:
                    sp.note(route="rebuild",
                            reason=self._rebuild_reason(popt, scn, cache,
                                                        over, reuse))
                    pred, tf, cg = scn._evaluate(popt, baseline=base,
                                                 point=dict(pt),
                                                 reuse=reuse)
                    if reuse:
                        cache.update(opt=popt, scn=scn, tf=tf, cg=cg,
                                     cres=pred.cluster)
            preds.append(pred)
        return preds

    def _cluster_reusable(self, popt: "Optimization", scn: "Scenario",
                          cache: Dict[str, Any]) -> bool:
        """Points differing only in same-length worker specs retune."""
        prev = cache["scn"]
        return (scn.is_cluster and prev is not None
                and popt == cache["opt"]
                and scn.graph is prev.graph
                and scn.traces is prev.traces
                and scn.cost is prev.cost
                and scn.layer_grad_bytes is prev.layer_grad_bytes
                and scn.activation_bytes is prev.activation_bytes
                and scn.collective_mode == prev.collective_mode
                and cache["cg"].can_retune(scn.specs))

    def _rebuild_reason(self, popt: "Optimization", scn: "Scenario",
                        cache: Dict[str, Any], over: Dict[str, Any],
                        reuse: bool) -> str:
        """Name why a sweep point fell back to a full rebuild.

        Mirrors the reuse predicates in :meth:`sweep` /
        :meth:`_cluster_reusable`, reporting the *first* failed condition
        so scale regressions show up in telemetry with a cause attached.
        """
        if not reuse:
            return "reuse_disabled"
        if cache["opt"] is None:
            return "first_point"
        prev = cache["scn"]
        if scn.is_cluster:
            if cache["cg"] is None:
                return "no_cached_cluster"
            if popt != cache["opt"]:
                return "opt_params_changed"
            if prev is None or scn.graph is not prev.graph \
                    or scn.traces is not prev.traces:
                return "graph_changed"
            if scn.cost is not prev.cost \
                    or scn.layer_grad_bytes is not prev.layer_grad_bytes \
                    or scn.activation_bytes is not prev.activation_bytes:
                return "cost_or_bytes_changed"
            if scn.collective_mode != prev.collective_mode:
                return "collective_mode_changed"
            if len(scn.specs) != len(getattr(prev, "specs", ())):
                return "worker_count_changed"
            return "retune_rejected"
        if over:
            return "scenario_override"
        if cache["tf"] is None:
            return "no_cached_transform"
        if type(popt) is not type(cache["opt"]):
            return "opt_type_changed"
        return "retune_unsupported"


# ============================================================== prediction
@dataclasses.dataclass
class Prediction:
    """Unified what-if outcome, identical across both routes.

    ``baseline``/``predicted`` are makespans in seconds; ``cluster`` is the
    per-worker :class:`ClusterResult` breakdown when the scenario routed
    through the global cluster graph, else ``None``.
    """

    optimization: "Optimization"
    baseline: float
    predicted: float
    result: SimResult
    cluster: Optional[ClusterResult] = None
    point: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the evaluated graph (cluster global graph on cluster routes) and its
    # schedule override — what Prediction.critical_path walks
    graph: Optional[DependencyGraph] = dataclasses.field(
        default=None, repr=False, compare=False)
    schedule: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    # (activation_bytes, layer_grad_bytes) from the evaluating scenario —
    # what sizes Prediction.timelines' live-memory series
    byte_maps: Optional[Tuple[Optional[Dict[str, float]],
                              Optional[Dict[str, float]]]] = \
        dataclasses.field(default=None, repr=False, compare=False)
    _cp: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _timelines: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def speedup(self) -> float:
        return (self.baseline / self.predicted if self.predicted > 0
                else float("inf"))

    @property
    def critical_path(self):
        """The predicted timeline's makespan-defining chain
        (:class:`repro_torch.analysis.CriticalPath`), extracted lazily.

        Re-simulates the evaluated graph with binding recording (same
        engine, bit-identical timeline) on first access.  Sweeps share one
        build and retune it in place between points, which would silently
        yield a *different point's* path — so the extraction is checked
        against this prediction's makespan and raises (instead of lying)
        when the carried graph has moved on; re-evaluate the point via
        :meth:`Scenario.predict` to diagnose it.
        """
        if self._cp is None:
            if self.graph is None:
                raise OptimizationError(
                    "this Prediction does not carry its evaluated graph; "
                    "re-evaluate via Scenario.predict/evaluate")
            from repro_torch.analysis import extract_critical_path
            cp = extract_critical_path(self.graph, schedule=self.schedule)
            if abs(cp.makespan - self.predicted) > \
                    1e-9 * max(abs(self.predicted), 1e-30):
                raise OptimizationError(
                    f"the evaluated graph no longer reproduces this "
                    f"prediction (makespan {cp.makespan} vs "
                    f"{self.predicted}): a later sweep point retuned the "
                    f"shared build in place — re-evaluate this point via "
                    f"Scenario.predict to get its critical path")
            self._cp = cp
        return self._cp

    @property
    def timelines(self):
        """Counter timelines of the predicted timeline
        (:class:`repro_torch.obs.TimelineSet`): per-lane busy/utilization,
        ready-queue depth, COMM bytes in flight, and — when the scenario
        carries byte maps — per-worker live memory.  Derived lazily from
        the carried graph + result; like :attr:`critical_path`, raises
        instead of lying when a later sweep point retuned the shared
        build in place.
        """
        if self._timelines is None:
            if self.graph is None:
                raise OptimizationError(
                    "this Prediction does not carry its evaluated graph; "
                    "re-evaluate via Scenario.predict/evaluate")
            from repro_torch.obs import compute_timelines
            acts, grads = self.byte_maps or (None, None)
            try:
                self._timelines = compute_timelines(
                    self.graph, self.cluster or self.result,
                    activation_bytes=acts, layer_grad_bytes=grads)
            except ValueError as e:
                raise OptimizationError(str(e)) from e
        return self._timelines

    def __repr__(self) -> str:
        tag = f" point={self.point}" if self.point else ""
        return (f"Prediction({self.optimization.spec()}: "
                f"{self.baseline*1e3:.3f}ms -> {self.predicted*1e3:.3f}ms, "
                f"{self.speedup:.2f}x{tag})")


# ============================================================ optimization
class Optimization:
    """A named graph transformation with typed parameters.

    Subclasses are frozen dataclasses (fields == parameters) registered via
    :func:`register`; they implement :meth:`build`, which mutates a
    :class:`GraphTransform` in place — that is what makes stacking
    composable (every optimization in a :class:`Stack` mutates the same
    transform, in order).
    """

    name: ClassVar[str] = "?"
    algorithm: ClassVar[str] = ""

    # ------------------------------------------------------------ protocol
    def build(self, s: Scenario, tf: GraphTransform) -> None:
        raise NotImplementedError

    def apply(self, scenario: Scenario,
              tf: Optional[GraphTransform] = None) -> GraphTransform:
        """Apply to (a copy of) the scenario's baseline graph."""
        if tf is None:
            tf = scenario.transform()
        self.build(scenario, tf)
        return tf

    def predict(self, scenario: Scenario) -> Prediction:
        return scenario.predict(self)

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        """Cheaply re-parameterize ``tf`` (already built with ``old``'s
        params) to this instance's params, in place.  Return ``False`` when
        the change is structural and needs a rebuild (the default)."""
        return False

    # ------------------------------------------------------------ headroom
    def headroom_targets(self, s: Scenario
                         ) -> Optional[Callable[[Task], bool]]:
        """Predicate over the tasks this optimization can *shrink*, or None.

        The contract backing :func:`repro_torch.analysis.opportunity`'s Amdahl
        bounds: :meth:`build` must never make a targeted task slower, and
        everything else it does must be added work (the makespan is
        monotone in durations/payloads, so erasing the targets then upper-
        bounds any real parameterization).  Return a predicate selecting
        every task the model might speed up (``lambda t: False`` for
        optimizations that only add or redistribute work — their bound is
        exactly 1.0x); return ``None`` (the default) when the optimization
        restructures the graph and no shrink-bound exists (``pipeline``).
        """
        return None

    def headroom(self, s: Scenario, tf: GraphTransform) -> bool:
        """Mutate ``tf`` into this optimization's idealized best case.

        Default: erase the :meth:`headroom_targets` (duration *and*
        payload to zero — a collective with zero payload still wires, as
        hop-latency-only legs, so the bound flows through the real cluster
        simulator).  Returns False when no bound exists.  Override when
        the ideal case is not expressible as target-erasure (``overlap``
        removes its targets outright — fully hidden communication also
        frees the device lane's issue slots).
        """
        targets = self.headroom_targets(s)
        if targets is None:
            return False
        for t in tf.select(targets):
            t.duration = 0.0
            t.comm_bytes = 0.0
        return True

    # ---------------------------------------------------------- parameters
    def param_names(self) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self))

    def with_params(self, **params: Any) -> "Optimization":
        if not params:
            return self
        bad = [k for k in params if k not in self.param_names()]
        if bad:
            raise OptimizationError(
                f"{self.name} has no parameter(s) {bad}; valid: "
                f"{list(self.param_names())}")
        return dataclasses.replace(self, **params)

    # -------------------------------------------------------- composition
    def __or__(self, other: "Optimization") -> "Stack":
        if not isinstance(other, Optimization):
            return NotImplemented
        return Stack(self, other)

    # --------------------------------------------------------------- spec
    def spec(self) -> str:
        """``name:param=value`` round-trip form (:func:`parse_stack`)."""
        parts = [self.name]
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            parts.append(f"{f.name}={v!r}")
        return ":".join(parts)


@dataclasses.dataclass(frozen=True, init=False)
class Stack(Optimization):
    """Ordered composition: ``Stack(A, B)`` applies A, then B to A's output.

    Nested stacks flatten on construction, so ``(A | B) | C == A | (B | C)``
    — composition is associative by construction.
    """

    opts: Tuple[Optimization, ...]

    name: ClassVar[str] = "stack"

    def __init__(self, *opts: Union[Optimization,
                                    Sequence[Optimization]]) -> None:
        flat: List[Optimization] = []
        for o in opts:
            if isinstance(o, Stack):
                flat.extend(o.opts)
            elif isinstance(o, Optimization):
                flat.append(o)
            else:
                for x in o:
                    flat.extend(x.opts if isinstance(x, Stack) else [x])
        object.__setattr__(self, "opts", tuple(flat))

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        for o in self.opts:
            o.build(s, tf)

    def headroom_targets(self, s: Scenario
                         ) -> Optional[Callable[[Task], bool]]:
        preds = [o.headroom_targets(s) for o in self.opts]
        if any(p is None for p in preds):
            return None
        return lambda t: any(p(t) for p in preds)

    def headroom(self, s: Scenario, tf: GraphTransform) -> bool:
        # every member must bound; erasure composes (idempotent), so the
        # union of the members' ideal cases is the stack's ideal case
        return all(o.headroom(s, tf) for o in self.opts)

    def _param_owners(self) -> Dict[str, List[int]]:
        owners: Dict[str, List[int]] = {}
        for i, o in enumerate(self.opts):
            for p in o.param_names():
                owners.setdefault(p, []).append(i)
        return owners

    def param_names(self) -> Tuple[str, ...]:
        """Member parameters owned by exactly one member — those route
        unambiguously through :meth:`with_params`, which is what lets
        ``sweep("ddp,ckpt_interval", {"steps": [...]})`` move a stacked
        member's knob.  Shared names are excluded (set them on the member
        directly)."""
        return tuple(p for p, idx in self._param_owners().items()
                     if len(idx) == 1)

    def with_params(self, **params: Any) -> "Optimization":
        if not params:
            return self
        owners = self._param_owners()
        out = list(self.opts)
        for k, v in params.items():
            idx = owners.get(k, [])
            if not idx:
                raise OptimizationError(
                    f"no member of stack {self.spec()!r} has parameter "
                    f"{k!r}")
            if len(idx) > 1:
                raise OptimizationError(
                    f"parameter {k!r} is ambiguous in stack "
                    f"{self.spec()!r} ({len(idx)} members define it); "
                    f"set it on the member directly")
            out[idx[0]] = out[idx[0]].with_params(**{k: v})
        return Stack(*out)

    def spec(self) -> str:
        return ",".join(o.spec() for o in self.opts)


# ================================================================ parsing
def _split_outside(s: str, sep: str) -> List[str]:
    """Split on ``sep`` outside brackets/quotes (so ``axes=[("d",4)]`` and
    stacked specs coexist)."""
    out, cur, depth, quote = [], [], 0, None
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch in "([{":
            depth += 1
            cur.append(ch)
        elif ch in ")]}":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [p.strip() for p in out if p.strip()]


def _parse_value(v: str) -> Any:
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(value: Any, hint: Any) -> Any:
    """Nudge CLI-parsed values toward the declared parameter type."""
    if hint is None:
        return value
    origin = typing.get_origin(hint)
    if origin is Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        hint = args[0] if len(args) == 1 else None
    if hint is float and isinstance(value, (int, bool)):
        return float(value)
    if hint is int and isinstance(value, float) and value.is_integer():
        return int(value)
    return value


def parse_stack(spec: str) -> Tuple[Optimization, Dict[str, Any]]:
    """Parse a CLI stack spec like ``"amp,ddp:workers=16,zero"``.

    Comma-separated optimizations, ``param=value`` pairs parsed against the
    registry (typed via each optimization's dataclass fields).  Parameters
    attach with colons (``ddp:bucket_bytes=1e6``) or as comma-separated
    continuations of the preceding optimization
    (``pipeline:stages=4,microbatches=16,schedule=1f1b`` — a comma part
    whose head is ``name=value`` extends the optimization to its left).
    Keys that are :class:`Scenario` fields (``workers``,
    ``collective_mode``) are collected into the returned override dict
    instead.  Returns ``(optimization_or_stack, scenario_overrides)``.
    """
    pending: List[Tuple[type, Dict[str, Any], str]] = []
    overrides: Dict[str, Any] = {}
    for part in _split_outside(spec, ","):
        fields = _split_outside(part, ":")
        if "=" in fields[0]:
            # continuation: the whole part parameterizes the previous opt
            if not pending:
                raise OptimizationError(
                    f"parameter {fields[0]!r} appears before any "
                    f"optimization name in {spec!r}")
            cls, params, _ = pending[-1]
            kvs = fields
        else:
            cls = get_optimization(fields[0])
            params = {}
            pending.append((cls, params, part))
            kvs = fields[1:]
        try:
            hints = typing.get_type_hints(cls)
        except Exception:
            hints = {}
        valid = {f.name for f in dataclasses.fields(cls)}
        for kv in kvs:
            if "=" not in kv:
                raise OptimizationError(
                    f"bad parameter {kv!r} in {part!r}; expected name=value")
            k, v = kv.split("=", 1)
            k, val = k.strip(), _parse_value(v.strip())
            if k in valid:
                params[k] = _coerce(val, hints.get(k))
            elif k in _SCENARIO_OVERRIDES:
                overrides[k] = val
            else:
                raise OptimizationError(
                    f"{cls.name} has no parameter {k!r}; valid: "
                    f"{sorted(valid)} (or scenario overrides "
                    f"{list(_SCENARIO_OVERRIDES)})")
    opts: List[Optimization] = []
    for cls, params, part in pending:
        try:
            opts.append(cls(**params))
        except TypeError as e:
            raise OptimizationError(
                f"cannot construct {cls.name!r} from {part!r}: {e}") from e
    if not opts:
        raise OptimizationError(f"empty stack spec {spec!r}")
    return (opts[0] if len(opts) == 1 else Stack(*opts)), overrides


def _resolve(opt: Union[str, Optimization],
             params: Optional[Dict[str, Any]] = None) -> Optimization:
    if isinstance(opt, str):
        if "," in opt or ":" in opt:
            stack, over = parse_stack(opt)
            if over:
                raise OptimizationError(
                    f"scenario overrides {sorted(over)} are not allowed in "
                    f"this context; set them on the Scenario")
            if params:
                raise OptimizationError(
                    "pass parameters either in the spec string or as "
                    "keyword arguments, not both")
            return stack
        cls = get_optimization(opt)
        try:
            return cls(**(params or {}))
        except TypeError as e:
            raise OptimizationError(
                f"cannot construct {cls.name!r}: {e}") from e
    if not isinstance(opt, Optimization):
        raise OptimizationError(
            f"expected an Optimization or registered name, got {opt!r}")
    return opt.with_params(**params) if params else opt


def _expand_grid(grid: Union[Dict[str, Sequence[Any]],
                             Sequence[Dict[str, Any]]]
                 ) -> List[Dict[str, Any]]:
    if isinstance(grid, dict):
        keys = list(grid)
        return [dict(zip(keys, combo))
                for combo in itertools.product(*(list(grid[k])
                                                 for k in keys))]
    return [dict(p) for p in grid]


# ====================================================== worker-spec grids
def uniform_bandwidth_specs(n: int, scales: Sequence[float]
                            ) -> List[List[WorkerSpec]]:
    """One sweep point per scale: all ``n`` workers' links throttled alike —
    the ``workers`` grid for a cluster bandwidth sweep."""
    return [[WorkerSpec(bandwidth_scale=s) for _ in range(n)]
            for s in scales]


def straggler_specs(n: int, slowdowns: Sequence[float], *, straggler: int = 0
                    ) -> List[List[WorkerSpec]]:
    """One sweep point per slowdown: worker ``straggler`` is that much
    slower — the ``workers`` grid for a straggler sweep."""
    return [[WorkerSpec(compute_scale=s if i == straggler else 1.0)
             for i in range(n)] for s in slowdowns]


# ================================================================= models
@register("noop", "baseline", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class Noop(Optimization):
    """Identity: predict the unmodified scenario.

    Useful to route a baseline through the same machinery as real
    optimizations — e.g. ``perf_report --trace-dir`` renders the imported
    cluster's per-worker breakdown via ``predict("noop")``, and stacks can
    be compared against ``noop`` point-for-point in sweeps.
    """

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        pass

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        return True

    def headroom_targets(self, s: Scenario):
        return lambda t: False      # identity: bound is exactly 1.0x


@register("amp", algorithm="Alg 3")
@dataclasses.dataclass(frozen=True)
class AMP(Optimization):
    """Paper Algorithm 3 (AMP).

    GPU original: sgemm/scudnn kernels 3x (TensorCore), everything else 2x
    (halved bytes).  TPU analogue: MXU-bound ops (dot/convolution fusions
    whose roofline is compute) get ``matmul_speedup`` (bf16 -> int8/fp8 on
    the MXU); bandwidth-bound ops get ``memory_speedup`` (halved HBM
    traffic).
    """

    matmul_speedup: float = 3.0
    memory_speedup: float = 2.0

    @staticmethod
    def _targets(tf: GraphTransform) -> List[Task]:
        # device tasks plus point-to-point COMM legs anywhere (pipeline
        # activation/gradient hops: halved precision halves the payload)
        return tf.select(lambda t: on_device(t) or t.kind == TaskKind.COMM)

    def _rescale(self, tf: GraphTransform, matmul: float,
                 memory: float) -> None:
        """Divide durations by the per-class factors (build == factor,
        retune == new/old ratio; classification is duration-independent,
        so re-applying with a ratio is exact re-parameterization)."""
        for t in self._targets(tf):
            if t.is_comm():
                t.duration /= memory   # payload bits halve too
                t.comm_bytes /= memory
            elif t.attrs.get("opcode") in ("dot", "convolution") or (
                    t.kind == TaskKind.COMPUTE and t.flops > t.bytes_accessed):
                t.duration /= matmul
            else:
                t.duration /= memory

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        self._rescale(tf, self.matmul_speedup, self.memory_speedup)

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        if old.matmul_speedup == 0 or old.memory_speedup == 0:
            return False
        self._rescale(tf, self.matmul_speedup / old.matmul_speedup,
                      self.memory_speedup / old.memory_speedup)
        return True

    def headroom_targets(self, s: Scenario):
        # everything _rescale divides: device tasks and p2p hop payloads
        return lambda t: on_device(t) or t.kind == TaskKind.COMM


@register("fused_optimizer", "fusedadam", algorithm="Alg 4")
@dataclasses.dataclass(frozen=True)
class FusedOptimizer(Optimization):
    """Paper Algorithm 4 (FusedAdam).

    Remove every weight-update-phase device task, insert one fused task
    whose duration is the roofline of the *summed* FLOPs/bytes — on GPU the
    win is eliminated CUDA-launch overhead; on TPU it is the eliminated
    per-op issue overhead and re-fused memory traffic.

    The port's addition: a graph measured on a GPU
    (:mod:`repro_torch.core.kineto`) has host tasks for each kernel launch,
    so the update phase's host tasks go too, except the fused kernel's own
    launch -- the paper's Algorithm 4 removes the phase's CPU tasks with its
    GPU tasks.  The reference's graphs have no update-phase host task, so
    there the result is the reference's.
    """

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        wu = [t for t in tf.select(all_of(on_device, by_phase("update")))
              if t.kind != TaskKind.COLLECTIVE]
        if not wu:
            return
        total_flops = sum(t.flops for t in wu)
        # fused kernel reads params/grads/moments once: bytes = unique
        # traffic, approximated as the sum minus re-read intermediates
        # (2/3 of memory ops).
        total_bytes = sum(t.bytes_accessed for t in wu) / 3.0
        first, rest = wu[0], wu[1:]
        first.name = "fused_optimizer_kernel"
        first.flops = total_flops
        first.bytes_accessed = total_bytes
        first.duration = s.cost.compute_time(total_flops, total_bytes)
        for t in rest:
            tf.remove(t)
        keep = {p.uid for p in tf.graph.parents(first)}
        tf.remove(lambda t: (t.thread == HOST_THREAD and t.phase == "update"
                             and t.kind == TaskKind.HOST and t.uid not in keep))

    def headroom_targets(self, s: Scenario):
        return lambda t: (on_device(t) and t.phase == "update"
                          and t.kind != TaskKind.COLLECTIVE)


@register("fused_norm", algorithm="Alg 5")
@dataclasses.dataclass(frozen=True)
class FusedNorm(Optimization):
    """Paper Algorithm 5 (Reconstructing Batchnorm), normalized for LMs.

    Split the normalization, fuse halves with neighbouring compute: remove
    the activation tasks (now fused into matmuls) and speed normalization
    tasks by 2x (halved input reads).
    """

    norm_layer: str = "norm"
    activation_pattern: str = r"max|tanh|gelu|silu|logistic"
    norm_speedup: float = 2.0

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        tf.remove(all_of(on_device, by_layer(self.norm_layer),
                         by_name(self.activation_pattern)))
        for t in tf.select(all_of(on_device, by_layer(self.norm_layer))):
            if t.kind != TaskKind.COLLECTIVE:
                t.duration /= self.norm_speedup

    def headroom_targets(self, s: Scenario):
        sel = all_of(on_device, by_layer(self.norm_layer))
        return lambda t: sel(t) and t.kind != TaskKind.COLLECTIVE


@register("ddp", "distributed", algorithm="Alg 6")
@dataclasses.dataclass(frozen=True)
class DDP(Optimization):
    """Paper Algorithm 6: predict DP training from a single-worker profile.

    Inserts one all-reduce per gradient bucket on a dedicated communication
    lane (NCCL-stream semantics: buckets serialize on the lane), with
    wait-free-backprop dependencies: last bwd task of the bucket's layers ->
    all-reduce -> first update task.  Worker count and gradient payloads
    come from the scenario.
    """

    bucket_bytes: float = 25 * 1024 * 1024
    bandwidth: Optional[float] = None
    crosses_pod: bool = False

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        cost = s.cost
        num_workers = s.num_workers
        layer_grad_bytes = s.grads
        coll = CollectiveModel(cost.hw, cost.topo)
        if self.bandwidth is not None:
            # override link bandwidth (the paper's 10/20/40 Gbps sweeps)
            coll = CollectiveModel(
                dataclasses.replace(cost.hw, ici_bandwidth=self.bandwidth,
                                    dcn_bandwidth=self.bandwidth), cost.topo)
        g = tf.graph

        # ready order: reverse forward order, approximated by
        # last-bwd-finish order
        bwd_last: Dict[str, Task] = {}
        for t in g.lane_tasks(DEVICE_STREAM):
            if t.phase == "bwd" and t.layer in layer_grad_bytes:
                bwd_last[t.layer] = t          # lane order => last wins
        order = [l for l in bwd_last] or list(reversed(list(layer_grad_bytes)))
        missing = [l for l in layer_grad_bytes if l not in order]
        order += missing
        buckets = bucket_layers(layer_grad_bytes, self.bucket_bytes,
                                reverse_order=order)

        lane = g.lane_tasks(DEVICE_STREAM)
        lane_pos = {t.uid: i for i, t in enumerate(lane)}
        update_tasks = [t for t in lane if t.phase == "update"]
        sync = [t for t in g.lane_tasks(HOST_THREAD)
                if t.kind == TaskKind.SYNC]
        tail = sync[-1] if sync else None

        for i, (layers, payload) in enumerate(buckets):
            dur = coll.group_time("all-reduce", payload, num_workers,
                                  self.crosses_pod)
            ar = Task(name=f"allreduce:bucket{i}", kind=TaskKind.COLLECTIVE,
                      thread=GRAD_CHANNEL, duration=dur, comm_bytes=payload,
                      phase="comm", attrs={"collective": "all-reduce",
                                           "group_size": num_workers,
                                           "bucket": i, "layers": layers})
            parents = [bwd_last[l] for l in layers if l in bwd_last]
            # paper: AllReduce -> WU.  XLA may interleave update ops with
            # bwd, so pick the earliest update task scheduled *after* every
            # parent to stay acyclic; fall back to the host-side completion
            # sync.
            after = max((lane_pos[p.uid] for p in parents), default=-1)
            barrier = next((t for t in update_tasks
                            if lane_pos[t.uid] > after), tail)
            children = [x for x in (barrier,) if x is not None]
            tf.append(ar, parents=parents, children=children)

    def headroom_targets(self, s: Scenario):
        # pure insertion: DP communication only ever adds to a
        # single-worker baseline, so the bound is exactly 1.0x
        return lambda t: False


def extend_next_forward(tf: GraphTransform) -> Dict[str, Task]:
    """Clone the forward-phase device tasks as a next-iteration prologue.

    Cross-iteration what-ifs (P3, parameter-server pulls) gate the *next*
    forward pass on communication; a single-iteration graph cannot express
    that, so we append a copy of the fwd segment after the current
    iteration's device lane (paper Algorithm 7 inserts push/pull "between
    the backward and the forward GPU tasks for each layer").  Returns
    {layer: first cloned fwd task}.
    """
    g = tf.graph
    fwd = [t for t in g.lane_tasks(DEVICE_STREAM) if t.phase == "fwd"]
    first_of_layer: Dict[str, Task] = {}
    sync = [t for t in g.lane_tasks(HOST_THREAD) if t.kind == TaskKind.SYNC]
    tail = sync[-1] if sync else None
    for t in fwd:
        c = t.clone()
        c.name = f"next:{t.name}"
        c.phase = "next_fwd"
        g.add_task(c)                      # appends to device lane => ordered
        if t.layer and t.layer not in first_of_layer:
            first_of_layer[t.layer] = c
        if tail is not None:
            g.add_edge(c, tail)
    return first_of_layer


@register("p3", algorithm="Alg 7")
@dataclasses.dataclass(frozen=True)
class P3(Optimization):
    """Paper Algorithm 7 (Priority-Based Parameter Propagation).

    Slice each layer's gradient, insert push/pull pairs on send/receive
    channels, prioritize slices of layers closer to the *input* (they are
    needed last in bwd but first in the *next* fwd), and override the
    scheduler with the priority policy.  The next-iteration forward segment
    is cloned so the pull->fwd dependency is expressible.

    ``priority=False, slice_bytes=inf`` gives the plain parameter-server
    baseline of paper Fig. 10.
    """

    bandwidth: float = 0.0
    slice_bytes: float = 4 * 1024 * 1024
    priority: bool = True

    def __post_init__(self) -> None:
        if self.bandwidth <= 0:
            raise OptimizationError(
                "p3 needs bandwidth=<bytes/s> (the per-link push/pull "
                "bandwidth)")

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        layer_grad_bytes = s.grads
        num_workers = s.num_workers
        g = tf.graph

        bwd_last: Dict[str, Task] = {}
        for t in g.lane_tasks(DEVICE_STREAM):
            if t.layer in layer_grad_bytes and t.phase == "bwd":
                bwd_last[t.layer] = t
        next_fwd = extend_next_forward(tf)
        sync = [t for t in g.lane_tasks(HOST_THREAD)
                if t.kind == TaskKind.SYNC]
        tail = sync[-1] if sync else None

        # priority: negative distance to output == earlier layers first
        # (paper line 9)
        layer_order = list(layer_grad_bytes)
        prio = {l: -(len(layer_order) - i)
                for i, l in enumerate(layer_order)}

        for layer, gbytes in layer_grad_bytes.items():
            nslices = max(1, math.ceil(gbytes / self.slice_bytes))
            per = gbytes / nslices
            t_push = per * (num_workers - 1) / max(num_workers, 1) \
                / self.bandwidth
            for sl in range(nslices):
                push = Task(name=f"push:{layer}:{sl}",
                            kind=TaskKind.COLLECTIVE,
                            thread=ici_channel("send"), duration=t_push,
                            comm_bytes=per, phase="comm",
                            attrs={"priority": prio[layer]})
                pull = Task(name=f"pull:{layer}:{sl}",
                            kind=TaskKind.COLLECTIVE,
                            thread=ici_channel("recv"), duration=t_push,
                            comm_bytes=per, phase="comm",
                            attrs={"priority": prio[layer]})
                parents = [bwd_last[layer]] if layer in bwd_last else []
                tf.append(push, parents=parents)
                children = [x for x in (next_fwd.get(layer, tail),)
                            if x is not None]
                tf.append(pull, parents=[push], children=children)

        if self.priority:
            tf.prioritize(lambda t: t.attrs.get("priority", -1e9))

    def headroom_targets(self, s: Scenario):
        return lambda t: False      # insertion-only vs the baseline


@register("blueconnect", algorithm="Alg 8")
@dataclasses.dataclass(frozen=True)
class BlueConnect(Optimization):
    """Paper Algorithm 8: decompose each all-reduce into per-axis
    reduce-scatter chains + reversed all-gather chains on parallel channels.

    ``axes`` is ((axis_name, size), ...) — the factorization p1*p2*...*pk.
    """

    axes: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        if not self.axes:
            raise OptimizationError(
                "blueconnect needs axes=[(axis_name, size), ...]")
        object.__setattr__(self, "axes",
                           tuple((str(a), int(n)) for a, n in self.axes))

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        cost = s.cost
        coll = CollectiveModel(cost.hw, cost.topo)
        targets = [t for t in tf.select(
            lambda t: t.kind == TaskKind.COLLECTIVE
            and t.attrs.get("collective") == "all-reduce")]
        for u in targets:
            parents = tf.graph.parents(u)
            children = tf.graph.children(u)
            payload = u.comm_bytes
            prev: List[Task] = list(parents)
            p = payload
            chain: List[Task] = []
            for ax, n in self.axes:
                kind = cost.topo.axis_kind.get(ax, "ici")
                rs = Task(name=f"reduce-scatter:{u.name}:{ax}",
                          kind=TaskKind.COLLECTIVE, thread=ici_channel(ax),
                          duration=coll.axis_time("reduce-scatter", p, n,
                                                  kind),
                          comm_bytes=p, phase="comm",
                          attrs={"collective": "reduce-scatter",
                                 "group_size": n})
                tf.append(rs, parents=prev)
                prev = [rs]
                chain.append(rs)
                p /= max(n, 1)
            for ax, n in reversed(list(self.axes)):
                kind = cost.topo.axis_kind.get(ax, "ici")
                p *= max(n, 1)
                ag = Task(name=f"all-gather:{u.name}:{ax}",
                          kind=TaskKind.COLLECTIVE, thread=ici_channel(ax),
                          duration=coll.axis_time("all-gather", p, n, kind),
                          comm_bytes=p, phase="comm",
                          attrs={"collective": "all-gather",
                                 "group_size": n})
                tf.append(ag, parents=prev)
                prev = [ag]
                chain.append(ag)
            for c in children:
                tf.graph.add_edge(prev[0], c)
            tf.remove(u)

    def headroom_targets(self, s: Scenario):
        return lambda t: (t.kind == TaskKind.COLLECTIVE and
                          t.attrs.get("collective") == "all-reduce")


@register("remove_layer", algorithm="Alg 9")
@dataclasses.dataclass(frozen=True)
class RemoveLayer(Optimization):
    """Paper Algorithm 9 Remove_layer (MetaFlow)."""

    layer_pattern: str

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        tf.remove(all_of(on_device, by_layer(self.layer_pattern)))

    def headroom_targets(self, s: Scenario):
        return all_of(on_device, by_layer(self.layer_pattern))


@register("scale_layer", algorithm="Alg 9")
@dataclasses.dataclass(frozen=True)
class ScaleLayer(Optimization):
    """Paper Algorithm 9 Scale_layer (MetaFlow)."""

    layer_pattern: str
    scale: float = 1.0

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        tf.scale(all_of(on_device, by_layer(self.layer_pattern)), self.scale)

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        if self.layer_pattern != old.layer_pattern or old.scale == 0:
            return False
        tf.scale(all_of(on_device, by_layer(self.layer_pattern)),
                 self.scale / old.scale)
        return True

    def headroom_targets(self, s: Scenario):
        # scale > 1 only slows the targets; erasure still upper-bounds it
        return all_of(on_device, by_layer(self.layer_pattern))


def _layer_anchors(graph: DependencyGraph, layer_pattern: str
                   ) -> Tuple[Dict[str, Task], Dict[str, Task]]:
    """Per matching layer: (last forward task, first backward task) on the
    device lane — the insertion anchors of the activation what-ifs."""
    import re
    rx = re.compile(layer_pattern)
    fwd_last: Dict[str, Task] = {}
    bwd_first: Dict[str, Task] = {}
    for t in graph.lane_tasks(DEVICE_STREAM):
        if t.layer and rx.search(t.layer):
            if t.phase == "fwd":
                fwd_last[t.layer] = t
            elif t.phase == "bwd" and t.layer not in bwd_first:
                bwd_first[t.layer] = t
    return fwd_last, bwd_first


@register("offload", "vdnn", algorithm="Alg 10")
@dataclasses.dataclass(frozen=True)
class Offload(Optimization):
    """Paper Algorithm 10 (vDNN), TPU form: activations of matching layers
    are offloaded HBM->host after their forward task and prefetched
    host->HBM before their backward task, on the DMA channel.
    ``prefetch_distance`` controls how many layers ahead the prefetch is
    hooked (the paper's custom Schedule override becomes an explicit
    dependency re-wiring here).  Activation bytes come from the scenario.
    """

    layer_pattern: str
    prefetch_distance: int = 1

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        cost, activation_bytes = s.cost, s.acts
        fwd_last, bwd_first = _layer_anchors(tf.graph, self.layer_pattern)
        bwd_order = [l for l in bwd_first]
        for i, layer in enumerate(bwd_order):
            nbytes = activation_bytes.get(layer, 0.0)
            if nbytes <= 0 or layer not in fwd_last:
                continue
            off = Task(name=f"offload:{layer}", kind=TaskKind.OFFLOAD,
                       thread=DMA_CHANNEL,
                       duration=cost.offload_time(nbytes),
                       bytes_accessed=nbytes, phase="fwd")
            tf.append(off, parents=[fwd_last[layer]])
            pre = Task(name=f"prefetch:{layer}", kind=TaskKind.OFFLOAD,
                       thread=DMA_CHANNEL,
                       duration=cost.offload_time(nbytes),
                       bytes_accessed=nbytes, phase="bwd")
            # prefetch is triggered `prefetch_distance` bwd layers early
            trigger_idx = max(0, i - self.prefetch_distance)
            trigger = bwd_first[bwd_order[trigger_idx]]
            parents = [off] + ([trigger] if trigger_idx != i else [])
            tf.append(pre, parents=parents, children=[bwd_first[layer]])

    def headroom_targets(self, s: Scenario):
        return lambda t: False      # trades time for memory, never faster


@register("gist", algorithm="Alg 11")
@dataclasses.dataclass(frozen=True)
class Gist(Optimization):
    """Paper Algorithm 11 (Gist): insert encode after fwd / decode before
    bwd as device tasks costed like element-wise kernels over the
    activation (bytes from the scenario)."""

    layer_pattern: str
    codec_bytes_per_elem_ratio: float = 2.0

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        cost, activation_bytes = s.cost, s.acts
        fwd_last, bwd_first = _layer_anchors(tf.graph, self.layer_pattern)
        for layer, anchor in fwd_last.items():
            nbytes = activation_bytes.get(layer, 0.0)
            if nbytes <= 0:
                continue
            traffic = nbytes * self.codec_bytes_per_elem_ratio
            enc = Task(name=f"gist-encode:{layer}", kind=TaskKind.MEMORY,
                       thread=DEVICE_STREAM, bytes_accessed=traffic,
                       duration=cost.compute_time(nbytes, traffic),
                       phase="fwd")
            tf.insert_after(anchor, enc)
            if layer in bwd_first:
                dec = Task(name=f"gist-decode:{layer}",
                           kind=TaskKind.MEMORY, thread=DEVICE_STREAM,
                           bytes_accessed=traffic,
                           duration=cost.compute_time(nbytes, traffic),
                           phase="bwd")
                tf.insert_before(bwd_first[layer], dec, extra_parents=[enc])

    def headroom_targets(self, s: Scenario):
        return lambda t: False      # codec insertion only adds device work


@register("dgc", algorithm="Alg 12")
@dataclasses.dataclass(frozen=True)
class DGC(Optimization):
    """Paper Algorithm 12 (Deep Gradient Compression): scale every gradient
    collective's payload by ``compression`` and insert compress/decompress
    device tasks around it.

    Re-parameterizable in place (:meth:`retune`): a ``Scenario.sweep`` grid
    over ``compression`` / ``codec_flops_per_byte`` rescales the applied
    transform instead of rebuilding per point.
    """

    compression: float = 0.01
    codec_flops_per_byte: float = 4.0

    _TARGET_OPS = ("all-reduce", "reduce-scatter")

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        if old.compression == 0:
            return False
        cost = s.cost
        colls = {t.name: t for t in tf.select(
            lambda t: t.kind == TaskKind.COLLECTIVE and
            t.attrs.get("collective") in self._TARGET_OPS)}
        base = {name: u.comm_bytes / old.compression
                for name, u in colls.items()}
        for t in tf.select(lambda t: t.name.startswith("dgc-")):
            role, _, cname = t.name.partition(":")
            payload = base.get(cname)
            if payload is None:
                return False          # structure drifted: rebuild the point
            t.flops = payload * self.codec_flops_per_byte
            out = 2 * payload if role == "dgc-compress" \
                else 2 * payload * self.compression
            t.bytes_accessed = out
            t.duration = cost.compute_time(t.flops, out)
        for name, u in colls.items():
            u.comm_bytes = base[name] * self.compression
            u.duration = u.duration / old.compression * self.compression
        return True

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        cost = s.cost
        targets = [t for t in tf.select(
            lambda t: t.kind == TaskKind.COLLECTIVE and
            t.attrs.get("collective") in ("all-reduce", "reduce-scatter"))]
        for u in targets:
            payload = u.comm_bytes
            u.comm_bytes = payload * self.compression
            u.duration = u.duration * self.compression
            f = payload * self.codec_flops_per_byte
            comp = Task(name=f"dgc-compress:{u.name}", kind=TaskKind.COMPUTE,
                        thread=DEVICE_STREAM, flops=f,
                        bytes_accessed=2 * payload,
                        duration=cost.compute_time(f, 2 * payload),
                        phase="comm")
            dec = Task(name=f"dgc-decompress:{u.name}",
                       kind=TaskKind.COMPUTE, thread=DEVICE_STREAM, flops=f,
                       bytes_accessed=2 * payload * self.compression,
                       duration=cost.compute_time(
                           f, 2 * payload * self.compression),
                       phase="comm")
            parents = list(tf.graph.parents(u))
            children = list(tf.graph.children(u))
            lane = tf.graph.lane_tasks(DEVICE_STREAM)
            lane_pos = {t.uid: i for i, t in enumerate(lane)}
            dev_parents = [p for p in parents if p.thread == DEVICE_STREAM]
            # compress right after its last device-lane producer (WFBP
            # overlap keeps)
            if dev_parents:
                anchor = max(dev_parents, key=lambda p: lane_pos[p.uid])
                tf.insert_after(anchor, comp, extra_children=[u])
            else:
                tf.append(comp, children=[u])
            for p in parents:
                tf.graph.remove_edge(p, u)
                if p.uid != comp.uid:
                    tf.graph.add_edge(p, comp)
            # decompress: must sit *after* compress in device program order
            # (XLA may schedule a bucket's consumer earlier in the lane than
            # a later bucket's last producer; splicing before such a
            # consumer would close a cycle through the lane edges).  Pick
            # the earliest device-lane consumer after comp; if none, run
            # decompress right after compress.
            lane = tf.graph.lane_tasks(DEVICE_STREAM)
            lane_pos = {t.uid: i for i, t in enumerate(lane)}
            dev_children = [c for c in children if c.thread == DEVICE_STREAM
                            and lane_pos[c.uid] > lane_pos[comp.uid]]
            if dev_children:
                anchor = min(dev_children, key=lambda c: lane_pos[c.uid])
                tf.insert_before(anchor, dec, extra_parents=[u])
            else:
                tf.insert_after(comp, dec, extra_parents=[u])
            lane_pos = {t.uid: i for i, t in
                        enumerate(tf.graph.lane_tasks(DEVICE_STREAM))}
            for c in children:
                tf.graph.remove_edge(u, c)
                if c.uid == dec.uid:
                    continue
                if (c.thread == DEVICE_STREAM
                        and lane_pos[c.uid] <= lane_pos[dec.uid]):
                    continue   # lane-earlier consumer: order kept by the lane
                tf.graph.add_edge(dec, c)

    def headroom_targets(self, s: Scenario):
        return lambda t: (t.kind == TaskKind.COLLECTIVE and
                          t.attrs.get("collective") in self._TARGET_OPS)


@register("zero", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class ZeRO(Optimization):
    """ZeRO-1/2 style: replace gradient all-reduce with reduce-scatter,
    shard the optimizer update by 1/N, all-gather updated params (N from
    the scenario's worker spec)."""

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        cost, num_workers = s.cost, s.num_workers
        coll = CollectiveModel(cost.hw, cost.topo)
        for u in tf.select(lambda t: t.kind == TaskKind.COLLECTIVE and
                           t.attrs.get("collective") == "all-reduce"):
            payload = u.comm_bytes
            u.name = f"reduce-scatter:{u.name}"
            u.attrs["collective"] = "reduce-scatter"
            u.duration = coll.group_time("reduce-scatter", payload,
                                         num_workers)
            ag = Task(name="all-gather:params", kind=TaskKind.COLLECTIVE,
                      thread=u.thread,
                      duration=coll.group_time("all-gather", payload,
                                               num_workers),
                      comm_bytes=payload, phase="comm",
                      attrs={"collective": "all-gather",
                             "group_size": num_workers})
            # forward only cross-thread consumers (the weight-update
            # barrier).  u's same-lane successor is the *next bucket's*
            # reduce-scatter; the channel lane already orders it, and an
            # explicit ag->successor edge would contradict ag's position at
            # the lane tail (a cycle)
            children = [c for c in tf.graph.children(u)
                        if c.thread != u.thread]
            tf.append(ag, parents=[u], children=children)
        tf.scale(all_of(on_device, by_phase("update")), 1.0 / num_workers)

    def headroom_targets(self, s: Scenario):
        # shrinks the sharded update and rewrites gradient all-reduces
        # (reduce-scatter + all-gather together never beat zero comm)
        return lambda t: ((t.kind == TaskKind.COLLECTIVE and
                           t.attrs.get("collective") == "all-reduce")
                          or (on_device(t) and t.phase == "update"))


@register("overlap", "overlap_collectives", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class OverlapCollectives(Optimization):
    """Move device-lane collectives onto ICI channel lanes (async
    collectives), keeping data dependencies — models compute/communication
    overlap."""

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        g = tf.graph
        for t in list(g.lane_tasks(DEVICE_STREAM)):
            if t.kind == TaskKind.COLLECTIVE:
                parents = g.parents(t)
                children = g.children(t)
                nt = t.clone()
                nt.thread = ici_channel("ici")
                g.remove_task(t, bridge=True)
                g.add_task(nt)
                for p in parents:
                    if nt.uid != p.uid and p in g:
                        g.add_edge(p, nt)
                for c in children:
                    if nt.uid != c.uid and c in g:
                        g.add_edge(nt, c)

    def headroom_targets(self, s: Scenario):
        return lambda t: (on_device(t) and t.kind == TaskKind.COLLECTIVE)

    def headroom(self, s: Scenario, tf: GraphTransform) -> bool:
        # fully hidden communication also frees the device lane's issue
        # slot, which erasure-in-place cannot express: the best case is the
        # collective gone from the lane entirely (bridged, like build does)
        for t in tf.select(self.headroom_targets(s)):
            tf.graph.remove_task(t, bridge=True)
        return True


@register("straggler", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class Straggler(Optimization):
    """One slow replica in a synchronous job: every collective waits for
    the straggler, so collective durations stretch by the straggler's extra
    compute time (symmetric-worker model, paper §4.2.1 'Duration').  For
    the structural per-worker model, use a cluster scenario with a slowed
    :class:`WorkerSpec` instead."""

    slowdown: float = 1.5
    affected_fraction: float = 1.0

    @staticmethod
    def _per_collective_extra(tf: GraphTransform, slowdown: float,
                              affected_fraction: float
                              ) -> Tuple[List[Task], float]:
        device_time = sum(t.duration for t in tf.select(on_device)
                          if t.kind != TaskKind.COLLECTIVE)
        extra = device_time * (slowdown - 1.0) * affected_fraction
        colls = tf.select(lambda t: t.kind == TaskKind.COLLECTIVE)
        return colls, (extra / len(colls) if colls else 0.0)

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        colls, per = self._per_collective_extra(tf, self.slowdown,
                                                self.affected_fraction)
        for t in colls:
            t.duration += per

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        # device durations are untouched by build, so the per-collective
        # extras of both parameterizations are recomputable from tf itself
        colls, per_old = self._per_collective_extra(
            tf, old.slowdown, old.affected_fraction)
        _, per_new = self._per_collective_extra(
            tf, self.slowdown, self.affected_fraction)
        for t in colls:
            t.duration += per_new - per_old
        return True

    def headroom_targets(self, s: Scenario):
        return lambda t: False      # a straggler only ever slows the job


@register("bandwidth", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class Bandwidth(Optimization):
    """Paper Fig. 2 example: 'what if network bandwidth is N x'.

    Scales every communication task — group collectives *and* point-to-
    point COMM legs (pipeline activation/gradient hops), which the old
    trailing-gap hop model hid from this what-if.
    """

    factor: float = 1.0

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        tf.scale(lambda t: t.is_comm(), 1.0 / self.factor)

    def retune(self, s: Scenario, tf: GraphTransform,
               old: "Optimization") -> bool:
        if old.factor == 0:
            return False
        tf.scale(lambda t: t.is_comm(), old.factor / self.factor)
        return True

    def headroom_targets(self, s: Scenario):
        return lambda t: t.is_comm()    # infinite bandwidth == free comm


@register("grad_accum", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class GradAccum(Optimization):
    """Gradient accumulation: fwd+bwd repeat ``microbatches`` times per
    step, collectives and update run once (amortized)."""

    microbatches: int = 1

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        tf.scale(all_of(on_device, by_phase("fwd")),
                 float(self.microbatches))
        tf.scale(all_of(on_device, by_phase("bwd")),
                 float(self.microbatches))

    def headroom_targets(self, s: Scenario):
        return lambda t: False      # repeats fwd/bwd, never shrinks them


@register("pipeline", "pp", algorithm="beyond-paper")
@dataclasses.dataclass(frozen=True)
class PipelineParallel(Optimization):
    """Pipeline / hybrid parallelism as a *placement* through the real
    cluster simulator (GPipe / 1F1B; see :mod:`repro_torch.parallel.plan`).

    The scenario's profile is partitioned by layer into ``stages`` balanced
    stage profiles, scheduled over ``microbatches``, replicated ``dp`` ways
    per stage (hybrid PP x DP: per-stage gradient rings over each stage's
    replicas), and placed onto ``stages * dp`` workers (stage-major; the
    scenario's WorkerSpec list — pods, stragglers, skewed links — maps
    1:1 onto the slots).  Cross-stage activation/gradient hops are
    point-to-point COMM legs whose duration follows the placed link (DCN
    across pods) and retunes in sweeps like ring legs.

    Unlike every other registered optimization this is not a graph rewrite
    — :meth:`Scenario.predict` evaluates it on the cluster route directly,
    splitting a stack at the pipeline element (see the module docstring
    for the pre/post composition semantics).
    """

    stages: int = 2
    microbatches: int = 8
    schedule: str = "gpipe"
    dp: int = 1

    def __post_init__(self) -> None:
        if self.stages < 1 or self.microbatches < 1 or self.dp < 1:
            raise OptimizationError(
                f"pipeline needs stages/microbatches/dp >= 1, got "
                f"{self.spec()}")
        from repro_torch.parallel.plan import SCHEDULES
        if self.schedule not in SCHEDULES:
            raise OptimizationError(
                f"pipeline schedule must be one of {SCHEDULES}, got "
                f"{self.schedule!r}")

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        raise OptimizationError(
            "pipeline is a placement, not a graph transform; evaluate it "
            "via Scenario.predict/evaluate/sweep (not supported on the "
            "trace route)")


def _num_comm_tasks(graph: DependencyGraph) -> int:
    return sum(1 for t in graph.tasks()
               if t.kind in (TaskKind.COLLECTIVE, TaskKind.COMM))


def _split_pipeline(opt: Optimization
                    ) -> Tuple[Optional[Optimization],
                               Optional["PipelineParallel"],
                               Optional[Optimization]]:
    """Split a stack at its pipeline element: (pre, pipeline, post).

    ``(None, None, None)`` when the stack has no pipeline placement; raises
    when it has more than one (a graph can only be placed once).
    """
    if isinstance(opt, PipelineParallel):
        return None, opt, None
    if not isinstance(opt, Stack):
        return None, None, None
    idx = [i for i, o in enumerate(opt.opts)
           if isinstance(o, PipelineParallel)]
    if not idx:
        return None, None, None
    if len(idx) > 1:
        raise OptimizationError(
            "a stack can contain at most one pipeline placement")
    i = idx[0]
    pre = Stack(*opt.opts[:i]) if opt.opts[:i] else None
    post = Stack(*opt.opts[i + 1:]) if opt.opts[i + 1:] else None
    return pre, opt.opts[i], post


# ================================================================= search
def default_candidates(scenario: Scenario) -> List[Optimization]:
    """Default-constructible registered optimizations — the search space a
    driver explores when the user names none."""
    out: List[Optimization] = []
    for name in available():
        cls = get_optimization(name)
        try:
            out.append(cls())
        except (TypeError, OptimizationError):
            continue       # requires parameters the driver cannot default
    return out


def greedy_search(scenario: Scenario, *, max_depth: int = 3,
                  candidates: Optional[Sequence[Optimization]] = None,
                  round1: Optional[Dict[int, Prediction]] = None
                  ) -> Tuple[Optional[Optimization], List[Prediction]]:
    """Greedy hill-climb over the registry: repeatedly stack whichever
    candidate most reduces the predicted makespan, until no candidate
    improves or ``max_depth`` is reached.

    Candidates that do not apply to the scenario (missing byte maps, no
    collectives to transform, ...) are skipped, so the search runs on any
    scenario.  ``round1`` optionally seeds the first round with already-
    evaluated depth-1 predictions keyed by ``id(candidate)`` — the
    opportunity-ranking pass realizes every candidate anyway
    (:func:`repro_torch.analysis.rank_opportunities`), and re-simulating them
    would double the most expensive stage.  Returns ``(best stack or
    None, per-round best predictions)``.
    """
    cands = list(candidates) if candidates is not None \
        else default_candidates(scenario)
    chosen: List[Optimization] = []
    best = scenario.baseline().makespan
    trail: List[Prediction] = []
    for _ in range(max_depth):
        round_best: Optional[Prediction] = None
        for cand in cands:
            if any(type(cand) is type(o) for o in chosen):
                continue
            try:
                if not chosen and round1 is not None \
                        and id(cand) in round1:
                    pred = round1[id(cand)]
                else:
                    pred = scenario.predict(Stack(*chosen, cand) if chosen
                                            else cand)
            except Exception:
                continue      # not applicable to this scenario
            if pred.predicted < (round_best.predicted if round_best
                                 else best):
                round_best = pred
        if round_best is None:
            break
        opt = round_best.optimization
        chosen = list(opt.opts) if isinstance(opt, Stack) else [opt]
        best = round_best.predicted
        trail.append(round_best)
    if not chosen:
        return None, trail
    return (chosen[0] if len(chosen) == 1 else Stack(*chosen)), trail
