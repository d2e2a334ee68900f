"""Serving-scenario simulation of the port (counterpart of
``repro/serving``): request-level workloads through the dependency-graph
what-if engine.

Daydream's thesis — estimate an optimization's efficacy by simulating its
effect on a dependency graph instead of implementing it — applied to
inference serving: an open-loop workload (:mod:`~repro_torch.serving.workload`)
is lowered under a batching policy into a task graph
(:mod:`~repro_torch.serving.graphgen`) priced by an analytic/fitted
:class:`ServingCostModel` (:mod:`~repro_torch.serving.costs`), and
:class:`ServingScenario` (:mod:`~repro_torch.serving.scenario`) routes it
through the *existing* registry/sweep machinery, so

    ServingScenario(workload=wl, serving_cost=cost).predict(
        "continuous_batching,chunked_prefill,tp:degree=8")

answers "what happens to my p99 TTFT and goodput" before anyone
implements the policy — with ``.critical_path`` diagnosis, trace
export/diff, and headroom bounds working unchanged on the serving graph.

The subsystem's calibration anchor is the **static-batch drain-time
invariant**: in ``mode="static"`` (``repro_torch.serve.ServeEngine``
semantics) a single full batch arriving at t=0 simulates to exactly
``sum(prefill_i) + budget * decode_step`` — see
:mod:`repro_torch.serving.graphgen` for the full statement.

Importing this package registers the serving optimizations
(``continuous_batching``, ``static_slots``, ``chunked_prefill``, ``tp``,
``kv_offload``) with the registry of :mod:`repro_torch.core.optimize`
(the port's own; the reference's registry is untouched).  The files are the
reference's with imports re-pointed; :mod:`~repro_torch.serving.measure`
fits the cost model to the port's engine on the card and solves the
prefill scale against the whole batch's roofline (see its docstring).
"""

from .workload import (RequestSpec, Workload, explicit_workload,
                       poisson_workload, scale_arrivals, trace_workload)
from .costs import ServingCostModel
from .graphgen import (ServingGraph, ServingPolicy, build_serving_graph,
                       slot_lane, slot_lane_classes, ARRIVAL_LANE, COLL_LANE, DMA_LANE,
                       SCHED_LANE)
from .scenario import (ChunkedPrefill, ContinuousBatching, KVOffload,
                       ServingOptimization, ServingPrediction,
                       ServingScenario, StaticSlots, TensorParallelServing,
                       format_serving_table, serving_metrics)

__all__ = [
    "RequestSpec", "Workload", "poisson_workload", "trace_workload",
    "explicit_workload", "scale_arrivals",
    "ServingCostModel",
    "ServingGraph", "ServingPolicy", "build_serving_graph", "slot_lane",
    "slot_lane_classes",
    "ARRIVAL_LANE", "SCHED_LANE", "COLL_LANE", "DMA_LANE",
    "ServingOptimization", "ContinuousBatching", "StaticSlots",
    "ChunkedPrefill", "TensorParallelServing", "KVOffload",
    "ServingScenario", "ServingPrediction", "serving_metrics",
    "format_serving_table",
]
