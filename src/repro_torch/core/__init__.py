"""Daydream core of the PyTorch/CUDA port: dependency-graph what-if
performance prediction for DNN training/serving (paper: Zhu et al., USENIX
ATC 2020), carried over file-for-file from ``repro.core``.

Public surface:

    from repro_torch.core import (
        Task, TaskKind, DependencyGraph, simulate, GraphTransform,
        trace_compiled, trace_measured, CostModel, whatif,
        ClusterGraph, WorkerSpec,          # N-worker global-graph simulation
        Optimization, Scenario, Stack, Prediction,   # unified what-if API
        register, get_optimization,        # the optimization registry
    )

The simulator, the transforms, the cost model, the cluster/fold engines and
the what-if registry are the reference's, with the same thread and channel
names (``device``, ``host``, ``ici:<axis>``, ``w<i>/...``), so graphs and
predictions agree task for task with ``repro.core``.

Trace acquisition differs: where the reference parses compiled HLO
(``repro.core.hlo``), the port builds the graph from a torch.profiler
capture, either of a real step on the card (Kineto/CUPTI:
:mod:`repro_torch.core.kineto`, :func:`repro_torch.core.trace.trace_measured`)
or of the step run on meta tensors, priced by the cost model with no card
(:mod:`repro_torch.core.analytical`,
:func:`repro_torch.core.trace.trace_compiled`).  Those modules import torch
and are loaded only when one of their names is first read from this
package, so ``import repro_torch.core`` stays a pure-Python import.
"""

import importlib

from .task import (Task, TaskKind, HardwareSpec, TPU_V5E, H100_SXM, HOST_THREAD,
                   DEVICE_STREAM, DATA_THREAD, DMA_CHANNEL, ici_channel,
                   p2p_channel, worker_thread, split_worker_thread)
from .graph import DependencyGraph, GraphError
from .simulate import (simulate, simulate_incremental, simulate_reference,
                       SimResult, default_schedule, lane_utilization,
                       make_priority_schedule)
from .cluster import (ClusterGraph, ClusterResult, WorkerSpec,
                      match_collective_gid_groups, match_collective_groups,
                      match_push_pull_groups, match_wired_p2p)
from .fold import (FoldedClusterGraph, FoldedClusterResult, WorkerClass,
                   fold_cluster, fold_plan, partition_workers)
from .transform import (GraphTransform, predicted_speedup, by_kind, by_name,
                        by_layer, by_phase, on_device, all_of, any_of)
from .costmodel import CostModel, CollectiveModel, MeshTopology
from .layermap import LayerMap, LayerProfile, bucket_layers
from .optimize import (Optimization, OptimizationError, PipelineParallel,
                       Prediction, Scenario, Stack, available,
                       get_optimization, greedy_search, parse_stack,
                       register)
from . import optimize
from . import whatif

# name -> module of the trace route, imported on first access
_LAZY = {"TraceBundle": "trace", "trace_compiled": "trace",
         "trace_measured": "trace", "measure_wallclock": "trace",
         "graph_from_events": "kineto",
         "graph_from_meta_events": "analytical"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Task", "TaskKind", "HardwareSpec", "TPU_V5E", "H100_SXM",
    "HOST_THREAD", "DEVICE_STREAM", "DATA_THREAD", "DMA_CHANNEL", "ici_channel",
    "p2p_channel", "worker_thread", "split_worker_thread",
    "DependencyGraph", "GraphError",
    "simulate", "simulate_incremental", "simulate_reference", "SimResult",
    "default_schedule", "lane_utilization", "make_priority_schedule",
    "ClusterGraph", "ClusterResult", "WorkerSpec",
    "match_collective_gid_groups", "match_collective_groups",
    "match_push_pull_groups", "match_wired_p2p",
    "FoldedClusterGraph", "FoldedClusterResult", "WorkerClass",
    "fold_cluster", "fold_plan", "partition_workers",
    "GraphTransform", "predicted_speedup",
    "by_kind", "by_name", "by_layer", "by_phase", "on_device", "all_of", "any_of",
    "CostModel", "CollectiveModel", "MeshTopology",
    "graph_from_events", "graph_from_meta_events",
    "LayerMap", "LayerProfile", "bucket_layers",
    "TraceBundle", "trace_compiled", "trace_measured", "measure_wallclock",
    "Optimization", "OptimizationError", "PipelineParallel", "Prediction",
    "Scenario", "Stack",
    "available", "get_optimization", "greedy_search", "parse_stack",
    "register",
    "optimize", "whatif",
]
