"""Modeled optimizations (paper §5 + Appendix A) — legacy function surface.

The implementations live in :mod:`repro_torch.core.optimize` as registered
:class:`~repro_torch.core.optimize.Optimization` dataclasses (one per paper
algorithm; see the table in that module's docstring).  Every function here
is a thin wrapper that builds the matching optimization and a
:class:`~repro_torch.core.optimize.Scenario`, kept so existing call sites and
notebooks keep working:

* ``what_if_*``          -> analytical single-graph route, returns the
  applied :class:`GraphTransform`.
* ``cluster_what_if_*``  -> global-cluster route (worker specs -> dPRO-style
  :class:`ClusterGraph`), returns the per-worker :class:`ClusterResult`.
  ``collective_mode`` threads through every cluster wrapper uniformly.

Paper table-1 coverage (all composable via ``optimize.Stack`` / ``|``):
  AMP, FusedAdam, Reconstructing-Norm, DDP insertion, P3,          (evaluated, §5.1)
  BlueConnect, MetaFlow, vDNN, Gist, DGC                            (modeled,   §5.2)
Beyond-paper what-ifs:
  ZeRO optimizer sharding, collective overlap, straggler, bandwidth
  scaling, gradient accumulation.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from .cluster import ClusterResult, WorkerSpec, _as_specs
from .costmodel import CostModel
from .graph import DependencyGraph
from .optimize import (AMP, DDP, DGC, P3, Bandwidth, BlueConnect,
                       FusedNorm, FusedOptimizer, Gist, GradAccum,
                       GRAD_CHANNEL, Offload, OverlapCollectives,
                       PipelineParallel, RemoveLayer, ScaleLayer, Scenario,
                       Stack, Straggler, ZeRO, extend_next_forward)
from .transform import GraphTransform

_worker_specs = _as_specs       # int N or explicit WorkerSpec list, validated

__all__ = [
    "GRAD_CHANNEL", "extend_next_forward",
    "what_if_amp", "what_if_fused_optimizer", "what_if_fused_norm",
    "what_if_distributed", "what_if_p3", "what_if_blueconnect",
    "what_if_remove_layer", "what_if_scale_layer", "what_if_offload",
    "what_if_gist", "what_if_dgc", "what_if_zero",
    "what_if_overlap_collectives", "what_if_straggler", "what_if_bandwidth",
    "what_if_grad_accum",
    "cluster_what_if_distributed", "cluster_what_if_zero",
    "cluster_what_if_p3", "cluster_what_if_straggler",
    "cluster_what_if_bandwidth", "cluster_what_if_pipeline",
]


# --------------------------------------------------------------------- AMP
def what_if_amp(graph: DependencyGraph, *, matmul_speedup: float = 3.0,
                memory_speedup: float = 2.0) -> GraphTransform:
    """Paper Algorithm 3 (AMP) — see :class:`repro_torch.core.optimize.AMP`."""
    return AMP(matmul_speedup=matmul_speedup,
               memory_speedup=memory_speedup).apply(Scenario(graph))


# -------------------------------------------------------------- FusedAdam
def what_if_fused_optimizer(graph: DependencyGraph,
                            cost: Optional[CostModel] = None
                            ) -> GraphTransform:
    """Paper Algorithm 4 (FusedAdam) — see
    :class:`repro_torch.core.optimize.FusedOptimizer`."""
    return FusedOptimizer().apply(Scenario(graph, cost=cost))


# ------------------------------------------------- Reconstructing BatchNorm
def what_if_fused_norm(graph: DependencyGraph, *, norm_layer: str = "norm",
                       activation_pattern: str = r"max|tanh|gelu|silu|logistic",
                       norm_speedup: float = 2.0) -> GraphTransform:
    """Paper Algorithm 5 (Reconstructing Batchnorm) — see
    :class:`repro_torch.core.optimize.FusedNorm`."""
    return FusedNorm(norm_layer=norm_layer,
                     activation_pattern=activation_pattern,
                     norm_speedup=norm_speedup).apply(Scenario(graph))


# ------------------------------------------------------ Distributed (DDP)
def what_if_distributed(graph: DependencyGraph,
                        layer_grad_bytes: Dict[str, float],
                        num_workers: int,
                        *, bandwidth: Optional[float] = None,
                        bucket_bytes: float = 25 * 1024 * 1024,
                        cost: Optional[CostModel] = None,
                        crosses_pod: bool = False) -> GraphTransform:
    """Paper Algorithm 6 (DDP) — see :class:`repro_torch.core.optimize.DDP`."""
    return DDP(bucket_bytes=bucket_bytes, bandwidth=bandwidth,
               crosses_pod=crosses_pod).apply(
        Scenario(graph, cost=cost, layer_grad_bytes=layer_grad_bytes,
                 workers=num_workers))


# ------------------------------------------------------------------- P3
def what_if_p3(graph: DependencyGraph, layer_grad_bytes: Dict[str, float],
               num_workers: int, *, bandwidth: float,
               slice_bytes: float = 4 * 1024 * 1024,
               priority: bool = True,
               cost: Optional[CostModel] = None) -> GraphTransform:
    """Paper Algorithm 7 (P3) — see :class:`repro_torch.core.optimize.P3`."""
    return P3(bandwidth=bandwidth, slice_bytes=slice_bytes,
              priority=priority).apply(
        Scenario(graph, cost=cost, layer_grad_bytes=layer_grad_bytes,
                 workers=num_workers))


# ------------------------------------------------------------ BlueConnect
def what_if_blueconnect(graph: DependencyGraph, axes: Sequence[Tuple[str, int]],
                        cost: Optional[CostModel] = None) -> GraphTransform:
    """Paper Algorithm 8 (BlueConnect) — see
    :class:`repro_torch.core.optimize.BlueConnect`."""
    return BlueConnect(axes=tuple(axes)).apply(Scenario(graph, cost=cost))


# --------------------------------------------------------------- MetaFlow
def what_if_remove_layer(graph: DependencyGraph, layer_pattern: str
                         ) -> GraphTransform:
    """Paper Algorithm 9 Remove_layer."""
    return RemoveLayer(layer_pattern=layer_pattern).apply(Scenario(graph))


def what_if_scale_layer(graph: DependencyGraph, layer_pattern: str,
                        scale: float) -> GraphTransform:
    """Paper Algorithm 9 Scale_layer."""
    return ScaleLayer(layer_pattern=layer_pattern,
                      scale=scale).apply(Scenario(graph))


# ------------------------------------------------------------------ vDNN
def what_if_offload(graph: DependencyGraph, layer_pattern: str,
                    activation_bytes: Dict[str, float],
                    cost: Optional[CostModel] = None,
                    prefetch_distance: int = 1) -> GraphTransform:
    """Paper Algorithm 10 (vDNN) — see
    :class:`repro_torch.core.optimize.Offload`."""
    return Offload(layer_pattern=layer_pattern,
                   prefetch_distance=prefetch_distance).apply(
        Scenario(graph, cost=cost, activation_bytes=activation_bytes))


# ------------------------------------------------------------------ Gist
def what_if_gist(graph: DependencyGraph, layer_pattern: str,
                 activation_bytes: Dict[str, float],
                 cost: Optional[CostModel] = None,
                 codec_bytes_per_elem_ratio: float = 2.0) -> GraphTransform:
    """Paper Algorithm 11 (Gist) — see :class:`repro_torch.core.optimize.Gist`."""
    return Gist(layer_pattern=layer_pattern,
                codec_bytes_per_elem_ratio=codec_bytes_per_elem_ratio).apply(
        Scenario(graph, cost=cost, activation_bytes=activation_bytes))


# ------------------------------------------------------------------- DGC
def what_if_dgc(graph: DependencyGraph, *, compression: float = 0.01,
                codec_flops_per_byte: float = 4.0,
                cost: Optional[CostModel] = None) -> GraphTransform:
    """Paper Algorithm 12 (DGC) — see :class:`repro_torch.core.optimize.DGC`."""
    return DGC(compression=compression,
               codec_flops_per_byte=codec_flops_per_byte).apply(
        Scenario(graph, cost=cost))


# ------------------------------------------------------- beyond the paper
def what_if_zero(graph: DependencyGraph, num_workers: int,
                 cost: Optional[CostModel] = None) -> GraphTransform:
    """ZeRO-1/2 style sharding — see :class:`repro_torch.core.optimize.ZeRO`."""
    return ZeRO().apply(Scenario(graph, cost=cost, workers=num_workers))


def what_if_overlap_collectives(graph: DependencyGraph) -> GraphTransform:
    """Async collectives — see
    :class:`repro_torch.core.optimize.OverlapCollectives`."""
    return OverlapCollectives().apply(Scenario(graph))


def what_if_straggler(graph: DependencyGraph, *, slowdown: float = 1.5,
                      affected_fraction: float = 1.0) -> GraphTransform:
    """Amortized straggler model — see
    :class:`repro_torch.core.optimize.Straggler`."""
    return Straggler(slowdown=slowdown,
                     affected_fraction=affected_fraction).apply(
        Scenario(graph))


def what_if_bandwidth(graph: DependencyGraph, factor: float
                      ) -> GraphTransform:
    """Paper Fig. 2 example — see :class:`repro_torch.core.optimize.Bandwidth`."""
    return Bandwidth(factor=factor).apply(Scenario(graph))


def what_if_grad_accum(graph: DependencyGraph, microbatches: int
                       ) -> GraphTransform:
    """Gradient accumulation — see
    :class:`repro_torch.core.optimize.GradAccum`."""
    return GradAccum(microbatches=microbatches).apply(Scenario(graph))


# --------------------------------------------------- cluster-routed what-ifs
# The ``num_workers`` what-ifs above splice *analytical* collective costs
# into one worker's graph — every worker collapses onto one timeline.  The
# ``cluster_*`` wrappers below set a :class:`WorkerSpec` list on the
# Scenario, which routes the same registered optimizations through
# :class:`repro_torch.core.cluster.ClusterGraph`: one global simulation with a
# per-worker :class:`SimResult` breakdown — answering questions the
# single-graph path cannot (stragglers, skewed links, mixed generations).

def cluster_what_if_distributed(graph: DependencyGraph,
                                layer_grad_bytes: Dict[str, float],
                                workers, *,
                                bucket_bytes: float = 25 * 1024 * 1024,
                                cost: Optional[CostModel] = None,
                                collective_mode: str = "ring"
                                ) -> ClusterResult:
    """DDP what-if on the global cluster graph (paper Alg. 6 x dPRO).

    With uniform ``workers`` this matches :func:`what_if_distributed`'s
    single-graph prediction (the ring legs telescope to the same analytical
    collective time); heterogeneous specs answer the questions the
    single-graph path cannot.
    """
    s = Scenario(graph, cost=cost, layer_grad_bytes=layer_grad_bytes,
                 workers=_worker_specs(workers),
                 collective_mode=collective_mode)
    return s.predict(DDP(bucket_bytes=bucket_bytes)).cluster


def cluster_what_if_zero(graph: DependencyGraph,
                         layer_grad_bytes: Dict[str, float],
                         workers, *, cost: Optional[CostModel] = None,
                         collective_mode: str = "ring") -> ClusterResult:
    """ZeRO sharding simulated on the global graph: the reduce-scatter and
    param all-gather each become cross-worker ring legs."""
    s = Scenario(graph, cost=cost, layer_grad_bytes=layer_grad_bytes,
                 workers=_worker_specs(workers),
                 collective_mode=collective_mode)
    return s.predict(DDP() | ZeRO()).cluster


def cluster_what_if_p3(graph: DependencyGraph,
                       layer_grad_bytes: Dict[str, float],
                       workers, *, bandwidth: float,
                       slice_bytes: float = 4 * 1024 * 1024,
                       priority: bool = True,
                       cost: Optional[CostModel] = None,
                       collective_mode: str = "ring") -> ClusterResult:
    """P3 on the global graph: pushes stay worker-local (preserving the
    overlap with late backprop); pulls gate on every worker's push via the
    parameter-server aggregation barrier.  The priority schedule carries
    over to the global simulation unchanged."""
    s = Scenario(graph, cost=cost, layer_grad_bytes=layer_grad_bytes,
                 workers=_worker_specs(workers),
                 collective_mode=collective_mode)
    return s.predict(P3(bandwidth=bandwidth, slice_bytes=slice_bytes,
                        priority=priority)).cluster


def cluster_what_if_straggler(graph: DependencyGraph,
                              layer_grad_bytes: Dict[str, float],
                              num_workers: int, *,
                              straggler: int = 0, slowdown: float = 1.5,
                              cost: Optional[CostModel] = None,
                              collective_mode: str = "ring") -> ClusterResult:
    """One slow worker, modeled structurally: unlike :func:`what_if_straggler`
    (which amortizes the delay into every collective's duration), the
    straggler's late gradients stall the ring legs and the delay propagates
    to the other workers through the dependency edges."""
    specs = [WorkerSpec(compute_scale=slowdown if i == straggler else 1.0)
             for i in range(num_workers)]
    return cluster_what_if_distributed(graph, layer_grad_bytes, specs,
                                       cost=cost,
                                       collective_mode=collective_mode)


def cluster_what_if_pipeline(graph: DependencyGraph,
                             stages: int, microbatches: int, *,
                             schedule: str = "gpipe", dp: int = 1,
                             workers=None,
                             activation_bytes: Optional[Dict[str, float]]
                             = None,
                             layer_grad_bytes: Optional[Dict[str, float]]
                             = None,
                             cost: Optional[CostModel] = None,
                             collective_mode: str = "ring") -> ClusterResult:
    """Pipeline / hybrid PP x DP placement simulated on the global graph.

    Partitions ``graph`` by layer into ``stages`` balanced stages, runs the
    GPipe or 1F1B microbatch schedule on ``stages * dp`` workers with
    point-to-point activation/gradient hops and per-stage gradient rings —
    see :class:`repro_torch.core.optimize.PipelineParallel` and
    :mod:`repro_torch.parallel.plan`.  ``workers`` (optional WorkerSpec list,
    stage-major) places stages on heterogeneous pods/stragglers.
    """
    s = Scenario(graph, cost=cost, layer_grad_bytes=layer_grad_bytes,
                 activation_bytes=activation_bytes,
                 workers=workers if workers is not None else 1,
                 collective_mode=collective_mode)
    return s.predict(PipelineParallel(stages=stages,
                                      microbatches=microbatches,
                                      schedule=schedule, dp=dp)).cluster


def cluster_what_if_bandwidth(graph: DependencyGraph,
                              layer_grad_bytes: Dict[str, float],
                              num_workers: int, *,
                              scales: Sequence[float],
                              cost: Optional[CostModel] = None,
                              collective_mode: str = "ring"
                              ) -> ClusterResult:
    """Skewed per-worker link bandwidth (paper Fig. 2's sweep, made
    per-link): ``scales[i]`` throttles the ring links adjacent to worker i,
    so one congested NIC slows only the legs that traverse it."""
    if len(scales) != num_workers:
        raise ValueError("need one bandwidth scale per worker")
    specs = [WorkerSpec(bandwidth_scale=s) for s in scales]
    return cluster_what_if_distributed(graph, layer_grad_bytes, specs,
                                       cost=cost,
                                       collective_mode=collective_mode)
