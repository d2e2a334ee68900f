"""Trace acquisition: a PyTorch step function -> Daydream dependency graph.

Daydream Phase 1 (paper §4.1) as the paper runs it on GPUs: the step runs
under torch.profiler (Kineto over CUPTI) and :mod:`repro_torch.core.kineto`
turns the capture into a graph whose durations are the measured ones, so
unlike the reference's ``trace_measured`` nothing is rescaled.

* :func:`trace_compiled` — the reference's analytical route, which needs no
  card: the step runs once on ``meta`` tensors (``init_params(cfg,
  device="meta")``, meta batches) under torch.profiler, and
  :mod:`repro_torch.core.analytical` prices each operator it dispatched,
  each kernel launch included, with :class:`CostModel` (the H100 SXM's data
  sheet by default).
* :func:`trace_measured` — warm up, profile a few calls, build the graph
  of the fastest; on request also time a few calls' issue without the
  profiler, and report the host scale that would take the host lane to
  that pace (ROADMAP C5).
* :func:`measure_wallclock` — the step's time without the profiler: the
  median over calls of CUDA-event time (host clock on the CPU).

``trace_measured(..., save_to=path)`` also writes the kept capture as
torch.profiler exported it, which :func:`repro_torch.traceio.load_trace_dir`
reads back into the same graph; ``TraceBundle.export_chrome`` writes the
simulated step as this package's native Chrome export.
"""

from __future__ import annotations

import dataclasses
import gc
import gzip
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch import resolve_device
from .analytical import graph_from_meta_events
from .costmodel import CostModel
from .graph import DependencyGraph
from .kineto import CAPTURE_KEY, graph_from_events
from .simulate import SimResult, simulate
from .task import DEVICE_STREAM, H100_SXM, HOST_THREAD


@dataclasses.dataclass
class TraceBundle:
    """Everything Daydream knows about one step function.  ``module`` is the
    capture's raw trace events (the reference keeps the HLO module there)."""

    graph: DependencyGraph
    module: List[Dict[str, Any]]
    aggregates: Dict[str, float]
    cost: CostModel
    compiled: Any = None
    measured_step_s: Optional[float] = None

    def simulate(self, schedule=None) -> SimResult:
        return simulate(self.graph, schedule)

    def export_chrome(self, path: str,
                      result: Optional[SimResult] = None) -> Dict[str, Any]:
        """Export the (simulated) step timeline as Chrome trace-event JSON.

        Opens in Perfetto / ``chrome://tracing``; re-importable via
        :mod:`repro_torch.traceio` (the round-trip reproduces the simulated
        makespan).  ``result`` defaults to a fresh :meth:`simulate`.
        """
        from repro_torch.traceio import export_graph_trace
        return export_graph_trace(self.graph, result or self.simulate(),
                                  path)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_wallclock(fn: Callable, *args, device="cuda", iters: int = 10,
                      warmup: int = 3, **kwargs) -> float:
    """Median seconds per call of ``fn(*args, **kwargs)``: on CUDA the time
    between two events recorded around the call on the current stream
    (each call ends in a sync before the next starts), on the CPU the host
    clock."""
    dev = resolve_device(device)
    times = []
    for i in range(warmup + iters):
        _sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            dt = time.perf_counter() - t0
        if i >= warmup:
            times.append(dt)
    times.sort()
    return times[len(times) // 2]


def profile_events(fn: Callable, *args, device="cuda", **kwargs
                   ) -> List[Dict[str, Any]]:
    """The trace events of one call of ``fn`` (ending in a device sync) under
    torch.profiler with CPU (and on CUDA, CUDA) activities and shapes: the
    ``traceEvents`` of :func:`profile_trace`'s document."""
    return profile_trace(fn, *args, device=device, **kwargs)["traceEvents"]


def profile_trace(fn: Callable, *args, device="cuda", **kwargs
                  ) -> Dict[str, Any]:
    """The Chrome trace document torch.profiler exports for one call of
    ``fn`` (ending in a device sync) with CPU (and on CUDA, CUDA) activities
    and shapes, with ``CAPTURE_KEY: {"issue_s": ...}`` added: the host
    seconds from the call to its return, before the sync.

    ``with_flops`` stays off: its counts do not reach the exported trace
    (:mod:`.kineto` computes the matrix products' FLOPs from the recorded
    shapes), and the host time it adds to every operator stretches the
    profiled step where the host paces the device, which the simulation
    would then reproduce as if it were the step's own.

    Python's cyclic garbage collector is run first and paused during the
    call: the parsed traces of earlier captures are hundreds of thousands
    of objects each, and a collection that traverses them inside the call
    stretches the host time the simulation reproduces (ROADMAP C5)."""
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    gc.collect()
    paused = gc.isenabled()
    gc.disable()
    try:
        with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            issue_s = time.perf_counter() - t0
            _sync(dev)
    finally:
        if paused:
            gc.enable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    doc[CAPTURE_KEY] = {"issue_s": issue_s}
    return doc


def host_span_s(events: List[Dict[str, Any]]) -> float:
    """Seconds from the first to the end of the last host-side record
    (operator or CUDA runtime/driver call) of a capture."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e
          and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    return (max(e["ts"] + e.get("dur", 0) for e in xs)
            - min(e["ts"] for e in xs)) * 1e-6


def trace_compiled(fn: Callable, *args, cost: Optional[CostModel] = None,
                   max_tasks: int = 60_000, **kwargs) -> TraceBundle:
    """Analytical trace: run ``fn(*args, **kwargs)`` once on meta tensors
    under torch.profiler and build its graph and the reference's aggregates
    (``repro.core.hlo.aggregate_costs``'s keys) from the operators it
    dispatched, priced by ``cost`` (default ``CostModel(hw=H100_SXM)``).
    Every tensor argument must be on the ``meta`` device: nothing is
    allocated or computed, on the card or the CPU.  ``compiled`` is None
    (there is no compiled program)."""
    bad = [t.device for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor) and not t.is_meta]
    if bad:
        raise ValueError(f"trace_compiled needs meta tensors, got tensors on "
                         f"{sorted(set(map(str, bad)))}")
    cost = cost or CostModel(hw=H100_SXM)
    events = profile_events(fn, *args, device="meta", **kwargs)
    graph, agg = graph_from_meta_events(events, cost, max_tasks=max_tasks)
    return TraceBundle(graph=graph, module=events, aggregates=agg, cost=cost)


# calls timed without the profiler where a caller asks for the host scale
PACE_CALLS = 3


def trace_measured(fn: Callable, *args, device="cuda",
                   cost: Optional[CostModel] = None, warmup: int = 2,
                   profiles: int = 3, save_to: Optional[str] = None,
                   pace_calls: int = 0, **kwargs) -> TraceBundle:
    """Profile ``profiles`` calls of ``fn(*args, **kwargs)`` after ``warmup``
    calls, one capture each, and build the dependency graph of the capture
    with the shortest host span, with measured durations.  On a shared host
    the pace varies from call to call; the fastest capture is the one least
    slowed by other load.

    The simulation reproduces the pace of the host it captured, and the
    profiler slows the host (ROADMAP C5).  With ``pace_calls`` (on CUDA),
    that many calls between the warm-up and the captures are timed without
    the profiler (the host clock from the call to its return, before a
    sync), and ``aggregates["host_scale"]`` is ``min(1, median of those /
    the kept capture's host-lane total)``: the factor that
    ``kineto.scale_host_lane`` would apply to take the lane (the host's own
    work, its waits on a full launch queue released to the device) to the
    unprofiled pace.  The graph is returned as captured.  A caller that
    applies the scale calibrates the simulation on this step's own host
    time: where the host paces the card, the scaled step then reproduces
    the unprofiled call by construction, so it is a base for what-ifs, not
    a prediction of this step.  On the CPU the operators are the device's
    work and the scale is 1.

    ``cost`` (for tasks that what-ifs insert) defaults to the H100 SXM's
    data sheet on CUDA and to the reference's default on the CPU.
    ``save_to`` (a ``*.pt.trace.json[.gz]`` path) receives the kept
    capture's document as torch.profiler exported it (with
    ``CAPTURE_KEY``'s issue time), which
    :func:`repro_torch.traceio.load_trace_dir` reads back into the same
    graph.  The bundle's ``aggregates["calls"]`` counts the calls of ``fn``
    made here."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync(dev)
    issue = []
    for _ in range(pace_calls if dev.type == "cuda" else 0):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        issue.append(time.perf_counter() - t0)
        _sync(dev)
    doc, spans = None, []
    for _ in range(max(1, profiles)):
        got = profile_trace(fn, *args, device=dev, **kwargs)
        spans.append(host_span_s(got["traceEvents"]))
        if spans[-1] == min(spans):
            doc = got
        del got
    if save_to is not None:
        with (gzip.open(save_to, "wt") if save_to.endswith(".gz")
              else open(save_to, "w")) as f:
            json.dump(doc, f)
    events = doc["traceEvents"]
    graph = graph_from_events(events, device=dev.type)
    lane_s = sum(t.duration + t.gap for t in graph.lane_tasks(HOST_THREAD))
    unprofiled = sorted(issue)[len(issue) // 2] if issue else None
    scale = 1.0 if unprofiled is None else min(1.0, unprofiled / lane_s)
    if cost is None:
        cost = CostModel(hw=H100_SXM) if dev.type == "cuda" else CostModel()
    tasks = graph.tasks()
    dev_tasks = [t for t in tasks if t.thread == DEVICE_STREAM]
    agg = {"flops": sum(t.flops for t in dev_tasks),
           "bytes_accessed": sum(t.bytes_accessed for t in dev_tasks),
           "device_s": sum(t.duration for t in dev_tasks),
           "device_tasks": float(len(dev_tasks)),
           "host_tasks": float(len(tasks) - len(dev_tasks)),
           "span_s": min(spans), "slowest_span_s": max(spans),
           "host_scale": scale, "issue_s": doc[CAPTURE_KEY]["issue_s"],
           "host_lane_s": lane_s,
           "unprofiled_issue_s": unprofiled,
           "calls": float(warmup + len(issue) + max(1, profiles))}
    return TraceBundle(graph=graph, module=events, aggregates=agg, cost=cost)
