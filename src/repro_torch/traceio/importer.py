"""Trace import: per-worker event streams -> simulation-ready graphs.

This is Daydream Phase 1 (§4.1) for *captured* traces: every event becomes
a :class:`~repro_torch.core.task.Task`, dependencies are reconstructed from

1. **stream order** — events on one thread execute in timestamp order, so
   each per-thread lane is chained in program order (the graph's lane
   edges), and
2. **explicit deps** — flow/correlation ids (Chrome) or ``deps`` lists
   (native JSONL) become cross-thread edges,

and Daydream's *gap* (§4.2.1, untraced runtime between consecutive tasks
on one thread) is inferred from idle time on host threads when the trace
does not record it explicitly.

:func:`load_trace_dir` is the directory-level entry point: one trace file
per worker (see :mod:`repro_torch.traceio.events` for ordering and formats),
clock-aligned (:mod:`repro_torch.traceio.align`) and turned into one
:class:`~repro_torch.core.graph.DependencyGraph` per worker plus the per-worker
start skews.  Feed the result to
:meth:`repro_torch.core.cluster.ClusterGraph.from_traces` /
``Scenario(trace_dir=...)``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import warnings
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.graph import DependencyGraph, GraphError
from repro_torch.core.task import HOST_THREAD
from repro_torch.obs.spans import span as _obs_span

from .align import ClockAlignment, align_traces, apply_alignment
from .chrome import read_chrome
from .events import TraceEvent, TraceImportError, WorkerTrace, read_jsonl

_NUM = re.compile(r"(\d+)")


@dataclasses.dataclass
class ImportedCluster:
    """A loaded trace set: aligned events, per-worker graphs, start skews."""

    graphs: List[DependencyGraph]
    traces: List[WorkerTrace]
    alignments: List[ClockAlignment]
    start_skews: List[float]

    @property
    def num_workers(self) -> int:
        return len(self.graphs)

    def first_ts(self) -> float:
        """Earliest (aligned) timestamp across all workers — the capture's
        time origin."""
        return min((tr.first_ts() for tr in self.traces), default=0.0)

    def worker_events(self, *, rebase: bool = True
                      ) -> List[List["TraceEvent"]]:
        """Per-worker aligned event streams; with ``rebase`` (default) all
        timestamps shift so the earliest event across workers sits at t=0 —
        the same origin a simulated timeline uses, which is what
        :mod:`repro_torch.analysis.diff` compares against.  Events are copies;
        the stored traces are never mutated."""
        t0 = self.first_ts() if rebase else 0.0
        return [[dataclasses.replace(ev, ts=ev.ts - t0,
                                     deps=list(ev.deps),
                                     attrs=dict(ev.attrs))
                 for ev in tr.events] for tr in self.traces]


def graph_from_events(trace: WorkerTrace, *,
                      infer_gaps: str = "host") -> DependencyGraph:
    """Reconstruct one worker's dependency graph from its events.

    ``infer_gaps``: ``"host"`` (default) infers missing gaps from
    inter-event idle time on host threads only — device/channel idle is
    dependency waiting, which the graph already expresses, and baking it
    into gaps would pin what-if predictions to the captured timeline;
    ``"all"`` infers on every thread; ``"none"`` never infers.
    """
    if infer_gaps not in ("host", "all", "none"):
        raise ValueError(f"infer_gaps must be host|all|none, "
                         f"got {infer_gaps!r}")
    g = DependencyGraph()
    lanes: Dict[str, List[TraceEvent]] = {}
    for ev in trace.events:
        lanes.setdefault(ev.thread, []).append(ev)
    task_of: Dict[int, object] = {}
    for thread, evs in lanes.items():
        evs.sort(key=lambda e: e.ts)          # stable: ties keep file order
        infer = infer_gaps == "all" or (
            infer_gaps == "host"
            and thread.rsplit("/", 1)[-1] == HOST_THREAD)
        for i, ev in enumerate(evs):
            t = ev.to_task()
            if ev.gap is None and infer and i + 1 < len(evs):
                t.gap = max(0.0, evs[i + 1].ts - ev.end)
            if ev.eid in task_of:
                raise TraceImportError(
                    f"{trace.source}: duplicate event id {ev.eid}")
            task_of[ev.eid] = g.add_task(t)   # lane-linked program order
    for ev in trace.events:
        dst = task_of[ev.eid]
        for dep in ev.deps:
            src = task_of.get(dep)
            if src is None:
                raise TraceImportError(
                    f"{trace.source}: event {ev.eid} ({ev.name!r}) depends "
                    f"on unknown event id {dep}")
            if src is not dst:
                g.add_edge(src, dst)
    try:
        g.validate()
    except GraphError as e:
        raise TraceImportError(
            f"{trace.source}: imported events do not form a DAG ({e}); "
            f"check flow/deps ids against the stream order") from e
    return g


def find_worker_files(trace_dir: str) -> List[str]:
    """Per-worker trace files in ``trace_dir``, in worker order.

    Accepts ``*.jsonl`` (native) and ``*.json`` (Chrome trace-event) files;
    order is by the first integer in the file name, then lexicographic —
    ``worker0.jsonl``, ``worker1.jsonl``, ... as written by the exporters.
    """
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.jsonl"))
                   + glob.glob(os.path.join(trace_dir, "*.json")))
    return sorted(paths, key=worker_order)


def worker_order(path: str):
    """Sort key of a worker file: the first integer in its name, then the
    name."""
    m = _NUM.search(os.path.basename(path))
    return (int(m.group(1)) if m else float("inf"), os.path.basename(path))


def load_worker_trace(path: str, worker: int = 0) -> WorkerTrace:
    """Read one worker trace file, dispatching on the extension."""
    if path.endswith(".jsonl"):
        return read_jsonl(path, worker)
    if path.endswith(".json"):
        return read_chrome(path, worker)
    raise TraceImportError(
        f"{path}: unknown trace format (expected .jsonl or .json)")


def _check_alignment_quality(alignments: Sequence[ClockAlignment],
                             strict: bool, source: str) -> None:
    """Flag multi-worker alignments that could not actually align.

    ``anchors == 0`` means a worker shares no matched collective with the
    set and kept its own clock verbatim (identity map); ``fallback`` means
    the drift fit was degenerate and only the offset was corrected.  Either
    way the diff/calibration downstream compares against possibly-skewed
    clocks, so warn by default and raise under ``align="strict"``.
    """
    unanchored = [i for i, al in enumerate(alignments) if al.anchors == 0]
    fallbacks = [i for i, al in enumerate(alignments) if al.fallback]
    if not unanchored and not fallbacks:
        return
    parts = []
    if unanchored:
        parts.append(f"worker(s) {unanchored} share no matched collectives "
                     f"with the set (identity clock map)")
    if fallbacks:
        parts.append(f"worker(s) {fallbacks} had a degenerate drift fit "
                     f"(offset-only fallback)")
    msg = (f"{source}: clock alignment is unreliable — " + "; ".join(parts)
           + "; timestamps may be cross-worker skewed")
    if strict:
        raise TraceImportError(msg)
    warnings.warn(msg, stacklevel=3)


def load_trace_dir(trace_dir: str, *,
                   align: Union[bool, str] = True,
                   infer_gaps: str = "host") -> ImportedCluster:
    """Load a per-worker trace directory into an :class:`ImportedCluster`.

    Reads every worker file, clock-aligns the traces (``align=True``; see
    :mod:`repro_torch.traceio.align`), reconstructs one graph per worker, and
    computes each worker's *start skew* — how much later than the earliest
    worker it began its step on the aligned timeline.  The skews become
    zero-duration gate tasks in
    :meth:`~repro_torch.core.cluster.ClusterGraph.from_worker_graphs`, so a
    worker that genuinely started late stays late in the simulation.

    ``align`` is ``True`` (align, warn when a multi-worker set cannot be
    anchored), ``False`` (keep local clocks), or ``"strict"`` (align, raise
    :class:`TraceImportError` when any worker has no anchors or needed the
    offset-only fallback).

    The format is detected, in this order: torch.profiler captures
    (``*.pt.trace.json[.gz]``, or documents that start with
    ``schemaVersion``/``deviceProperties``) are routed through
    :func:`repro_torch.traceio.torch_profiler.load_torch_profile`; XLA
    profiler captures (``jax.profiler`` log directories holding
    ``plugins/profile/<run>/*.trace.json.gz``) through
    :func:`repro_torch.traceio.xla.load_xla_profile`; anything else is this
    package's native export.  A torch.profiler file also matches the XLA
    reader's ``*.trace.json`` pattern, hence its place first.
    """
    if align not in (True, False, "strict"):
        raise ValueError(f"align must be True, False or 'strict', "
                         f"got {align!r}")
    if not os.path.isdir(trace_dir):
        raise TraceImportError(f"trace dir {trace_dir!r} does not exist")
    from .torch_profiler import find_torch_profiler_files, load_torch_profile
    from .xla import find_xla_trace_files, load_xla_profile
    with _obs_span("traceio.load_trace_dir", dir=trace_dir) as sp:
        if find_torch_profiler_files(trace_dir):
            sp.note(format="torch.profiler")
            return load_torch_profile(trace_dir)
        if find_xla_trace_files(trace_dir):
            sp.note(format="xla")
            return load_xla_profile(trace_dir, infer_gaps=infer_gaps)
        files = find_worker_files(trace_dir)
        if not files:
            raise TraceImportError(
                f"trace dir {trace_dir!r} has no *.jsonl / *.json worker "
                f"files")
        traces = [load_worker_trace(f, i) for i, f in enumerate(files)]
        if align and len(traces) > 1:
            alignments = align_traces(traces)
            _check_alignment_quality(alignments, align == "strict",
                                     trace_dir)
            for tr, al in zip(traces, alignments):
                apply_alignment(tr, al)
        else:
            alignments = [ClockAlignment() for _ in traces]
        firsts = [tr.first_ts() for tr in traces]
        t0 = min(firsts, default=0.0)
        start_skews = [max(0.0, f - t0) for f in firsts]
        graphs = [graph_from_events(tr, infer_gaps=infer_gaps)
                  for tr in traces]
        sp.note(format="native", workers=len(graphs),
                events=sum(len(tr.events) for tr in traces))
        return ImportedCluster(graphs=graphs, traces=traces,
                               alignments=alignments,
                               start_skews=start_skews)
