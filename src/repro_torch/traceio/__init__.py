"""Trace I/O: real per-worker profiler traces <-> simulation graphs.

Daydream's premise (§4.1) is that the dependency graph comes from
*low-level traces*; this package supplies that path for the cluster
simulator.  It turns N independently-captured per-worker traces into the
asymmetric global graph :meth:`repro_torch.core.cluster.ClusterGraph
.from_worker_graphs` simulates, and exports predictions back out so they
open in Perfetto.

Pipeline::

    trace_dir/worker*.{jsonl,json}
        │  readers: native JSONL (events.read_jsonl) and Chrome
        │  trace-event JSON (chrome.read_chrome) -> TraceEvent streams
        ▼
    align.align_traces       dPRO-style clock alignment: least-squares
        │                    per-worker offset+drift, anchored on matched
        ▼                    collective end times
    importer.graph_from_events
        │                    tasks + stream-order lanes + flow/correlation
        ▼                    cross-thread edges, host-gap inference
    ClusterGraph.from_traces / Scenario(trace_dir=...)
        │                    matched collectives -> ring / hierarchical /
        ▼                    fused cross-worker structures
    chrome.export_graph_trace / export_cluster_traces
                             predictions -> Chrome JSON (Perfetto);
                             re-importable (round-trip invariant)

Format contract: :mod:`repro_torch.traceio.events` (native JSONL) and
:mod:`repro_torch.traceio.chrome` (Chrome trace-event subset), byte for byte
the reference's, so a trace exported by either package imports in the
other.  :func:`load_trace_dir` detects two kinds of real capture:
torch.profiler's (``export_chrome_trace`` / ``tensorboard_trace_handler``
output, one file per worker), imported through
:mod:`repro_torch.traceio.torch_profiler` into the same graph
``repro_torch.core.trace_measured`` builds; and ``jax.profiler`` /
XLA-profiler captures (TensorBoard profile logdirs with
``plugins/profile/<run>/*.trace.json.gz``), imported through
:mod:`repro_torch.traceio.xla` (device/step annotations mapped onto the lane
model).  Synthetic trace sets for tests/benchmarks:
:mod:`repro_torch.traceio.synthetic`.

Gap inference modes (``infer_gaps`` on :func:`load_trace_dir` /
:func:`graph_from_events`) — Daydream §4.2.1's *gap* is untraced runtime
between consecutive tasks on one thread:

* ``"host"`` (default): infer missing gaps from inter-event idle time on
  host threads only.  Device/channel idle is dependency *waiting*, which
  the graph already expresses; baking it into gaps would pin what-if
  predictions to the captured timeline.
* ``"all"``: infer on every thread — use when a capture has no
  dependency information at all and the timeline should replay as-is.
* ``"none"``: never infer; only explicitly recorded gaps survive.

Clock alignment guards: degenerate anchor sets fall back to offset-only
fits (:data:`repro_torch.traceio.align.SCALE_MIN` / ``SCALE_MAX`` bounds on the
drift term), and multi-worker sets that cannot be anchored at all warn by
default — pass ``align="strict"`` to :func:`load_trace_dir` to make both
conditions raise instead.

Counter-track schema (``counters=True`` on the exporters, default): each
worker's :class:`repro_torch.obs.TimelineSet` is emitted as phase-``"C"``
Chrome counter events — ``{"ph": "C", "name": <track>, "pid": <worker>,
"tid": 0, "ts": <µs>, "args": {"value": <v>}}``, one sample per change
point plus a closing sample at the makespan.  Tracks per worker:
``utilization`` (busy-lane fraction, 0..1), ``ready_queue``
(dependency-ready tasks awaiting dispatch; both always emitted),
``memory_bytes`` (live activation+gradient bytes — present when the
Scenario byte maps are passed through) and ``comm_bytes_in_flight``
(present when the worker communicates).  Single-file exports of
multi-worker graphs prefix track names with ``w<i>/``.  Every reader in
this package (``read_chrome``, ``read_xla_trace``) skips ``"C"`` events,
so counter-carrying files import byte-identically to counter-free ones
and the round-trip invariant is untouched.

Self-instrumentation: the import pipeline itself emits JSONL spans
(``traceio.load_trace_dir`` and downstream ``cluster.from_worker_graphs``)
when ``REPRO_TELEMETRY=<path>`` is set or a launch CLI passes
``--telemetry PATH`` — see :mod:`repro_torch.obs.spans`.

User surface: ``Scenario(trace_dir=...)`` runs any registered optimization
stack on imported traces, ``Scenario.diff_against`` compares a prediction
with a capture task by task, and ``Scenario.calibrate()`` fits the CostModel
to the capture (:mod:`repro_torch.analysis`).  The reference's CLI forms
(``launch.perf_report --trace-dir``, ``launch.calibrate``) are not carried
over yet.
"""

from .events import (TraceEvent, TraceImportError, WorkerTrace, classify,
                     infer_collective, read_jsonl, write_jsonl)
from .chrome import (chrome_trace_dict, counter_track_events,
                     events_from_graph, export_cluster_traces,
                     export_graph_trace, predicted_worker_events,
                     read_chrome)
from .align import (ClockAlignment, align_traces, apply_alignment,
                    collective_end_anchors)
from .importer import (ImportedCluster, find_worker_files, graph_from_events,
                       load_trace_dir, load_worker_trace)
from .synthetic import synthetic_cluster_traces, write_synthetic_trace_dir
from .xla import find_xla_trace_files, load_xla_profile, read_xla_trace
from .torch_profiler import (find_torch_profiler_files, load_torch_profile,
                             read_torch_profiler)

__all__ = [
    "TraceEvent", "TraceImportError", "WorkerTrace",
    "classify", "infer_collective", "read_jsonl", "write_jsonl",
    "chrome_trace_dict", "counter_track_events", "events_from_graph",
    "export_cluster_traces", "export_graph_trace",
    "predicted_worker_events", "read_chrome",
    "ClockAlignment", "align_traces", "apply_alignment",
    "collective_end_anchors",
    "ImportedCluster", "find_worker_files", "graph_from_events",
    "load_trace_dir", "load_worker_trace",
    "synthetic_cluster_traces", "write_synthetic_trace_dir",
    "find_xla_trace_files", "load_xla_profile", "read_xla_trace",
    "find_torch_profiler_files", "load_torch_profile", "read_torch_profiler",
]
