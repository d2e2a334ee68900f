"""torch.profiler capture import: the port's counterpart of :mod:`.xla`.

torch.profiler writes one Chrome trace-event JSON document per profiled
process: ``profile.export_chrome_trace(path)``, or
``torch.profiler.tensorboard_trace_handler(dir)``'s
``<worker>.<timestamp>.pt.trace.json[.gz]``.  It holds Kineto's CPU
operators and ``record_function`` scopes, the CUDA runtime and driver calls
and CUPTI's kernel, memcpy and memset records, linked by correlation ids.
Its top-level object starts with ``schemaVersion`` and ``deviceProperties``
before ``traceEvents``.

A file is one worker.  Its graph is
:func:`repro_torch.core.kineto.graph_from_events`'s, the graph
``trace_measured`` builds from the same events (launch-queue waits
included): on the CUDA route when the document lists a device or holds a
device record, else on the CPU route.  Its events are that graph's
simulated timeline (:func:`~.chrome.events_from_graph`), from 0; several
files are shifted by their captures' relative start (files of one host
share its clock) and clock-aligned on matched collectives like any trace
set.
Durations are the captured ones, so :mod:`repro_torch.analysis.diff` and
:mod:`repro_torch.analysis.calibrate` compare against what the card ran.

:func:`find_torch_profiler_files` is what
:func:`repro_torch.traceio.load_trace_dir` keys its detection on: a
``*.pt.trace.json[.gz]`` name, or a ``*.json[.gz]`` document whose first
top-level key is ``schemaVersion`` or ``deviceProperties``.
"""

from __future__ import annotations

import glob
import gzip
import os
import re
from typing import Any, Dict, List, Tuple

from repro_torch.core.graph import DependencyGraph
from repro_torch.core.kineto import DEVICE_CATS, graph_from_events
from repro_torch.core.simulate import simulate

from .align import ClockAlignment, align_traces, apply_alignment
from .chrome import events_from_graph
from .events import TraceImportError, WorkerTrace
from .importer import ImportedCluster, worker_order
from .xla import _read_trace_json

_US = 1e6      # Chrome microseconds -> seconds
_SUFFIXES = (".pt.trace.json", ".pt.trace.json.gz")
_FIRST_KEY = re.compile(r'^\s*\{\s*"(schemaVersion|deviceProperties)"')


def _is_torch_profiler_file(path: str) -> bool:
    """Whether ``path`` is a torch.profiler Chrome trace: by its name, or by
    the first key of its top-level object (read from the file's head)."""
    if path.endswith(_SUFFIXES):
        return True
    if not path.endswith((".json", ".json.gz")):
        return False
    try:
        with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
            head = f.read(4096)
    except (OSError, EOFError, UnicodeDecodeError):
        return False
    return bool(_FIRST_KEY.match(head))


def find_torch_profiler_files(path: str) -> List[str]:
    """torch.profiler trace files at ``path`` (one file, or a directory's
    ``*.json[.gz]`` files), in worker order: by the first integer in the
    name, then by name.  ``[]`` when there is none."""
    if os.path.isfile(path):
        return [path] if _is_torch_profiler_file(path) else []
    files = [f for f in glob.glob(os.path.join(path, "*.json"))
             + glob.glob(os.path.join(path, "*.json.gz"))
             if _is_torch_profiler_file(f)]
    return sorted(files, key=worker_order)


def read_torch_profiler(path: str, worker: int = 0
                        ) -> Tuple[DependencyGraph, WorkerTrace, float]:
    """One torch.profiler file -> (its step graph, its worker trace from 0,
    the capture's first timestamp in seconds on its own clock)."""
    doc = _read_trace_json(path)
    events: List[Dict[str, Any]] = [e for e in doc["traceEvents"]
                                    if isinstance(e, dict)]
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if not timed:
        raise TraceImportError(f"{path}: capture has no complete (ph=X) events")
    cuda = bool(doc.get("deviceProperties")) or any(
        e.get("cat") in DEVICE_CATS for e in timed)
    try:
        graph = graph_from_events(events, device="cuda" if cuda else "cpu")
    except ValueError as e:
        raise TraceImportError(f"{path}: {e}") from e
    if not len(graph):
        raise TraceImportError(f"{path}: capture holds no task")
    t0 = min(float(e["ts"]) for e in timed) / _US
    trace = events_from_graph(graph, simulate(graph))
    return graph, WorkerTrace(worker=worker, events=trace, source=path), t0


def load_torch_profile(path: str) -> ImportedCluster:
    """Load torch.profiler captures (a file, or a directory of them, one
    file per worker) into an :class:`ImportedCluster`."""
    files = find_torch_profiler_files(path)
    if not files:
        raise TraceImportError(f"{path!r} holds no torch.profiler trace "
                               f"(*.pt.trace.json[.gz], or a document that "
                               f"starts with schemaVersion/deviceProperties)")
    graphs, traces, starts = [], [], []
    for i, f in enumerate(files):
        g, tr, t0 = read_torch_profiler(f, i)
        graphs.append(g)
        traces.append(tr)
        starts.append(t0)
    for tr, t0 in zip(traces, starts):        # relative, to keep precision
        for ev in tr.events:
            ev.ts += t0 - min(starts)
    if len(traces) > 1:
        alignments = align_traces(traces)
        for tr, al in zip(traces, alignments):
            apply_alignment(tr, al)
    else:
        alignments = [ClockAlignment()]
    firsts = [tr.first_ts() for tr in traces]
    t0 = min(firsts)
    return ImportedCluster(graphs=graphs, traces=traces, alignments=alignments,
                           start_skews=[f - t0 for f in firsts])
