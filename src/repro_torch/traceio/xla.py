"""XLA profiler (``jax.profiler``) capture import.

``jax.profiler.trace(logdir)`` / ``jax.profiler.start_trace(logdir)``
write a TensorBoard-style profile directory::

    logdir/plugins/profile/<run-timestamp>/<host>.trace.json.gz
    logdir/plugins/profile/<run-timestamp>/<host>.xplane.pb

The ``.trace.json.gz`` file is gzipped Chrome trace-event JSON, one per
host, with every device/host stream of that host as a ``(pid, tid)`` pair:
device processes (or, on CPU-backed captures, the XLA runtime threads of
the ``/host:CPU`` process) carry HLO-op slices tagged with
``args.hlo_op`` / ``args.hlo_module``; the python host thread carries the
profiler's nested call-stack flames; ``jax.profiler.StepTraceAnnotation``
shows up as slices carrying ``args.step_num``.

This reader maps those captures onto the lane model the rest of
:mod:`repro_torch.traceio` uses (one non-overlapping event sequence per thread):

* **step slicing** — with step annotations present, only events inside the
  selected step's window are kept (``step="last"`` by default: the last —
  warmed-up — step; an int selects a specific ``step_num``; ``None``
  keeps the whole capture);
* **leaf extraction** — profiler flames nest (a python frame contains its
  callees; an HLO module slice contains its ops), which violates the lane
  model, so each ``(pid, tid)`` keeps only its *leaf* slices — the frames
  where time is actually spent — and residual overlaps are clipped;
* **lane naming** — threads holding HLO-op slices (or XLA-runtime thread
  names) become ``device`` lanes, python/host threads become ``host``
  lanes, anything else keeps a sanitized thread name;
* **kinds** — from the lane plus the usual name classification
  (:func:`repro_torch.traceio.events.classify`), so HLO collectives
  (``all-reduce.N`` ...) land as :data:`TaskKind.COLLECTIVE` with their
  lane order preserved.

XLA's Chrome export carries no flow events on these captures, so
cross-thread dependencies are not recoverable: the imported graph has
per-lane program order only, which preserves every duration (what
calibration fits against) but lets a simulation compact inter-lane idle
time.

One *worker* per device process — or per host file when the capture is
CPU-backed (single ``/host:CPU`` process).  Multi-host captures are
clock-aligned through matched collectives like any other trace set.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .align import ClockAlignment, align_traces, apply_alignment
from .events import TraceEvent, TraceImportError, WorkerTrace
from .importer import ImportedCluster, graph_from_events

_US = 1e6     # Chrome microseconds -> seconds

# XLA runtime execution threads (device streams on CPU-backed captures).
_DEVICE_THREAD = re.compile(
    r"XLATfrtCpuClient|XlaLauncher|StreamExecutor|TpuDriver|/device:", re.I)
_HOST_THREAD = re.compile(r"^python$|main_thread|^host", re.I)
# Background service threads that are not part of the training step.
_NOISE_THREAD = re.compile(r"llvm-codegen|compile|Profiler|pthread", re.I)


def find_xla_trace_files(path: str) -> List[str]:
    """Per-host ``.trace.json(.gz)`` files of an XLA profile capture.

    ``path`` may be the profiler logdir (the newest run under
    ``plugins/profile/`` wins), one run directory, or one trace file.
    Returns ``[]`` when ``path`` holds no XLA capture — the signal
    :func:`repro_torch.traceio.load_trace_dir` keys its format detection on.
    """
    if os.path.isfile(path):
        return [path] if path.endswith((".trace.json", ".trace.json.gz")) \
            else []
    runs = sorted(glob.glob(os.path.join(path, "plugins", "profile", "*")))
    in_run_dir = bool(runs)
    candidates = [runs[-1]] if runs else [path]
    for cand in candidates:
        files = sorted(glob.glob(os.path.join(cand, "*.trace.json.gz"))
                       + glob.glob(os.path.join(cand, "*.trace.json")))
        if not in_run_dir:
            # a bare directory of worker<N>.trace.json files is this
            # package's *native* Chrome export, not an XLA capture —
            # claiming it would bypass the provenance-aware importer
            files = [f for f in files
                     if not re.match(r"worker\d+\.trace\.json$",
                                     os.path.basename(f))]
        if files:
            return files
    return []


def _read_trace_json(path: str) -> Dict[str, Any]:
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise TraceImportError(f"{path}: not a readable Chrome trace "
                               f"({e})") from e
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise TraceImportError(
            f"{path}: expected a Chrome trace object with 'traceEvents'")
    return doc


def _leaf_slices(evs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Leaves of one thread's flame stack, in time order.

    Nested profiler slices (python frames over their callees, HLO module
    slices over their ops) attribute the same wall time at every depth;
    the lane model needs each instant counted once, so only slices that
    contain no other slice survive.
    """
    evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
    out: List[Dict[str, Any]] = []
    stack: List[List[Any]] = []          # [event, end, is_leaf]
    for e in evs:
        while stack and e["ts"] >= stack[-1][1]:
            top = stack.pop()
            if top[2]:
                out.append(top[0])
        if stack:
            stack[-1][2] = False
        stack.append([e, e["ts"] + e["dur"], True])
    while stack:
        top = stack.pop()
        if top[2]:
            out.append(top[0])
    return sorted(out, key=lambda e: e["ts"])


def _clip_overlaps(evs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Force strictly sequential slices (tiny profiler-rounding overlaps
    between adjacent leaves get clipped, zero-length remnants dropped)."""
    out: List[Dict[str, Any]] = []
    cursor = float("-inf")
    for e in evs:
        ts, dur = e["ts"], e["dur"]
        if ts < cursor:
            dur -= cursor - ts
            ts = cursor
        if dur <= 0:
            continue
        e = dict(e, ts=ts, dur=dur)
        cursor = ts + dur
        out.append(e)
    return out


def _step_window(events: List[Dict[str, Any]],
                 step: Union[str, int, None]
                 ) -> Optional[Tuple[float, float]]:
    """Resolve one annotated step's [start, end] window over a whole file.

    ``jax.profiler.StepTraceAnnotation`` slices carry ``args.step_num`` —
    but only on the annotating (host) thread, so the window must be
    computed file-wide and then applied to *every* thread, device lanes
    included.  ``step="last"`` picks the highest step number (steady
    state), an int picks that step, ``None`` keeps everything.  Returns
    ``None`` (keep everything) for unannotated captures.
    """
    if step is None:
        return None
    markers: Dict[int, Tuple[float, float]] = {}
    for e in events:
        num = (e.get("args") or {}).get("step_num")
        if num is None:
            continue
        lo, hi = markers.get(int(num), (float("inf"), float("-inf")))
        markers[int(num)] = (min(lo, e["ts"]),
                             max(hi, e["ts"] + e["dur"]))
    if not markers:
        return None
    if step == "last":
        chosen = max(markers)
    else:
        chosen = int(step)
        if chosen not in markers:
            raise TraceImportError(
                f"step {chosen} not in capture (annotated steps: "
                f"{sorted(markers)})")
    return markers[chosen]


def _select_step(events: List[Dict[str, Any]],
                 window: Optional[Tuple[float, float]]
                 ) -> List[Dict[str, Any]]:
    """Restrict one thread's X events to a :func:`_step_window` (marker
    slices themselves are dropped — they are annotations, not work)."""
    if window is None:
        return events
    lo, hi = window
    return [e for e in events
            if e["ts"] >= lo and e["ts"] + e["dur"] <= hi
            and (e.get("args") or {}).get("step_num") is None]


def _lane_name(thread_name: str, has_hlo: bool, used: Dict[str, int]) -> str:
    """Map one profiler thread onto a lane name (``device`` / ``host`` /
    sanitized), deduplicated with ``:<k>`` suffixes.  Host-name patterns
    win over HLO presence: CPU-backed captures can run small HLO programs
    inline on the python thread, which is still host time."""
    if _HOST_THREAD.search(thread_name):
        base = "host"
    elif has_hlo or _DEVICE_THREAD.search(thread_name):
        base = "device"
    else:
        base = re.sub(r"[^\w.-]+", "_", thread_name).strip("_") or "aux"
    used[base] = used.get(base, 0) + 1
    return base if used[base] == 1 else f"{base}:{used[base]}"


def read_xla_trace(path: str, *, step: Union[str, int, None] = "last"
                   ) -> List[WorkerTrace]:
    """Read one per-host ``.trace.json(.gz)`` file into worker traces.

    One worker per device process; CPU-backed captures (a single
    ``/host:CPU`` process) yield one worker.  Worker numbering here is
    file-local — :func:`load_xla_profile` renumbers across hosts.
    """
    doc = _read_trace_json(path)
    proc_names: Dict[Any, str] = {}
    thread_names: Dict[Tuple[Any, Any], str] = {}
    by_thread: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        if ph == "M":
            args = ev.get("args") or {}
            if ev.get("name") == "process_name":
                proc_names[ev.get("pid")] = str(args.get("name", ""))
            elif ev.get("name") == "thread_name":
                thread_names[(ev.get("pid"), ev.get("tid"))] = \
                    str(args.get("name", ""))
        elif ph == "X":
            key = (ev.get("pid"), ev.get("tid"))
            by_thread.setdefault(key, []).append(
                {"name": str(ev.get("name", "")),
                 "ts": float(ev.get("ts", 0.0)),
                 "dur": float(ev.get("dur", 0.0)),
                 "args": ev.get("args") or {}})
    if not by_thread:
        raise TraceImportError(f"{path}: capture has no complete (ph=X) "
                               f"events")

    window = _step_window(
        [e for evs in by_thread.values() for e in evs], step)
    traces: List[WorkerTrace] = []
    for pid in sorted({k[0] for k in by_thread}, key=str):
        threads = sorted((k for k in by_thread if k[0] == pid),
                         key=lambda k: str(k[1]))
        proc_is_device = "/device:" in proc_names.get(pid, "")
        used: Dict[str, int] = {}
        events: List[TraceEvent] = []
        for key in threads:
            tname = thread_names.get(key, f"tid{key[1]}")
            if _NOISE_THREAD.search(tname):
                continue
            evs = _select_step(by_thread[key], window)
            evs = _clip_overlaps(_leaf_slices(evs))
            if not evs:
                continue
            has_hlo = any("hlo_op" in e["args"] for e in evs)
            lane = _lane_name(tname, has_hlo or (
                proc_is_device and not _HOST_THREAD.search(tname)), used)
            for e in evs:
                args = e["args"]
                attrs = {k: v for k, v in args.items()
                         if isinstance(v, (str, int, float, bool))}
                attrs["xla_thread"] = tname
                events.append(TraceEvent(
                    name=str(args.get("hlo_op") or e["name"]),
                    thread=lane, ts=e["ts"] / _US, dur=e["dur"] / _US,
                    eid=len(events), attrs=attrs))
        if events:
            traces.append(WorkerTrace(worker=len(traces), events=events,
                                      source=f"{path}#pid={pid}"))
    if not traces:
        raise TraceImportError(
            f"{path}: no usable worker events after step slicing "
            f"(step={step!r})")
    return traces


def load_xla_profile(path: str, *, step: Union[str, int, None] = "last",
                     infer_gaps: str = "host") -> ImportedCluster:
    """Load a ``jax.profiler`` capture into an :class:`ImportedCluster`.

    ``path`` is the profiler logdir, one run directory, or one trace file
    (see :func:`find_xla_trace_files`).  Workers from one host file share
    that host's clock (identity alignment); multi-host captures are
    aligned through matched collectives like native trace sets.
    """
    files = find_xla_trace_files(path)
    if not files:
        raise TraceImportError(
            f"{path!r} holds no XLA profile (*.trace.json[.gz] under "
            f"plugins/profile/<run>/)")
    traces: List[WorkerTrace] = []
    file_of: List[int] = []
    for fi, f in enumerate(files):
        for tr in read_xla_trace(f, step=step):
            tr.worker = len(traces)
            traces.append(tr)
            file_of.append(fi)
    if len(set(file_of)) > 1:
        alignments = align_traces(traces)
        for tr, al in zip(traces, alignments):
            apply_alignment(tr, al)
    else:
        alignments = [ClockAlignment() for _ in traces]
    firsts = [tr.first_ts() for tr in traces]
    t0 = min(firsts, default=0.0)
    start_skews = [max(0.0, f - t0) for f in firsts]
    graphs = [graph_from_events(tr, infer_gaps=infer_gaps) for tr in traces]
    return ImportedCluster(graphs=graphs, traces=traces,
                           alignments=alignments, start_skews=start_skews)
