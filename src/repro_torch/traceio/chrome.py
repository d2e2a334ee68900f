"""Chrome trace-event JSON: reader and exporters.

The Chrome trace-event format is what the JAX/XLA profiler, TensorBoard's
trace viewer, and most GPU profilers emit, and what Perfetto / ``chrome://
tracing`` open.  This module reads the subset needed to reconstruct a
dependency graph, and writes predictions back out so simulated timelines
open in the same viewers.

Reader contract (:func:`read_chrome`)
-------------------------------------

* The file is either ``{"traceEvents": [...]}`` or a bare event list.
* ``ph == "X"`` complete events become :class:`~repro_torch.traceio.events
  .TraceEvent`\\ s; ``ts``/``dur`` are microseconds (per the spec) and are
  converted to seconds.  Task metadata is taken from ``args`` when present
  (``kind``, ``gap``, ``layer``, ``phase``, ``flops``, ``bytes``,
  ``comm_bytes``, ``collective``, ``group_size``, ``id``) and inferred from
  the event name/thread otherwise.
* ``ph == "M"`` ``thread_name``/``process_name`` metadata names the
  threads; unnamed tids become ``t<tid>`` (prefixed ``p<pid>/`` when the
  file contains several pids).
* ``ph == "C"`` counter events (the tracks our exporters emit — see
  below) are *skipped*: they describe derived series, not tasks, so a
  counter-carrying file imports byte-identically to its counter-free twin.
* Dependencies: flow events (``ph`` in ``s``/``t``/``f``) keyed by
  ``(cat, id)``.  A flow binds to the slice named by ``args.bind`` (our
  export extension: the X event's ``args.id``); foreign traces fall back to
  timestamp binding — ``s`` to the latest slice on its (pid, tid) starting
  at or before ``ts``, ``t``/``f`` to the earliest slice starting at or
  after ``ts``.  Each ``t``/``f`` depends on the closest preceding ``s`` of
  its flow id.  Events sharing ``args.correlation`` (GPU launch/kernel
  correlation ids) are also linked earliest-to-rest.

Exporters
---------

:func:`events_from_graph` turns a simulated graph into events (explicit
cross-thread deps; same-thread order is carried by timestamps), and
:func:`export_graph_trace` / :func:`export_cluster_traces` write Chrome
JSON — the latter writes **one file per worker**, collapsing cross-worker
collective structures (ring legs / hierarchical stages, tagged with
``attrs["coll_gid"]`` at build time) back into one per-worker collective
event spanning first-leg start to last-leg finish, exactly what a real
per-worker profiler would have captured.  Cross-worker edges are dropped —
each file stands alone, which is what makes the export → import round trip
a real test of trace *matching* rather than graph serialization.  What
does survive is *provenance*: collapsed collectives carry their
``coll_gid``, and point-to-point hop legs carry ``args.p2p`` (src/dst
worker) plus the ``p2p_gid`` mirrored in the receiver's ``p2p_in`` — which
is how re-import (:func:`repro_torch.core.cluster.match_wired_p2p`) re-wires
pipeline stage boundaries and :mod:`repro_torch.analysis.diff` matches hops
task-by-task.  :func:`predicted_worker_events` exposes the collapsed
per-worker timelines without writing files.

Both exporters also emit Perfetto **counter tracks** (``counters=True``):
phase-``"C"`` events sampling each worker's :class:`repro_torch.obs.TimelineSet`
at every change point — ``utilization`` (busy-lane fraction, 0..1),
``ready_queue`` (dependency-ready tasks not yet dispatched),
``comm_bytes_in_flight``, and ``memory_bytes`` (live activation+gradient
bytes, present when byte maps are passed).  The reader skips them (above),
so the round-trip invariant is untouched.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import _RING_ROUNDS
from repro_torch.core.graph import DependencyGraph
from repro_torch.core.simulate import SimResult, simulate
from repro_torch.core.task import Task, TaskKind, split_worker_thread, _json_safe
from repro_torch.obs.timeline import (TimelineSet, check_result_fresh,
                                      compute_timelines)

from .events import TraceEvent, TraceImportError, WorkerTrace

_US = 1e6     # seconds -> Chrome microseconds

_LEG_SUFFIX = re.compile(r":leg\d+$")


# ================================================================== reading
def read_chrome(path: str, worker: int = 0) -> WorkerTrace:
    """Read one worker's Chrome trace-event JSON file (contract above)."""
    with open(path) as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError as e:
            raise TraceImportError(f"{path}: not valid JSON: {e}") from e
    raw = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(raw, list):
        raise TraceImportError(
            f"{path}: expected a traceEvents list, got {type(raw).__name__}")

    thread_names: Dict[Tuple[Any, Any], str] = {}
    xs: List[Tuple[Dict[str, Any], TraceEvent]] = []
    pids = set()
    for ev in raw:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "thread_name":
            thread_names[(ev.get("pid"), ev.get("tid"))] = \
                str(ev.get("args", {}).get("name", ""))
        elif ph == "X":
            pids.add(ev.get("pid"))

    def thread_of(ev: Dict[str, Any]) -> str:
        key = (ev.get("pid"), ev.get("tid"))
        name = thread_names.get(key) or f"t{ev.get('tid')}"
        if len(pids) > 1:
            name = f"p{ev.get('pid')}/{name}"
        return name

    by_eid: Dict[int, TraceEvent] = {}
    for ev in raw:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        gap = args.get("gap")
        te = TraceEvent(
            name=str(ev.get("name", "?")), thread=thread_of(ev),
            ts=float(ev.get("ts", 0.0)) / _US,
            dur=float(ev.get("dur", 0.0)) / _US,
            eid=int(args["id"]) if "id" in args else len(xs),
            kind=args.get("kind"),
            gap=None if gap is None else float(gap),
            layer=args.get("layer"), phase=args.get("phase"),
            flops=float(args.get("flops", 0.0)),
            bytes_accessed=float(args.get("bytes", 0.0)),
            comm_bytes=float(args.get("comm_bytes", 0.0)),
            collective=args.get("collective"),
            group_size=int(args.get("group_size") or 0),
            attrs={k: v for k, v in args.items()
                   if k not in ("id", "kind", "gap", "layer", "phase",
                                "flops", "bytes", "comm_bytes", "collective",
                                "group_size", "correlation") and _json_safe(v)})
        if te.eid in by_eid:
            raise TraceImportError(f"{path}: duplicate event id {te.eid}")
        by_eid[te.eid] = te
        xs.append((ev, te))

    _bind_flows(path, raw, xs, by_eid)
    _link_correlations(xs)
    events = [te for _, te in xs]
    return WorkerTrace(worker=worker, events=events, source=path)


def _bind_flows(path: str, raw: List[Any],
                xs: List[Tuple[Dict[str, Any], TraceEvent]],
                by_eid: Dict[int, TraceEvent]) -> None:
    """Turn flow events into TraceEvent.deps per the reader contract."""
    # per-(pid, tid) slice starts, sorted, for timestamp binding
    slices: Dict[Tuple[Any, Any], List[Tuple[float, TraceEvent]]] = \
        collections.defaultdict(list)
    for ev, te in xs:
        slices[(ev.get("pid"), ev.get("tid"))].append(
            (float(ev.get("ts", 0.0)), te))
    for lst in slices.values():
        lst.sort(key=lambda p: p[0])
    starts = {k: [p[0] for p in v] for k, v in slices.items()}

    def bind(ev: Dict[str, Any]) -> Optional[TraceEvent]:
        args = ev.get("args") or {}
        if "bind" in args:
            te = by_eid.get(int(args["bind"]))
            if te is None:
                raise TraceImportError(
                    f"{path}: flow event binds to unknown event id "
                    f"{args['bind']}")
            return te
        key = (ev.get("pid"), ev.get("tid"))
        if key not in starts:
            return None
        ts = float(ev.get("ts", 0.0))
        if ev.get("ph") == "s":
            idx = bisect.bisect_right(starts[key], ts) - 1
        else:
            idx = bisect.bisect_left(starts[key], ts)
        if 0 <= idx < len(slices[key]):
            return slices[key][idx][1]
        return None

    flows: Dict[Tuple[Any, Any], List[Tuple[float, str, Dict[str, Any]]]] = \
        collections.defaultdict(list)
    for ev in raw:
        if isinstance(ev, dict) and ev.get("ph") in ("s", "t", "f"):
            flows[(ev.get("cat"), ev.get("id"))].append(
                (float(ev.get("ts", 0.0)), ev.get("ph"), ev))
    for group in flows.values():
        group.sort(key=lambda p: (p[0], p[1] != "s"))
        srcs: List[Tuple[float, TraceEvent]] = []
        for ts, ph, ev in group:
            te = bind(ev)
            if te is None:
                continue
            if ph == "s":
                srcs.append((ts, te))
            elif srcs:
                src = max((s for s in srcs if s[0] <= ts),
                          default=srcs[0], key=lambda s: s[0])[1]
                if src.eid != te.eid:
                    te.deps.append(src.eid)


def _link_correlations(xs: List[Tuple[Dict[str, Any], TraceEvent]]) -> None:
    corr: Dict[Any, List[TraceEvent]] = collections.defaultdict(list)
    for ev, te in xs:
        args = ev.get("args") or {}
        cid = args.get("correlation", args.get("correlation_id"))
        if cid is not None:
            corr[cid].append(te)
    for group in corr.values():
        if len(group) < 2:
            continue
        group.sort(key=lambda t: t.ts)
        first = group[0]
        for te in group[1:]:
            if first.eid != te.eid:
                te.deps.append(first.eid)


# ================================================================ exporting
def _event_from_task(t: Task, ts: float, eid: int) -> TraceEvent:
    attrs = {k: v for k, v in t.attrs.items()
             if k not in ("collective", "group_size") and _json_safe(v)}
    return TraceEvent(
        name=t.name, thread=t.thread, ts=ts, dur=t.duration, eid=eid,
        kind=t.kind.value, gap=t.gap, layer=t.layer, phase=t.phase,
        flops=t.flops, bytes_accessed=t.bytes_accessed,
        comm_bytes=t.comm_bytes, collective=t.attrs.get("collective"),
        group_size=int(t.attrs.get("group_size") or 0), attrs=attrs)


def events_from_graph(graph: DependencyGraph,
                      result: Optional[SimResult] = None
                      ) -> List[TraceEvent]:
    """Turn a (simulated) graph into trace events.

    Timestamps come from ``result`` (simulated on the spot when omitted);
    gaps are written explicitly from the tasks, so re-importing never
    infers.  Cross-thread edges become explicit ``deps``; same-thread
    edges are implied by per-thread timestamp order (the stream-order
    contract), which every lane-consistent simulation satisfies.
    """
    result = result or simulate(graph)
    events: List[TraceEvent] = []
    eid_of: Dict[int, int] = {}
    for thread, lane in graph.lanes.items():
        pos = {uid: i for i, uid in enumerate(lane)}
        for uid in sorted(lane, key=lambda u: (result.start[u], pos[u])):
            t = graph.get(uid)
            ev = _event_from_task(t, result.start[uid], len(events))
            eid_of[uid] = ev.eid
            events.append(ev)
    for t in graph.tasks():
        for c in graph.children(t):
            if c.thread != t.thread:
                events[eid_of[c.uid]].deps.append(eid_of[t.uid])
    for ev in events:
        ev.deps = sorted(set(ev.deps))
    return events


def counter_track_events(timelines: TimelineSet, *,
                         worker: Optional[int] = None,
                         pid: int = 0) -> List[Dict[str, Any]]:
    """Phase-``"C"`` Chrome counter events sampling ``timelines``.

    One sample per change point plus a closing sample at the makespan —
    exactly the piecewise-constant series, no resampling.  ``worker``
    selects one worker's tracks under plain names (the per-worker cluster
    export); ``None`` emits every worker, prefixing names with ``w<i>/``
    when the set spans several workers (the single-file export).
    """
    from repro_torch.obs.timeline import Timeline
    workers = timelines.workers if worker is None else [worker]
    prefix_names = worker is None and len(workers) > 1
    flat = Timeline((), (), timelines.makespan)
    out: List[Dict[str, Any]] = []
    for w in workers:
        prefix = f"w{w}/" if prefix_names else ""
        # utilization/ready_queue always (a flat-zero queue is a finding:
        # nothing ever waited); memory only when byte maps sized it, comm
        # only when the worker communicated — absence is meaningful there
        tracks = (("utilization", timelines.utilization.get(w, flat)),
                  ("memory_bytes", timelines.memory.get(w)),
                  ("ready_queue", timelines.queue_depth.get(w, flat)),
                  ("comm_bytes_in_flight", timelines.comm_bytes.get(w)))
        for name, tl in tracks:
            if tl is None or (not len(tl)
                              and name not in ("utilization",
                                               "ready_queue")):
                continue
            for t, v in tl.samples():
                out.append({"ph": "C", "name": prefix + name, "pid": pid,
                            "tid": 0, "ts": t * _US, "args": {"value": v}})
    return out


def chrome_trace_dict(events: Sequence[TraceEvent], *, pid: int = 0,
                      process_name: str = "worker0",
                      counters: Optional[Sequence[Dict[str, Any]]] = None
                      ) -> Dict[str, Any]:
    """Chrome trace-event JSON object for ``events`` (one process).

    ``counters`` are pre-built phase-``"C"`` dicts
    (:func:`counter_track_events`) appended after the slices; the reader
    skips them on re-import.
    """
    tids: Dict[str, int] = {}
    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": process_name}}]
    for ev in events:
        if ev.thread not in tids:
            tids[ev.thread] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tids[ev.thread],
                        "args": {"name": ev.thread}})
    for ev in events:
        # free-form attrs first; the reserved metadata keys (the ones
        # read_chrome strips back out of args) must win over any
        # same-named attr, else an attr called "id"/"gap" would corrupt
        # flow binding and gap handling on re-import
        args: Dict[str, Any] = dict(ev.attrs)
        args.update({"id": ev.eid, "kind": ev.kind,
                     "gap": 0.0 if ev.gap is None else ev.gap})
        for key, val in (("layer", ev.layer), ("phase", ev.phase),
                         ("collective", ev.collective)):
            if val:
                args[key] = val
        for key, val in (("flops", ev.flops), ("bytes", ev.bytes_accessed),
                         ("comm_bytes", ev.comm_bytes),
                         ("group_size", ev.group_size)):
            if val:
                args[key] = val
        out.append({"ph": "X", "name": ev.name, "cat": ev.kind or "task",
                    "pid": pid, "tid": tids[ev.thread],
                    "ts": ev.ts * _US, "dur": ev.dur * _US, "args": args})
    fid = 0
    by_eid = {ev.eid: ev for ev in events}
    for ev in events:
        for dep in ev.deps:
            src = by_eid[dep]
            fid += 1
            out.append({"ph": "s", "cat": "dep", "name": "dep", "id": fid,
                        "pid": pid, "tid": tids[src.thread],
                        "ts": src.ts * _US, "args": {"bind": src.eid}})
            out.append({"ph": "f", "cat": "dep", "name": "dep", "id": fid,
                        "bp": "e", "pid": pid, "tid": tids[ev.thread],
                        "ts": ev.ts * _US, "args": {"bind": ev.eid}})
    if counters:
        out.extend(counters)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_graph_trace(graph: DependencyGraph,
                       result: Optional[SimResult] = None,
                       path: Optional[str] = None, *,
                       process_name: str = "worker0",
                       counters: bool = True,
                       activation_bytes: Optional[Dict[str, float]] = None,
                       layer_grad_bytes: Optional[Dict[str, float]] = None
                       ) -> Dict[str, Any]:
    """Export one graph's simulated timeline as Chrome trace JSON.

    Returns the trace dict; writes it to ``path`` when given.  Open the
    file in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
    ``counters=True`` adds utilization/queue/comm counter tracks (plus
    live ``memory_bytes`` when byte maps are passed — the schema in the
    module docstring); the reader skips them, so re-import is unchanged.
    """
    result = result or simulate(graph)
    cevents = None
    if counters:
        cevents = counter_track_events(compute_timelines(
            graph, result, activation_bytes=activation_bytes,
            layer_grad_bytes=layer_grad_bytes))
    trace = chrome_trace_dict(events_from_graph(graph, result),
                              process_name=process_name, counters=cevents)
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


# ------------------------------------------------- cluster per-worker export
def predicted_worker_events(cluster_graph, result
                            ) -> List[List[TraceEvent]]:
    """Per-worker predicted timelines, exactly as the cluster exporter
    writes them.

    ``result`` is a :class:`~repro_torch.core.cluster.ClusterResult` (or its
    global :class:`~repro_torch.core.simulate.SimResult`).  One event list per
    worker: ordinary tasks as-is, wired collective structures collapsed
    back into one per-worker event carrying its ``coll_gid``, p2p hop legs
    with their ``p2p``/``p2p_gid`` provenance, thread names localized.
    This is the *predicted* side of :mod:`repro_torch.analysis.diff` — diffing
    against a captured trace compares like with like, because both sides
    are per-worker profiler-shaped timelines.

    Raises when ``result`` no longer matches the graph's durations (a
    sweep retuned the shared build in place after this result was
    simulated): events would otherwise silently mix one point's
    timestamps with another point's durations.
    """
    res = getattr(result, "global_result", result)
    check_result_fresh(cluster_graph.graph, res)
    partition = cluster_graph._worker_partition()
    return [_collapse_worker(cluster_graph, res, i, partition.get(i, []))[0]
            for i in range(len(cluster_graph.workers))]


def _collective_origin(t: Task) -> Optional[str]:
    """Base collective name of a wired piece (ring leg / hierarchical
    stage), or None for ordinary tasks."""
    if "ring_round" in t.attrs:
        return _LEG_SUFFIX.sub("", t.name)
    stage = t.attrs.get("stage")
    if stage and t.name.endswith(":" + stage):
        return t.name[: -len(stage) - 1]
    return None


def _collapse_worker(cluster_graph, res: SimResult,
                     worker: int, tasks: Sequence[Task]
                     ) -> Tuple[List[TraceEvent], Dict[int, int]]:
    """Worker ``i``'s local events: ordinary tasks as-is, collective pieces
    collapsed back into one event per wired collective (by ``coll_gid``)."""
    n = len(cluster_graph.workers)
    singles: List[Task] = []
    groups: Dict[int, List[Task]] = collections.defaultdict(list)
    for t in tasks:
        if t.thread.endswith("trace/skew"):
            continue          # import artifact; skew is carried by the ts
        gid = t.attrs.get("coll_gid")
        if gid is not None and _collective_origin(t) is not None:
            groups[gid].append(t)
        else:
            singles.append(t)

    drafts: List[Tuple[float, TraceEvent, List[int]]] = []
    unit_of: Dict[int, int] = {}       # task uid -> draft index
    for t in singles:
        ev = _event_from_task(t, res.start[t.uid], -1)
        unit_of[t.uid] = len(drafts)
        drafts.append((ev.ts, ev, [t.uid]))
    for gid in sorted(groups):
        pieces = groups[gid]
        ts = min(res.start[p.uid] for p in pieces)
        end = max(res.finish[p.uid] for p in pieces)
        proto = min(pieces, key=lambda p: res.start[p.uid])
        payload = max(p.comm_bytes for p in pieces)
        if any("ring_round" in p.attrs for p in pieces):
            # legs carry payload/k chunks where k is the *group's* member
            # count — a per-stage DDP ring spans a worker subset, so the
            # cluster-wide count would inflate the payload.  k follows
            # from the leg count: rounds = _RING_ROUNDS[op] * (k - 1).
            mult = _RING_ROUNDS.get(proto.attrs.get("collective"), 1)
            k = len(pieces) // mult + 1
            payload *= k
        else:
            k = int(proto.attrs.get("group_size") or n)
        ev = TraceEvent(
            name=_collective_origin(proto) or proto.name,
            thread=proto.thread, ts=ts, dur=end - ts, eid=-1,
            kind=TaskKind.COLLECTIVE.value, gap=0.0, phase="comm",
            comm_bytes=payload, collective=proto.attrs.get("collective"),
            group_size=k, attrs={"coll_gid": gid})
        idx = len(drafts)
        drafts.append((ts, ev, [p.uid for p in pieces]))
        for p in pieces:
            unit_of[p.uid] = idx

    # order per thread by ts (stable), assign eids, localize thread names
    order = sorted(range(len(drafts)), key=lambda i: (drafts[i][0], i))
    events: List[TraceEvent] = []
    eid_of_unit: Dict[int, int] = {}
    for i in order:
        _, ev, _ = drafts[i]
        ev.eid = len(events)
        ev.thread = split_worker_thread(ev.thread)[1]
        eid_of_unit[i] = ev.eid
        events.append(ev)

    # project global edges onto worker-local event deps (one-step bridge
    # across the zero-duration cluster/sync barriers; cross-worker edges
    # are dropped — each worker's file stands alone)
    g = cluster_graph.graph
    for t in tasks:
        if t.uid not in unit_of:
            continue
        dst = unit_of[t.uid]
        parents: List[Task] = []
        for p in g.parents(t):
            w, _ = split_worker_thread(p.thread)
            if w == worker:
                parents.append(p)
            elif w is None:                       # barrier: bridge one step
                parents.extend(pp for pp in g.parents(p)
                               if split_worker_thread(pp.thread)[0] == worker)
        for p in parents:
            src = unit_of.get(p.uid)
            if src is None or src == dst:
                continue
            if events[eid_of_unit[src]].thread != events[eid_of_unit[dst]].thread:
                events[eid_of_unit[dst]].deps.append(events[eid_of_unit[src]].eid)
    for ev in events:
        ev.deps = sorted(set(ev.deps))
    return events, eid_of_unit


def export_cluster_traces(cluster_graph, result, out_dir: str, *,
                          stem: str = "worker",
                          counters: bool = True,
                          activation_bytes: Optional[Dict[str, float]] = None,
                          layer_grad_bytes: Optional[Dict[str, float]] = None
                          ) -> List[str]:
    """Export a simulated cluster as N per-worker Chrome trace files.

    ``result`` is the :class:`~repro_torch.core.cluster.ClusterResult` of
    ``cluster_graph.simulate()``.  Writes ``<stem><i>.trace.json`` per
    worker into ``out_dir`` and returns the paths.  The files re-import via
    :meth:`ClusterGraph.from_traces` — the round-trip invariant the test
    suite anchors on: a uniform cluster's re-import reproduces the
    predicted makespan.

    ``counters=True`` adds each worker's utilization/queue/comm counter
    tracks (plus live ``memory_bytes`` when byte maps are passed), computed
    once on the global graph and sliced per worker; the reader skips them,
    so the round-trip invariant is untouched.
    """
    os.makedirs(out_dir, exist_ok=True)
    timelines = None
    if counters:
        timelines = compute_timelines(
            cluster_graph.graph, result, activation_bytes=activation_bytes,
            layer_grad_bytes=layer_grad_bytes)
    paths: List[str] = []
    for i, events in enumerate(predicted_worker_events(cluster_graph,
                                                       result)):
        cevents = counter_track_events(timelines, worker=i, pid=i) \
            if timelines is not None else None
        trace = chrome_trace_dict(events, pid=i, process_name=f"worker{i}",
                                  counters=cevents)
        path = os.path.join(out_dir, f"{stem}{i}.trace.json")
        with open(path, "w") as f:
            json.dump(trace, f)
        paths.append(path)
    return paths
