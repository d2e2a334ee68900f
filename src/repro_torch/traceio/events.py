"""Trace events and the native JSONL per-worker trace format.

This module is the *format contract* of the trace I/O subsystem
(Daydream §4.1: the dependency graph is built from low-level traces).  A
trace set is a directory with **one file per worker**; workers are ordered
by the first integer in the file name (``worker0.jsonl``, ``worker1.json``,
...), falling back to lexicographic order.

Native JSONL format (``*.jsonl``)
---------------------------------

One JSON object per line; blank lines and lines whose object carries a
``"trace"`` key (file metadata) are ignored.  Event fields:

``name``        task name (required)
``thread``      execution stream — ``device`` / ``host`` / ``ici:<axis>`` /
                ``dma`` / ``data`` (required; free-form threads allowed)
``ts``          start time in **seconds**, worker-local clock (required)
``dur``         duration in seconds (required)
``id``          event id referenced by ``deps`` (default: line ordinal)
``deps``        explicit dependency event ids (cross-thread edges; same-
                thread program order is implied by ``ts`` order per thread)
``kind``        :class:`~repro_torch.core.task.TaskKind` value string; inferred
                from the name/thread when absent
``gap``         Daydream §4.2.1 untraced follow-on time in seconds.  When
                absent, the importer *infers* it from the idle time to the
                next same-thread event (host threads only by default) —
                records written by this repo always carry it explicitly.
``layer`` / ``phase`` / ``flops`` / ``bytes`` / ``comm_bytes``
                optional task metadata (see :meth:`repro_torch.core.task.Task
                .to_record`)
``collective``  collective op (``all-reduce`` | ``reduce-scatter`` |
                ``all-gather`` | ``all-to-all`` | ``collective-permute``);
                inferred from the name when absent.  Collectives are what
                :func:`repro_torch.core.cluster.match_collective_groups` matches
                across workers and what clock alignment anchors on.
``group_size``  collective group size as captured (informational)
``attrs``       free-form JSON-safe dict merged into ``Task.attrs``

Chrome trace-event JSON (``*.json``) is read by :mod:`repro_torch.traceio.chrome`
and normalized into the same :class:`TraceEvent` records.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.core.task import Task, TaskKind, HOST_THREAD, DATA_THREAD, \
    DMA_CHANNEL


class TraceImportError(RuntimeError):
    """A trace file/set that cannot be turned into a simulation graph."""


# Collective-op inference from task/kernel names (covers XLA HLO names,
# NCCL kernel names, and our own exports).
_COLLECTIVE_PATTERNS = [
    ("all-reduce", re.compile(r"all[-_ ]?reduce|ncclAllReduce", re.I)),
    ("reduce-scatter", re.compile(r"reduce[-_ ]?scatter|ncclReduceScatter",
                                  re.I)),
    ("all-gather", re.compile(r"all[-_ ]?gather|ncclAllGather", re.I)),
    ("all-to-all", re.compile(r"all[-_ ]?to[-_ ]?all|ncclAllToAll", re.I)),
    ("collective-permute", re.compile(r"collective[-_ ]?permute|"
                                      r"ncclSend|ncclRecv", re.I)),
]


def infer_collective(name: str) -> Optional[str]:
    """Canonical collective op named by ``name``, or None."""
    for op, rx in _COLLECTIVE_PATTERNS:
        if rx.search(name):
            return op
    return None


def classify(name: str, thread: str,
             collective: Optional[str] = None) -> TaskKind:
    """Default task-kind classification for events without an explicit kind.

    Collective names win; otherwise the thread decides (Daydream binds kinds
    to execution threads: host/data/DMA streams carry host/data/offload
    tasks, everything else is device compute).
    """
    if collective or infer_collective(name):
        return TaskKind.COLLECTIVE
    local = thread.rsplit("/", 1)[-1]
    if local == HOST_THREAD or local.startswith("host"):
        return TaskKind.HOST
    if local == DATA_THREAD:
        return TaskKind.DATA
    if local == DMA_CHANNEL:
        return TaskKind.OFFLOAD
    if local.startswith("ici"):
        return TaskKind.COLLECTIVE
    return TaskKind.COMPUTE


@dataclasses.dataclass
class TraceEvent:
    """One profiled event, normalized across trace formats.

    ``ts``/``dur``/``gap`` are seconds in the *worker-local* clock until
    :func:`repro_torch.traceio.align.apply_alignment` rescales them.  ``deps``
    are event ids (explicit cross-thread dependencies); same-thread program
    order comes from per-thread ``ts`` order.
    """

    name: str
    thread: str
    ts: float
    dur: float
    eid: int = -1
    deps: List[int] = dataclasses.field(default_factory=list)
    kind: Optional[str] = None          # TaskKind value string
    gap: Optional[float] = None         # None => importer may infer
    layer: Optional[str] = None
    phase: Optional[str] = None
    flops: float = 0.0
    bytes_accessed: float = 0.0
    comm_bytes: float = 0.0
    collective: Optional[str] = None
    group_size: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def resolved_collective(self) -> Optional[str]:
        return self.collective or infer_collective(self.name)

    def to_task(self) -> Task:
        """Materialize the event as a graph :class:`Task` (no deps/ts)."""
        coll = self.resolved_collective()
        kind = TaskKind(self.kind) if self.kind \
            else classify(self.name, self.thread, coll)
        attrs = dict(self.attrs)
        if coll and kind == TaskKind.COLLECTIVE:
            attrs.setdefault("collective", coll)
            if self.group_size:
                attrs.setdefault("group_size", self.group_size)
        return Task(name=self.name, kind=kind, thread=self.thread,
                    duration=self.dur, gap=self.gap or 0.0, layer=self.layer,
                    phase=self.phase, flops=self.flops,
                    bytes_accessed=self.bytes_accessed,
                    comm_bytes=self.comm_bytes, attrs=attrs)

    def to_json(self) -> Dict[str, Any]:
        """The native JSONL line for this event (see module docstring)."""
        rec: Dict[str, Any] = {"name": self.name, "thread": self.thread,
                               "ts": self.ts, "dur": self.dur,
                               "id": self.eid}
        if self.deps:
            rec["deps"] = list(self.deps)
        if self.kind:
            rec["kind"] = self.kind
        if self.gap is not None:
            rec["gap"] = self.gap
        for key, val in (("layer", self.layer), ("phase", self.phase)):
            if val:
                rec[key] = val
        for key, val in (("flops", self.flops),
                         ("bytes", self.bytes_accessed),
                         ("comm_bytes", self.comm_bytes)):
            if val:
                rec[key] = val
        if self.collective:
            rec["collective"] = self.collective
        if self.group_size:
            rec["group_size"] = self.group_size
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec

    @staticmethod
    def from_json(rec: Dict[str, Any], default_eid: int) -> "TraceEvent":
        try:
            name = str(rec["name"])
            thread = str(rec["thread"])
            ts = float(rec["ts"])
            dur = float(rec["dur"])
        except KeyError as e:
            raise TraceImportError(
                f"trace event missing required field {e.args[0]!r}: {rec!r}"
            ) from e
        gap = rec.get("gap")
        return TraceEvent(
            name=name, thread=thread, ts=ts, dur=dur,
            eid=int(rec.get("id", default_eid)),
            deps=[int(d) for d in rec.get("deps", ())],
            kind=rec.get("kind"),
            gap=None if gap is None else float(gap),
            layer=rec.get("layer"), phase=rec.get("phase"),
            flops=float(rec.get("flops", 0.0)),
            bytes_accessed=float(rec.get("bytes", 0.0)),
            comm_bytes=float(rec.get("comm_bytes", 0.0)),
            collective=rec.get("collective"),
            group_size=int(rec.get("group_size") or 0),
            attrs=dict(rec.get("attrs", {})))


@dataclasses.dataclass
class WorkerTrace:
    """One worker's captured events plus bookkeeping."""

    worker: int
    events: List[TraceEvent]
    source: str = ""

    def collectives(self) -> List[TraceEvent]:
        return [e for e in self.events if e.resolved_collective()]

    def first_ts(self) -> float:
        return min((e.ts for e in self.events), default=0.0)


def read_jsonl(path_or_lines: Union[str, Iterable[str]],
               worker: int = 0) -> WorkerTrace:
    """Read a native JSONL worker trace (path, open file, or line iterable)."""
    source = path_or_lines if isinstance(path_or_lines, str) else "<lines>"
    if isinstance(path_or_lines, str):
        fh: Any = open(path_or_lines, "r")
        close = True
    else:
        fh, close = path_or_lines, False
    events: List[TraceEvent] = []
    try:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceImportError(
                    f"{source}:{lineno}: not valid JSON: {e}") from e
            if not isinstance(rec, dict) or "trace" in rec:
                continue                    # metadata line
            events.append(TraceEvent.from_json(rec, default_eid=len(events)))
    finally:
        if close:
            fh.close()
    eids = [e.eid for e in events]
    if len(set(eids)) != len(eids):
        raise TraceImportError(f"{source}: duplicate event ids")
    return WorkerTrace(worker=worker, events=events, source=source)


def write_jsonl(events: Sequence[TraceEvent],
                path: Optional[str] = None, *,
                meta: Optional[Dict[str, Any]] = None) -> List[str]:
    """Write events as native JSONL; returns the lines (also when ``path``
    is None, for in-memory round-trips)."""
    header = {"trace": "repro-jsonl", "version": 1, **(meta or {})}
    lines = [json.dumps(header)]
    lines += [json.dumps(e.to_json()) for e in events]
    if path is not None:
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return lines
