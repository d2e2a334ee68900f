"""Predicted-vs-captured trace diffing: *where* does the model disagree.

Daydream's validation methodology (paper §6) compares predicted runtimes
against ground-truth captures; dPRO refines it to per-op error
attribution.  This module turns that methodology into a reusable tool: the
predicted timeline is rendered per worker exactly as the trace exporter
writes it (:func:`repro_torch.traceio.predicted_worker_events` — collectives
collapsed to one per-worker event, p2p hops with provenance), the captured
per-worker trace is clock-aligned (:mod:`repro_torch.traceio.align`) and rebased
to t=0, and the two sides are matched task-by-task:

* primary key **(lane, name, occurrence)** — workers run the same program,
  so the k-th same-named event on a thread is the same logical operation
  (the discipline collective matching already uses);
* a second pass rescues renamed/re-homed events through *provenance*:
  collectives by ``coll_gid``, p2p hop legs by ``p2p_gid`` — exact for
  traces this repo exported, inert for foreign captures (gids simply
  absent on one side).

The output is the per-task error distribution, per-kind rollups, and a
top-K "most mispredicted tasks" report — what ``Scenario.diff_against``
returns.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import DependencyGraph
from repro_torch.core.simulate import SimResult


@dataclasses.dataclass(frozen=True)
class TaskDiff:
    """One matched (predicted, captured) task pair."""

    worker: int
    thread: str
    name: str
    occurrence: int
    kind: str
    predicted_start: float
    predicted_dur: float
    captured_start: float
    captured_dur: float

    @property
    def dur_error(self) -> float:
        """Signed duration error, seconds (positive == over-predicted)."""
        return self.predicted_dur - self.captured_dur

    @property
    def start_error(self) -> float:
        """Signed timeline-placement error, seconds."""
        return self.predicted_start - self.captured_start

    @property
    def abs_error(self) -> float:
        """Worst of |duration error| and |start error| — the "how wrong is
        this task" scalar the top-K report ranks by."""
        return max(abs(self.dur_error), abs(self.start_error))

    @property
    def rel_dur_error(self) -> float:
        """|duration error| relative to the captured duration (inf for a
        predicted-from-nothing duration)."""
        if self.captured_dur > 0:
            return abs(self.dur_error) / self.captured_dur
        return 0.0 if self.predicted_dur == 0 else float("inf")


@dataclasses.dataclass
class KindStats:
    """Error rollup for one task kind."""

    count: int = 0
    captured_s: float = 0.0
    predicted_s: float = 0.0
    abs_err_s: float = 0.0        # summed |duration error|
    max_abs_err_s: float = 0.0

    @property
    def wape(self) -> float:
        """Weighted absolute percentage error of durations (sum|err| /
        sum captured) — the per-kind headline number."""
        if self.captured_s > 0:
            return self.abs_err_s / self.captured_s
        return 0.0 if self.abs_err_s == 0 else float("inf")


@dataclasses.dataclass
class TraceDiff:
    """Full predicted-vs-captured comparison."""

    tasks: List[TaskDiff]
    unmatched_predicted: List[Tuple[int, str, str, int]]  # (w, thread, name, occ)
    unmatched_captured: List[Tuple[int, str, str, int]]
    predicted_makespan: float
    captured_makespan: float

    @property
    def makespan_error(self) -> float:
        return self.predicted_makespan - self.captured_makespan

    @property
    def makespan_rel_error(self) -> float:
        if self.captured_makespan > 0:
            return self.makespan_error / self.captured_makespan
        return 0.0 if self.predicted_makespan == 0 else float("inf")

    def max_abs_error(self) -> float:
        """Largest per-task error in the whole diff (0.0 when empty) —
        the round-trip invariant asserts this is ~0 when a prediction is
        diffed against its own export."""
        return max((d.abs_error for d in self.tasks), default=0.0)

    def per_kind(self) -> Dict[str, KindStats]:
        out: Dict[str, KindStats] = collections.defaultdict(KindStats)
        for d in self.tasks:
            st = out[d.kind]
            st.count += 1
            st.captured_s += d.captured_dur
            st.predicted_s += d.predicted_dur
            err = abs(d.dur_error)
            st.abs_err_s += err
            if err > st.max_abs_err_s:
                st.max_abs_err_s = err
        return dict(out)

    def top_mispredicted(self, k: int = 10) -> List[TaskDiff]:
        """The ``k`` worst-predicted tasks, by :attr:`TaskDiff.abs_error`
        (non-finite errors excluded — they rank by :meth:`format`'s n/a
        rows, not here)."""
        finite = [d for d in self.tasks if math.isfinite(d.abs_error)]
        return sorted(finite, key=lambda d: -d.abs_error)[:k]

    # ------------------------------------------------------------- report
    def format(self, *, top: int = 10, unit: float = 1e3,
               unit_name: str = "ms") -> str:
        lines = [f"== predicted vs captured: {len(self.tasks)} matched "
                 f"task(s), {len(self.unmatched_predicted)} unmatched "
                 f"predicted, {len(self.unmatched_captured)} unmatched "
                 f"captured =="]
        lines.append(
            f"makespan: predicted {self.predicted_makespan * unit:.3f} "
            f"{unit_name} vs captured {self.captured_makespan * unit:.3f} "
            f"{unit_name} ({_pct(self.makespan_rel_error, signed=True)})")
        kinds = self.per_kind()
        if kinds:
            lines.append(f"{'kind':12s} {'count':>6s} {'captured':>10s} "
                         f"{'predicted':>10s} {'wape':>7s} {'max|err|':>9s}")
            for kind in sorted(kinds):
                st = kinds[kind]
                lines.append(
                    f"{kind:12s} {st.count:6d} "
                    f"{st.captured_s * unit:10.3f} "
                    f"{st.predicted_s * unit:10.3f} "
                    f"{_pct(st.wape):>7s} "
                    f"{st.max_abs_err_s * unit:9.4f}")
        worst = [d for d in self.top_mispredicted(top) if d.abs_error > 0]
        if worst:
            lines.append(f"top {len(worst)} mispredicted task(s):")
            for d in worst:
                lines.append(
                    f"  w{d.worker} {d.thread:16s} {d.name}#{d.occurrence}: "
                    f"dur {d.predicted_dur * unit:.4f} vs "
                    f"{d.captured_dur * unit:.4f} {unit_name} "
                    f"({d.dur_error * unit:+.4f}), start "
                    f"{d.start_error * unit:+.4f}")
        return "\n".join(lines)


def _pct(x: float, *, signed: bool = False) -> str:
    """Render a ratio as a percentage; ``n/a`` for non-finite values
    (a zero-captured denominator has no meaningful relative error)."""
    if not math.isfinite(x):
        return "n/a"
    return f"{x * 100:+.2f}%" if signed else f"{x * 100:.2f}%"


# =============================================================== matching
def _keyed(events) -> Dict[Tuple[str, str, int], Any]:
    """(thread, name, occurrence) -> event, occurrence counted in
    (thread, ts) scan order — deterministic for any event file order."""
    seen: Dict[Tuple[str, str], int] = collections.defaultdict(int)
    out: Dict[Tuple[str, str, int], Any] = {}
    for ev in sorted(events, key=lambda e: (e.thread, e.ts, e.eid)):
        k = (ev.thread, ev.name)
        out[(ev.thread, ev.name, seen[k])] = ev
        seen[k] += 1
    return out


def _gid_of(ev) -> Optional[Tuple[str, int]]:
    """Provenance identity of an event, when it carries one."""
    gid = ev.attrs.get("coll_gid")
    if gid is not None:
        return ("coll", int(gid))
    gid = ev.attrs.get("p2p_gid")
    if gid is not None:
        return ("p2p", int(gid))
    return None


def diff_worker_events(predicted, captured, worker: int
                       ) -> Tuple[List[TaskDiff], List[Tuple], List[Tuple]]:
    """Match one worker's predicted events against its captured events.

    Primary match by (thread, name, occurrence); leftover events on both
    sides get a provenance pass (``coll_gid`` / ``p2p_gid``) so renamed or
    re-homed collectives and hops still pair up.  Returns ``(diffs,
    unmatched_predicted_keys, unmatched_captured_keys)``.
    """
    pk, ck = _keyed(predicted), _keyed(captured)
    diffs: List[TaskDiff] = []
    matched_c = set()

    def emit(key, pev, cev):
        diffs.append(TaskDiff(
            worker=worker, thread=key[0], name=pev.name, occurrence=key[2],
            kind=pev.kind or "?", predicted_start=pev.ts,
            predicted_dur=pev.dur, captured_start=cev.ts,
            captured_dur=cev.dur))

    leftover_p = []
    for key, pev in pk.items():
        cev = ck.get(key)
        if cev is not None:
            matched_c.add(key)
            emit(key, pev, cev)
        else:
            leftover_p.append((key, pev))
    leftover_c = {k: ev for k, ev in ck.items() if k not in matched_c}

    # provenance pass over the leftovers
    by_gid_c = {}
    for k, ev in leftover_c.items():
        gid = _gid_of(ev)
        if gid is not None:
            by_gid_c[gid] = (k, ev)
    unmatched_p = []
    for key, pev in leftover_p:
        gid = _gid_of(pev)
        hit = by_gid_c.pop(gid, None) if gid is not None else None
        if hit is not None:
            ckey, cev = hit
            del leftover_c[ckey]
            emit(key, pev, cev)
        else:
            unmatched_p.append((worker,) + key)
    unmatched_c = [(worker,) + k for k in leftover_c]
    return diffs, unmatched_p, unmatched_c


# ============================================================== entry points
def _captured_makespan(events) -> float:
    """Last completion across events, gaps included — the predicted side's
    ``SimResult.makespan`` is ``finish + gap`` of the last task, so the
    captured side must account trailing untraced time the same way or the
    headline makespan error carries a systematic bias."""
    return max((ev.end + (ev.gap or 0.0) for ev in events), default=0.0)


def _load_captured(captured, n_workers: int):
    """Captured side -> (per-worker rebased event lists, makespan)."""
    from repro_torch.traceio import ImportedCluster, load_trace_dir
    if not isinstance(captured, ImportedCluster):
        captured = load_trace_dir(str(captured))
    if captured.num_workers != n_workers:
        raise ValueError(
            f"predicted timeline has {n_workers} worker(s) but the captured "
            f"trace set has {captured.num_workers}")
    events = captured.worker_events(rebase=True)
    return events, _captured_makespan(
        [ev for evs in events for ev in evs])


def diff_cluster(cluster_graph, result, captured) -> TraceDiff:
    """Diff a simulated cluster against a captured per-worker trace set.

    ``result`` is the :class:`~repro_torch.core.cluster.ClusterResult` of the
    prediction; ``captured`` is a trace directory or a pre-loaded
    :class:`repro_torch.traceio.ImportedCluster` (clock-aligned on load).  Both
    sides are rendered as per-worker profiler-shaped timelines, so
    collectives compare as one event per worker and p2p hops compare
    leg-for-leg — diffing a prediction against its *own* export reports
    zero error for every task, the subsystem's round-trip invariant.
    """
    from repro_torch.traceio import predicted_worker_events
    pred_events = predicted_worker_events(cluster_graph, result)
    cap_events, cap_makespan = _load_captured(captured, len(pred_events))
    res = getattr(result, "global_result", result)
    return _assemble_diff(
        [(pred_events[w], cap_events[w]) for w in range(len(pred_events))],
        res.makespan, cap_makespan)


def diff_graph(graph: DependencyGraph, result: SimResult,
               captured) -> TraceDiff:
    """Single-worker form: diff one simulated graph against one captured
    trace (a :class:`repro_torch.traceio.WorkerTrace`, a trace file path, or a
    one-worker trace directory)."""
    from repro_torch.traceio import WorkerTrace, events_from_graph, \
        load_worker_trace
    import os
    if isinstance(captured, WorkerTrace):
        trace = captured
    elif os.path.isdir(str(captured)):
        events, makespan = _load_captured(captured, 1)
        pred = events_from_graph(graph, result)
        return _assemble_diff([(pred, events[0])], result.makespan, makespan)
    else:
        trace = load_worker_trace(str(captured))
    t0 = trace.first_ts()
    cap = [dataclasses.replace(ev, ts=ev.ts - t0) for ev in trace.events]
    cap_makespan = _captured_makespan(cap)
    pred = events_from_graph(graph, result)
    return _assemble_diff([(pred, cap)], result.makespan, cap_makespan)


def diff_prediction(pred, tf, cg, captured) -> TraceDiff:
    """Diff an evaluated prediction (the ``(pred, tf, cg)`` triple
    :meth:`Scenario.evaluate` returns) against a captured trace set —
    cluster routes compare per worker, single-graph routes compare the one
    timeline."""
    if cg is not None:
        return diff_cluster(cg, pred.cluster, captured)
    return diff_graph(tf.graph, pred.result, captured)


def _assemble_diff(pairs: Sequence[Tuple[list, list]],
                   predicted_makespan: float,
                   captured_makespan: float) -> TraceDiff:
    tasks: List[TaskDiff] = []
    up: List[Tuple] = []
    uc: List[Tuple] = []
    for w, (pev, cev) in enumerate(pairs):
        d, p, c = diff_worker_events(pev, cev, w)
        tasks.extend(d)
        up.extend(p)
        uc.extend(c)
    return TraceDiff(tasks=tasks, unmatched_predicted=up,
                     unmatched_captured=uc,
                     predicted_makespan=predicted_makespan,
                     captured_makespan=captured_makespan)
