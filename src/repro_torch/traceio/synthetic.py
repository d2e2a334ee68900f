"""Synthetic per-worker traces of a data-parallel training step.

Shared by the traceio tests, ``benchmarks/bench_traceio.py``, and
``examples/trace_import.py``: generates what a per-worker profiler *would*
capture from an N-worker DDP step — per-layer forward/backward/update
compute on the device stream, one gradient all-reduce per layer on a
communication channel, host dispatch/sync — with three kinds of controlled
imperfection:

* ``compute_scales``: per-worker compute slowdowns (stragglers).  The
  collective *end* times are computed globally (a synchronous all-reduce
  finishes when the slowest participant is done), so each worker's
  collective events include their real blocking time — exactly how a
  profiler sees a straggler from a fast worker's side.
* ``clock_offsets`` / ``clock_drifts``: each worker's events are stamped
  through its own skewed clock (``ts_local = ts_true * drift + offset``),
  which the alignment pass must undo.
* explicit ``gap = 0`` everywhere, so imports never infer gaps and the
  generated step is exactly reproducible.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from repro_torch.core.costmodel import CostModel
from repro_torch.core.task import DEVICE_STREAM, HOST_THREAD, ici_channel

from .events import TraceEvent, WorkerTrace, write_jsonl

GRAD_CHANNEL = ici_channel("grad")


def synthetic_cluster_traces(n_workers: int = 4, *, layers: int = 6,
                             fwd: float = 2e-3, bwd: float = 4e-3,
                             upd: float = 1e-3, dispatch: float = 20e-6,
                             grad_bytes: float = 30e6,
                             compute_scales: Optional[Sequence[float]] = None,
                             clock_offsets: Optional[Sequence[float]] = None,
                             clock_drifts: Optional[Sequence[float]] = None,
                             cost: Optional[CostModel] = None
                             ) -> List[WorkerTrace]:
    """Generate N per-worker traces of one DDP training step (see module
    docstring).  Event counts are ``4 * layers + 2`` per worker."""
    scales = list(compute_scales or [1.0] * n_workers)
    offsets = list(clock_offsets or [0.0] * n_workers)
    drifts = list(clock_drifts or [1.0] * n_workers)
    if not (len(scales) == len(offsets) == len(drifts) == n_workers):
        raise ValueError("per-worker parameter lists must have n_workers "
                         "entries")
    cost = cost or CostModel()
    coll_dur = cost.collectives.group_time("all-reduce", grad_bytes,
                                           n_workers) if n_workers > 1 \
        else 0.0

    # -- true-time schedule per worker, collectives synchronized globally --
    evs: List[List[TraceEvent]] = [[] for _ in range(n_workers)]
    eid = [0] * n_workers

    def emit(w: int, **kw) -> TraceEvent:
        ev = TraceEvent(eid=eid[w], gap=0.0, **kw)
        eid[w] += 1
        evs[w].append(ev)
        return ev

    dev_cursor = [0.0] * n_workers
    disp = [emit(w, name="host:dispatch", thread=HOST_THREAD, ts=0.0,
                 dur=dispatch, kind="host") for w in range(n_workers)]
    for w in range(n_workers):
        dev_cursor[w] = dispatch
    for l in range(layers):
        for w in range(n_workers):
            e = emit(w, name=f"fwd:l{l}", thread=DEVICE_STREAM,
                     ts=dev_cursor[w], dur=fwd * scales[w], kind="compute",
                     layer=f"l{l}", phase="fwd",
                     deps=[disp[w].eid] if l == 0 else [])
            dev_cursor[w] += e.dur
    bwd_end = [[0.0] * layers for _ in range(n_workers)]
    bwd_eid = [[0] * layers for _ in range(n_workers)]
    for l in reversed(range(layers)):
        for w in range(n_workers):
            e = emit(w, name=f"bwd:l{l}", thread=DEVICE_STREAM,
                     ts=dev_cursor[w], dur=bwd * scales[w], kind="compute",
                     layer=f"l{l}", phase="bwd")
            dev_cursor[w] += e.dur
            bwd_end[w][l] = e.end
            bwd_eid[w][l] = e.eid
    # per-layer all-reduce in backward-completion order; everyone blocks
    # until the slowest participant's gradients are ready
    comm_cursor = [0.0] * n_workers
    coll_end = [0.0] * layers
    coll_eid = [[0] * layers for _ in range(n_workers)]
    for l in reversed(range(layers)):
        ready = [max(bwd_end[w][l], comm_cursor[w])
                 for w in range(n_workers)]
        end = max(ready) + coll_dur
        coll_end[l] = end
        for w in range(n_workers):
            e = emit(w, name=f"allreduce:l{l}", thread=GRAD_CHANNEL,
                     ts=ready[w], dur=end - ready[w], kind="collective",
                     layer=f"l{l}", phase="comm", comm_bytes=grad_bytes,
                     collective="all-reduce", group_size=n_workers,
                     deps=[bwd_eid[w][l]])
            comm_cursor[w] = end
            coll_eid[w][l] = e.eid
    for l in range(layers):
        for w in range(n_workers):
            ts = max(dev_cursor[w], coll_end[l] if n_workers > 1
                     else dev_cursor[w])
            e = emit(w, name=f"upd:l{l}", thread=DEVICE_STREAM, ts=ts,
                     dur=upd * scales[w], kind="compute", layer=f"l{l}",
                     phase="update", deps=[coll_eid[w][l]]
                     if n_workers > 1 else [])
            dev_cursor[w] = e.end
    for w in range(n_workers):
        emit(w, name="host:sync", thread=HOST_THREAD, ts=dev_cursor[w],
             dur=1e-6, kind="sync", deps=[evs[w][-1].eid])

    # -- stamp through each worker's skewed local clock --
    for w in range(n_workers):
        d, o = drifts[w], offsets[w]
        if d == 1.0 and o == 0.0:
            continue
        for ev in evs[w]:
            ev.ts = ev.ts * d + o
            ev.dur *= d
    return [WorkerTrace(worker=w, events=evs[w], source=f"<synthetic:{w}>")
            for w in range(n_workers)]


def write_synthetic_trace_dir(trace_dir: str, n_workers: int = 4,
                              **kwargs) -> List[str]:
    """Write a synthetic trace set as native JSONL worker files; returns
    the file paths (``worker<i>.jsonl``)."""
    os.makedirs(trace_dir, exist_ok=True)
    paths = []
    for tr in synthetic_cluster_traces(n_workers, **kwargs):
        path = os.path.join(trace_dir, f"worker{tr.worker}.jsonl")
        write_jsonl(tr.events, path, meta={"worker": tr.worker})
        paths.append(path)
    return paths
