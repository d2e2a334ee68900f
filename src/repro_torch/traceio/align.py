"""Clock alignment across independently-captured per-worker traces.

Each worker's profiler stamps events with its *own* clock, so N traces of
one training step disagree by a per-worker offset (clocks started at
different times) and drift (oscillators tick at slightly different rates).
dPRO (arXiv:2205.02473) aligns them by anchoring on communication: a
synchronous collective *ends* at (physically) the same instant on every
participant, so matched collective end times are observations of one global
timestamp through each worker's clock.

:func:`align_traces` matches collectives across traces by (name,
occurrence) — the same contract :func:`repro_torch.core.cluster
.match_collective_groups` uses on graphs — takes worker 0's clock as the
reference timeline, and least-squares fits a per-worker affine map
``t_ref ≈ scale * t_local + offset`` over the anchor pairs:

* >= 2 anchors: full offset+drift fit (closed-form simple linear
  regression);
* exactly 1 anchor: offset only (``scale = 1``);
* no anchors (single worker, or no matched collectives): identity, flagged
  by ``anchors == 0`` so callers can warn.

Real oscillator drift is parts-per-million; a fitted scale far from 1 (or
non-positive, which would *negate* every duration downstream) can only
come from a degenerate anchor set — collinear-in-time anchors, mismatched
collectives, or a noise-dominated fit.  Fits with scale outside
``[SCALE_MIN, SCALE_MAX]`` therefore fall back to an offset-only map
(``scale = 1``) with :attr:`ClockAlignment.fallback` set so callers can
flag the anchors.

:func:`apply_alignment` rescales a trace in place: timestamps map through
the affine fit; durations and gaps are *intervals*, so they scale by the
drift term only.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from .events import TraceEvent, WorkerTrace

# Sanity bounds on the fitted drift term.  Physical clock drift is ppm-
# scale; anything outside a factor of 2 is a degenerate/noise-dominated
# fit, and a non-positive scale would negate durations and gaps outright.
SCALE_MIN = 0.5
SCALE_MAX = 2.0


@dataclasses.dataclass(frozen=True)
class ClockAlignment:
    """Affine map from one worker's clock to the reference timeline."""

    scale: float = 1.0       # drift correction (reference seconds per local)
    offset: float = 0.0      # seconds
    anchors: int = 0         # matched collective ends the fit used
    residual: float = 0.0    # RMS fit residual, seconds
    fallback: bool = False   # drift fit rejected -> offset-only map

    def apply_time(self, ts: float) -> float:
        return self.scale * ts + self.offset

    @property
    def is_identity(self) -> bool:
        return self.scale == 1.0 and self.offset == 0.0


def collective_end_anchors(traces: Sequence[WorkerTrace]
                           ) -> List[List[float]]:
    """Matched collective end times, one row per anchor, one column per
    worker (rows ordered by worker 0's timeline).  Collectives are matched
    by (name, occurrence); only keys present in *every* trace anchor —
    alignment is best-effort, the importer's graph-level matching raises on
    real inconsistencies."""
    keyed: List[Dict[Tuple[str, int], TraceEvent]] = []
    for tr in traces:
        seen: Dict[str, int] = collections.defaultdict(int)
        d: Dict[Tuple[str, int], TraceEvent] = {}
        # occurrence numbering must scan in the exact order the graph-level
        # matcher will (sorted thread, then per-thread time order), or
        # same-named collectives on different channels could anchor
        # physically different operations onto each other
        for ev in sorted(tr.collectives(), key=lambda e: (e.thread, e.ts)):
            key = (ev.name, seen[ev.name])
            seen[ev.name] += 1
            d[key] = ev
        keyed.append(d)
    if not keyed:
        return []
    common = set(keyed[0])
    for d in keyed[1:]:
        common &= set(d)
    ordered = sorted(common, key=lambda k: keyed[0][k].ts)
    return [[d[k].end for d in keyed] for k in ordered]


def _fit(xs: Sequence[float], ys: Sequence[float]) -> Tuple[float, float]:
    """Least-squares ``y ≈ a*x + b`` (a pinned to 1 when x is degenerate)."""
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    var = sum((x - mx) ** 2 for x in xs)
    if var <= 1e-24:
        return 1.0, my - mx
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    a = cov / var
    return a, my - a * mx


def align_traces(traces: Sequence[WorkerTrace],
                 ) -> List[ClockAlignment]:
    """Per-worker clock alignments onto worker 0's timeline (see module
    docstring).  Does not mutate the traces — pair with
    :func:`apply_alignment`."""
    n = len(traces)
    if n == 0:
        return []
    anchors = collective_end_anchors(traces)
    out = [ClockAlignment(anchors=len(anchors))]     # worker 0 == reference
    for i in range(1, n):
        xs = [row[i] for row in anchors]
        ys = [row[0] for row in anchors]
        if not xs:
            out.append(ClockAlignment(anchors=0))
            continue
        fallback = False
        if len(xs) == 1:
            a, b = 1.0, ys[0] - xs[0]
        else:
            a, b = _fit(xs, ys)
            if not (math.isfinite(a) and SCALE_MIN <= a <= SCALE_MAX):
                # degenerate anchors (noise/mismatch): a wildly-off or
                # non-positive drift would corrupt every duration, so keep
                # the clock rate and fit the offset alone
                a = 1.0
                b = sum(y - x for x, y in zip(xs, ys)) / len(xs)
                fallback = True
        rss = sum((a * x + b - y) ** 2 for x, y in zip(xs, ys))
        out.append(ClockAlignment(scale=a, offset=b, anchors=len(xs),
                                  residual=math.sqrt(rss / len(xs)),
                                  fallback=fallback))
    return out


def apply_alignment(trace: WorkerTrace, alignment: ClockAlignment) -> None:
    """Rescale a trace's events onto the reference timeline, in place."""
    if alignment.is_identity:
        return
    a = alignment.scale
    for ev in trace.events:
        ev.ts = alignment.apply_time(ev.ts)
        ev.dur *= a
        if ev.gap is not None:
            ev.gap *= a
