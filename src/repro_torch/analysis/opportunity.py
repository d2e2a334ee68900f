"""Opportunity ranking: *which* optimization is worth trying first.

For every registered :class:`~repro_torch.core.optimize.Optimization` an
Amdahl-style **upper bound** on its speedup is computed through the real
simulator: the optimization declares which tasks it can shrink
(:meth:`Optimization.headroom_targets` / :meth:`Optimization.headroom`),
an idealized variant with those tasks erased (duration and payload to
zero) is evaluated on the scenario's own route — single graph, replicate
cluster, or imported traces — and the resulting speedup bounds anything
the real model can deliver.

Soundness: with lanes fixed, a task's start is the max over its
predecessors' completions, so the makespan is *monotone* in durations and
payloads.  Every registered optimization either shrinks (a subset of) its
declared targets or adds work elsewhere, so its realized speedup can never
exceed the bound — the invariant the golden test pins for the whole
registry.  Note the targets must be erased *everywhere*, not only on the
current critical path: shrinking on-path tasks exposes a new path that the
optimization may also shrink, so a path-restricted bound would not be an
upper bound.  The critical path still drives the *attribution* column —
how much of today's makespan the targets occupy — which is the fast signal
for why a bound is large.

Optimizations that restructure the graph instead of shrinking tasks
(``pipeline``) have no shrink-bound and rank as *unbounded* (try early,
the ranking cannot rule them out); optimizations that only add work
(``ddp`` insertion on a single-worker baseline, ``straggler``) declare
empty targets and bound at exactly 1.0x — which is how
``hillclimb --search-whatif`` knows to skip them and says so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.optimize import (Optimization, OptimizationError, Scenario,
                                       default_candidates)

from .critical_path import extract_critical_path

# Bounds at or below this are "no headroom": greedy search skips them.
NO_HEADROOM = 1.0 + 1e-9


@dataclasses.dataclass(frozen=True)
class _Headroom(Optimization):
    """Internal wrapper: evaluate ``inner``'s idealized best case."""

    inner: Optimization

    def build(self, s: Scenario, tf) -> None:
        if not self.inner.headroom(s, tf):
            raise OptimizationError(
                f"{self.inner.name} declares no shrink-targets; its bound "
                f"is unbounded")


@dataclasses.dataclass
class Opportunity:
    """One candidate's headroom assessment."""

    optimization: Optimization
    bound: float                     # upper-bound speedup; inf == unbounded
    cp_share: Optional[float] = None  # fraction of baseline critical path
    realized: Optional[float] = None  # depth-1 realized speedup
    error: str = ""                  # why realization failed, if it did
    # the realized depth-1 Prediction itself (realize=True only) — callers
    # seed greedy_search's first round with it instead of re-simulating
    prediction: Optional[object] = \
        dataclasses.field(default=None, repr=False, compare=False)

    @property
    def unbounded(self) -> bool:
        return math.isinf(self.bound)

    @property
    def skipped(self) -> bool:
        """No headroom: the bound proves the candidate cannot improve
        this scenario."""
        return self.bound <= NO_HEADROOM


def opportunity_bound(scenario: Scenario, opt: Optimization) -> float:
    """Upper-bound ``opt``'s speedup on ``scenario`` (see module
    docstring).  ``math.inf`` when the optimization restructures the graph
    and no shrink-bound exists."""
    try:
        pred = scenario.predict(_Headroom(opt))
    except OptimizationError:
        return math.inf
    # monotonicity guarantees >= 1; the max() only absorbs float fuzz
    return max(1.0, pred.speedup)


def rank_opportunities(scenario: Scenario,
                       candidates: Optional[Sequence[Optimization]] = None,
                       *, realize: bool = False,
                       baseline_cluster=None) -> List[Opportunity]:
    """Rank ``candidates`` (default: every default-constructible registered
    optimization) by their speedup upper bound, best headroom first.

    With ``realize=True`` each candidate is additionally evaluated for
    real, so reports can print bound vs realized side by side; the
    :class:`Opportunity` keeps the depth-1 :class:`Prediction` so callers
    can seed ``greedy_search(round1=...)`` with it instead of
    re-simulating the whole candidate set.  Candidates that do not apply
    to the scenario record the failure instead of a number.

    ``baseline_cluster`` optionally passes the
    :class:`~repro_torch.core.cluster.ClusterGraph` of an already-evaluated
    noop prediction (diagnose/hillclimb have one in hand) so cluster
    scenarios do not rebuild and re-simulate the baseline a second time
    just for the cp-share attribution.
    """
    cands = list(candidates) if candidates is not None \
        else default_candidates(scenario)
    # attribute cp-share against the scenario's *real* baseline route: on
    # cluster/trace scenarios the makespan the bounds are computed against
    # lives on the evaluated cluster graph (stragglers, per-worker traced
    # speeds), not on worker 0's standalone timeline.  Target predicates
    # are written against single-worker thread names (``on_device`` checks
    # ``thread == "device"``), so cluster tasks are matched through a
    # localized read-only view (uid preserved).
    if scenario.is_cluster:
        from repro_torch.core.task import split_worker_thread
        from .critical_path import cluster_critical_path
        cg = baseline_cluster
        if cg is None:
            _, _, cg = scenario.evaluate("noop")
        cp = cluster_critical_path(cg)
        view = []
        for t in cg.graph.tasks():
            lt = dataclasses.replace(t)
            lt.thread = split_worker_thread(t.thread)[1]
            view.append(lt)
    else:
        cp = extract_critical_path(scenario.graph)
        view = scenario.graph.tasks()
    out: List[Opportunity] = []
    for cand in cands:
        bound = opportunity_bound(scenario, cand)
        targets = cand.headroom_targets(scenario)
        share: Optional[float] = None
        if targets is not None:
            share = cp.targeted_share(t.uid for t in view if targets(t))
        opp = Opportunity(optimization=cand, bound=bound, cp_share=share)
        if realize:
            try:
                opp.prediction = scenario.predict(cand)
                opp.realized = opp.prediction.speedup
            except Exception as e:   # candidate not applicable here
                opp.error = f"{type(e).__name__}: {e}"
        out.append(opp)
    out.sort(key=lambda o: (-o.bound, o.optimization.spec()))
    return out


def format_opportunity_table(opps: Sequence[Opportunity], *,
                             title: str = "opportunity ranking") -> str:
    """The bound-vs-realized table ``hillclimb --search-whatif`` and
    ``diagnose`` print."""
    lines = [f"== {title}: Amdahl bounds through the simulator ==",
             f"{'candidate':28s} {'bound':>10s} {'cp-share':>9s} "
             f"{'realized':>9s}  note"]
    for o in opps:
        spec = o.optimization.spec()
        name = spec if len(spec) <= 28 else spec[:25] + "..."
        bound = "unbounded" if o.unbounded else f"{o.bound:.2f}x"
        share = "-" if o.cp_share is None else f"{o.cp_share * 100:.0f}%"
        if o.realized is not None:
            realized = f"{o.realized:.2f}x"
        else:
            realized = "-"
        if o.error:
            note = f"not applicable ({o.error.split(':')[0]})"
        elif o.unbounded:
            note = "restructures the graph; no shrink-bound"
        elif o.skipped:
            note = "skipped: no headroom on this scenario"
        else:
            note = ""
        lines.append(f"{name:28s} {bound:>10s} {share:>9s} {realized:>9s}"
                     f"  {note}".rstrip())
    return "\n".join(lines)


def searchable_candidates(opps: Sequence[Opportunity]
                          ) -> List[Optimization]:
    """Candidates worth handing to greedy search, highest headroom first
    (unbounded ones lead — the ranking cannot rule them out)."""
    return [o.optimization for o in opps if not o.skipped]
