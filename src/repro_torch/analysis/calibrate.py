"""Diff-driven CostModel auto-calibration: close the fidelity loop.

:meth:`Scenario.diff_against` measures *where* the simulator
disagrees with a capture; this module consumes that error signal the way
dPRO (arXiv:2205.02473) earns its <5% fidelity — by fitting the replayer's
constants to the trace.  The loop is simulate → diff → refit, always
through the *real* simulator (one :class:`ClusterGraph` build, then
cost-swap + :meth:`ClusterGraph.retune` per probe, so a probe costs one
retune+simulate, never a rebuild):

* **per-kind duration scales** (``kind_scale:compute`` ...) have a
  closed-form coordinate update: diff matching keys on (lane, name,
  occurrence), which graph program order keeps stable under duration
  changes, so predicted durations of kind *k* respond *linearly* to its
  scale and the L1-optimal multiplier is the predicted-duration-weighted
  median of captured/predicted ratios.  Each proposal is verified through
  the simulator and accepted only if the global loss drops — the loss
  history is monotone by construction.
* **link constants** (``ici_factor``, ``dcn_factor``, ``hop_latency``)
  shape collective/p2p durations non-separably (ring legs couple workers,
  blocking time folds in), so they are fit by bounded golden-section
  search on ``log10(value)``, again accept-only-if-improved.

The loss is the global duration WAPE (sum |predicted - captured| over the
matched tasks / sum captured) — the same per-kind number
:meth:`TraceDiff.format` reports, rolled up.

Entry point: :func:`calibrate_scenario` (drives
:meth:`repro_torch.core.optimize.Scenario.calibrate`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import CostModel, FittableConstant
from repro_torch.obs.spans import span as _obs_span

from .diff import TraceDiff, diff_cluster

# Kinds whose durations the link constants (not per-kind scales) explain.
_LINK_KINDS = ("collective", "comm")

_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


@dataclasses.dataclass
class CalibrationReport:
    """What one calibration run did, before/after fidelity included."""

    before: TraceDiff
    after: TraceDiff
    fitted: Dict[str, Tuple[float, float]]   # name -> (initial, fitted)
    loss_history: List[float]                # global WAPE per accepted state
    rounds: int
    sim_calls: int
    converged: bool

    @property
    def loss_before(self) -> float:
        return self.loss_history[0] if self.loss_history else 0.0

    @property
    def loss_after(self) -> float:
        return self.loss_history[-1] if self.loss_history else 0.0

    def format(self, *, unit: float = 1e3, unit_name: str = "ms") -> str:
        """The before/after fidelity table (per-kind WAPE, makespan)."""
        from .diff import _pct
        lines = [f"== calibration: {self.rounds} round(s), "
                 f"{self.sim_calls} simulator call(s), loss "
                 f"{_pct(self.loss_before)} -> {_pct(self.loss_after)}"
                 f"{' (converged)' if self.converged else ''} =="]
        bk, ak = self.before.per_kind(), self.after.per_kind()
        lines.append(f"{'kind':12s} {'count':>6s} {'captured':>10s} "
                     f"{'wape before':>12s} {'wape after':>11s}")
        for kind in sorted(set(bk) | set(ak)):
            b, a = bk.get(kind), ak.get(kind)
            cap = (b or a).captured_s
            cnt = (b or a).count
            lines.append(
                f"{kind:12s} {cnt:6d} {cap * unit:10.3f} "
                f"{_pct(b.wape) if b else 'n/a':>12s} "
                f"{_pct(a.wape) if a else 'n/a':>11s}")
        lines.append(
            f"makespan rel err: "
            f"{_pct(self.before.makespan_rel_error, signed=True)} -> "
            f"{_pct(self.after.makespan_rel_error, signed=True)} "
            f"(captured {self.before.captured_makespan * unit:.3f} "
            f"{unit_name})")
        changed = {n: v for n, v in self.fitted.items()
                   if not math.isclose(v[0], v[1], rel_tol=1e-9)}
        if changed:
            lines.append("fitted constants:")
            for name in sorted(changed):
                init, fit = changed[name]
                lines.append(f"  {name:24s} {init:.6g} -> {fit:.6g}")
        else:
            lines.append("fitted constants: none moved (model already "
                         "at a loss minimum)")
        return "\n".join(lines)


def _loss(diff: TraceDiff) -> float:
    """Global duration WAPE over the matched tasks."""
    cap = sum(d.captured_dur for d in diff.tasks)
    err = sum(abs(d.dur_error) for d in diff.tasks)
    if cap > 0:
        return err / cap
    return 0.0 if err == 0 else float("inf")


def _weighted_median_ratio(pairs: Sequence[Tuple[float, float]]) -> float:
    """Predicted-duration-weighted median of captured/predicted ratios —
    the exact L1 minimizer of ``sum |s * pred - cap|`` over ``s``.

    ``pairs`` is (predicted, captured) per matched task; zero-predicted
    tasks carry no weight (no scale can move them) and are skipped.
    """
    ratios = sorted((cap / pred, pred) for pred, cap in pairs if pred > 0)
    if not ratios:
        return 1.0
    total = sum(w for _, w in ratios)
    acc = 0.0
    for ratio, w in ratios:
        acc += w
        if acc >= total / 2.0:
            return ratio
    return ratios[-1][0]


class _Evaluator:
    """simulate+diff at a candidate cost, through one reusable cluster.

    Builds the trace cluster once, then evaluates each candidate CostModel
    by swapping ``cluster.cost`` and retuning — the exact durations a
    fresh build would produce (``retune``'s contract), at a fraction of
    the cost.  Counts simulator calls and memoizes by constant vector so
    repeated probes (golden-section endpoints, closed-form verification)
    are free.
    """

    def __init__(self, scenario, imported) -> None:
        self.scenario = scenario
        self.imported = imported
        self.cluster = scenario._trace_cluster(imported.graphs)
        self.sim_calls = 0
        self._memo: Dict[Any, Tuple[float, TraceDiff]] = {}

    def __call__(self, cost: CostModel) -> Tuple[float, TraceDiff]:
        key = (tuple(sorted(cost.kind_scales.items())), cost.ici_factor,
               cost.dcn_factor, cost.collectives.hop_latency)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        cg = self.cluster
        cg.cost = cost
        cg.retune(cg.workers)
        res = cg.simulate()
        diff = diff_cluster(cg, res, self.imported)
        self.sim_calls += 1
        out = (_loss(diff), diff)
        self._memo[key] = out
        return out


def _golden_section(evaluate, lo: float, hi: float, probes: int
                    ) -> Tuple[float, float]:
    """Minimize ``evaluate(x)`` over ``[lo, hi]`` in log10 space with at
    most ``probes`` evaluations; returns (best_x, best_loss)."""
    a, b = math.log10(lo), math.log10(hi)
    x1 = b - _GOLDEN * (b - a)
    x2 = a + _GOLDEN * (b - a)
    f1, f2 = evaluate(10 ** x1), evaluate(10 ** x2)
    best_x, best_f = (x1, f1) if f1 <= f2 else (x2, f2)
    for _ in range(max(0, probes - 2)):
        if f1 <= f2:
            b, x2, f2 = x2, x1, f1
            x1 = b - _GOLDEN * (b - a)
            f1 = evaluate(10 ** x1)
        else:
            a, x1, f1 = x1, x2, f2
            x2 = a + _GOLDEN * (b - a)
            f2 = evaluate(10 ** x2)
        if f1 < best_f:
            best_x, best_f = x1, f1
        if f2 < best_f:
            best_x, best_f = x2, f2
    return 10 ** best_x, best_f


def calibrate_scenario(scenario, traces: Any = None, *,
                       constants: Optional[Sequence[str]] = None,
                       max_rounds: int = 6, tol: float = 1e-3,
                       probes_per_constant: int = 6
                       ) -> Tuple[Any, CalibrationReport]:
    """Fit ``scenario.cost``'s constants against a captured trace set.

    ``traces`` is a trace directory or pre-loaded
    :class:`repro_torch.traceio.ImportedCluster`; it defaults to the scenario's
    own capture (``Scenario(trace_dir=...)``) — the dPRO workflow of
    fitting the replayer to the trace it replays.  ``constants`` names a
    subset of :meth:`CostModel.fittable_constants` to fit (default: every
    constant whose task kind / link actually appears in the diff).

    Returns ``(calibrated_scenario, CalibrationReport)``; the input
    scenario is never mutated.  The loop runs at most ``max_rounds``
    coordinate-descent rounds, each proposal verified through the real
    simulator and accepted only on improvement, and stops early once a
    round improves the loss by less than ``tol`` (relative).  Simulator
    calls are bounded by ``1 + rounds * constants * probes_per_constant``
    — the budget ``benchmarks/bench_analysis.py`` gates.
    """
    from repro_torch.traceio import ImportedCluster, load_trace_dir
    if traces is None:
        traces = scenario.traces
    if traces is None:
        raise ValueError("calibrate needs a captured trace set: pass "
                         "traces/trace_dir or build the Scenario from one")
    if not isinstance(traces, ImportedCluster):
        traces = load_trace_dir(str(traces))

    base = scenario if scenario.traces is traces else \
        dataclasses.replace(scenario, traces=traces, trace_dir=None,
                            workers=1)
    evaluate = _Evaluator(base, traces)
    cost = base.cost
    loss, before = evaluate(cost)
    history = [loss]

    # fit only constants the capture can actually inform
    kinds_present = {d.kind for d in before.tasks}
    all_constants = {c.name: c for c in cost.fittable_constants(
        kinds=sorted(kinds_present - set(_LINK_KINDS)))}
    has_link = bool(kinds_present & set(_LINK_KINDS))
    if not has_link:
        for name in ("ici_factor", "dcn_factor", "hop_latency"):
            all_constants.pop(name, None)
    if scenario.collective_mode == "fused":
        # fused mode replays traced collective durations verbatim — the
        # link constants have nothing to move
        for name in ("ici_factor", "dcn_factor", "hop_latency"):
            all_constants.pop(name, None)
    if constants is not None:
        unknown = set(constants) - set(all_constants)
        if unknown:
            raise ValueError(
                f"unknown/unfittable constant(s) {sorted(unknown)}; "
                f"available here: {sorted(all_constants)}")
        all_constants = {n: all_constants[n] for n in constants}

    initial = {n: c.value for n, c in all_constants.items()}
    current = dict(initial)
    rounds = 0
    converged = False
    last_diff = before
    for _ in range(max_rounds):
        if history[-1] < 1e-9:     # already a faithful replay
            converged = True
            break
        rounds += 1
        round_start = history[-1]
        with _obs_span("calibrate.round", round=rounds,
                       constants=len(all_constants)) as sp:
            for name, const in all_constants.items():
                if const.kind is not None:
                    pairs = [(d.predicted_dur, d.captured_dur)
                             for d in last_diff.tasks
                             if d.kind == const.kind]
                    ratio = _weighted_median_ratio(pairs)
                    proposal = min(max(current[name] * ratio, const.lo),
                                   const.hi)
                    if math.isclose(proposal, current[name], rel_tol=1e-9):
                        continue
                    cand = cost.with_constants({**current, name: proposal})
                    cand_loss, cand_diff = evaluate(cand)
                    if cand_loss < history[-1]:
                        current[name] = proposal
                        cost = cand
                        history.append(cand_loss)
                        last_diff = cand_diff
                else:
                    def probe(x, _name=name):
                        return evaluate(
                            cost.with_constants({**current, _name: x}))[0]
                    best_x, best_f = _golden_section(
                        probe, const.lo, const.hi, probes_per_constant)
                    if best_f < history[-1] and not math.isclose(
                            best_x, current[name], rel_tol=1e-9):
                        current[name] = best_x
                        cost = cost.with_constants({name: best_x})
                        loss2, last_diff = evaluate(cost)
                        history.append(loss2)
            sp.note(loss=history[-1])
        improved = round_start - history[-1]
        if improved <= tol * max(round_start, 1e-12):
            converged = True
            break

    _, after = evaluate(cost)
    report = CalibrationReport(
        before=before, after=after,
        fitted={n: (initial[n], current[n]) for n in all_constants},
        loss_history=history, rounds=rounds,
        sim_calls=evaluate.sim_calls, converged=converged)
    calibrated = dataclasses.replace(scenario, cost=cost)
    return calibrated, report
