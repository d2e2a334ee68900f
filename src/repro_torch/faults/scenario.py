"""FaultScenario: goodput what-ifs through the optimization registry.

Mirrors the :class:`~repro_torch.serving.scenario.ServingScenario` routing
pattern: ``ckpt_interval``, ``elastic``, ``hot_spare`` and
``straggler_mitigation`` are *registered optimizations* — they parse from
CLI stack specs, compose with ``|`` / :class:`Stack`, and sweep over grids
— but instead of rewriting the step graph they fold into a
:class:`FaultPolicy` and the scenario re-runs the goodput simulator under
that policy.  Every other stack member (``ddp``, ``amp``, ``bandwidth``,
...) applies as a normal graph what-if to produce the *steady-state* step
makespan the goodput simulation interleaves with fault episodes.

Steady-state reuse: evaluating one fault policy point needs the step
makespan at the full worker count (and, for elastic jobs, at each reduced
count the failure process actually visits).  Those cluster evaluations are
cached on the scenario keyed by ``(residual stack spec, worker count)``,
so a checkpoint-interval sweep — or any sweep that only moves fault-policy
parameters — re-runs only the O(fault events) renewal simulation per
point, never the cluster build.  The reference's ``bench_faults.py``
gates this at >= 3x over rebuilding the steady state per point.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.cluster import ClusterGraph, WorkerSpec
from repro_torch.core.graph import DependencyGraph
from repro_torch.core.optimize import (Optimization, OptimizationError, Prediction,
                                 Scenario, Stack, _resolve, register)
from repro_torch.core.task import DEVICE_STREAM, HOST_THREAD, Task, TaskKind
from repro_torch.core.transform import GraphTransform
from repro_torch.faults.events import (FaultTimeline, exponential_failures,
                                 preemption_windows, transient_stragglers)
from repro_torch.faults.goodput import (GoodputReport, simulate_goodput,
                                  young_daly_steps)
from repro_torch.faults.recovery import RecoveryModel

__all__ = [
    "FaultPolicy", "FaultOptimization", "CkptInterval", "Elastic",
    "HotSpare", "StragglerMitigation", "GoodputPrediction", "FaultScenario",
    "demo_scenario", "format_goodput_table",
]


# ================================================================= policy
@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """The resolved fault-handling configuration of one evaluation."""

    ckpt_interval_steps: int = 100
    elastic: bool = False
    min_workers: int = 1
    hot_spares: int = 0
    straggler_mitigation: bool = False
    mitigation_overhead: float = 0.02
    mitigation_cap: float = 1.2


# ===================================================== fault optimizations
class FaultOptimization(Optimization):
    """Base for registered optimizations that adjust the fault policy.

    A checkpoint interval is not a graph rewrite, so :meth:`build` raises
    (the :class:`~repro_torch.serving.scenario.ServingOptimization` pattern) and
    :class:`FaultScenario` intercepts via :meth:`adjust` instead.
    """

    def build(self, s: Scenario, tf: GraphTransform) -> None:
        raise OptimizationError(
            f"{self.name!r} is a fault-policy optimization; evaluate it "
            f"via a repro_torch.faults.FaultScenario (it re-runs the goodput "
            f"simulation rather than rewriting the step graph)")

    def adjust(self, policy: FaultPolicy) -> FaultPolicy:
        raise NotImplementedError

    def headroom_targets(self, s: Scenario
                         ) -> Optional[Callable[[Task], bool]]:
        return None     # availability policies have no shrink-only bound


@register("ckpt_interval", "checkpoint_interval")
@dataclasses.dataclass(frozen=True)
class CkptInterval(FaultOptimization):
    """Checkpoint every ``steps`` steps: smaller intervals lose less work
    per failure but pay the synchronous write more often (Young/Daly)."""

    steps: int = 100

    def __post_init__(self) -> None:
        if self.steps < 1:
            raise OptimizationError(
                f"ckpt_interval needs steps >= 1, got {self.steps}")

    def adjust(self, policy: FaultPolicy) -> FaultPolicy:
        return dataclasses.replace(policy, ckpt_interval_steps=self.steps)


@register("elastic")
@dataclasses.dataclass(frozen=True)
class Elastic(FaultOptimization):
    """Keep training on the surviving N-k workers instead of halting for a
    replacement: collectives re-close over the smaller group and per-worker
    compute scales by N/(N-k) (global batch preserved)."""

    min_workers: int = 1

    def adjust(self, policy: FaultPolicy) -> FaultPolicy:
        return dataclasses.replace(policy, elastic=True,
                                   min_workers=max(1, self.min_workers))


@register("hot_spare", "hot_spares")
@dataclasses.dataclass(frozen=True)
class HotSpare(FaultOptimization):
    """Provision ``count`` idle spares: replacement acquisition drops from
    the cold ``repair_s`` path to ``spare_activation_s``; a consumed spare
    restocks once the failed machine is repaired."""

    count: int = 1

    def __post_init__(self) -> None:
        if self.count < 1:
            raise OptimizationError(
                f"hot_spare needs count >= 1, got {self.count}")

    def adjust(self, policy: FaultPolicy) -> FaultPolicy:
        return dataclasses.replace(policy, hot_spares=self.count)


@register("straggler_mitigation")
@dataclasses.dataclass(frozen=True)
class StragglerMitigation(FaultOptimization):
    """Cap transient straggler dilation at ``cap`` (backup workers /
    work re-assignment) at the price of ``overhead`` on *every* step —
    whether it pays depends on the straggler process, which is exactly
    what the goodput simulation answers."""

    overhead: float = 0.02
    cap: float = 1.2

    def __post_init__(self) -> None:
        if self.overhead < 0:
            raise OptimizationError(
                f"straggler_mitigation overhead must be >= 0, "
                f"got {self.overhead}")
        if self.cap < 1.0:
            raise OptimizationError(
                f"straggler_mitigation cap must be >= 1.0, got {self.cap}")

    def adjust(self, policy: FaultPolicy) -> FaultPolicy:
        return dataclasses.replace(policy, straggler_mitigation=True,
                                   mitigation_overhead=self.overhead,
                                   mitigation_cap=self.cap)


def _split_fault(opt: Optimization
                 ) -> Tuple[List[FaultOptimization],
                            Optional[Optimization]]:
    """Partition a (possibly stacked) optimization into fault-policy
    members and the residual graph-transforming stack (``None`` if empty).
    """
    members = opt.opts if isinstance(opt, Stack) else (opt,)
    fault = [o for o in members if isinstance(o, FaultOptimization)]
    rest = [o for o in members if not isinstance(o, FaultOptimization)]
    if not fault:
        return [], opt
    if not rest:
        return fault, None
    return fault, (rest[0] if len(rest) == 1 else Stack(*rest))


# ============================================================== prediction
@dataclasses.dataclass
class GoodputPrediction(Prediction):
    """A :class:`Prediction` over *useful* throughput under failures.

    ``baseline`` is the scenario's fault-free baseline step makespan and
    ``predicted`` the *effective* seconds per useful step
    (``horizon / useful_steps``), so ``.speedup`` compares useful
    throughput against the fault-free baseline and composes across
    residual graph what-ifs.  The carried graph/result are the full-N
    steady-state step (critical path and counter timelines describe one
    steady step); the fault-horizon story lives in :attr:`report` and the
    :attr:`capacity_timeline` / :attr:`progress_timeline` counter series.
    """

    report: Optional[GoodputReport] = None
    policy: Optional[FaultPolicy] = None
    #: steady-state step makespan at full N under the residual stack
    steady_step_s: float = 0.0

    # ----------------------------------------------------- conveniences --
    @property
    def goodput(self) -> float:
        """Useful steps per hour."""
        return self.report.goodput_steps_per_hour

    @property
    def goodput_fraction(self) -> float:
        """Useful throughput over this policy's own fault-free rate."""
        return self.report.goodput_fraction

    @property
    def availability(self) -> float:
        return self.report.availability

    @property
    def capacity_timeline(self):
        """Piecewise-constant active-worker count over the horizon
        (:class:`repro_torch.obs.Timeline`)."""
        return _samples_timeline(self.report.capacity_samples,
                                 self.report.horizon_s)

    @property
    def progress_timeline(self):
        """Committed (durable) steps over the horizon."""
        return _samples_timeline(self.report.progress_samples,
                                 self.report.horizon_s)

    @property
    def critical_path(self):
        """Critical path of the *steady-state step* this prediction
        interleaved with fault episodes (same checked extraction as the
        base class, against the steady step makespan)."""
        if self._cp is None:
            if self.graph is None:
                raise OptimizationError(
                    "this GoodputPrediction does not carry its steady-state "
                    "graph; re-evaluate via FaultScenario.predict")
            from repro_torch.analysis import extract_critical_path
            cp = extract_critical_path(self.graph, schedule=self.schedule)
            if abs(cp.makespan - self.steady_step_s) > \
                    1e-9 * max(abs(self.steady_step_s), 1e-30):
                raise OptimizationError(
                    f"the steady-state graph no longer reproduces this "
                    f"prediction (makespan {cp.makespan} vs "
                    f"{self.steady_step_s}); re-evaluate this point via "
                    f"FaultScenario.predict")
            self._cp = cp
        return self._cp

    def __repr__(self) -> str:
        return (f"GoodputPrediction({self.optimization.spec()}: "
                f"{self.goodput:,.1f} useful steps/h "
                f"({self.goodput_fraction:.1%} of fault-free), "
                f"availability {self.availability:.1%})")


def _samples_timeline(samples, end: float):
    from repro_torch.obs import Timeline
    deltas = []
    prev = 0.0
    for t, v in samples:
        if v != prev:
            deltas.append((t, v - prev))
            prev = v
    return Timeline.from_deltas(deltas, end)


# ================================================================ scenario
@dataclasses.dataclass
class FaultScenario(Scenario):
    """A :class:`Scenario` that predicts goodput under a fault process.

    The training side (graph, cost, byte maps, workers, traces) is a
    normal scenario; on top of it, ``mtbf_s``/``seed`` drive a per-worker
    exponential failure process, optional deterministic preemption windows
    and transient straggler windows complete the
    :class:`~repro_torch.faults.events.FaultTimeline`, and ``recovery`` (derived
    from the scenario's byte maps + CostModel when not given) prices each
    episode.  ``evaluate``/``predict``/``sweep`` accept stacks mixing
    fault-policy members with ordinary graph what-ifs::

        scn.predict("ddp,elastic,ckpt_interval:steps=250")
    """

    mtbf_s: float = 0.0                 # per-worker MTBF; 0 = no failures
    horizon_s: float = 86400.0          # simulated wall-clock (24h)
    seed: int = 0
    ckpt_interval_steps: int = 100
    recovery: Optional[RecoveryModel] = None
    # deterministic preemption windows (period 0 = none)
    preempt_period_s: float = 0.0
    preempt_duration_s: float = 0.0
    preempt_offset_s: float = 0.0
    preempt_workers: int = 1
    # transient straggler windows (rate 0 = none)
    straggler_rate_per_hour: float = 0.0
    straggler_slowdown: float = 2.0
    straggler_duration_s: float = 120.0
    #: explicit event timeline overriding the generated processes
    timeline: Optional[FaultTimeline] = None

    _steady_cache: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _ftl: Optional[FaultTimeline] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.horizon_s <= 0:
            raise OptimizationError(
                f"FaultScenario horizon must be > 0, got {self.horizon_s}")
        if self.recovery is None:
            self.recovery = RecoveryModel.from_scenario(self)

    # ---------------------------------------------------------- timeline --
    def fault_timeline(self) -> FaultTimeline:
        """The (cached) reproducible event timeline for this scenario."""
        if self._ftl is None:
            if self.timeline is not None:
                self._ftl = self.timeline.until(self.horizon_s)
            else:
                tl = exponential_failures(self.num_workers, self.mtbf_s,
                                          self.horizon_s, self.seed)
                if self.preempt_period_s > 0 and self.preempt_duration_s > 0:
                    tl = tl | preemption_windows(
                        self.preempt_period_s, self.preempt_duration_s,
                        self.horizon_s, offset_s=self.preempt_offset_s,
                        workers=self.preempt_workers)
                if self.straggler_rate_per_hour > 0:
                    tl = tl | transient_stragglers(
                        self.straggler_rate_per_hour,
                        self.straggler_slowdown,
                        self.straggler_duration_s, self.horizon_s,
                        self.seed)
                self._ftl = tl
        return self._ftl

    @property
    def job_mtbf_s(self) -> float:
        """Job-level MTBF: any of the N workers failing ends the epoch."""
        if self.mtbf_s <= 0:
            return math.inf
        return self.mtbf_s / self.num_workers

    # ------------------------------------------------- steady-state cache --
    def _elastic_specs(self, n: int) -> List[WorkerSpec]:
        base = self.specs
        big_n = len(base)
        if n < 1 or n > big_n:
            raise OptimizationError(
                f"cannot evaluate steady state at {n} of {big_n} workers")
        scale = big_n / n
        # failed workers drop from the end of the spec list (approximation
        # for heterogeneous clusters); global batch is preserved, so the
        # survivors each compute scale-times more
        return [dataclasses.replace(w, compute_scale=w.compute_scale * scale)
                for w in base[:n]]

    def _steady(self, residual: Optional[Optimization], n: int, *,
                rescale: bool = False
                ) -> Tuple[Prediction, GraphTransform,
                           Optional[ClusterGraph]]:
        """Steady-state step evaluation at ``n`` workers, cached by
        (residual spec, n) so fault-policy sweeps never rebuild it."""
        key = (residual.spec() if residual is not None else "noop",
               n, bool(rescale))
        hit = self._steady_cache.get(key)
        if hit is not None:
            return hit
        if n == self.num_workers and not rescale:
            scn: Scenario = self
        else:
            if self.traces is not None:
                raise OptimizationError(
                    "elastic re-meshing is not supported on the trace "
                    "route: reduced-worker step times cannot be derived "
                    "from fixed per-worker traces")
            scn = dataclasses.replace(self, workers=self._elastic_specs(n))
        eval_opt = residual if residual is not None else _resolve("noop")
        out = Scenario._evaluate(scn, eval_opt)
        self._steady_cache[key] = out
        return out

    # ------------------------------------------------------------ routing --
    def _evaluate(self, opt: Optimization, *,
                  baseline: Optional[float] = None,
                  point: Optional[Dict[str, Any]] = None,
                  reuse: bool = True
                  ) -> Tuple[GoodputPrediction, GraphTransform,
                             Optional[ClusterGraph]]:
        base = self.baseline().makespan if baseline is None else baseline
        fault, residual = _split_fault(opt)
        policy = FaultPolicy(ckpt_interval_steps=self.ckpt_interval_steps)
        for fo in fault:
            policy = fo.adjust(policy)

        n = self.num_workers
        rescale = policy.elastic and n > 1
        steady_pred, tf, cg = self._steady(residual, n, rescale=rescale)
        step_full = steady_pred.predicted
        if rescale:
            def step_fn(active: int) -> float:
                if active >= n:
                    return step_full
                return self._steady(residual, active,
                                    rescale=True)[0].predicted
        else:
            step_fn = step_full

        report = simulate_goodput(
            n_workers=n, horizon_s=self.horizon_s,
            timeline=self.fault_timeline(), recovery=self.recovery,
            ckpt_interval_steps=policy.ckpt_interval_steps,
            step_s=step_fn, elastic=policy.elastic,
            hot_spares=policy.hot_spares,
            straggler_mitigation=policy.straggler_mitigation,
            mitigation_overhead=policy.mitigation_overhead,
            mitigation_cap=policy.mitigation_cap,
            min_workers=policy.min_workers)
        predicted = (self.horizon_s / report.useful_steps
                     if report.useful_steps else math.inf)
        pred = GoodputPrediction(
            opt, base, predicted, steady_pred.result, steady_pred.cluster,
            dict(point or {}), graph=steady_pred.graph,
            schedule=steady_pred.schedule, byte_maps=self._byte_maps(),
            report=report, policy=policy, steady_step_s=step_full)
        return pred, tf, cg

    def sweep(self, opt, grid, *, reuse: bool = True
              ) -> List[GoodputPrediction]:
        """Grid sweep; the base class's reuse fast paths construct plain
        :class:`Prediction`\\ s that would drop the goodput report, so
        ``reuse`` is forced off — the steady-state cache on this scenario
        is what makes fault-policy sweeps cheap instead."""
        return super().sweep(opt, grid, reuse=False)

    # ------------------------------------------------------------ helpers --
    def optimal_ckpt_interval(self, opt: Union[str, Optimization,
                                               None] = None,
                              intervals: Optional[List[int]] = None
                              ) -> Tuple[GoodputPrediction,
                                         List[GoodputPrediction], int]:
        """Sweep the checkpoint interval and return
        ``(best, all points, young_daly_steps)``.

        The default grid brackets the Young/Daly closed-form optimum
        geometrically; ``opt`` stacks extra members (fault policies or
        graph what-ifs) under every point.
        """
        fault, residual = _split_fault(_resolve(opt)) if opt is not None \
            else ([], None)
        rescale = any(isinstance(f, Elastic) for f in fault)
        step_full = self._steady(residual, self.num_workers,
                                 rescale=rescale)[0].predicted
        k_yd = young_daly_steps(self.recovery.checkpoint_write_s,
                                self.job_mtbf_s, step_full)
        if intervals is None:
            if math.isinf(self.job_mtbf_s):
                intervals = [self.ckpt_interval_steps]
            else:
                intervals = sorted({max(1, int(round(k_yd * f)))
                                    for f in (0.25, 0.5, 0.75, 1.0,
                                              1.5, 2.0, 4.0)})
        preds = []
        for k in intervals:
            members = [o for o in fault
                       if not isinstance(o, CkptInterval)]
            members.append(CkptInterval(steps=k))
            if residual is not None:
                members.insert(0, residual)
            o = members[0] if len(members) == 1 else Stack(*members)
            preds.append(self._evaluate(o, point={"steps": k})[0])
        best = max(preds, key=lambda p: (p.report.useful_steps,
                                         -p.policy.ckpt_interval_steps))
        return best, preds, k_yd


# ================================================================== demo
def demo_scenario(*, workers: int = 16, layers: int = 8,
                  mtbf_s: float = 6 * 3600.0, horizon_s: float = 86400.0,
                  seed: int = 0, **kw) -> FaultScenario:
    """A canonical synthetic data-parallel fault scenario (CLI/example/
    bench default): ``layers`` fwd/bwd/update layers, 64 MB gradients per
    layer, ``workers`` workers.  Evaluate stacks like
    ``"ddp,elastic,ckpt_interval:steps=250"`` against it."""
    g = DependencyGraph()
    h = g.add_task(Task("host:dispatch", TaskKind.HOST, HOST_THREAD, 20e-6))
    for i in range(layers):
        t = g.add_task(Task(f"fwd:l{i}", TaskKind.COMPUTE, DEVICE_STREAM,
                            2e-3, layer=f"l{i}", phase="fwd"))
        if i == 0:
            g.add_edge(h, t)
    for i in reversed(range(layers)):
        g.add_task(Task(f"bwd:l{i}", TaskKind.COMPUTE, DEVICE_STREAM, 4e-3,
                        layer=f"l{i}", phase="bwd"))
        g.add_task(Task(f"upd:l{i}", TaskKind.COMPUTE, DEVICE_STREAM, 1e-3,
                        layer=f"l{i}", phase="update"))
    grads = {f"l{i}": 64e6 for i in range(layers)}
    acts = {f"l{i}": 32e6 for i in range(layers)}
    return FaultScenario(graph=g, layer_grad_bytes=grads,
                         activation_bytes=acts, workers=workers,
                         mtbf_s=mtbf_s, horizon_s=horizon_s, seed=seed,
                         **kw)


# ================================================================ report
def format_goodput_table(preds: List[GoodputPrediction]) -> str:
    """Fixed-width goodput table for the launch.goodput CLI."""
    hdr = (f"{'what-if':<44} {'steps/h':>10} {'of ideal':>9} "
           f"{'avail':>7} {'fails':>6} {'lost':>7} {'speedup':>8}")
    lines = [hdr, "-" * len(hdr)]
    for p in preds:
        spec = p.optimization.spec()
        if len(spec) > 43:
            spec = spec[:40] + "..."
        r = p.report
        lines.append(
            f"{spec:<44} {r.goodput_steps_per_hour:>10,.0f} "
            f"{r.goodput_fraction:>8.1%} {r.availability:>6.1%} "
            f"{r.failures:>6d} {r.lost_steps:>7d} {p.speedup:>7.2f}x")
    return "\n".join(lines)
