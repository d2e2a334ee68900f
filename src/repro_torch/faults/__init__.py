"""Goodput under failures: fault-injection simulation over the step engine
(counterpart of ``repro.faults``, carried over file for file with imports
re-pointed; importing it registers the fault policies with the port's
registry, the reference's is untouched).

Daydream-style what-ifs predict the *steady-state* step makespan.  Production
training jobs rarely run in steady state: workers fail at some MTBF and
restart from checkpoints, preemptible capacity comes and goes in windows, and
transient stragglers dilate whole step times.  This package answers the
question practitioners actually ask — "how many *useful* steps/hour do I get
at my MTBF, and does mitigation X pay?" — by simulation, before deployment.

Model (and its assumptions)
---------------------------

``events``    Seeded stochastic failure processes produce a reproducible
              :class:`FaultTimeline`: per-worker exponential MTBF failures,
              deterministic preemption windows, and transient straggler
              windows that dilate step time by a multiplicative factor.
              Everything is seeded per (seed, kind, worker) stream, so the
              timeline is bit-identical across reruns and stable when the
              worker count changes.

``recovery``  A typed :class:`RecoveryModel` costs each episode: detection
              (heartbeat timeout, from ``runtime.fault.Heartbeat`` defaults),
              checkpoint restore (bytes from ``ckpt.checkpoint_bytes`` or the
              Scenario gradient byte maps, bandwidth from the CostModel's
              host<->device DMA path), process restart, replacement
              acquisition (or hot-spare activation), and elastic re-meshing.

``goodput``   A renewal-style event simulator interleaves steady-state step
              makespans with fault/recovery episodes.  Between fault events
              progress advances in closed form over checkpoint blocks (K
              steps + one synchronous checkpoint write), so the cost is
              O(fault events), not O(steps).  A failure rolls the job back
              to the last *committed* step: work since the last finished
              checkpoint is lost, bounding lost work per failure by the
              checkpoint interval.

Assumptions, explicitly: failures are fail-stop and detected by heartbeat
timeout; checkpoint writes are synchronous on the step path (no async
overlap); rollback restores exactly the last committed step (no partial
credit); preemptions are *graceful* — a proactive checkpoint runs before
capacity disappears, so they cost availability but never lose work; elastic
re-meshing keeps the global batch size, so per-worker compute scales by
N/(N-k) while collectives re-close over the surviving group (via the same
fold/wire machinery as the steady-state cluster build); stragglers are
transient and job-wide (the dilated lane gates the synchronous step).

Surfaces
--------

:class:`FaultScenario` routes the registered what-ifs ``ckpt_interval``,
``elastic``, ``hot_spare`` and ``straggler_mitigation`` through the ordinary
registry / ``sweep`` / critical-path / timeline machinery and returns
:class:`GoodputPrediction` (useful steps/hour, availability, lost work,
checkpoint/recovery overheads, capacity + progress counter timelines).
``python -m repro_torch.launch.goodput`` is the CLI entry point;
``young_daly_interval`` gives the closed-form optimum the
checkpoint-interval sweep is cross-checked against in tests.
"""

from repro_torch.faults.events import (FaultEvent, FaultTimeline,
                                 exponential_failures, preemption_windows,
                                 transient_stragglers)
from repro_torch.faults.goodput import (GoodputReport, simulate_goodput,
                                  young_daly_interval, young_daly_steps)
from repro_torch.faults.recovery import RecoveryModel
from repro_torch.faults.scenario import (CkptInterval, Elastic, FaultPolicy,
                                   FaultScenario, GoodputPrediction, HotSpare,
                                   StragglerMitigation, demo_scenario,
                                   format_goodput_table)

__all__ = [
    "FaultEvent",
    "FaultTimeline",
    "exponential_failures",
    "preemption_windows",
    "transient_stragglers",
    "GoodputReport",
    "simulate_goodput",
    "young_daly_interval",
    "young_daly_steps",
    "RecoveryModel",
    "FaultPolicy",
    "FaultScenario",
    "GoodputPrediction",
    "CkptInterval",
    "Elastic",
    "HotSpare",
    "StragglerMitigation",
    "demo_scenario",
    "format_goodput_table",
]
