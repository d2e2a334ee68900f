"""Diagnosis subsystem: critical paths, trace diffs, opportunity ranking.

The simulator (:mod:`repro_torch.core.simulate`), the cluster graphs
(:mod:`repro_torch.core.cluster`), and the trace I/O layer
(:mod:`repro_torch.traceio`) predict *a* makespan; this package explains it:

* :mod:`repro_torch.analysis.critical_path` — walk the recorded binding
  predecessors (``simulate(record_binding=True)``) to the
  makespan-defining chain and attribute it into compute / comm / host /
  idle, per worker.
* :mod:`repro_torch.analysis.diff` — align a captured per-worker trace against
  the predicted timeline task-by-task (paper §6 validation methodology as
  a reusable tool): per-task error distributions, per-kind rollups, top-K
  mispredictions.
* :mod:`repro_torch.analysis.opportunity` — Amdahl-style speedup upper bounds
  per registered optimization, computed through the real simulator, which
  is the ordering ``hillclimb --search-whatif`` explores.
* :mod:`repro_torch.analysis.calibrate` — close the fidelity loop: fit CostModel
  constants (per-kind duration scales, link-bandwidth factors, hop
  latency) to a captured trace by iterating simulate → diff → refit
  through the real simulator (dPRO's trace-fitted replayer).

User surfaces: ``Prediction.critical_path``,
``Scenario.diff_against(trace_dir)``, and ``Scenario.calibrate()`` (the
reference's ``launch.diagnose`` / ``launch.calibrate`` CLIs are not carried
over yet).
"""

from .calibrate import CalibrationReport, calibrate_scenario
from .critical_path import (CATEGORIES, CriticalPath, PathSegment,
                            cluster_critical_path, extract_critical_path)
from .diff import (KindStats, TaskDiff, TraceDiff, diff_cluster, diff_graph,
                   diff_prediction, diff_worker_events)
from .opportunity import (NO_HEADROOM, Opportunity, format_opportunity_table,
                          opportunity_bound, rank_opportunities,
                          searchable_candidates)

__all__ = [
    "CalibrationReport", "calibrate_scenario",
    "CATEGORIES", "CriticalPath", "PathSegment",
    "cluster_critical_path", "extract_critical_path",
    "KindStats", "TaskDiff", "TraceDiff",
    "diff_cluster", "diff_graph", "diff_prediction", "diff_worker_events",
    "NO_HEADROOM", "Opportunity", "format_opportunity_table",
    "opportunity_bound", "rank_opportunities", "searchable_candidates",
]
