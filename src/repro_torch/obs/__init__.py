"""Observability: counter timelines and self-instrumentation spans.

Two independent layers share this package because both answer "what
happened *over time*?" rather than "what was the total?":

* :mod:`repro_torch.obs.timeline` — piecewise-constant :class:`Timeline` counter
  series (per-lane busy/utilization, ready-queue depth, COMM bytes in
  flight, per-worker live memory) derived from any simulated result, plus
  the single busy-interval implementation ``core.simulate`` and serving
  route through.  Surfaced as ``Prediction.timelines`` and as Perfetto
  counter tracks in ``traceio.chrome`` exports.
* :mod:`repro_torch.obs.spans` — JSONL span telemetry for the tool's own hot
  paths (``REPRO_TELEMETRY=<path>`` / ``--telemetry``), a no-op otherwise.

Neither submodule imports ``repro_torch.*`` at module scope, so ``repro_torch.obs``
is importable from anywhere in the package without cycles.
"""

from repro_torch.obs.spans import configure, enabled, span, telemetry_path
from repro_torch.obs.timeline import (Timeline, TimelineSet, check_result_fresh,
                                compute_timelines, format_timeline_report,
                                interval_overlap, interval_union,
                                lane_utilization)

__all__ = [
    "Timeline", "TimelineSet", "check_result_fresh", "compute_timelines",
    "format_timeline_report", "interval_overlap", "interval_union",
    "lane_utilization",
    "span", "configure", "enabled", "telemetry_path",
]
