"""Performance report launcher (counterpart of
``repro/launch/perf_report.py``), so far its trace-import helpers only:

    imp, scn = load_trace_scenario("traces/")          # one file per worker
    scn.predict("amp").critical_path

``load_trace_scenario`` reads a directory of per-worker profiler traces
(torch.profiler captures of the port's step, Chrome trace-event JSON or the
native JSONL: see :mod:`repro_torch.traceio`) into a ready-to-diagnose
:class:`~repro_torch.core.optimize.Scenario`; ``launch.goodput
--trace-dir`` builds its fault scenario from it.  The report's other
routes (the compiled-cell roofline, ``--cluster``, ``--what-if``,
``--export-trace``) are not ported yet.
"""

from repro_torch.core.cluster import WorkerSpec


def _parse_straggler(straggler: str, workers: int):
    try:
        idx_s, slow_s = straggler.split(":")
        idx, slow = int(idx_s), float(slow_s)
    except ValueError:
        raise SystemExit(
            f"--straggler expects IDX:SLOWDOWN (e.g. 0:2.0), "
            f"got {straggler!r}")
    if not 0 <= idx < workers:
        raise SystemExit(
            f"--straggler index {idx} out of range for {workers} workers")
    return idx, slow


def load_trace_scenario(trace_dir: str, straggler: str = ""):
    """Import a per-worker trace dir into a ready-to-diagnose Scenario.

    Prints the per-worker import summary (event counts, clock fits, start
    skews), derives gradient payloads for insertion-style what-ifs
    (ddp/zero on a trace without collectives: traced collective payload
    split over the traced backward layers), and layers an optional
    ``IDX:SLOWDOWN`` straggler spec on top of the traced speeds.  Shared
    by the reference's ``perf_report --trace-dir`` and ``diagnose``; returns
    ``(ImportedCluster, Scenario)``.
    """
    from repro_torch import traceio
    from repro_torch.core.optimize import Scenario
    imp = traceio.load_trace_dir(trace_dir)
    n = imp.num_workers
    print(f"== imported {n} worker trace(s) from {trace_dir} ==")
    for i, al in enumerate(imp.alignments):
        print(f"w{i}: {len(imp.traces[i].events)} events, clock "
              f"scale={al.scale:.6f} offset={al.offset*1e3:+.3f}ms "
              f"({al.anchors} anchors), start skew "
              f"{imp.start_skews[i]*1e3:.3f}ms")

    g0 = imp.graphs[0]
    layers = sorted({t.layer for t in g0.tasks()
                     if t.layer and t.phase == "bwd"})
    total = sum(t.comm_bytes for t in g0.tasks()
                if t.attrs.get("collective"))
    grads = {l: total / len(layers) for l in layers} \
        if layers and total else None

    workers = None
    if straggler:
        idx, slow = _parse_straggler(straggler, n)
        workers = [WorkerSpec(compute_scale=slow if i == idx else 1.0)
                   for i in range(n)]
    return imp, Scenario(traces=imp, layer_grad_bytes=grads,
                         workers=workers if workers is not None else 1)
