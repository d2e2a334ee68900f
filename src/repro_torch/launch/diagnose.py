"""Diagnosis CLI: explain a captured step and rank what to try next
(counterpart of ``repro/launch/diagnose.py``: the same flags and output).

Imports a per-worker profiler trace set (torch.profiler captures of the
port's step, Chrome trace-event JSON / native JSONL —
:mod:`repro_torch.traceio`), then runs the diagnosis subsystem
(:mod:`repro_torch.analysis`) over it:

1. **fidelity** — the simulator's reproduction of the capture, diffed
   task-by-task (per-kind error rollups, top-K mispredicted tasks): how
   much to trust the what-ifs below;
2. **critical path** — the makespan-defining chain of the (re)simulated
   step, attributed into compute / comm / host / idle per worker: where
   the time actually goes;
3. **opportunity ranking** — Amdahl-style speedup upper bounds for every
   registered optimization, bound vs realized: what is worth trying first;
4. optionally ``--calibrate``: fit the CostModel constants to the capture
   (:mod:`repro_torch.analysis.calibrate`) and print the before/after fidelity
   table — the what-ifs then run on the calibrated model;
5. optionally a concrete ``--what-if`` stack, reported with its own
   critical path so before/after chains can be compared.

    PYTHONPATH=src python -m repro_torch.launch.diagnose --trace-dir traces/ \\
        [--calibrate] [--what-if 'amp,bandwidth:factor=2'] [--top 10] \\
        [--no-rank]
"""

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(
        description="diagnose a captured per-worker trace set: "
                    "prediction fidelity, critical path, ranked what-ifs")
    ap.add_argument("--trace-dir", required=True, dest="trace_dir",
                    help="directory with one trace file per worker "
                         "(worker0.jsonl / worker0.trace.json, ...)")
    ap.add_argument("--what-if", default="", dest="what_if",
                    help="registry stack to evaluate on top of the "
                         "diagnosis, e.g. 'amp,bandwidth:factor=2'")
    ap.add_argument("--top", type=int, default=10,
                    help="entries in the top-mispredicted and "
                         "longest-segment lists (default 10)")
    ap.add_argument("--no-diff", action="store_true",
                    help="skip the predicted-vs-captured diff")
    ap.add_argument("--no-rank", action="store_true",
                    help="skip the opportunity ranking")
    ap.add_argument("--straggler", default="",
                    help="IDX:SLOWDOWN what-if worker spec layered on top "
                         "of the traced speeds")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the CostModel to the capture first "
                         "(repro_torch.analysis.calibrate) and print the "
                         "before/after fidelity table; the diagnosis "
                         "below then runs on the calibrated model")
    ap.add_argument("--timeline", action="store_true",
                    help="print counter-timeline rollups (per-worker "
                         "utilization, peak live memory, ready-queue "
                         "depth, COMM bytes in flight — repro_torch.obs) next "
                         "to the critical path")
    ap.add_argument("--telemetry", default="",
                    help="append the tool's own span telemetry (import, "
                         "build, calibrate timings) as JSONL to this "
                         "path (repro_torch.obs.spans; same as "
                         "REPRO_TELEMETRY=<path>)")
    args = ap.parse_args()

    if args.telemetry:
        from repro_torch import obs
        obs.configure(args.telemetry)

    from repro_torch.analysis import (diff_prediction, format_opportunity_table,
                                rank_opportunities)
    from repro_torch.launch.perf_report import (format_cluster_report,
                                          load_trace_scenario)

    imp, scenario = load_trace_scenario(args.trace_dir, args.straggler)
    n = imp.num_workers
    if args.calibrate:
        scenario, report = scenario.calibrate()
        print(report.format())
    pred, tf, cg = scenario.evaluate("noop")

    if not args.no_diff:
        diff = diff_prediction(pred, tf, cg, imp)
        print(diff.format(top=args.top))
    print(pred.critical_path.format(top=args.top))
    if args.timeline:
        from repro_torch.obs import format_timeline_report
        print(format_timeline_report(pred.timelines))
    print(format_cluster_report(pred.cluster,
                                title=f"imported cluster x{n}"))

    if not args.no_rank:
        opps = rank_opportunities(scenario, realize=True,
                                  baseline_cluster=cg)
        print(format_opportunity_table(opps))

    if args.what_if:
        wpred = scenario.predict(args.what_if)
        print(f"== what-if {args.what_if} ==")
        print(f"baseline  : {wpred.baseline * 1e3:10.3f} ms")
        print(f"predicted : {wpred.predicted * 1e3:10.3f} ms "
              f"({wpred.speedup:.2f}x)")
        print(wpred.critical_path.format(top=args.top))
        if args.timeline:
            from repro_torch.obs import format_timeline_report
            print(format_timeline_report(wpred.timelines))


if __name__ == "__main__":
    main()
