"""Calibration CLI: fit the CostModel to a captured trace set (counterpart
of ``repro/launch/calibrate.py``: the same flags and output).

Closes the fidelity loop (dPRO arXiv:2205.02473): imports a per-worker
profiler capture — a torch.profiler capture of the port's step
(``*.pt.trace.json[.gz]``, :mod:`repro_torch.traceio.torch_profiler`),
native JSONL, Chrome trace-event JSON, or a ``jax.profiler`` logdir
(``plugins/profile/<run>/*.trace.json.gz``, see
:mod:`repro_torch.traceio.xla`) — then iterates simulate → diff → refit
through the real simulator (:mod:`repro_torch.analysis.calibrate`) and prints
the before/after fidelity table: per-kind WAPE, makespan error, and every
constant the fit moved.

    PYTHONPATH=src python -m repro_torch.launch.calibrate --trace-dir traces/ \\
        [--max-rounds 6] [--tol 1e-3] [--constants kind_scale:compute,...]\\
        [--diff] [--strict-align]

The calibrated constants print in ``CostModel.with_constants`` form so a
follow-up what-if run can reuse them.
"""

import argparse


def main() -> None:
    ap = argparse.ArgumentParser(
        description="fit CostModel constants to a captured trace set and "
                    "report fidelity before/after")
    ap.add_argument("--trace-dir", required=True, dest="trace_dir",
                    help="per-worker trace directory (worker*.jsonl / "
                         "*.trace.json / *.pt.trace.json[.gz]) or a "
                         "jax.profiler logdir")
    ap.add_argument("--max-rounds", type=int, default=6, dest="max_rounds",
                    help="coordinate-descent rounds (default 6)")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="relative per-round loss improvement below which "
                         "the fit stops (default 1e-3)")
    ap.add_argument("--constants", default="",
                    help="comma-separated subset of fittable constants, "
                         "e.g. 'kind_scale:compute,ici_factor' "
                         "(default: all the capture can inform)")
    ap.add_argument("--diff", action="store_true",
                    help="also print the full post-calibration diff "
                         "(top mispredicted tasks)")
    ap.add_argument("--strict-align", action="store_true",
                    dest="strict_align",
                    help="raise instead of warn when the capture's clocks "
                         "cannot be reliably aligned")
    ap.add_argument("--straggler", default="",
                    help="IDX:SLOWDOWN what-if worker spec layered on top "
                         "of the traced speeds")
    args = ap.parse_args()

    from repro_torch import traceio
    from repro_torch.launch.perf_report import load_trace_scenario

    if args.strict_align:
        # fail fast, before the scenario import prints anything
        traceio.load_trace_dir(args.trace_dir, align="strict")
    imp, scenario = load_trace_scenario(args.trace_dir, args.straggler)
    constants = [c.strip() for c in args.constants.split(",") if c.strip()] \
        or None
    calibrated, report = scenario.calibrate(
        constants=constants, max_rounds=args.max_rounds, tol=args.tol)
    print(report.format())
    if args.diff:
        print(report.after.format())
    moved = {n: v[1] for n, v in report.fitted.items()
             if v[0] != v[1]}
    if moved:
        print(f"reuse with: CostModel().with_constants({moved!r})")


if __name__ == "__main__":
    main()
