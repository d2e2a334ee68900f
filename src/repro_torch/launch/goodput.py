"""Goodput-under-failures CLI: useful steps/hour for a fault-policy stack
(counterpart of ``repro/launch/goodput.py``: the same flags and output).

Builds a :class:`repro_torch.faults.FaultScenario` — from a synthetic
data-parallel step by default, or from imported per-worker profiler traces
with ``--trace-dir``, such as a torch.profiler capture of the port's step —
and prints the goodput table for the baseline stack plus every requested
what-if::

    PYTHONPATH=src python -m repro_torch.launch.goodput --workers 16 \\
        --mtbf-hours 6 --what-if 'ddp,elastic' \\
        --what-if 'ddp,hot_spare:count=2'

``--what-if`` repeats; each spec is any registry stack mixing fault
policies (``ckpt_interval:steps=K``, ``elastic``, ``hot_spare``,
``straggler_mitigation``) with ordinary graph what-ifs (``amp``,
``bandwidth``, ...).  ``--sweep-interval`` sweeps the checkpoint interval
around the Young/Daly closed-form optimum and marks both.
"""

import argparse
import json
import math
import sys

from repro_torch.core import parse_stack
from repro_torch.faults import (FaultScenario, demo_scenario,
                                format_goodput_table, young_daly_interval)


def build_scenario(args) -> FaultScenario:
    kw = dict(mtbf_s=args.mtbf_hours * 3600.0, horizon_s=args.horizon_s,
              seed=args.seed, ckpt_interval_steps=args.ckpt_interval,
              preempt_period_s=args.preempt_period,
              preempt_duration_s=args.preempt_duration,
              straggler_rate_per_hour=args.straggler_rate,
              straggler_slowdown=args.straggler_slowdown)
    if args.trace_dir:
        from repro_torch.launch.perf_report import load_trace_scenario
        _, scn = load_trace_scenario(args.trace_dir)
        return FaultScenario(graph=scn.graph, cost=scn.cost,
                             layer_grad_bytes=scn.layer_grad_bytes,
                             workers=scn.workers, traces=scn.traces, **kw)
    return demo_scenario(workers=args.workers, layers=args.layers, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="goodput under failures: useful steps/hour, "
                    "availability and lost work for fault-policy what-ifs "
                    "over the dependency-graph simulator")
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--layers", type=int, default=8,
                    help="synthetic step graph depth")
    ap.add_argument("--mtbf-hours", type=float, default=6.0,
                    help="per-worker MTBF in hours (0 = no failures)")
    ap.add_argument("--horizon-s", type=float, default=86400.0,
                    help="simulated wall-clock, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-interval", type=int, default=100,
                    help="baseline checkpoint interval, steps")
    ap.add_argument("--preempt-period", type=float, default=0.0,
                    help="preemption window period, seconds (0 = none)")
    ap.add_argument("--preempt-duration", type=float, default=0.0)
    ap.add_argument("--straggler-rate", type=float, default=0.0,
                    help="transient straggler windows per hour (0 = none)")
    ap.add_argument("--straggler-slowdown", type=float, default=2.0)
    ap.add_argument("--trace-dir", default=None,
                    help="build the training side from imported per-worker "
                         "profiler traces instead of the synthetic step")
    ap.add_argument("--base", default="ddp",
                    help="baseline training stack the fault policies ride "
                         "on (synthetic route; 'noop' for traces that "
                         "already carry collectives)")
    ap.add_argument("--what-if", action="append", default=[],
                    help="registry stack spec; repeatable")
    ap.add_argument("--sweep-interval", action="store_true",
                    help="sweep the checkpoint interval around the "
                         "Young/Daly optimum")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    if args.trace_dir and args.base == "ddp":
        args.base = "noop"      # traces already carry their collectives

    scn = build_scenario(args)
    rec = scn.recovery
    print(f"# {scn.num_workers} workers, per-worker MTBF "
          f"{args.mtbf_hours:.1f}h (job "
          f"{scn.job_mtbf_s / 3600.0 if scn.mtbf_s else math.inf:.2f}h), "
          f"horizon {scn.horizon_s / 3600.0:.1f}h, ckpt every "
          f"{scn.ckpt_interval_steps} steps; recovery: {rec.describe()}",
          file=sys.stderr)

    preds = [scn.predict(args.base)]
    for spec in args.what_if:
        opt, overrides = parse_stack(spec)
        if overrides:
            raise SystemExit(f"scenario overrides {sorted(overrides)} are "
                             f"not supported in --what-if specs here")
        preds.append(scn.predict(opt))

    if args.as_json:
        out = []
        for p in preds:
            r = p.report
            out.append({"spec": p.optimization.spec(),
                        "goodput_steps_per_hour": r.goodput_steps_per_hour,
                        "goodput_fraction": r.goodput_fraction,
                        "availability": r.availability,
                        "failures": r.failures,
                        "lost_steps": r.lost_steps,
                        "useful_steps": r.useful_steps,
                        "speedup": p.speedup})
        print(json.dumps(out, indent=2))
    else:
        print(format_goodput_table(preds))

    if args.sweep_interval:
        best, points, k_yd = scn.optimal_ckpt_interval(args.base)
        tau = young_daly_interval(rec.checkpoint_write_s, scn.job_mtbf_s)
        print(f"\n== checkpoint-interval sweep (Young/Daly optimum "
              f"{tau:.0f}s ~= {k_yd} steps) ==")
        for p in points:
            k = p.policy.ckpt_interval_steps
            mark = "  <- best" if p is best else \
                ("  <- Young/Daly" if k == k_yd else "")
            print(f"  every {k:>6d} steps: "
                  f"{p.report.goodput_steps_per_hour:>10,.0f} useful "
                  f"steps/h ({p.report.goodput_fraction:.1%}){mark}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
