"""Serving what-if CLI: predict latency/goodput for a policy stack.

Generates a seeded open-loop workload, builds a
:class:`repro_torch.serving.ServingScenario` priced by the arch's registered
:func:`repro_torch.configs.serving_cost`, and prints the latency/goodput table
for the baseline (static slots, the engine's semantics) plus every
requested what-if stack — all through the simulator, nothing is served::

    PYTHONPATH=src python -m repro_torch.launch.serve_sim --model llama3_405b \\
        --rate 500 --duration 60 --what-if 'continuous_batching,tp:degree=8'

``--what-if`` repeats and each spec is any registry stack
(``continuous_batching,chunked_prefill:chunk=256,tp:degree=8``); add
``--bound`` to print each stack's headroom upper bound next to the
realized speedup.  ``--trace`` replays a JSONL request log instead of the
Poisson process.
"""

import argparse
import json
import sys

from repro_torch.configs import normalize_arch, serving_cost
from repro_torch.core import parse_stack
from repro_torch.serving import (ServingPolicy, ServingScenario,
                                 format_serving_table, poisson_workload,
                                 trace_workload)


def build_scenario(args) -> ServingScenario:
    cost = serving_cost(args.model, smoke=args.smoke)
    if args.trace:
        wl = trace_workload(args.trace)
    else:
        wl = poisson_workload(args.rate, args.duration, seed=args.seed,
                              prompt_mean=args.prompt_mean,
                              output_mean=args.output_mean)
    policy = ServingPolicy(mode="static", slots=args.slots)
    return ServingScenario(workload=wl, policy=policy, serving_cost=cost)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="request-level serving simulation: p50/p99 latency and "
                    "goodput what-ifs over the dependency-graph simulator")
    ap.add_argument("--model", default="llama3_405b",
                    help="arch id (dashed or underscore form)")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--duration", type=float, default=60.0,
                    help="arrival-window length, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-mean", type=int, default=512)
    ap.add_argument("--output-mean", type=int, default=128)
    ap.add_argument("--slots", type=int, default=8,
                    help="baseline policy's batch slots")
    ap.add_argument("--smoke", action="store_true",
                    help="price the reduced smoke config")
    ap.add_argument("--trace", default=None,
                    help="JSONL request log replayed instead of Poisson")
    ap.add_argument("--what-if", action="append", default=[],
                    help="registry stack spec; repeatable")
    ap.add_argument("--bound", action="store_true",
                    help="print each stack's headroom upper bound")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    args.model = normalize_arch(args.model)

    scn = build_scenario(args)
    wl = scn.workload
    print(f"# {args.model}: {len(wl)} requests over {wl.duration:.1f}s "
          f"({wl.offered_rate():.1f} req/s offered, "
          f"{wl.total_output_tokens} output tokens), baseline "
          f"static_slots:{scn.policy.slots}", file=sys.stderr)

    preds = [scn.predict("noop")]
    for spec in args.what_if:
        opt, overrides = parse_stack(spec)
        if overrides:
            raise SystemExit(f"serving stacks take no scenario overrides, "
                             f"got {overrides} in {spec!r}")
        preds.append(scn.predict(opt))

    if args.as_json:
        out = []
        for p in preds:
            out.append({
                "spec": p.optimization.spec(), "speedup": p.speedup,
                "makespan": p.predicted, "goodput": p.goodput,
                "ttft_p50": p.ttft_p50, "ttft_p99": p.ttft_p99,
                "tpot_p50": p.tpot_p50, "tpot_p99": p.tpot_p99,
                "latency_p50": p.latency_p50, "latency_p99": p.latency_p99,
                "tokens_generated": p.tokens_generated,
                "requests_completed": p.requests_completed,
            })
        print(json.dumps(out, indent=2))
    else:
        print(format_serving_table(preds))
    if args.bound:
        from repro_torch.analysis.opportunity import opportunity_bound
        for p in preds[1:]:
            b = opportunity_bound(scn, p.optimization)
            print(f"bound {p.optimization.spec()}: <= {b:.2f}x "
                  f"(realized {p.speedup:.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
