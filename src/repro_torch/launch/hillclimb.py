"""What-if hill-climb CLI (counterpart of ``repro/launch/hillclimb.py``:
the same flags and JSON record).

With ``--search-whatif N`` it traces the cell's per-device train
step once on meta tensors (:func:`repro_torch.launch.perf_report.trace_cell`,
priced on ``H100_SXM``; no card needed) and greedily hill-climbs the
*optimization registry* (:mod:`repro_torch.core.optimize`): every
default-constructible registered optimization is a candidate, and the
best-stack-so-far grows one optimization per round (at most N) while the
predicted makespan keeps dropping.  Extra candidates with parameters come
from repeatable ``--candidate name:param=value`` specs.

Before searching, it prints the opportunity-ranking table
(:mod:`repro_torch.analysis`: per-candidate Amdahl speedup bound through the
real simulator, critical-path share, and the realized depth-1 speedup),
orders the search best-headroom-first, and skips candidates whose bound
proves they cannot improve the scenario — the table says which and why.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch tinyllama-1.1b \\
        --shape train_4k --tag whatif3 --search-whatif 3 \\
        --candidate dgc:compression=0.01 --out /tmp/perf

Without ``--search-whatif`` the reference runs the dry-run cell
(``launch/dryrun.py::run_cell``), which is not ported yet (ROADMAP A10):
the port raises ``SystemExit`` saying so.
"""

import argparse
import json
import os


def parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    return v


def search_whatif(args, cfg) -> None:
    """Greedy registry search over the traced step's dependency graph."""
    from repro_torch.core.optimize import default_candidates, greedy_search, \
        parse_stack
    # lazy: perf_report imports this module at top level (parse_value)
    from repro_torch.launch.perf_report import build_scenario, cell_cost, \
        trace_cell
    from repro_torch.configs import registry as cfg_registry

    if args.mesh == "multi":
        raise SystemExit("--mesh multi traces the 2-pod mesh, and meshes are "
                         "not ported yet (ROADMAP A10)")
    shape = cfg_registry.SHAPES[args.shape]
    cost = cell_cost()
    graph = trace_cell(cfg, shape, cost=cost).graph
    scenario, _ = build_scenario(graph, cfg, cost,
                                 workers=args.cluster or 1,
                                 straggler=args.straggler)

    candidates = default_candidates(scenario)
    for spec in args.candidate:
        opt, over = parse_stack(spec)
        if over:
            raise SystemExit(f"--candidate {spec!r}: scenario overrides "
                             f"belong in --cluster/--straggler")
        candidates.append(opt)

    # rank by Amdahl-style headroom bounds first (repro_torch.analysis):
    # greedy search then tries high-headroom candidates first,
    # provably-hopeless ones (bound <= 1x) are skipped, and the table shows
    # why
    from repro_torch.analysis import (format_opportunity_table,
                                      rank_opportunities,
                                      searchable_candidates)
    opps = rank_opportunities(scenario, candidates, realize=True)
    print(format_opportunity_table(opps, title="what-if search ordering"))
    searchable = searchable_candidates(opps)
    skipped = [o for o in opps if o.skipped]
    if skipped:
        print(f"skipping {len(skipped)} candidate(s) whose bound proves no "
              f"improvement on this scenario")

    # the ranking already realized every candidate at depth 1: seed the
    # first greedy round with those predictions instead of re-simulating
    round1 = {id(o.optimization): o.prediction
              for o in opps if o.prediction is not None}
    best, trail = greedy_search(scenario, max_depth=args.search_whatif,
                                candidates=searchable, round1=round1)
    base = scenario.baseline().makespan
    print(f"baseline: {base*1e3:.3f} ms; searched {len(searchable)} of "
          f"{len(candidates)} registry candidates to depth "
          f"{args.search_whatif}")
    for i, pred in enumerate(trail):
        print(f"round {i+1}: {pred.optimization.spec():60s} "
              f"{pred.predicted*1e3:10.3f} ms  ({pred.speedup:.2f}x)")
    if best is None:
        print("no registered optimization improves this scenario")
    rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "status": "ok", "mode": "whatif_search",
           "baseline_ms": base * 1e3,
           "best_stack": best.spec() if best is not None else None,
           "opportunities": [
               {"candidate": o.optimization.spec(),
                "bound": None if o.unbounded else o.bound,
                "cp_share": o.cp_share, "realized": o.realized,
                "skipped": o.skipped,
                "error": o.error or None} for o in opps],
           "trail": [{"stack": p.optimization.spec(),
                      "predicted_ms": p.predicted * 1e3,
                      "speedup": p.speedup} for p in trail]}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(
        args.out, f"{args.arch}__{args.shape}__{args.mesh}__{args.tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {path}")


def main() -> None:
    from repro_torch.configs import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--search-whatif", type=int, default=0,
                    help="greedy-search the optimization registry to this "
                         "stack depth (required: the dry-run cell the "
                         "reference runs without it is not ported yet)")
    ap.add_argument("--candidate", action="append", default=[],
                    help="extra search candidate as a registry spec, e.g. "
                         "dgc:compression=0.01 (repeatable)")
    ap.add_argument("--cluster", type=int, default=0,
                    help="search on the N-worker cluster route")
    ap.add_argument("--straggler", default="",
                    help="IDX:SLOWDOWN cluster straggler (with --cluster)")
    args = ap.parse_args()

    cfg = registry.get_config(args.arch)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_value(v)
    if overrides:
        cfg = cfg.with_(**overrides)
    print(f"overrides: {overrides}")
    if args.search_whatif:
        search_whatif(args, cfg)
        return
    raise SystemExit("hillclimb without --search-whatif runs the dry-run cell "
                     "(launch/dryrun.py::run_cell), which is not ported yet "
                     "(ROADMAP A10); pass --search-whatif N")


if __name__ == "__main__":
    main()
