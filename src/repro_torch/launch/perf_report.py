"""Performance report CLI (counterpart of ``repro/launch/perf_report.py``:
the same flags and output).

Compiled-cell route (``--arch``/``--shape``): the flash-attention
substitution the paper's §7.4 workflow models ("profile the kernel
separately, input the result into Daydream").  The reference compiles a
256-chip cell and walks its HLO; here the per-device train step
(``make_train_step`` with ``AdamW(fused=True)`` on ``global_batch / 256``
sequences, the reference's ``--mesh single`` data-parallel program) runs
once on meta tensors under torch.profiler
(:func:`repro_torch.core.trace.trace_compiled`), so no card is needed and
nothing is allocated.  The report then

  1. totals the step's FLOPs and bytes and separates the attention core's:
     the ``repro_torch::flash_attention`` operators and every operator of
     their plain backward (``kernels/ref.py::flash_attention_bwd``, which
     materialises f32 scores in query chunks), selected by the autograd
     node that runs it (``FlashAttentionFnBackward``); the q/k/v/o
     projections are not in it;
  2. replaces those bytes with a flash kernel's traffic (q, k, v, o per
     pass: forward, backward recompute, backward), which on the port is the
     roofline of a flash backward kernel;
  3. prints both roofline rows on ``H100_SXM`` (``cost.hw``; never a TPU's
     constants), tagged ``modeled_flash``.

    PYTHONPATH=src python -m repro_torch.launch.perf_report --arch tinyllama-1.1b \\
        --shape train_4k --cluster 4 --what-if amp --out /tmp/perf

Meshes are not ported, so the traced program has no collectives
(``collective_s`` is 0): ``--cluster N`` and ``--what-if ddp,...`` insert
them as on every other route, and ``--mesh multi`` raises.  Only train
shapes of data-parallel (``layout="dp"``) configs, and of moe and mla_moe
configs (all experts on the device), are traced.

Trace-import route (no trace of a model): import per-worker profiler
captures (torch.profiler captures of the port's step, Chrome trace-event
JSON or the native JSONL: see :mod:`repro_torch.traceio`), run a registry
stack on the imported cluster, and export the prediction for Perfetto::

    PYTHONPATH=src python -m repro_torch.launch.perf_report --trace-dir traces/ \\
        --what-if 'amp,bandwidth:factor=2' --export-trace predicted/

``--serving`` simulates an open-loop request workload on ``--arch``, and
``--goodput`` wraps either training route in a fault-injection simulation.
"""

import argparse
import json
import os

import torch

from repro_torch.configs import registry
from repro_torch.core.analytical import classify
from repro_torch.core.cluster import ClusterResult, WorkerSpec
from repro_torch.core.costmodel import CostModel, MeshTopology
from repro_torch.core.kineto import ENGINE, KERNEL_PREFIX, OP_CATS, _Event, _nest, task_ops
from repro_torch.core.roofline import roofline_report, format_row
from repro_torch.core.task import H100_SXM
from repro_torch.core.trace import trace_compiled
from repro_torch.data import make_batch
from repro_torch.launch.hillclimb import parse_value
from repro_torch.models import init_params, make_train_step
from repro_torch.models.model import active_params
from repro_torch.optim import AdamW

CHIPS = 256                 # the reference's --mesh single: 16 x 16 chips
# the autograd node of FlashAttentionFn: its backward is the plain recompute
ATTN_BWD_NODE = f"{ENGINE}: FlashAttentionFnBackward"


def cell_cost() -> CostModel:
    """The compiled route's cost model: the H100's data sheet on the
    reference's single-pod mesh topology (16 x 16)."""
    return CostModel(hw=H100_SXM, topo=MeshTopology.single_pod(16, 16))


def trace_cell(cfg, shape, chips: int = CHIPS, cost=None):
    """``trace_compiled`` of one device's train step at ``shape`` on meta
    tensors: ``make_train_step(cfg, AdamW(fused=True))`` on a batch of
    ``global_batch // chips`` sequences (the data-parallel program each of
    ``chips`` devices runs).  A moe or mla_moe config's expert-parallel
    layout ("v2") is traced as that data-parallel program with every expert
    on the device: the reference's expert all-to-all is not in it (ROADMAP
    C16).
    Returns the :class:`TraceBundle`."""
    if shape.kind != "train":
        raise SystemExit(f"the compiled route traces train steps only; "
                         f"{shape.name} is a {shape.kind} shape")
    if cfg.layout != "dp" and not (cfg.family in ("moe", "mla_moe")
                                   and cfg.layout == "v2"):
        raise SystemExit(f"layout {cfg.layout!r} shards the step over a mesh, "
                         f"which is not ported yet (ROADMAP A10); the "
                         f"compiled route traces layout='dp' only")
    opt = AdamW(fused=True)
    params = init_params(cfg, device="meta")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    batch = {k: torch.from_numpy(v).to("meta") for k, v in make_batch(
        cfg, seq_len=shape.seq_len, batch=max(1, shape.global_batch // chips),
        step=0).items()}
    return trace_compiled(make_train_step(cfg, opt), state, batch,
                          cost=cost or cell_cost())


def _in_attention_core(op: _Event) -> bool:
    return op.name == KERNEL_PREFIX + "flash_attention" or any(
        a.cat == "cpu_op" and a.name == ATTN_BWD_NODE for a in op.ancestors())


def aggregate_with_attention_split(events):
    """Totals of a meta-tensor capture's task operators + the attention
    core's slice (the flash operators and their plain backward)."""
    tot = {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
           "collective_s": 0.0, "attn_bytes": 0.0, "attn_flops": 0.0}
    host_side = [_Event(e) for e in events if e.get("ph") == "X" and "ts" in e
                 and e.get("cat") in OP_CATS]
    _nest(host_side)
    for op in task_ops(host_side):
        _, flops, nbytes, _ = classify(op)
        tot["flops"] += flops
        tot["bytes"] += nbytes
        if _in_attention_core(op):
            tot["attn_bytes"] += nbytes
            tot["attn_flops"] += flops
    return tot


def flash_traffic(cfg, shape, chips: int) -> float:
    """Per-device HBM bytes of the flash kernel across the step.

    fwd + bwd-recompute + bwd = 3 kernel passes (bwd reads dO too: 4th
    tensor stream folded into the factor), each streaming q, k, v, o once.
    Train shapes double for the gradient outputs.  q and k have the head
    dim ``D``, v and o ``D_v`` (``flash_head_dims``).
    """
    B, S = shape.global_batch, shape.seq_len
    D, Dv = flash_head_dims(cfg)
    per_pass = 2 * B * S * cfg.n_heads * (D + Dv) * 2    # q,k,v,o bf16
    passes = 3.0 if shape.kind == "train" else 1.0
    layers = cfg.n_layers
    return passes * layers * per_pass / chips


def flash_head_dims(cfg):
    """(q/k head dim, v head dim) of the flash kernel's launches: MLA's
    (qk_nope + qk_rope, v_head_dim), else the config's one head dim twice."""
    if cfg.family == "mla_moe":
        return cfg.qk_nope + cfg.qk_rope, cfg.v_head_dim
    hd = cfg.head_dim or cfg.d_model // max(cfg.n_heads, 1)
    return hd, hd


def flash_rooflines(bundle, cfg, shape, chips: int = CHIPS, cost=None):
    """``(totals, flash bytes, compiled roofline, with-flash roofline)`` of
    a traced cell, on ``cost.hw`` (default the bundle's cost model's)."""
    hw = (cost or bundle.cost).hw
    tot = aggregate_with_attention_split(bundle.module)
    fb = flash_traffic(cfg, shape, chips)
    agg = {"flops": tot["flops"],
           "bytes": tot["bytes"] - tot["attn_bytes"] + fb,
           "collective_bytes": tot["collective_bytes"],
           "collective_s": tot["collective_s"]}
    base_agg = {"flops": tot["flops"], "bytes": tot["bytes"],
                "collective_bytes": tot["collective_bytes"],
                "collective_s": tot["collective_s"]}
    kw = dict(chips=chips, kind=shape.kind,
              n_active_params=active_params(cfg), seq_len=shape.seq_len,
              global_batch=shape.global_batch, hw=hw)
    return tot, fb, roofline_report(base_agg, **kw), roofline_report(agg, **kw)


def format_cluster_report(result: ClusterResult, *, title: str = "cluster",
                          unit: float = 1e3) -> str:
    """Per-worker table for a :class:`ClusterResult` (unit=1e3 -> ms).

    One row per worker: local makespan, device/comm/host busy time, idle
    time, and the slowdown vs the fastest worker — the straggler / skew
    signal the single-graph what-if path cannot produce.
    """
    best = min((r.makespan for r in result.per_worker.values()),
               default=0.0) or 1.0
    lines = [f"== {title}: {len(result.workers)} workers, "
             f"global makespan {result.makespan * unit:.3f} ==",
             "worker  makespan   device     comm      host      idle    vs-best"]
    for i in sorted(result.per_worker):
        r = result.per_worker[i]
        dev = r.thread_busy.get("device", 0.0)
        host = r.thread_busy.get("host", 0.0)
        comm = sum(v for k, v in r.thread_busy.items()
                   if k not in ("device", "host", "data"))
        idle = r.breakdown.get("idle_s", 0.0)
        lines.append(f"w{i:<5d}  {r.makespan * unit:8.3f}  {dev * unit:8.3f} "
                     f"{comm * unit:8.3f}  {host * unit:8.3f}  "
                     f"{idle * unit:8.3f}   {r.makespan / best:5.2f}x")
    return "\n".join(lines)


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


def build_scenario(graph, cfg, cost, *, workers=1, straggler: str = ""):
    """The traced step's graph as an optimize.Scenario.

    Gradient buckets are keyed by the layer tags that actually appear on the
    graph's backward tasks so the all-reduce legs gate on real backprop
    (wait-free-backprop wiring); total payload is the config's parameter
    bytes.  If the graph carries no layer tags, the fallback is one
    synthetic bucket list — cluster reports then show per-worker
    compute/comm splits but no backprop-overlap coupling.

    ``workers``: 1 keeps the analytical single-graph route; an int > 1 (or
    a ``--straggler`` spec) builds a WorkerSpec list so predictions route
    through the global ClusterGraph.
    """
    from repro_torch.core.optimize import Scenario
    title = ""
    if isinstance(workers, int) and workers > 1:
        specs = [WorkerSpec() for _ in range(workers)]
        title = f"cluster x{workers}"
        if straggler:
            idx, slow = _parse_straggler(straggler, workers)
            specs[idx] = WorkerSpec(compute_scale=slow)
            title += f" (w{idx} {slow}x slower)"
        workers = specs
    layers = sorted({t.layer for t in graph.tasks()
                     if t.layer and t.phase == "bwd"})
    if not layers:
        layers = [f"layer{i}" for i in range(max(1, cfg.n_layers))]
    per_layer = 2.0 * active_params(cfg) / len(layers)  # bf16 grads
    grads = {l: per_layer for l in layers}
    return Scenario(graph, cost=cost, layer_grad_bytes=grads,
                    workers=workers), title


def cluster_whatif_report(graph, cfg, cost, *, workers: int,
                          straggler: str = "",
                          critical_path: bool = False,
                          timeline: bool = False) -> str:
    """Cluster-simulate the traced step across ``workers`` replicas."""
    if straggler:
        _parse_straggler(straggler, workers)
    from repro_torch.core.optimize import DDP
    scenario, title = build_scenario(graph, cfg, cost, workers=workers,
                                     straggler=straggler)
    pred = scenario.predict(DDP())
    out = format_cluster_report(pred.cluster, title=title)
    if critical_path:
        out += "\n" + pred.critical_path.format()
    if timeline:
        from repro_torch.obs import format_timeline_report
        out += "\n" + format_timeline_report(pred.timelines)
    return out


def export_prediction(pred, tf, cg, dest: str) -> str:
    """Write a prediction's timeline as Chrome trace JSON (Perfetto).

    Cluster routes write one re-importable file per worker into ``dest``
    (a directory); single-graph routes write one file at ``dest``.
    """
    from repro_torch import traceio
    acts, grads = pred.byte_maps or (None, None)
    if cg is not None:
        # collectives (coll_gid) and point-to-point hops (p2p provenance)
        # both round-trip through --trace-dir re-import, pipeline
        # placements included; byte maps size the memory counter tracks
        paths = traceio.export_cluster_traces(cg, pred.cluster, dest,
                                              activation_bytes=acts,
                                              layer_grad_bytes=grads)
        return (f"exported {len(paths)} per-worker Chrome traces to "
                f"{dest}/ (open in https://ui.perfetto.dev; re-import with "
                f"--trace-dir)")
    if dest.endswith(".json"):
        path = dest
    else:
        os.makedirs(dest, exist_ok=True)
        path = os.path.join(dest, "trace.json")
    traceio.export_graph_trace(tf.graph, pred.result, path,
                               activation_bytes=acts,
                               layer_grad_bytes=grads)
    return f"exported Chrome trace to {path} (open in https://ui.perfetto.dev)"


def whatif_stack_report(graph, cfg, cost, spec: str, *, workers: int = 0,
                        straggler: str = "", export_trace: str = "",
                        critical_path: bool = False,
                        timeline: bool = False) -> str:
    """Evaluate a registry-parsed optimization stack on the traced step.

    ``spec`` is the CLI form parsed against the optimization registry, e.g.
    ``amp,ddp:workers=16,zero`` — commas stack optimizations (applied left
    to right), colons attach ``param=value`` pairs; a ``workers=N`` pair
    sets the scenario's analytical worker count.  Combine with
    ``--cluster N`` to route the same stack through the global ClusterGraph
    and get the per-worker table, and ``--export-trace`` to dump the
    predicted timeline for Perfetto.
    """
    from repro_torch.core.optimize import parse_stack
    import dataclasses as _dc
    opt, overrides = parse_stack(spec)     # fail fast on bad specs
    if workers and "workers" in overrides:
        raise SystemExit(
            f"--what-if sets workers={overrides['workers']} but --cluster "
            f"{workers} was also given; pick one (--cluster routes through "
            f"the global ClusterGraph, workers=N in the spec is the "
            f"analytical route)")
    scenario, title = build_scenario(graph, cfg, cost,
                                     workers=workers or 1,
                                     straggler=straggler)
    if overrides:
        scenario = _dc.replace(scenario, **overrides)
    pred, tf, cg = scenario.evaluate(opt)
    lines = [f"== what-if {spec} =="]
    for o in (opt.opts if hasattr(opt, "opts") else (opt,)):
        lines.append(f"   {o.spec()}")
    lines.append(f"baseline  : {pred.baseline * 1e3:10.3f} ms")
    lines.append(f"predicted : {pred.predicted * 1e3:10.3f} ms "
                 f"({pred.speedup:.2f}x)")
    if pred.cluster is not None:
        lines.append(format_cluster_report(
            pred.cluster, title=title or f"cluster x{len(pred.cluster.workers)}"))
    if critical_path:
        lines.append(pred.critical_path.format())
    if timeline:
        from repro_torch.obs import format_timeline_report
        lines.append(format_timeline_report(pred.timelines))
    if export_trace:
        lines.append(export_prediction(pred, tf, cg, export_trace))
    return "\n".join(lines)


def load_trace_scenario(trace_dir: str, straggler: str = ""):
    """Import a per-worker trace dir into a ready-to-diagnose Scenario.

    Prints the per-worker import summary (event counts, clock fits, start
    skews), derives gradient payloads for insertion-style what-ifs
    (ddp/zero on a trace without collectives: traced collective payload
    split over the traced backward layers), and layers an optional
    ``IDX:SLOWDOWN`` straggler spec on top of the traced speeds.  Shared
    by ``perf_report --trace-dir`` and ``repro_torch.launch.diagnose``;
    returns ``(ImportedCluster, Scenario)``.
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


def trace_report(args) -> None:
    """``--trace-dir`` route: import real per-worker profiler traces
    (torch.profiler captures, Chrome trace-event JSON / native JSONL — see
    :mod:`repro_torch.traceio`), run an optimization stack from the registry
    on the imported cluster, and optionally export the prediction back to
    Chrome format.

        PYTHONPATH=src python -m repro_torch.launch.perf_report \\
            --trace-dir traces/ --what-if 'amp,bandwidth:factor=2' \\
            --export-trace predicted/
    """
    imp, scenario = load_trace_scenario(args.trace_dir, args.straggler)
    n = imp.num_workers
    spec = args.what_if or "noop"
    pred, tf, cg = scenario.evaluate(spec)
    if args.what_if:
        print(f"== what-if {spec} on imported traces ==")
        print(f"baseline  : {pred.baseline * 1e3:10.3f} ms")
        print(f"predicted : {pred.predicted * 1e3:10.3f} ms "
              f"({pred.speedup:.2f}x)")
    print(format_cluster_report(pred.cluster,
                                title=f"imported cluster x{n}"))
    if args.critical_path:
        print(pred.critical_path.format())
    if args.timeline:
        from repro_torch.obs import format_timeline_report
        print(format_timeline_report(pred.timelines))
    if args.export_trace:
        print(export_prediction(pred, tf, cg, args.export_trace))


def serving_report(args) -> None:
    """``--serving`` route: open-loop request simulation on ``--arch``.

    Builds a seeded Poisson workload, prices it with the arch's registered
    :func:`repro_torch.configs.serving_cost` (``H100_SXM``), and prints the
    latency/goodput table for baseline + ``--what-if`` stack — nothing is
    traced or served.

        PYTHONPATH=src python -m repro_torch.launch.perf_report --serving \\
            --arch tinyllama-1.1b --rate 50 --duration 5 \\
            --what-if 'continuous_batching,tp:degree=8'
    """
    from repro_torch.configs import normalize_arch, serving_cost
    from repro_torch.serving import (ServingPolicy, ServingScenario,
                                     format_serving_table, poisson_workload)
    if not args.arch:
        raise SystemExit("--serving needs --arch")
    arch = normalize_arch(args.arch)
    wl = poisson_workload(args.rate, args.duration, seed=0)
    scn = ServingScenario(workload=wl, policy=ServingPolicy(mode="static"),
                          serving_cost=serving_cost(arch))
    preds = [scn.predict("noop")]
    if args.what_if:
        preds.append(scn.predict(args.what_if))
    print(f"== serving {arch}: {len(wl)} requests, "
          f"{wl.offered_rate():.1f} req/s offered ==")
    print(format_serving_table(preds))
    if args.critical_path:
        print(preds[-1].critical_path.format())
    if args.timeline:
        from repro_torch.obs import format_timeline_report
        print(format_timeline_report(preds[-1].timelines))
    if args.export_trace:
        from repro_torch.traceio import export_graph_trace
        p = preds[-1]
        print(export_graph_trace(p.graph, p.result, args.export_trace))


def goodput_section(scenario, args) -> str:
    """``--goodput``: wrap a built training scenario in a
    :class:`repro_torch.faults.FaultScenario` and report useful steps/hour,
    availability and lost work for the baseline + ``--what-if`` stack.
    Composes with ``--trace-dir`` (imported cluster) and with the
    compiled-arch route (add ``--cluster N`` for a data-parallel fleet).
    """
    from repro_torch.faults import FaultScenario, format_goodput_table

    fscn = FaultScenario(
        graph=scenario.graph, cost=scenario.cost,
        layer_grad_bytes=scenario.layer_grad_bytes,
        activation_bytes=scenario.activation_bytes,
        workers=scenario.workers, traces=scenario.traces,
        collective_mode=scenario.collective_mode,
        mtbf_s=args.mtbf_hours * 3600.0, horizon_s=args.goodput_horizon,
        ckpt_interval_steps=args.ckpt_interval)
    base = "noop" if fscn.traces is not None or fscn.num_workers == 1 \
        else "ddp"
    preds = [fscn.predict(base)]
    if args.what_if:
        preds.append(fscn.predict(args.what_if))
    lines = [f"== goodput: {fscn.num_workers} worker(s), per-worker MTBF "
             f"{args.mtbf_hours:.1f}h, horizon "
             f"{args.goodput_horizon / 3600.0:.1f}h, ckpt every "
             f"{args.ckpt_interval} steps ==",
             f"recovery: {fscn.recovery.describe()}",
             format_goodput_table(preds)]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--tag", default="modeled_flash")
    ap.add_argument("--out", default="experiments/perf")
    ap.add_argument("--cluster", type=int, default=0,
                    help="also cluster-simulate N data-parallel workers")
    ap.add_argument("--straggler", default="",
                    help="IDX:SLOWDOWN, e.g. 0:2.0 (with --cluster)")
    ap.add_argument("--what-if", default="", dest="what_if",
                    help="registry-parsed optimization stack, e.g. "
                         "'amp,ddp:workers=16,zero' or "
                         "'pipeline:stages=4,microbatches=16,schedule=1f1b'"
                         " (see repro_torch.core.optimize; combine with "
                         "--cluster for per-worker breakdown; pipeline "
                         "placements always report per-stage workers)")
    ap.add_argument("--trace-dir", default="", dest="trace_dir",
                    help="import per-worker profiler traces (torch.profiler, "
                         "Chrome JSON / native JSONL, one file per worker) "
                         "instead of tracing --arch; runs --what-if on the "
                         "imported cluster (see repro_torch.traceio)")
    ap.add_argument("--export-trace", default="", dest="export_trace",
                    help="write the predicted timeline as Chrome trace JSON "
                         "(per-worker files on cluster routes) for Perfetto")
    ap.add_argument("--critical-path", action="store_true",
                    dest="critical_path",
                    help="print the predicted timeline's makespan-defining "
                         "chain with compute/comm/host/idle attribution "
                         "(repro_torch.analysis; composes with --what-if, "
                         "--cluster, and --trace-dir)")
    ap.add_argument("--timeline", action="store_true",
                    help="print the predicted timeline's counter rollups "
                         "(per-worker utilization, peak live memory, "
                         "ready-queue depth, COMM bytes in flight — "
                         "repro_torch.obs; composes with every route)")
    ap.add_argument("--telemetry", default="",
                    help="append the tool's own span telemetry (import, "
                         "build, retune, sweep, calibrate timings) as "
                         "JSONL to this path (repro_torch.obs.spans; same "
                         "as REPRO_TELEMETRY=<path>)")
    ap.add_argument("--serving", action="store_true",
                    help="serving route: simulate an open-loop request "
                         "workload on --arch instead of tracing a "
                         "training step; --what-if takes serving stacks "
                         "(continuous_batching, chunked_prefill, tp, ...) "
                         "— see repro_torch.launch.serve_sim for the full "
                         "knob surface")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="(--serving) Poisson arrival rate, req/s")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="(--serving) arrival window, seconds")
    ap.add_argument("--goodput", action="store_true",
                    help="goodput route: wrap the built scenario in a "
                         "fault-injection simulation (repro_torch.faults) "
                         "and report useful steps/hour under the "
                         "--mtbf-hours failure process; composes with "
                         "--trace-dir and --cluster, --what-if takes "
                         "fault-policy stacks (ckpt_interval, elastic, "
                         "hot_spare, straggler_mitigation) — see "
                         "repro_torch.launch.goodput for the full knob "
                         "surface")
    ap.add_argument("--mtbf-hours", type=float, default=6.0,
                    help="(--goodput) per-worker MTBF, hours")
    ap.add_argument("--goodput-horizon", type=float, default=86400.0,
                    help="(--goodput) simulated wall-clock, seconds")
    ap.add_argument("--ckpt-interval", type=int, default=100,
                    help="(--goodput) baseline checkpoint interval, steps")
    args = ap.parse_args()

    if args.telemetry:
        from repro_torch import obs
        obs.configure(args.telemetry)
    if args.serving:
        serving_report(args)
        return
    if args.trace_dir:
        if args.goodput:
            _, scenario = load_trace_scenario(args.trace_dir,
                                              args.straggler)
            print(goodput_section(scenario, args))
            return
        trace_report(args)
        return
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required (unless --trace-dir)")
    if args.mesh == "multi":
        raise SystemExit("--mesh multi traces the 2-pod mesh, and meshes are "
                         "not ported yet (ROADMAP A10)")

    cfg = registry.get_config(args.arch)
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg = cfg.with_(**{k: parse_value(v)})
    shape = registry.SHAPES[args.shape]
    chips = CHIPS
    cost = cell_cost()
    bundle = trace_cell(cfg, shape, chips, cost)
    graph = bundle.graph
    if args.goodput:
        scenario, _ = build_scenario(graph, cfg, cost,
                                     workers=args.cluster or 1,
                                     straggler=args.straggler)
        print(goodput_section(scenario, args))
        return
    tot, fb, base, modeled = flash_rooflines(bundle, cfg, shape, chips)
    print("compiled    :", format_row(args.arch, args.shape, args.mesh, base))
    print("with flash  :", format_row(args.arch, args.shape, args.mesh,
                                      modeled))
    if args.what_if:
        print(whatif_stack_report(graph, cfg, cost, args.what_if,
                                  workers=args.cluster,
                                  straggler=args.straggler,
                                  export_trace=args.export_trace,
                                  critical_path=args.critical_path,
                                  timeline=args.timeline))
    elif args.cluster:
        if args.export_trace:
            # one evaluation feeds both the report and the export
            scenario, title = build_scenario(graph, cfg, cost,
                                             workers=args.cluster,
                                             straggler=args.straggler)
            pred, tf, cg = scenario.evaluate("ddp")
            print(format_cluster_report(pred.cluster, title=title))
            if args.critical_path:
                print(pred.critical_path.format())
            if args.timeline:
                from repro_torch.obs import format_timeline_report
                print(format_timeline_report(pred.timelines))
            print(export_prediction(pred, tf, cg, args.export_trace))
        else:
            print(cluster_whatif_report(graph, cfg, cost,
                                        workers=args.cluster,
                                        straggler=args.straggler,
                                        critical_path=args.critical_path,
                                        timeline=args.timeline))
    elif args.export_trace or args.critical_path or args.timeline:
        scenario, _ = build_scenario(graph, cfg, cost)
        pred, tf, cg = scenario.evaluate("noop")
        if args.critical_path:
            print(pred.critical_path.format())
        if args.timeline:
            from repro_torch.obs import format_timeline_report
            print(format_timeline_report(pred.timelines))
        if args.export_trace:
            print(export_prediction(pred, tf, cg, args.export_trace))
    print(f"attention-loop bytes replaced: {tot['attn_bytes']/1e9:.1f} GB "
          f"-> flash kernel {fb/1e9:.2f} GB per device")
    os.makedirs(args.out, exist_ok=True)
    rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
           "status": "ok", "what_if": args.what_if or None,
           "modeled": "flash_attention_substitution",
           "attn_bytes_removed": tot["attn_bytes"],
           "flash_bytes_added": fb,
           "roofline_compiled": base, "roofline": modeled}
    with open(os.path.join(
            args.out,
            f"{args.arch}__{args.shape}__{args.mesh}__{args.tag}.json"),
            "w") as f:
        json.dump(rec, f, indent=1, default=str)


if __name__ == "__main__":
    main()
