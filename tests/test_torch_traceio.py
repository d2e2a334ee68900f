"""repro_torch.traceio against the JAX package's repro.traceio.

The first part is ``tests/test_traceio.py`` run on the port (its graphs
built by ``tests/torch_synthgraphs.py``), with its acceptance criteria:

* **Round-trip invariant**: exporting a simulated uniform N-worker cluster
  to per-worker Chrome traces and re-importing via
  ``ClusterGraph.from_traces`` reproduces the predicted makespan within
  1e-6 relative error (the golden ``tests/golden/trace_roundtrip.json``
  reproduced from ``repro_torch``).
* **Replicate equivalence**: a trace-imported cluster of N identical
  workers matches the replicate path (``ClusterGraph.build``) to float
  precision, for every collective mode.
* **Skew handling**: a synthetic trace set with per-worker clock offsets /
  drift and a straggler is aligned (dPRO-style least-squares offset+drift
  on collective-end anchors) and predicted correctly.

Then ``tests/test_traceio_properties.py``'s properties with the same
hypothesis settings, each example run through both packages and held
``==``; then the file formats: what one package writes, byte for byte what
the other writes, and each package's export imported by the other to the
same makespan.  Last the port's own reader, torch.profiler captures
(``repro_torch.traceio.torch_profiler``), and ``load_trace_dir``'s format
detection: a JAX capture, a native export and a torch.profiler file in a
bare directory each reach their own reader.
"""

import filecmp
import gzip
import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.traceio as ref_traceio  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import synthgraphs as ref_graphs  # noqa: E402
import torch_synthgraphs as port_graphs  # noqa: E402
from repro_torch.core import (ClusterGraph, CostModel, GraphError, Task, TaskKind,  # noqa: E402
                              WorkerSpec, simulate, whatif, DEVICE_STREAM)
from repro_torch.core.cluster import match_collective_groups  # noqa: E402
from repro_torch.core.kineto import graph_from_events as kineto_graph  # noqa: E402
from repro_torch.core.trace import TraceBundle  # noqa: E402
from repro_torch import traceio  # noqa: E402
from repro_torch.traceio import (TraceEvent, TraceImportError, WorkerTrace,  # noqa: E402
                                 align_traces, apply_alignment, events_from_graph,
                                 graph_from_events, load_trace_dir, read_jsonl,
                                 synthetic_cluster_traces, write_jsonl,
                                 write_synthetic_trace_dir)
from torch_synthgraphs import training_step_graph  # noqa: E402

LAYERS = 6
GRADS = {f"l{i}": 30e6 for i in range(LAYERS)}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "trace_roundtrip.json")


@pytest.fixture()
def ddp_graph():
    g = training_step_graph(layers=LAYERS)
    return whatif.what_if_distributed(g, GRADS, num_workers=4).graph


def write_traces(tmp_path, traces):
    os.makedirs(str(tmp_path), exist_ok=True)
    for tr in traces:
        write_jsonl(tr.events, str(tmp_path / f"worker{tr.worker}.jsonl"))
    return str(tmp_path)


# ================================================================ round trip
class TestRoundTrip:
    def test_uniform_cluster_export_import_recovers_makespan(self, ddp_graph,
                                                             tmp_path):
        """THE acceptance invariant: simulate -> export -> import -> same
        makespan within 1e-6 relative."""
        cost = CostModel()
        cg = ClusterGraph.build(ddp_graph, 4, cost=cost)
        res = cg.simulate()
        traceio.export_cluster_traces(cg, res, str(tmp_path))
        res2 = ClusterGraph.from_traces(str(tmp_path), cost=cost).simulate()
        assert res2.makespan == pytest.approx(res.makespan, rel=1e-6)

    def test_roundtrip_matches_golden(self, ddp_graph, tmp_path):
        """The fixed synthetic cluster's makespan is pinned by a golden
        file: format/importer drift that changes predictions fails here."""
        with open(GOLDEN) as f:
            golden = json.load(f)
        cost = CostModel()
        cg = ClusterGraph.build(ddp_graph, golden["workers"], cost=cost)
        res = cg.simulate()
        assert res.makespan == pytest.approx(golden["makespan_s"], rel=1e-9)
        traceio.export_cluster_traces(cg, res, str(tmp_path))
        res2 = ClusterGraph.from_traces(str(tmp_path), cost=cost).simulate()
        assert res2.makespan == pytest.approx(golden["makespan_s"], rel=1e-6)

    def test_single_graph_chrome_roundtrip_exact(self, ddp_graph, tmp_path):
        """graph -> Chrome JSON -> graph reproduces the simulated makespan
        exactly (all edges/durations/gaps survive)."""
        res = simulate(ddp_graph)
        path = str(tmp_path / "step.trace.json")
        traceio.export_graph_trace(ddp_graph, res, path)
        tr = traceio.load_worker_trace(path)
        g2 = graph_from_events(tr)
        assert len(g2) == len(ddp_graph)
        assert simulate(g2).makespan == pytest.approx(res.makespan,
                                                      rel=1e-12)

    def test_export_tolerates_none_valued_attrs(self):
        """HLO-extracted graphs tag non-collective comm tasks with
        ``collective=None`` / ``group_size=None``; export must not choke."""
        from repro_torch.core import DependencyGraph
        g = DependencyGraph()
        g.add_task(Task("permute", TaskKind.COLLECTIVE, "ici:x", 1e-3,
                        attrs={"collective": None, "group_size": None}))
        evs = events_from_graph(g)
        assert evs[0].group_size == 0 and evs[0].collective is None
        tr = read_jsonl(iter(write_jsonl(evs)))
        assert simulate(graph_from_events(tr)).makespan == \
            pytest.approx(1e-3)

    def test_jsonl_roundtrip_in_memory(self, ddp_graph):
        events = events_from_graph(ddp_graph)
        lines = write_jsonl(events)            # no path: in-memory
        tr = read_jsonl(iter(lines))
        g2 = graph_from_events(tr)
        assert simulate(g2).makespan == \
            pytest.approx(simulate(ddp_graph).makespan, rel=1e-12)

    def test_exported_cluster_trace_opens_as_chrome_json(self, ddp_graph,
                                                         tmp_path):
        cg = ClusterGraph.build(ddp_graph, 2)
        traceio.export_cluster_traces(cg, cg.simulate(), str(tmp_path))
        with open(tmp_path / "worker0.trace.json") as f:
            data = json.load(f)
        evs = data["traceEvents"]
        assert any(e.get("ph") == "X" for e in evs)
        assert any(e.get("ph") == "M" and e.get("name") == "thread_name"
                   for e in evs)
        # collective pieces collapsed back to one event per all-reduce
        names = [e["name"] for e in evs if e.get("ph") == "X"]
        assert not any(":leg" in n for n in names)
        assert any(e.get("args", {}).get("collective") == "all-reduce"
                   for e in evs if e.get("ph") == "X")


# ===================================================== replicate equivalence
class TestReplicateEquivalence:
    @pytest.mark.parametrize("n", [2, 4, 8])
    @pytest.mark.parametrize("mode", ["ring", "fused", "hierarchical"])
    def test_identical_workers_match_replicate_path(self, ddp_graph, n, mode,
                                                    tmp_path):
        """N identical imported traces == ClusterGraph.build to float
        precision, for every collective mode."""
        cost = CostModel()
        build = ClusterGraph.build(ddp_graph, n, cost=cost,
                                   collective_mode=mode).simulate()
        events = events_from_graph(ddp_graph)
        for w in range(n):
            write_jsonl(events, str(tmp_path / f"worker{w}.jsonl"))
        imported = ClusterGraph.from_traces(
            str(tmp_path), cost=cost, collective_mode=mode).simulate()
        assert imported.makespan == pytest.approx(build.makespan, rel=1e-12)
        assert imported.worker_makespans() == \
            pytest.approx(build.worker_makespans(), rel=1e-12)

    def test_from_worker_graphs_single_worker_identity(self, ddp_graph):
        res = ClusterGraph.from_worker_graphs([ddp_graph]).simulate()
        assert res.makespan == pytest.approx(simulate(ddp_graph).makespan,
                                             rel=1e-12)

    def test_worker_specs_layer_on_top_of_traces(self, ddp_graph):
        """Explicit WorkerSpecs scale the *traced* durations — the
        straggler what-if on imported traces."""
        uni = ClusterGraph.from_worker_graphs([ddp_graph] * 4).simulate()
        specs = [WorkerSpec(compute_scale=2.0 if i == 0 else 1.0)
                 for i in range(4)]
        slow = ClusterGraph.from_worker_graphs([ddp_graph] * 4,
                                               specs).simulate()
        assert slow.makespan > uni.makespan * 1.2
        assert slow.straggler() == 0


# ============================================================ clock alignment
class TestAlignment:
    OFFSETS = [0.0, 0.05, -0.03, 0.12]
    DRIFTS = [1.0, 1.0002, 0.9999, 1.0]

    def test_alignment_recovers_offset_and_drift(self):
        traces = synthetic_cluster_traces(
            4, clock_offsets=self.OFFSETS, clock_drifts=self.DRIFTS)
        aligns = align_traces(traces)
        for al, off, drift in zip(aligns, self.OFFSETS, self.DRIFTS):
            assert al.anchors == LAYERS
            # local = true*d + o  =>  true = (1/d)*local - o/d
            assert al.scale == pytest.approx(1.0 / drift, rel=1e-9)
            assert al.offset == pytest.approx(-off / drift, rel=1e-6,
                                              abs=1e-12)
            assert al.residual < 1e-9

    def test_skewed_clocks_do_not_change_prediction(self, tmp_path):
        """Prediction from offset/drifted traces == prediction from clean
        traces: alignment undoes the clocks."""
        cost = CostModel()
        clean = synthetic_cluster_traces(4)
        skewed = synthetic_cluster_traces(
            4, clock_offsets=self.OFFSETS, clock_drifts=self.DRIFTS)
        d1 = write_traces(tmp_path / "clean", clean)
        d2 = write_traces(tmp_path / "skewed", skewed)
        r1 = ClusterGraph.from_traces(d1, cost=cost).simulate()
        r2 = ClusterGraph.from_traces(d2, cost=cost).simulate()
        assert r2.makespan == pytest.approx(r1.makespan, rel=1e-6)

    def test_skewed_straggler_predicted_correctly(self, tmp_path):
        """Acceptance: clock-offset + straggler trace set is aligned and
        predicted correctly — the straggler's extra compute shifts the
        makespan by the analytical amount (everyone waits on the ring)."""
        cost = CostModel()
        slowdown = 2.0
        uni = synthetic_cluster_traces(4)
        strag = synthetic_cluster_traces(
            4, compute_scales=[slowdown, 1.0, 1.0, 1.0],
            clock_offsets=self.OFFSETS, clock_drifts=self.DRIFTS)
        d1 = write_traces(tmp_path / "uni", uni)
        d2 = write_traces(tmp_path / "strag", strag)
        r_uni = ClusterGraph.from_traces(d1, cost=cost).simulate()
        r = ClusterGraph.from_traces(d2, cost=cost).simulate()
        device_compute = sum(e.dur for e in uni[0].events
                             if e.thread == DEVICE_STREAM)
        expected = r_uni.makespan + (slowdown - 1.0) * device_compute
        assert r.makespan == pytest.approx(expected, rel=0.02)
        assert r.straggler() == 0

    def test_start_skew_gates_late_worker(self, tmp_path):
        """A worker whose (aligned) trace starts late stays late in the
        simulation — the start-skew gate tasks."""
        traces = synthetic_cluster_traces(2)
        late = 5e-3
        for ev in traces[1].events:
            ev.ts += late                     # true late start, not clock
        d = write_traces(tmp_path, traces)
        imp = load_trace_dir(d, align=False)
        assert imp.start_skews[1] == pytest.approx(late)
        res = ClusterGraph.from_traces(imp).simulate()
        base = ClusterGraph.from_traces(
            write_traces(tmp_path / "clean", synthetic_cluster_traces(2))
        ).simulate()
        assert res.makespan > base.makespan
        assert res.makespan == pytest.approx(base.makespan + late, rel=0.2)

    def test_single_worker_alignment_is_identity(self):
        traces = synthetic_cluster_traces(1)
        aligns = align_traces(traces)
        assert aligns[0].is_identity


# =============================================================== importing
class TestImport:
    def test_stream_order_and_deps_reconstructed(self):
        evs = [
            TraceEvent("a", "host", ts=0.0, dur=1e-3, eid=0),
            TraceEvent("b", "device", ts=2e-3, dur=1e-3, eid=1, deps=[0]),
            TraceEvent("c", "device", ts=4e-3, dur=1e-3, eid=2),
            TraceEvent("d", "ici:x", ts=5e-3, dur=1e-3, eid=3, deps=[2]),
        ]
        g = graph_from_events(WorkerTrace(0, evs))
        assert len(g) == 4
        by_name = {t.name: t for t in g.tasks()}
        # cross-thread dep a->b, lane edge b->c, cross-thread c->d
        assert by_name["b"] in g.children(by_name["a"])
        assert by_name["c"] in g.children(by_name["b"])
        assert by_name["d"] in g.children(by_name["c"])

    def test_host_gap_inference(self):
        evs = [
            TraceEvent("h1", "host", ts=0.0, dur=1e-3, eid=0),
            TraceEvent("h2", "host", ts=5e-3, dur=1e-3, eid=1),
            TraceEvent("k1", "device", ts=0.0, dur=1e-3, eid=2),
            TraceEvent("k2", "device", ts=5e-3, dur=1e-3, eid=3),
        ]
        g = graph_from_events(WorkerTrace(0, evs))
        by_name = {t.name: t for t in g.tasks()}
        assert by_name["h1"].gap == pytest.approx(4e-3)   # host: inferred
        assert by_name["k1"].gap == 0.0                   # device: not
        # explicit gap wins over inference
        evs[0].gap = 1e-3
        g2 = graph_from_events(WorkerTrace(0, evs))
        assert {t.name: t for t in g2.tasks()}["h1"].gap == 1e-3

    def test_kind_and_collective_inference(self):
        ev = TraceEvent("ncclAllReduce_f32", "comm", ts=0.0, dur=1e-3)
        t = ev.to_task()
        assert t.kind == TaskKind.COLLECTIVE
        assert t.attrs["collective"] == "all-reduce"
        assert traceio.infer_collective("fusion.123") is None
        assert traceio.classify("matmul", "device") == TaskKind.COMPUTE
        assert traceio.classify("enqueue", "host") == TaskKind.HOST

    def test_bad_dep_id_raises(self):
        evs = [TraceEvent("a", "device", ts=0.0, dur=1e-3, eid=0, deps=[7])]
        with pytest.raises(TraceImportError, match="unknown event id"):
            graph_from_events(WorkerTrace(0, evs))

    def test_cyclic_flow_raises(self):
        evs = [
            TraceEvent("a", "device", ts=0.0, dur=1e-3, eid=0, deps=[1]),
            TraceEvent("b", "ici:x", ts=0.5e-3, dur=1e-3, eid=1, deps=[0]),
        ]
        with pytest.raises(TraceImportError, match="DAG"):
            graph_from_events(WorkerTrace(0, evs))

    def test_missing_required_field_raises(self, tmp_path):
        p = tmp_path / "worker0.jsonl"
        p.write_text('{"name": "a", "thread": "device", "ts": 0.0}\n')
        with pytest.raises(TraceImportError, match="dur"):
            load_trace_dir(str(tmp_path))

    def test_empty_dir_raises(self, tmp_path):
        with pytest.raises(TraceImportError, match="no .*worker files"):
            load_trace_dir(str(tmp_path))
        with pytest.raises(TraceImportError, match="does not exist"):
            load_trace_dir(str(tmp_path / "nope"))

    def test_mismatched_collectives_raise(self, tmp_path):
        traces = synthetic_cluster_traces(2)
        # drop one collective from worker 1 -> matching must fail loudly
        drop = next(e for e in traces[1].events if e.name == "allreduce:l0")
        traces[1].events = [e for e in traces[1].events if e is not drop]
        for e in traces[1].events:
            e.deps = [dd for dd in e.deps if dd != drop.eid]
        d = write_traces(tmp_path, traces)
        with pytest.raises(GraphError, match="missing collective"):
            ClusterGraph.from_traces(d)

    def test_worker_file_ordering(self, tmp_path):
        for name, worker in [("worker10.jsonl", 10), ("worker2.jsonl", 2),
                             ("worker0.jsonl", 0)]:
            write_jsonl([TraceEvent("a", "device", ts=0.0, dur=1e-3,
                                    eid=0)], str(tmp_path / name))
        files = traceio.find_worker_files(str(tmp_path))
        assert [os.path.basename(f) for f in files] == \
            ["worker0.jsonl", "worker2.jsonl", "worker10.jsonl"]

    def test_chrome_flow_timestamp_binding(self, tmp_path):
        """Foreign Chrome traces (no args.bind extension) bind flows by
        timestamp: s -> enclosing slice, f -> next slice."""
        trace = {"traceEvents": [
            {"ph": "X", "name": "producer", "pid": 0, "tid": 1,
             "ts": 0.0, "dur": 100.0},
            {"ph": "X", "name": "consumer", "pid": 0, "tid": 2,
             "ts": 200.0, "dur": 50.0},
            {"ph": "s", "cat": "dep", "name": "dep", "id": 1, "pid": 0,
             "tid": 1, "ts": 50.0},
            {"ph": "f", "cat": "dep", "name": "dep", "id": 1, "pid": 0,
             "tid": 2, "ts": 200.0},
        ]}
        p = tmp_path / "worker0.json"
        p.write_text(json.dumps(trace))
        tr = traceio.read_chrome(str(p))
        consumer = next(e for e in tr.events if e.name == "consumer")
        producer = next(e for e in tr.events if e.name == "producer")
        assert consumer.deps == [producer.eid]

    def test_chrome_correlation_binding(self, tmp_path):
        trace = {"traceEvents": [
            {"ph": "X", "name": "launch", "pid": 0, "tid": 1, "ts": 0.0,
             "dur": 10.0, "args": {"correlation": 42}},
            {"ph": "X", "name": "kernel", "pid": 0, "tid": 2, "ts": 30.0,
             "dur": 99.0, "args": {"correlation": 42}},
        ]}
        p = tmp_path / "worker0.json"
        p.write_text(json.dumps(trace))
        tr = traceio.read_chrome(str(p))
        kernel = next(e for e in tr.events if e.name == "kernel")
        launch = next(e for e in tr.events if e.name == "launch")
        assert kernel.deps == [launch.eid]
        assert kernel.ts == pytest.approx(30e-6)   # us -> s


# ======================================================== scenario + sweeps
class TestTraceScenario:
    def test_scenario_trace_route_runs_registry_stack(self, tmp_path):
        """Acceptance: the PR-2 registry runs end-to-end on imported
        traces — amp|bandwidth composes and speeds up the cluster."""
        from repro_torch.core import Scenario
        write_synthetic_trace_dir(str(tmp_path), 4)
        scn = Scenario(trace_dir=str(tmp_path))
        assert scn.is_cluster
        pred = scn.predict("amp,bandwidth:factor=2")
        assert pred.cluster is not None
        assert len(pred.cluster.per_worker) == 4
        assert pred.speedup > 1.5
        base = scn.predict("noop")
        assert base.predicted == pytest.approx(base.baseline, rel=1e-12)

    def test_scenario_sweep_reuses_trace_cluster(self, tmp_path):
        """Worker-spec sweeps on the trace route retune one imported
        build; predictions match per-point rebuilds exactly."""
        from repro_torch.core import Scenario
        from repro_torch.core.optimize import straggler_specs
        write_synthetic_trace_dir(str(tmp_path), 4)
        scn = Scenario(trace_dir=str(tmp_path))
        grid = {"workers": straggler_specs(4, [1.0, 1.5, 2.0])}
        reused = scn.sweep("noop", grid, reuse=True)
        rebuilt = scn.sweep("noop", grid, reuse=False)
        assert [p.predicted for p in reused] == \
            [p.predicted for p in rebuilt]
        assert reused[0].predicted < reused[-1].predicted

    def test_scenario_worker_count_mismatch_raises(self, tmp_path):
        from repro_torch.core import Scenario
        from repro_torch.core.optimize import OptimizationError
        write_synthetic_trace_dir(str(tmp_path), 4)
        with pytest.raises(OptimizationError, match="4 trace worker"):
            Scenario(trace_dir=str(tmp_path), workers=8)
        with pytest.raises(OptimizationError, match="4 trace worker"):
            Scenario(trace_dir=str(tmp_path), workers=[WorkerSpec()] * 3)


# ========================================================== build invariants
class TestClusterBuildGuards:
    def test_hierarchical_rejects_unequal_pods(self, ddp_graph):
        """Satellite: unequal pod sizes would silently mis-group the
        cross-pod shard exchange; build must reject them loudly."""
        bad = [WorkerSpec(pod=0), WorkerSpec(pod=0), WorkerSpec(pod=0),
               WorkerSpec(pod=1)]
        with pytest.raises(GraphError, match="equal-size pods"):
            ClusterGraph.build(ddp_graph, bad,
                               collective_mode="hierarchical")
        with pytest.raises(GraphError, match="equal-size pods"):
            ClusterGraph.from_worker_graphs([ddp_graph] * 4, bad,
                                            collective_mode="hierarchical")
        # equal pods still fine (and ring mode never cares)
        ClusterGraph.build(ddp_graph, [WorkerSpec(pod=i // 2)
                                       for i in range(4)],
                           collective_mode="hierarchical")
        ClusterGraph.build(ddp_graph, bad, collective_mode="ring")

    def test_from_worker_graphs_spec_count_mismatch(self, ddp_graph):
        with pytest.raises(GraphError, match="pair up 1:1"):
            ClusterGraph.from_worker_graphs([ddp_graph] * 2,
                                            [WorkerSpec()] * 3)

    def test_match_collective_groups_on_identical_graphs(self, ddp_graph):
        groups = match_collective_groups([ddp_graph, ddp_graph])
        n_coll = sum(1 for t in ddp_graph.tasks()
                     if t.attrs.get("collective"))
        assert len(groups) == n_coll
        for op, members in groups:
            assert op == "all-reduce"
            assert members[0].name == members[1].name


def test_hop_latency_calibration_plumbing():
    """Satellite: measured hop latency flows CostModel -> CollectiveModel ->
    ring legs, the way compute calibration already flows into durations.
    (The reference's measurement half, ``core/calibrate.py``, is not carried
    over yet: only the plumbing is held here.)"""
    from repro_torch.core.costmodel import CollectiveModel
    hop = 3e-6
    # plumbing: CostModel(hop_latency=...) reaches ring legs
    cost = CostModel(hop_latency=hop)
    assert cost.collectives.hop_latency == hop
    base = CostModel()
    assert base.collectives.hop_latency == CollectiveModel.HOP_LATENCY
    g = training_step_graph(layers=2)
    tf = whatif.what_if_distributed(g, {"l0": 1e6, "l1": 1e6}, 4,
                                    cost=cost)
    cg = ClusterGraph.build(tf.graph, 4, cost=cost)
    legs = [t for t in cg.graph.tasks() if "ring_round" in t.attrs]
    assert legs
    hw = cost.hw
    # both layers land in one 2 MB bucket; leg = (payload/n)/link_bw + hop
    expected = (2e6 / 4) / (hw.ici_bandwidth * hw.ici_links_per_axis) + hop
    assert min(t.duration for t in legs) == pytest.approx(expected,
                                                          rel=1e-12)


# ===================================================== degenerate clock fits
class TestAlignmentGuards:
    """Satellite: _fit on noisy/degenerate anchors can produce a
    non-positive or wildly-off scale; apply_alignment would then negate
    every duration.  The fit must fall back to offset-only instead."""

    @staticmethod
    def _trace(worker, ends):
        evs = [TraceEvent(name, "ici:grad", ts=end - 1e-3, dur=1e-3,
                          eid=i, collective="all-reduce")
               for i, (name, end) in enumerate(ends)]
        return WorkerTrace(worker, evs)

    def test_negative_slope_anchors_fall_back_to_offset(self):
        # anchor pairs with anti-correlated times: least squares gives a
        # negative scale, which must be rejected
        t0 = self._trace(0, [("allreduce:a", 0.2), ("allreduce:b", 0.1)])
        t1 = self._trace(1, [("allreduce:a", 0.1), ("allreduce:b", 0.2)])
        aligns = align_traces([t0, t1])
        al = aligns[1]
        assert al.fallback
        assert al.scale == 1.0
        assert al.anchors == 2
        apply_alignment(t1, al)
        assert all(ev.dur > 0 for ev in t1.events)

    def test_wildly_off_scale_falls_back(self):
        # nearly-coincident local anchors against well-spread reference
        # ones: the regression slope explodes past any physical drift
        t0 = self._trace(0, [("allreduce:a", 0.1), ("allreduce:b", 0.9)])
        t1 = self._trace(1, [("allreduce:a", 0.5), ("allreduce:b", 0.502)])
        aligns = align_traces([t0, t1])
        assert aligns[1].fallback
        assert aligns[1].scale == 1.0
        # offset-only map still centers the anchors
        assert aligns[1].offset == pytest.approx(0.5 - 0.501, abs=1e-9)

    def test_physical_drift_is_not_rejected(self):
        traces = synthetic_cluster_traces(
            2, clock_offsets=[0.0, 0.1], clock_drifts=[1.0, 1.0005])
        aligns = align_traces(traces)
        assert not aligns[1].fallback
        assert aligns[1].scale == pytest.approx(1.0 / 1.0005, rel=1e-9)

    def test_degenerate_durations_never_go_negative(self, tmp_path):
        """End to end: an adversarial capture imports with positive
        durations everywhere (the graph would reject negatives)."""
        t0 = self._trace(0, [("allreduce:a", 0.2), ("allreduce:b", 0.1)])
        t1 = self._trace(1, [("allreduce:a", 0.1), ("allreduce:b", 0.2)])
        d = write_traces(tmp_path, [t0, t1])
        imp = load_trace_dir(d)
        for tr in imp.traces:
            assert all(ev.dur > 0 for ev in tr.events)


# ==================================================== unanchored multi-worker
class TestAlignmentQualityChecks:
    """Satellite: multi-worker captures whose traces share zero matched
    collectives must not silently proceed with identity alignment."""

    @staticmethod
    def _disjoint_dir(tmp_path):
        # two workers with no common collective names -> zero anchors
        t0 = WorkerTrace(0, [
            TraceEvent("allreduce:x", "ici:grad", ts=0.0, dur=1e-3, eid=0,
                       collective="all-reduce"),
            TraceEvent("k", "device", ts=0.0, dur=1e-3, eid=1)])
        t1 = WorkerTrace(1, [
            TraceEvent("allreduce:y", "ici:grad", ts=0.0, dur=1e-3, eid=0,
                       collective="all-reduce"),
            TraceEvent("k", "device", ts=0.0, dur=1e-3, eid=1)])
        return write_traces(tmp_path, [t0, t1])

    def test_zero_anchor_import_warns_by_default(self, tmp_path):
        d = self._disjoint_dir(tmp_path)
        with pytest.warns(UserWarning,
                          match="share no matched collectives"):
            imp = load_trace_dir(d)
        assert imp.num_workers == 2            # still usable, just flagged

    def test_strict_alignment_raises(self, tmp_path):
        d = self._disjoint_dir(tmp_path)
        with pytest.raises(TraceImportError, match="unreliable"):
            load_trace_dir(d, align="strict")

    def test_strict_rejects_fallback_fits(self, tmp_path):
        t0 = TestAlignmentGuards._trace(
            0, [("allreduce:a", 0.2), ("allreduce:b", 0.1)])
        t1 = TestAlignmentGuards._trace(
            1, [("allreduce:a", 0.1), ("allreduce:b", 0.2)])
        d = write_traces(tmp_path, [t0, t1])
        with pytest.raises(TraceImportError, match="degenerate drift"):
            load_trace_dir(d, align="strict")

    def test_align_false_stays_silent(self, tmp_path, recwarn):
        d = self._disjoint_dir(tmp_path)
        load_trace_dir(d, align=False)
        assert not [w for w in recwarn
                    if "collectives" in str(w.message)]

    def test_anchored_import_does_not_warn(self, tmp_path, recwarn):
        d = write_traces(tmp_path, synthetic_cluster_traces(2))
        load_trace_dir(d, align="strict")      # anchors exist: no raise
        assert not [w for w in recwarn
                    if "collectives" in str(w.message)]

    def test_bad_align_value_rejected(self, tmp_path):
        d = write_traces(tmp_path, synthetic_cluster_traces(2))
        with pytest.raises(ValueError, match="align must be"):
            load_trace_dir(d, align="loose")


# ============================================================ XLA profiler
class TestXlaImport:
    """jax.profiler / XLA capture reader (repro_torch.traceio.xla) on
    handcrafted captures."""

    @staticmethod
    def _write_capture(path, events, gz=True):
        import gzip as _gzip
        doc = {"displayTimeUnit": "ns", "metadata": {},
               "traceEvents": events}
        if gz:
            with _gzip.open(path, "wt") as f:
                json.dump(doc, f)
        else:
            with open(path, "w") as f:
                json.dump(doc, f)

    @classmethod
    def _profile_dir(cls, tmp_path, events):
        run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
        os.makedirs(str(run))
        cls._write_capture(str(run / "host.trace.json.gz"), events)
        return str(tmp_path)

    @staticmethod
    def _meta(pid, tid, pname, tname):
        return [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": pname}},
                {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": tname}}]

    def _step_capture(self):
        evs = self._meta(7, 1, "/host:CPU", "tf_XLATfrtCpuClient/1")
        evs += self._meta(7, 2, "/host:CPU", "python")[1:]
        for step, base in ((0, 1000.0), (1, 2000.0)):
            evs.append({"ph": "X", "name": "train", "pid": 7, "tid": 2,
                        "ts": base, "dur": 500.0,
                        "args": {"step_num": str(step)}})
            # nested python flame: outer frame contains two leaves
            evs.append({"ph": "X", "name": "$m outer", "pid": 7, "tid": 2,
                        "ts": base + 10, "dur": 100.0, "args": {}})
            evs.append({"ph": "X", "name": "$m leaf1", "pid": 7, "tid": 2,
                        "ts": base + 20, "dur": 30.0, "args": {}})
            evs.append({"ph": "X", "name": "$m leaf2", "pid": 7, "tid": 2,
                        "ts": base + 60, "dur": 40.0, "args": {}})
            evs.append({"ph": "X", "name": "dot.1", "pid": 7, "tid": 1,
                        "ts": base + 120, "dur": 200.0,
                        "args": {"hlo_op": "dot.1",
                                 "hlo_module": "jit_f"}})
            evs.append({"ph": "X", "name": "all-reduce.2", "pid": 7,
                        "tid": 1, "ts": base + 330, "dur": 50.0,
                        "args": {"hlo_op": "all-reduce.2",
                                 "hlo_module": "jit_f"}})
        return evs

    def test_step_slicing_keeps_last_step_only(self, tmp_path):
        d = self._profile_dir(tmp_path, self._step_capture())
        imp = traceio.load_xla_profile(d)          # step="last"
        names = [e.name for e in imp.traces[0].events]
        assert "dot.1" in names and "all-reduce.2" in names
        assert names.count("dot.1") == 1           # one step, not two
        assert "train" not in names                # marker itself excluded
        # leaf extraction: the container frame is gone, leaves survive
        assert "$m outer" not in names
        assert "$m leaf1" in names and "$m leaf2" in names

    def test_explicit_and_all_step_selection(self, tmp_path):
        d = self._profile_dir(tmp_path, self._step_capture())
        imp0 = traceio.load_xla_profile(d, step=0)
        assert [e.name for e in imp0.traces[0].events].count("dot.1") == 1
        imp_all = traceio.load_xla_profile(d, step=None)
        assert [e.name
                for e in imp_all.traces[0].events].count("dot.1") == 2
        with pytest.raises(TraceImportError, match="not in capture"):
            traceio.load_xla_profile(d, step=9)

    def test_lanes_kinds_and_units(self, tmp_path):
        d = self._profile_dir(tmp_path, self._step_capture())
        imp = traceio.load_xla_profile(d)
        by_name = {}
        for ev in imp.traces[0].events:
            by_name[ev.name] = ev
        assert by_name["dot.1"].thread == "device"
        assert by_name["$m leaf1"].thread == "host"
        assert by_name["dot.1"].dur == pytest.approx(200e-6)  # us -> s
        g = imp.graphs[0]
        kinds = {t.name: t.kind for t in g.tasks()}
        assert kinds["dot.1"] == TaskKind.COMPUTE
        assert kinds["all-reduce.2"] == TaskKind.COLLECTIVE
        assert kinds["$m leaf1"] == TaskKind.HOST

    def test_load_trace_dir_detects_xla_profiles(self, tmp_path):
        d = self._profile_dir(tmp_path, self._step_capture())
        imp = load_trace_dir(d)                    # auto-detected
        assert imp.num_workers == 1
        assert any(e.thread == "device" for e in imp.traces[0].events)

    def test_latest_run_wins_and_file_paths_accepted(self, tmp_path):
        d = self._profile_dir(tmp_path, self._step_capture())
        older = tmp_path / "plugins" / "profile" / "2020_01_01_00_00_00"
        os.makedirs(str(older))
        self._write_capture(str(older / "host.trace.json.gz"),
                            self._meta(1, 1, "/host:CPU", "python"))
        files = traceio.find_xla_trace_files(str(tmp_path))
        assert len(files) == 1 and "2026_01_01" in files[0]
        # a single trace file is also a valid entry point
        assert traceio.find_xla_trace_files(files[0]) == [files[0]]

    def test_native_chrome_exports_are_not_claimed(self, tmp_path):
        """Regression: a directory of native ``worker<N>.trace.json``
        exports must NOT be detected as an XLA capture — that would
        bypass the provenance-aware importer."""
        g = whatif.what_if_distributed(
            training_step_graph(layers=2),
            {f"l{i}": 1e6 for i in range(2)}, num_workers=2).graph
        cg = ClusterGraph.build(g, 2, cost=CostModel())
        res = cg.simulate()
        traceio.export_cluster_traces(cg, res, str(tmp_path))
        assert traceio.find_xla_trace_files(str(tmp_path)) == []
        imp = load_trace_dir(str(tmp_path))
        assert imp.num_workers == 2

    def test_capture_without_steps_keeps_everything(self, tmp_path):
        evs = self._meta(7, 1, "/host:CPU", "tf_XLATfrtCpuClient/1")
        evs.append({"ph": "X", "name": "dot.9", "pid": 7, "tid": 1,
                    "ts": 100.0, "dur": 10.0, "args": {"hlo_op": "dot.9"}})
        d = self._profile_dir(tmp_path, evs)
        imp = traceio.load_xla_profile(d)
        assert [e.name for e in imp.traces[0].events] == ["dot.9"]

    def test_empty_or_malformed_captures_raise(self, tmp_path):
        d = self._profile_dir(tmp_path, self._meta(1, 1, "/host:CPU",
                                                   "python"))
        with pytest.raises(TraceImportError, match="no complete"):
            traceio.load_xla_profile(d)
        with pytest.raises(TraceImportError, match="no XLA profile"):
            traceio.load_xla_profile(str(tmp_path / "nope"))


# ================================================= properties, both packages
REF = SimpleNamespace(core=ref_core, traceio=ref_traceio, graphs=ref_graphs)
PORT = SimpleNamespace(core=port_core, traceio=traceio, graphs=port_graphs)


def both(case):
    """``case(ns)`` through the reference and the port: equal results."""
    want, got = case(REF), case(PORT)
    assert got == want
    return got


durations = st.floats(min_value=1e-5, max_value=1e-2,
                      allow_nan=False, allow_infinity=False)


@settings(max_examples=25, deadline=None)
@given(layers=st.integers(1, 8), n=st.integers(2, 6),
       mode=st.sampled_from(["ring", "fused", "hierarchical"]),
       fwd=durations, bwd=durations, grad_mb=st.floats(0.5, 64.0))
def test_imported_identical_workers_match_replicate_path(layers, n, mode,
                                                         fwd, bwd, grad_mb):
    def case(ns):
        g = ns.graphs.training_step_graph(layers=layers, fwd=fwd, bwd=bwd)
        grads = {f"l{i}": grad_mb * 1e6 for i in range(layers)}
        tf = ns.core.whatif.what_if_distributed(g, grads, num_workers=n)
        cost = ns.core.CostModel()
        build = ns.core.ClusterGraph.build(tf.graph, n, cost=cost,
                                           collective_mode=mode).simulate()
        lines = ns.traceio.write_jsonl(ns.traceio.events_from_graph(tf.graph))
        worker_graphs = [ns.traceio.graph_from_events(
            ns.traceio.read_jsonl(iter(lines), w)) for w in range(n)]
        imported = ns.core.ClusterGraph.from_worker_graphs(
            worker_graphs, cost=cost, collective_mode=mode).simulate()
        assert imported.makespan == pytest.approx(build.makespan, rel=1e-12)
        assert imported.worker_makespans() == \
            pytest.approx(build.worker_makespans(), rel=1e-12)
        return lines, build.makespan, imported.makespan, imported.worker_makespans()
    both(case)


@settings(max_examples=25, deadline=None)
@given(layers=st.integers(1, 10), fwd=durations, bwd=durations,
       upd=durations)
def test_export_import_is_fixed_point(layers, fwd, bwd, upd):
    def case(ns):
        g = ns.graphs.training_step_graph(layers=layers, fwd=fwd, bwd=bwd, upd=upd)
        res = ns.core.simulate(g)
        ev1 = ns.traceio.events_from_graph(g, res)
        g2 = ns.traceio.graph_from_events(ns.traceio.WorkerTrace(0, ev1))
        res2 = ns.core.simulate(g2)
        assert res2.makespan == pytest.approx(res.makespan, rel=1e-12)
        ev2 = ns.traceio.events_from_graph(g2, res2)
        key = [(e.name, e.thread, e.dur, e.deps) for e in ev1]
        assert key == [(e.name, e.thread, e.dur, e.deps) for e in ev2]
        return key, res.makespan, res2.makespan
    both(case)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 5), layers=st.integers(2, 8),
       offsets=st.lists(st.floats(-1.0, 1.0), min_size=5, max_size=5),
       drifts=st.lists(st.floats(0.95, 1.05), min_size=5, max_size=5))
def test_alignment_recovers_affine_clock_skew(n, layers, offsets, drifts):
    # worker 0 is the reference timeline: its clock stays clean so the
    # recovered maps are directly comparable to the injected skews
    off = [0.0] + offsets[1:n]
    dr = [1.0] + drifts[1:n]

    def case(ns):
        traces = ns.traceio.synthetic_cluster_traces(
            n, layers=layers, clock_offsets=off, clock_drifts=dr)
        aligns = ns.traceio.align_traces(traces)
        for al, o, drift in zip(aligns, off, dr):
            assert al.anchors == layers
            assert al.scale == pytest.approx(1.0 / drift, rel=1e-6)
            assert al.offset == pytest.approx(-o / drift, rel=1e-6, abs=1e-9)
        return [(al.scale, al.offset, al.anchors, al.residual) for al in aligns]
    both(case)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 5), layers=st.integers(6, 12),
       offsets=st.lists(st.floats(-1.0, 1.0), min_size=5, max_size=5),
       drifts=st.lists(st.floats(0.98, 1.02), min_size=5, max_size=5),
       noise_us=st.floats(0.1, 20.0), seed=st.integers(0, 2**31))
def test_alignment_recovers_skew_under_anchor_noise(n, layers, offsets,
                                                    drifts, noise_us, seed):
    """Injected per-worker offset+drift is recovered within a tolerance
    proportional to the anchor jitter (the reference's bounds), and both
    packages fit the same jittered anchors to the same map."""
    import random
    off = [0.0] + offsets[1:n]
    dr = [1.0] + drifts[1:n]
    noise = noise_us * 1e-6

    def case(ns):
        rng = random.Random(seed)
        traces = ns.traceio.synthetic_cluster_traces(
            n, layers=layers, clock_offsets=off, clock_drifts=dr)
        for w, tr in enumerate(traces):
            if w == 0:
                continue            # keep the reference timeline clean
            for ev in tr.events:
                if ev.resolved_collective():
                    ev.dur += rng.uniform(-noise, noise) * dr[w]
        aligns = ns.traceio.align_traces(traces)
        for w, (al, o, d) in enumerate(zip(aligns, off, dr)):
            if w == 0:
                continue
            assert al.anchors == layers
            span = 4e-3 * layers      # bwd spacing lower-bounds anchor spread
            assert al.scale == pytest.approx(1.0 / d, abs=8 * noise / (d * span))
            recovered_offset_at_t0 = al.offset - (-o / d)
            assert abs(recovered_offset_at_t0) <= 8 * noise / d + \
                abs(al.scale - 1.0 / d) * 2.0  # offset trades off against drift
            assert al.residual <= 4 * noise
        return [(al.scale, al.offset, al.residual) for al in aligns]
    both(case)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 4), layers=st.integers(2, 6),
       offsets=st.lists(st.floats(-1000.0, 1000.0), min_size=3, max_size=3),
       drifts=st.lists(st.floats(1.05, 1.9), min_size=3, max_size=3))
def test_alignment_round_trips_negative_drift_and_large_offsets(
        n, layers, offsets, drifts):
    """Aligning traces skewed by drift > 1 and offsets up to ±1000 s
    reproduces the clean timeline without tripping the degenerate-fit
    fallback, identically in both packages."""
    off = [0.0] + offsets[:n - 1]
    dr = [1.0] + drifts[:n - 1]

    def case(ns):
        clean = ns.traceio.synthetic_cluster_traces(n, layers=layers)
        skewed = ns.traceio.synthetic_cluster_traces(
            n, layers=layers, clock_offsets=off, clock_drifts=dr)
        aligns = ns.traceio.align_traces(skewed)
        out = []
        for w, al in enumerate(aligns):
            assert not al.fallback
            if w > 0:
                assert al.scale == pytest.approx(1.0 / dr[w], rel=1e-9)
                assert al.scale < 1.0          # drift > 1 compresses the map
            ns.traceio.apply_alignment(skewed[w], al)
            for ev_clean, ev in zip(clean[w].events, skewed[w].events):
                assert ev.ts == pytest.approx(ev_clean.ts, abs=1e-6)
                assert ev.dur == pytest.approx(ev_clean.dur, abs=1e-6)
                assert ev.dur > 0
            out.append([(ev.ts, ev.dur) for ev in skewed[w].events])
        return out
    both(case)


@pytest.fixture(scope="module")
def true_captures(tmp_path_factory):
    """A small 2-worker capture from the TRUE (default) CostModel, written
    by each package, shared across calibration-recovery examples."""
    out = {}
    for label, ns in (("ref", REF), ("port", PORT)):
        d = tmp_path_factory.mktemp(f"prop_capture_{label}")
        ns.traceio.write_synthetic_trace_dir(str(d), 2, layers=3,
                                             cost=ns.core.CostModel())
        out[label] = str(d)
    return out


@settings(max_examples=8, deadline=None)
@given(scale=st.one_of(st.floats(0.3, 0.8), st.floats(1.25, 3.0)))
def test_calibration_recovers_perturbed_compute_scale(true_captures, scale):
    """For any compute-duration perturbation the simulate → diff → refit
    loop fits the scale back out (≈ 1.0, loss non-increasing), to the same
    constant and loss history in both packages."""
    def case(ns):
        d = true_captures["ref" if ns is REF else "port"]
        scn = ns.core.Scenario(trace_dir=d,
                               cost=ns.core.CostModel(kind_scales={"compute": scale}))
        _, rep = scn.calibrate(constants=["kind_scale:compute"])
        assert rep.fitted["kind_scale:compute"][1] == pytest.approx(1.0, rel=1e-6)
        assert all(b <= a + 1e-15 for a, b in
                   zip(rep.loss_history, rep.loss_history[1:]))
        assert rep.after.per_kind()["compute"].wape < 1e-6
        return rep.fitted, rep.loss_history, rep.sim_calls
    both(case)


# ============================================== file formats, both packages
def _ddp(ns, layers=LAYERS, n=4):
    g = ns.graphs.training_step_graph(layers=layers)
    grads = {f"l{i}": 30e6 for i in range(layers)}
    return ns.core.whatif.what_if_distributed(g, grads, num_workers=n).graph


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


def test_synthetic_trace_dirs_are_byte_equal(tmp_path):
    for label, ns in (("ref", REF), ("port", PORT)):
        ns.traceio.write_synthetic_trace_dir(
            str(tmp_path / label), 4, layers=4, cost=ns.core.CostModel(),
            compute_scales=[1.0, 1.5, 1.0, 1.0])
    _same_files(tmp_path / "ref", tmp_path / "port")


@pytest.mark.parametrize("mode", ["ring", "hierarchical"])
def test_cluster_exports_are_byte_equal(tmp_path, mode):
    for label, ns in (("ref", REF), ("port", PORT)):
        cg = ns.core.ClusterGraph.build(_ddp(ns), 4, cost=ns.core.CostModel(),
                                        collective_mode=mode)
        ns.traceio.export_cluster_traces(cg, cg.simulate(), str(tmp_path / label))
    _same_files(tmp_path / "ref", tmp_path / "port")


def test_single_graph_exports_are_byte_equal(tmp_path):
    for label, ns in (("ref", REF), ("port", PORT)):
        g = _ddp(ns)
        ns.traceio.export_graph_trace(g, ns.core.simulate(g),
                                      str(tmp_path / f"{label}.trace.json"))
    assert (tmp_path / "ref.trace.json").read_bytes() == \
        (tmp_path / "port.trace.json").read_bytes()


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_export_of_one_package_imports_in_the_other(tmp_path, writer, reader):
    cost = writer.core.CostModel()
    cg = writer.core.ClusterGraph.build(_ddp(writer), 4, cost=cost)
    res = cg.simulate()
    writer.traceio.export_cluster_traces(cg, res, str(tmp_path))
    back = reader.core.ClusterGraph.from_traces(
        str(tmp_path), cost=reader.core.CostModel()).simulate()
    own = writer.core.ClusterGraph.from_traces(str(tmp_path), cost=cost).simulate()
    assert back.makespan == own.makespan
    assert back.makespan == pytest.approx(res.makespan, rel=1e-6)


def test_golden_roundtrip_equals_the_reference(tmp_path):
    with open(GOLDEN) as f:
        golden = json.load(f)
    got = []
    for label, ns in (("ref", REF), ("port", PORT)):
        cost = ns.core.CostModel()
        cg = ns.core.ClusterGraph.build(_ddp(ns), golden["workers"], cost=cost)
        res = cg.simulate()
        ns.traceio.export_cluster_traces(cg, res, str(tmp_path / label))
        back = ns.core.ClusterGraph.from_traces(str(tmp_path / label),
                                                cost=cost).simulate()
        got.append((res.makespan, back.makespan))
    assert got[1] == got[0]
    assert got[1][1] == pytest.approx(golden["makespan_s"], rel=1e-6)


# ================================================ torch.profiler captures
CARD = Path(__file__).resolve().parent / "data" / "kineto_smoke_step.json.gz"


@pytest.fixture(scope="module")
def card_events():
    with gzip.open(CARD, "rt") as f:
        return json.load(f)["traceEvents"]


def _torch_doc(events):
    """A torch.profiler document: its first keys, then the events."""
    return {"schemaVersion": 1,
            "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
            "traceEvents": events, "traceName": "step"}


def _write(path, doc):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(doc, f)
    return str(path)


def test_torch_profiler_capture_is_the_trace_route_graph(tmp_path, card_events):
    """The reader builds ``core.kineto``'s graph of the same events: the
    same tasks and the same simulated makespan as ``trace_measured`` would
    build, its events that graph's timeline on the capture's clock."""
    _write(tmp_path / "host_42.1700000000.pt.trace.json.gz", _torch_doc(card_events))
    imp = load_trace_dir(str(tmp_path))
    want = kineto_graph(card_events)
    g = imp.graphs[0]
    assert imp.num_workers == 1 and imp.start_skews == [0.0]
    assert [(t.name, t.thread, t.duration) for t in g.tasks()] == \
        [(t.name, t.thread, t.duration) for t in want.tasks()]
    assert simulate(g).makespan == simulate(want).makespan
    assert imp.traces[0].first_ts() == 0.0
    assert len(imp.traces[0].events) == len(g)


def test_scenario_and_cluster_take_a_torch_profiler_dir(tmp_path, card_events):
    _write(tmp_path / "step.pt.trace.json", _torch_doc(card_events))
    base = simulate(kineto_graph(card_events)).makespan
    scn = port_core.Scenario(trace_dir=str(tmp_path))
    assert scn.baseline().makespan == pytest.approx(base, rel=1e-12)
    pred = scn.predict("fused_optimizer")
    assert pred.predicted < pred.baseline
    assert ClusterGraph.from_traces(str(tmp_path)).simulate().makespan == \
        pytest.approx(base, rel=1e-12)


def test_export_chrome_round_trip_of_a_card_capture(tmp_path, card_events):
    """``TraceBundle.export_chrome`` writes the native export; re-imported,
    it simulates to the capture graph's makespan."""
    g = kineto_graph(card_events)
    bundle = TraceBundle(graph=g, module=card_events, aggregates={},
                         cost=CostModel())
    d = tmp_path / "export"
    d.mkdir()
    trace = bundle.export_chrome(str(d / "worker0.trace.json"))
    assert trace["traceEvents"] and (d / "worker0.trace.json").exists()
    back = load_trace_dir(str(d))
    assert simulate(back.graphs[0]).makespan == \
        pytest.approx(simulate(g).makespan, rel=1e-12)


def test_detects_a_jax_capture(tmp_path):
    d = TestXlaImport._profile_dir(tmp_path, TestXlaImport()._step_capture())
    assert traceio.find_torch_profiler_files(d) == []
    imp = load_trace_dir(d)
    names = [e.name for e in imp.traces[0].events]
    assert names.count("dot.1") == 1 and "$m leaf1" in names


def test_detects_a_native_export(tmp_path):
    cg = ClusterGraph.build(_ddp(PORT, layers=2, n=2), 2, cost=CostModel())
    res = cg.simulate()
    traceio.export_cluster_traces(cg, res, str(tmp_path))
    assert traceio.find_torch_profiler_files(str(tmp_path)) == []
    assert traceio.find_xla_trace_files(str(tmp_path)) == []
    imp = load_trace_dir(str(tmp_path))
    assert imp.num_workers == 2
    assert ClusterGraph.from_traces(imp).simulate().makespan == \
        pytest.approx(res.makespan, rel=1e-6)


@pytest.mark.parametrize("name", ["host_7.1700000000.pt.trace.json",
                                  "host_7.1700000000.pt.trace.json.gz",
                                  "step.json"])
def test_detects_a_torch_profiler_file_in_a_bare_dir(tmp_path, card_events, name):
    """A ``.pt.trace.json`` also matches the XLA reader's ``*.trace.json``,
    so torch.profiler is detected first; a plain ``.json`` is one by its
    first top-level key."""
    path = _write(tmp_path / name, _torch_doc(card_events))
    assert traceio.find_torch_profiler_files(str(tmp_path)) == [path]
    if ".trace.json" in name:
        assert traceio.find_xla_trace_files(str(tmp_path)) == [path]
    imp = load_trace_dir(str(tmp_path))
    assert simulate(imp.graphs[0]).makespan == \
        simulate(kineto_graph(card_events)).makespan
    assert any(t.attrs.get("correlation") is not None for t in imp.graphs[0].tasks())


def test_torch_profiler_files_are_workers_in_order(tmp_path, card_events):
    """One file per worker, ordered by the first number in the name; files
    of one host keep their relative start."""
    late = [dict(e, ts=e["ts"] + 500.0) if "ts" in e else e for e in card_events]
    _write(tmp_path / "rank1.pt.trace.json", _torch_doc(late))
    _write(tmp_path / "rank0.pt.trace.json", _torch_doc(card_events))
    imp = traceio.load_torch_profile(str(tmp_path))
    assert [Path(tr.source).name for tr in imp.traces] == \
        ["rank0.pt.trace.json", "rank1.pt.trace.json"]
    assert imp.start_skews[0] == 0.0
    assert imp.start_skews[1] == pytest.approx(500e-6, abs=1e-9)


def test_cpu_capture_takes_the_operator_route(tmp_path):
    """A capture with no device record and no listed device is a CPU step:
    operators are the tasks, as ``trace_measured(device="cpu")`` builds."""
    ops = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 1, "tid": 1,
            "ts": ts, "dur": 10, "args": {}}
           for n, ts in (("aten::mm", 0), ("aten::add", 20))]
    _write(tmp_path / "cpu.pt.trace.json", {"schemaVersion": 1, "traceEvents": ops})
    imp = load_trace_dir(str(tmp_path))
    assert [t.name for t in imp.graphs[0].tasks()] == ["aten::mm", "aten::add"]
    assert all(t.thread == DEVICE_STREAM for t in imp.graphs[0].tasks())


def test_malformed_torch_profiler_files_raise(tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.pt.trace.json").write_text("{not json")
    with pytest.raises(TraceImportError, match="not a readable"):
        load_trace_dir(str(bad))
    empty = tmp_path / "empty"
    empty.mkdir()
    _write(empty / "x.pt.trace.json", {"schemaVersion": 1, "traceEvents": []})
    with pytest.raises(TraceImportError, match="no complete"):
        load_trace_dir(str(empty))
    nokernel = tmp_path / "nokernel"
    nokernel.mkdir()
    _write(nokernel / "x.pt.trace.json", _torch_doc(
        [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
          "pid": 1, "tid": 1, "ts": 0, "dur": 4, "args": {"correlation": 1}}]))
    with pytest.raises(TraceImportError, match="CUPTI traced nothing"):
        load_trace_dir(str(nokernel))
    with pytest.raises(TraceImportError, match="no torch.profiler trace"):
        traceio.load_torch_profile(str(tmp_path / "nope"))
