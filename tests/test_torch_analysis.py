"""repro_torch.analysis against the JAX package's repro.analysis.

The first part is ``tests/test_analysis.py`` run on the port (its graphs
built by ``tests/torch_synthgraphs.py``), with its acceptance criteria:

* **Critical-path invariants**: the extracted path's segment durations
  (+gaps) sum to the makespan to float precision, on single-worker graphs
  and on cluster graphs in every collective mode; the chain is contiguous;
  the path's composition and attribution fractions on the seed graph are
  pinned by ``tests/golden/critical_path.json``, reproduced from
  ``repro_torch``.
* **Trace-diff round trip**: diffing a prediction against its *own*
  exported trace set reports ~zero error for every task, point-to-point
  pipeline hops included, and a perturbed capture surfaces exactly the
  perturbed task at the top of the mispredicted list.
* **Opportunity bounds**: for every registered (default-constructible)
  optimization on the seed scenario, the Amdahl bound through the real
  simulator is >= the realized speedup.

Then the same inputs through both packages, held ``==``: critical-path
segments and fractions, per-task diffs and per-kind WAPEs, and the
opportunity bounds of the whole registry.
"""

import json
import math
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.analysis as ref_analysis  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.traceio as ref_traceio  # noqa: E402
import repro_torch.analysis as port_analysis  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import synthgraphs as ref_graphs  # noqa: E402
import torch_synthgraphs as port_graphs  # noqa: E402
from repro_torch.core import (ClusterGraph, CostModel, Scenario, TaskKind,  # noqa: E402
                              WorkerSpec, simulate, simulate_reference, whatif)
from repro_torch.core.optimize import default_candidates  # noqa: E402
from repro_torch import traceio  # noqa: E402
from repro_torch.analysis import (TaskDiff, TraceDiff, cluster_critical_path,  # noqa: E402
                                  diff_cluster, diff_graph, extract_critical_path,
                                  format_opportunity_table, opportunity_bound,
                                  rank_opportunities, searchable_candidates)
from torch_synthgraphs import random_dag, training_step_graph  # noqa: E402

LAYERS = 6
GRADS = {f"l{i}": 30e6 for i in range(LAYERS)}
ACTS = {f"l{i}": 10e6 for i in range(LAYERS)}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "critical_path.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def seed_scenario(workers=4):
    return Scenario(training_step_graph(layers=LAYERS),
                    layer_grad_bytes=dict(GRADS),
                    activation_bytes=dict(ACTS), workers=workers)


# ============================================================ binding record
class TestBindingRecording:
    def test_disabled_by_default(self):
        assert simulate(training_step_graph()).binding is None

    def test_recording_does_not_change_the_timeline(self):
        g = training_step_graph(layers=LAYERS)
        plain = simulate(g)
        rec = simulate(g, record_binding=True)
        assert rec.makespan == plain.makespan
        assert rec.start == plain.start
        assert set(rec.binding) == set(rec.start)

    @pytest.mark.parametrize("seed", range(12))
    def test_chain_continuity_on_random_dags(self, seed):
        """Every bound task starts exactly when its binder completes;
        unbound tasks start at t=0 — the property that makes path sums
        exact."""
        g = random_dag(seed)
        for engine in (simulate, simulate_reference):
            res = engine(g, record_binding=True)
            for uid, b in res.binding.items():
                if b is None:
                    assert res.start[uid] == 0.0
                else:
                    assert res.finish[b] + g.get(b).gap == res.start[uid]

    def test_engines_agree_on_binding(self):
        g = training_step_graph(layers=LAYERS)
        assert simulate(g, record_binding=True).binding == \
            simulate_reference(g, record_binding=True).binding

    def test_cluster_simulate_passthrough(self):
        g = training_step_graph(layers=LAYERS)
        tf = whatif.what_if_distributed(g, GRADS, num_workers=4)
        cg = ClusterGraph.build(tf.graph, 4)
        assert cg.simulate().global_result.binding is None
        res = cg.simulate(record_binding=True)
        assert len(res.global_result.binding) == len(cg.graph)


# ============================================================= critical path
class TestCriticalPath:
    def test_segments_sum_to_makespan_single(self):
        g = training_step_graph(layers=LAYERS)
        cp = extract_critical_path(g)
        assert sum(cp.breakdown().values()) == \
            pytest.approx(cp.makespan, rel=1e-12)
        assert cp.makespan == pytest.approx(simulate(g).makespan, rel=1e-12)
        # contiguity: origin at 0, each segment starts at its binder's end
        assert cp.segments[0].start == 0.0
        for a, b in zip(cp.segments, cp.segments[1:]):
            assert b.start == pytest.approx(a.end, rel=1e-12)

    @pytest.mark.parametrize("mode,specs", [
        ("ring", 4),
        ("fused", 4),
        ("hierarchical", [WorkerSpec(pod=i // 2) for i in range(4)]),
    ])
    def test_segments_sum_to_makespan_cluster(self, mode, specs):
        g = training_step_graph(layers=LAYERS)
        tf = whatif.what_if_distributed(g, GRADS, num_workers=4)
        cg = ClusterGraph.build(tf.graph, specs, cost=CostModel(),
                                collective_mode=mode)
        res = cg.simulate(record_binding=True)
        cp = cluster_critical_path(cg, res)
        assert sum(cp.breakdown().values()) == \
            pytest.approx(res.makespan, rel=1e-12)
        assert set(cp.per_worker()) <= set(range(4)) | {None}

    def test_straggler_path_runs_through_the_slow_worker(self):
        g = training_step_graph(layers=LAYERS)
        tf = whatif.what_if_distributed(g, GRADS, num_workers=4)
        specs = [WorkerSpec(compute_scale=3.0 if i == 2 else 1.0)
                 for i in range(4)]
        cp = cluster_critical_path(ClusterGraph.build(tf.graph, specs))
        pw = cp.per_worker()
        assert max((w for w in pw if w is not None), key=lambda w: pw[w]) == 2

    def test_random_dags_sum_exact(self):
        for seed in range(8):
            g = random_dag(seed)
            cp = extract_critical_path(g)
            assert sum(cp.breakdown().values()) == \
                pytest.approx(cp.makespan, rel=1e-12)

    def test_extract_resimulates_without_recording(self):
        g = training_step_graph(layers=LAYERS)
        res = simulate(g)                      # no binding recorded
        cp = extract_critical_path(g, res)
        assert cp.makespan == pytest.approx(res.makespan, rel=1e-12)

    def test_golden_composition(self, golden):
        """Path composition + attribution fractions on the seed graph —
        re-freeze tests/golden/critical_path.json via the commands in the
        file when an intentional engine/model change moves them."""
        want = golden["single"]
        cp = extract_critical_path(training_step_graph(layers=LAYERS))
        assert cp.makespan == pytest.approx(want["makespan_s"],
                                            rel=want["rtol"])
        assert len(cp.segments) == want["segments"]
        for cat, frac in want["fractions"].items():
            assert cp.fractions()[cat] == pytest.approx(
                frac, rel=want["rtol"], abs=1e-12)

    def test_golden_cluster_composition(self, golden):
        want = golden["cluster_ring"]
        g = training_step_graph(layers=LAYERS)
        tf = whatif.what_if_distributed(g, GRADS,
                                        num_workers=golden["workers"])
        cg = ClusterGraph.build(tf.graph, golden["workers"],
                                cost=CostModel())
        cp = cluster_critical_path(cg)
        assert cp.makespan == pytest.approx(want["makespan_s"],
                                            rel=want["rtol"])
        for cat, frac in want["fractions"].items():
            assert cp.fractions()[cat] == pytest.approx(
                frac, rel=want["rtol"], abs=1e-12)

    def test_format_smoke(self):
        txt = extract_critical_path(training_step_graph()).format()
        assert "critical path" in txt and "compute" in txt


# ================================================================== diffing
class TestTraceDiff:
    def _exported_cluster(self, tmp_path, mode="ring"):
        g = training_step_graph(layers=LAYERS)
        tf = whatif.what_if_distributed(g, GRADS, num_workers=4)
        cost = CostModel()
        cg = ClusterGraph.build(tf.graph, 4, cost=cost,
                                collective_mode=mode)
        res = cg.simulate()
        traceio.export_cluster_traces(cg, res, str(tmp_path))
        return cg, res

    def test_self_diff_reports_zero_error(self, tmp_path):
        cg, res = self._exported_cluster(tmp_path)
        diff = diff_cluster(cg, res, str(tmp_path))
        assert not diff.unmatched_predicted and not diff.unmatched_captured
        assert diff.max_abs_error() <= 1e-9
        assert diff.makespan_rel_error == pytest.approx(0.0, abs=1e-9)
        assert all(st.wape <= 1e-9 for st in diff.per_kind().values())

    def test_self_diff_includes_pipeline_p2p_hops(self, tmp_path):
        """p2p hop legs must match leg-for-leg (exported provenance) and
        report zero error — the PR-4 caveat closed."""
        scn = seed_scenario(workers=1)
        pred, tf, cg = scn.evaluate(
            "pipeline:stages=2,microbatches=4")
        traceio.export_cluster_traces(cg, pred.cluster, str(tmp_path))
        diff = diff_cluster(cg, pred.cluster, str(tmp_path))
        hops = [d for d in diff.tasks if d.kind == TaskKind.COMM.value]
        assert hops, "pipeline placement exported no hop legs"
        assert not diff.unmatched_predicted and not diff.unmatched_captured
        assert diff.max_abs_error() <= 1e-9

    def test_perturbed_capture_tops_the_mispredicted_list(self, tmp_path):
        cg, res = self._exported_cluster(tmp_path)
        # stretch one compute task in worker 2's captured trace by 2x
        path = os.path.join(str(tmp_path), "worker2.trace.json")
        with open(path) as f:
            data = json.load(f)
        victim = next(ev for ev in data["traceEvents"]
                      if ev.get("ph") == "X" and ev["name"] == "bwd:l3")
        delta_us = victim["dur"]
        victim["dur"] *= 2.0
        with open(path, "w") as f:
            json.dump(data, f)
        diff = diff_cluster(cg, res, str(tmp_path))
        top = diff.top_mispredicted(1)[0]
        assert top.name == "bwd:l3" and top.worker == 2
        assert abs(top.dur_error) == pytest.approx(delta_us / 1e6, rel=1e-9)
        assert diff.per_kind()["compute"].max_abs_err_s == \
            pytest.approx(delta_us / 1e6, rel=1e-9)

    def test_single_graph_diff(self, tmp_path):
        g = training_step_graph(layers=LAYERS)
        res = simulate(g)
        path = str(tmp_path / "step.trace.json")
        traceio.export_graph_trace(g, res, path)
        diff = diff_graph(g, res, path)
        assert not diff.unmatched_predicted and not diff.unmatched_captured
        assert diff.max_abs_error() <= 1e-9

    def test_worker_count_mismatch_raises(self, tmp_path):
        cg, res = self._exported_cluster(tmp_path)
        os.remove(os.path.join(str(tmp_path), "worker3.trace.json"))
        with pytest.raises(ValueError, match="worker"):
            diff_cluster(cg, res, str(tmp_path))

    def test_scenario_diff_against(self, tmp_path):
        """The API surface: a trace scenario diffs its own (noop)
        prediction against the capture it was built from with ~zero
        duration error (uniform synthetic capture == analytical model)."""
        traceio.write_synthetic_trace_dir(str(tmp_path), 4, layers=LAYERS)
        scn = Scenario(trace_dir=str(tmp_path))
        diff = scn.diff_against(str(tmp_path))
        assert not diff.unmatched_predicted and not diff.unmatched_captured
        assert diff.makespan_rel_error == pytest.approx(0.0, abs=1e-6)
        assert diff.max_abs_error() <= 1e-6
        assert "predicted vs captured" in diff.format()

    def test_zero_duration_kind_renders_na(self):
        """Satellite bugfix: a kind whose captured durations are all zero
        makes WAPE (and a zero captured makespan makes the relative
        makespan error) ``inf`` — the report must render ``n/a``, not a
        garbled ``inf%``, and the top-K ranking must stay finite."""
        def td(name, kind, pred_dur, cap_dur):
            return TaskDiff(worker=0, thread="device", name=name,
                            occurrence=0, kind=kind,
                            predicted_start=0.0, predicted_dur=pred_dur,
                            captured_start=0.0, captured_dur=cap_dur)
        diff = TraceDiff(
            tasks=[td("marker", "host", 1e-3, 0.0),       # wape -> inf
                   td("mm", "compute", 2e-3, 1e-3)],
            unmatched_predicted=[], unmatched_captured=[],
            predicted_makespan=3e-3, captured_makespan=0.0)
        assert math.isinf(diff.per_kind()["host"].wape)
        assert math.isinf(diff.makespan_rel_error)
        out = diff.format()
        assert "n/a" in out
        assert "inf" not in out and "nan" not in out
        # finite rows still render as percentages
        assert "100.00%" in out
        # the ranking is by finite |error| only
        assert all(math.isfinite(d.abs_error)
                   for d in diff.top_mispredicted(10))

    def test_all_zero_capture_stays_renderable(self):
        """Degenerate but reachable: every captured duration zero."""
        diff = TraceDiff(
            tasks=[TaskDiff(worker=0, thread="device", name="x",
                            occurrence=0, kind="compute",
                            predicted_start=0.0, predicted_dur=1e-3,
                            captured_start=0.0, captured_dur=0.0)],
            unmatched_predicted=[], unmatched_captured=[],
            predicted_makespan=1e-3, captured_makespan=0.0)
        out = diff.format()
        assert "inf" not in out
        assert out.count("n/a") >= 2          # makespan line + kind row


# ======================================================= p2p hop round trip
class TestP2PRoundTrip:
    def test_pipeline_hops_survive_reimport(self, tmp_path):
        """The PR-4 export caveat, closed: a pipeline placement's exported
        per-worker traces re-import through ClusterGraph.from_traces with
        the cross-stage hops re-wired, reproducing the predicted makespan."""
        scn = seed_scenario(workers=1)
        pred, tf, cg = scn.evaluate(
            "pipeline:stages=2,microbatches=4")
        traceio.export_cluster_traces(cg, pred.cluster, str(tmp_path))
        re = ClusterGraph.from_traces(str(tmp_path),
                                      cost=scn.cost).simulate()
        assert re.makespan == pytest.approx(pred.predicted, rel=1e-9)
        # the re-imported hops regained their cross-worker coupling
        wired = [t for t in ClusterGraph.from_traces(
            str(tmp_path), cost=scn.cost).graph.tasks()
            if t.kind == TaskKind.COMM and "p2p_gid" in t.attrs]
        assert wired

    def test_exported_hops_carry_provenance(self, tmp_path):
        scn = seed_scenario(workers=1)
        pred, tf, cg = scn.evaluate("pipeline:stages=2,microbatches=2")
        paths = traceio.export_cluster_traces(cg, pred.cluster,
                                              str(tmp_path))
        with open(paths[0]) as f:
            evs = json.load(f)["traceEvents"]
        hops = [ev for ev in evs if ev.get("ph") == "X"
                and ev.get("args", {}).get("p2p")]
        assert hops, "hop legs exported without args.p2p provenance"
        for ev in hops:
            assert "p2p_gid" in ev["args"]
            src, dst = ev["args"]["p2p"]
            assert (src, dst) == (0, 1)

    def test_hybrid_dp_ring_roundtrip(self, tmp_path):
        """Hybrid PP x DP: per-stage gradient rings live on a worker
        *subset*, which (name, occurrence) matching cannot re-import —
        gid-based matching wires them back over exactly their stage's
        workers, and the collapsed export carries the true group payload
        (not the cluster-wide inflation)."""
        scn = seed_scenario(workers=1)
        pred, tf, cg = scn.evaluate(
            "pipeline:stages=2,microbatches=2,dp=2")
        paths = traceio.export_cluster_traces(cg, pred.cluster,
                                              str(tmp_path))
        with open(paths[0]) as f:
            evs = json.load(f)["traceEvents"]
        ring = next(ev for ev in evs if ev.get("ph") == "X"
                    and ev.get("args", {}).get("collective") == "all-reduce")
        assert ring["args"]["group_size"] == 2      # the stage's dp ring
        assert ring["args"]["comm_bytes"] == pytest.approx(
            sum(GRADS.values()) / 2)                # per-stage grads
        re = ClusterGraph.from_traces(str(tmp_path),
                                      cost=scn.cost).simulate()
        assert re.makespan == pytest.approx(pred.predicted, rel=1e-9)

    def test_double_roundtrip_is_stable(self, tmp_path):
        """export -> import -> export -> import keeps the makespan and
        does not grow provenance lists or collide gids."""
        scn = seed_scenario(workers=1)
        pred, tf, cg = scn.evaluate("pipeline:stages=2,microbatches=3")
        d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
        traceio.export_cluster_traces(cg, pred.cluster, d1)
        cg2 = ClusterGraph.from_traces(d1, cost=scn.cost)
        res2 = cg2.simulate()
        traceio.export_cluster_traces(cg2, res2, d2)
        cg3 = ClusterGraph.from_traces(d2, cost=scn.cost)
        assert cg3.simulate().makespan == pytest.approx(pred.predicted,
                                                        rel=1e-9)
        for t in cg3.graph.tasks():
            assert len(t.attrs.get("p2p_in", ())) <= 1

    def test_stale_gid_cannot_collide_with_fresh_wiring(self, tmp_path):
        """An unmatched imported hop (receiver stripped from the capture)
        keeps its stale gid as a plain local event; freshly wired gids are
        seeded above every imported gid, so no two legs share one."""
        scn = seed_scenario(workers=1)
        pred, tf, cg = scn.evaluate("pipeline:stages=3,microbatches=2")
        traceio.export_cluster_traces(cg, pred.cluster, str(tmp_path))
        # strip one receiver's p2p_in so its hop cannot re-match
        path = os.path.join(str(tmp_path), "worker1.trace.json")
        with open(path) as f:
            data = json.load(f)
        victim = next(ev for ev in data["traceEvents"]
                      if ev.get("ph") == "X"
                      and ev.get("args", {}).get("p2p_in"))
        stale = victim["args"].pop("p2p_in")
        with open(path, "w") as f:
            json.dump(data, f)
        cg2 = ClusterGraph.from_traces(str(tmp_path), cost=scn.cost)
        gids = [t.attrs["p2p_gid"] for t in cg2.graph.tasks()
                if "p2p_gid" in t.attrs]
        assert len(gids) == len(set(gids)), "colliding p2p gids"
        # the stale leg stayed a plain local event (old behavior), the
        # rest re-wired
        wired = [t for t in cg2.graph.tasks()
                 if t.attrs.get("p2p_gid") not in stale
                 and "p2p_gid" in t.attrs and t.attrs["p2p_gid"] > max(
                     stale)]
        assert wired

    def test_replicate_equivalence_unaffected(self, tmp_path):
        """No p2p in a DDP export: re-import must still match the build
        path exactly (regression guard for the new wiring pass)."""
        g = training_step_graph(layers=LAYERS)
        tf = whatif.what_if_distributed(g, GRADS, num_workers=3)
        cost = CostModel()
        cg = ClusterGraph.build(tf.graph, 3, cost=cost)
        res = cg.simulate()
        traceio.export_cluster_traces(cg, res, str(tmp_path))
        re = ClusterGraph.from_traces(str(tmp_path), cost=cost).simulate()
        assert re.makespan == pytest.approx(res.makespan, rel=1e-9)


# ========================================================= opportunity rank
class TestOpportunity:
    def test_bounds_dominate_realized_for_whole_registry(self):
        """Acceptance: bound >= realized speedup for every
        registered (default-constructible) optimization on the seed
        scenario."""
        scn = seed_scenario(workers=4)
        opps = rank_opportunities(scn, realize=True)
        assert opps, "no candidates ranked"
        checked = 0
        for o in opps:
            if o.realized is None or math.isinf(o.bound):
                continue
            assert o.bound >= o.realized - 1e-9, (
                f"{o.optimization.spec()}: bound {o.bound} < realized "
                f"{o.realized}")
            checked += 1
        assert checked >= 8     # the registry's default-constructible core

    def test_bounds_golden(self, golden):
        scn = seed_scenario(workers=golden["workers"])
        for name, want in golden["opportunity_bounds"].items():
            if name == "rtol":
                continue
            got = opportunity_bound(scn, next(
                c for c in default_candidates(scn) if c.name == name))
            assert got == pytest.approx(want, rel=golden[
                "opportunity_bounds"]["rtol"]), (
                f"{name}: bound {got} vs golden {want} — re-freeze "
                f"tests/golden/critical_path.json if intentional")

    def test_insertion_only_candidates_bound_at_one(self):
        scn = seed_scenario(workers=4)
        by_name = {c.name: c for c in default_candidates(scn)}
        for name in ("ddp", "noop", "straggler", "grad_accum"):
            assert opportunity_bound(scn, by_name[name]) == \
                pytest.approx(1.0)

    def test_pipeline_is_unbounded(self):
        scn = seed_scenario(workers=4)
        by_name = {c.name: c for c in default_candidates(scn)}
        assert math.isinf(opportunity_bound(scn, by_name["pipeline"]))

    def test_ranking_sorted_and_searchable_filtered(self):
        scn = seed_scenario(workers=4)
        opps = rank_opportunities(scn)
        bounds = [o.bound for o in opps]
        assert bounds == sorted(bounds, reverse=True)
        kept = searchable_candidates(opps)
        assert all(not o.skipped or o.optimization not in kept
                   for o in opps)
        assert any(o.optimization.name == "amp" for o in opps)
        txt = format_opportunity_table(opps)
        assert "amp" in txt and "bound" in txt

    def test_stack_headroom_is_member_union(self):
        from repro_torch.core.optimize import Stack
        scn = seed_scenario(workers=1)
        by_name = {c.name: c for c in default_candidates(scn)}
        amp_bound = opportunity_bound(scn, by_name["amp"])
        stacked = opportunity_bound(
            scn, Stack(by_name["amp"], by_name["fused_optimizer"]))
        assert stacked >= amp_bound - 1e-9
        # a stack containing an unbounded member is unbounded
        assert math.isinf(opportunity_bound(
            scn, Stack(by_name["amp"], by_name["pipeline"])))

    def test_prediction_critical_path_property(self):
        scn = seed_scenario(workers=4)
        pred = scn.predict("amp")
        cp = pred.critical_path
        assert cp is pred.critical_path          # cached
        assert sum(cp.breakdown().values()) == \
            pytest.approx(pred.predicted, rel=1e-12)

    def test_stale_results_refused_everywhere(self, tmp_path):
        """Every diagnosis surface refuses a result whose graph was
        retuned afterwards (sweep reuse shares one build) — silently
        mixing two points' timelines is the failure mode."""
        from repro_torch.core.optimize import uniform_bandwidth_specs
        from repro_torch.analysis import extract_critical_path
        scn = Scenario(training_step_graph(layers=LAYERS),
                       layer_grad_bytes=dict(GRADS),
                       workers=[WorkerSpec() for _ in range(4)])
        pred, tf, cg = scn.evaluate("ddp")
        rec = cg.simulate(record_binding=True)
        _ = rec.global_result.binding          # materialize pre-retune
        cg.retune(uniform_bandwidth_specs(4, [0.25])[0])
        with pytest.raises(RuntimeError, match="retuned"):
            cluster_critical_path(cg, pred.cluster)     # re-derive path
        with pytest.raises(RuntimeError, match="discontiguous"):
            cluster_critical_path(cg, rec)              # recorded path
        with pytest.raises(ValueError, match="stale"):
            traceio.predicted_worker_events(cg, pred.cluster)
        fresh = cg.simulate(record_binding=True)
        assert sum(cluster_critical_path(cg, fresh).breakdown().values()) \
            == pytest.approx(fresh.makespan, rel=1e-12)

    def test_stale_sweep_prediction_refuses_critical_path(self):
        """Sweep points share one retuned-in-place build: an earlier
        point's critical_path must raise instead of silently reporting a
        later point's timeline (the last point still diagnoses fine)."""
        from repro_torch.core.optimize import OptimizationError, \
            uniform_bandwidth_specs
        scn = seed_scenario(workers=4)
        preds = scn.sweep("ddp",
                          {"workers": uniform_bandwidth_specs(
                              4, [1.0, 0.5, 0.25])})
        last = preds[-1].critical_path
        assert sum(last.breakdown().values()) == \
            pytest.approx(preds[-1].predicted, rel=1e-12)
        with pytest.raises(OptimizationError, match="retuned"):
            _ = preds[0].critical_path

    def test_greedy_search_round1_seed_matches_unseeded(self):
        from repro_torch.core.optimize import greedy_search
        scn = seed_scenario(workers=1)
        opps = rank_opportunities(scn, realize=True)
        kept = searchable_candidates(opps)
        round1 = {id(o.optimization): o.prediction
                  for o in opps if o.prediction is not None}
        best_a, trail_a = greedy_search(scn, max_depth=2, candidates=kept,
                                        round1=round1)
        best_b, trail_b = greedy_search(scn, max_depth=2, candidates=kept)
        assert [p.predicted for p in trail_a] == \
            [p.predicted for p in trail_b]
        assert (best_a is None) == (best_b is None)
        if best_a is not None:
            assert best_a.spec() == best_b.spec()


# ======================================================= both packages, ==
REF = SimpleNamespace(core=ref_core, traceio=ref_traceio, analysis=ref_analysis,
                      graphs=ref_graphs)
PORT = SimpleNamespace(core=port_core, traceio=traceio, analysis=port_analysis,
                       graphs=port_graphs)


def both(case):
    """``case(ns)`` through the reference and the port: equal results."""
    want, got = case(REF), case(PORT)
    assert got == want
    return got


def _segments(cp):
    return [(s.name, s.thread, s.category, s.start, s.duration, s.gap)
            for s in cp.segments], cp.makespan, cp.fractions(), cp.per_worker()


@pytest.mark.parametrize("graph", ["training_step"] + [f"random_dag_{s}" for s in range(4)])
def test_critical_path_equals_the_reference(graph):
    def case(ns):
        g = (ns.graphs.training_step_graph(layers=LAYERS) if graph == "training_step"
             else ns.graphs.random_dag(int(graph.rsplit("_", 1)[1])))
        return _segments(ns.analysis.extract_critical_path(g))
    both(case)


@pytest.mark.parametrize("mode", ["ring", "fused", "hierarchical"])
def test_cluster_critical_path_equals_the_reference(mode):
    def case(ns):
        g = ns.graphs.training_step_graph(layers=LAYERS)
        tf = ns.core.whatif.what_if_distributed(g, GRADS, num_workers=4)
        specs = [ns.core.WorkerSpec(pod=i // 2, compute_scale=1.5 if i == 1 else 1.0)
                 for i in range(4)]
        cg = ns.core.ClusterGraph.build(tf.graph, specs, cost=ns.core.CostModel(),
                                        collective_mode=mode)
        return _segments(ns.analysis.cluster_critical_path(cg))
    both(case)


def test_prediction_critical_path_equals_the_reference():
    """``Prediction.critical_path``, which raised ModuleNotFoundError in
    the port before ``repro_torch.analysis`` existed."""
    def case(ns):
        scn = ns.core.Scenario(ns.graphs.training_step_graph(layers=2))
        return _segments(scn.predict("noop").critical_path)
    both(case)


def _diff_key(d):
    return ([(t.worker, t.thread, t.name, t.occurrence, t.kind, t.predicted_start,
              t.predicted_dur, t.captured_start, t.captured_dur) for t in d.tasks],
            d.unmatched_predicted, d.unmatched_captured, d.predicted_makespan,
            d.captured_makespan, {k: (s.count, s.wape, s.max_abs_err_s)
                                  for k, s in d.per_kind().items()},
            d.format(top=5))


@pytest.mark.parametrize("opt", ["noop", "fused_optimizer", "amp"])
def test_diff_against_a_perturbed_capture_equals_the_reference(tmp_path, opt):
    """Each package's trace route on a clean 4-worker capture, with ``opt``
    applied, diffed against a capture with one straggling worker (both
    written by that package): the same task diffs and WAPEs."""
    def case(ns):
        d = tmp_path / ("ref" if ns is REF else "port")
        for name, scales in (("clean", None), ("straggler", [1.0, 1.0, 1.7, 1.0])):
            ns.traceio.write_synthetic_trace_dir(str(d / name), 4, layers=4,
                                                 cost=ns.core.CostModel(),
                                                 compute_scales=scales)
        scn = ns.core.Scenario(trace_dir=str(d / "clean"))
        return _diff_key(scn.diff_against(str(d / "straggler"), opt))
    both(case)


def test_single_graph_diff_equals_the_reference(tmp_path):
    def case(ns):
        g = ns.graphs.training_step_graph(layers=LAYERS)
        path = str(tmp_path / ("ref" if ns is REF else "port")) + ".trace.json"
        ns.traceio.export_graph_trace(g, ns.core.simulate(g), path)
        slow = ns.graphs.training_step_graph(layers=LAYERS, bwd=5e-3)
        return _diff_key(ns.analysis.diff_graph(slow, ns.core.simulate(slow), path))
    both(case)


def test_opportunity_bounds_equal_the_reference():
    """The registry's own what-ifs (``repro.serving`` and ``repro.faults``
    add theirs to the reference's registry when another test imports
    them)."""
    def case(ns):
        scn = ns.core.Scenario(ns.graphs.training_step_graph(layers=LAYERS),
                               layer_grad_bytes=dict(GRADS),
                               activation_bytes=dict(ACTS), workers=4)
        own = [c for c in ns.core.optimize.default_candidates(scn)
               if type(c).__module__ == ns.core.optimize.__name__]
        opps = ns.analysis.rank_opportunities(scn, own, realize=True)
        return [(o.optimization.name, o.bound, o.cp_share, o.realized, o.error)
                for o in opps], ns.analysis.format_opportunity_table(opps)
    both(case)
