"""repro_torch.faults against the JAX package's repro.faults.

First ``tests/test_faults.py`` run on the port (the checkpoint cases are in
``tests/test_torch_ckpt.py``), with its contracts:

* seeded fault timelines are reproducible (bit-identical reruns) and
  stable per worker stream (growing the cluster never reshuffles an
  existing worker's failure times);
* the renewal goodput engine is exact on hand-computable cases (quiet
  horizon, single mid-block failure) and deterministic end-to-end;
* the checkpoint-interval sweep's optimum agrees with the Young/Daly
  closed form on a golden case, and every value of
  ``tests/golden/faults.json`` is reproduced from ``repro_torch`` (read,
  not copied, and never rewritten here);
* fault policies route through the registry/stack/sweep surfaces
  (``ddp,elastic,ckpt_interval:steps=K`` parses, sweeps, and answers
  ``straggler_mitigation`` pay/no-pay both ways).

Then the same inputs through both packages, held ``==``: timelines,
``GoodputReport``s, ``FaultScenario.predict``/``sweep``/
``optimal_ckpt_interval`` on the demo scenario and on
``tests/torch_synthgraphs.py``'s step, and ``launch.goodput``'s JSON output
for the same argv.
"""

import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as ref_core  # noqa: E402
import repro.faults as ref_faults  # noqa: E402
import repro.launch.goodput as ref_goodput  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.faults as port_faults  # noqa: E402
import repro_torch.launch.goodput as port_goodput  # noqa: E402
import synthgraphs as ref_graphs  # noqa: E402
import torch_synthgraphs as port_graphs  # noqa: E402
from repro_torch.core import available, parse_stack  # noqa: E402
from repro_torch.core.optimize import OptimizationError, Scenario  # noqa: E402
from repro_torch.faults import (CkptInterval, FaultEvent, FaultScenario,  # noqa: E402
                                FaultTimeline, GoodputPrediction, RecoveryModel,
                                demo_scenario, exponential_failures,
                                format_goodput_table, preemption_windows,
                                simulate_goodput, transient_stragglers,
                                young_daly_interval, young_daly_steps)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "faults.json")


def quiet_recovery(**kw):
    """A RecoveryModel with simple numbers for hand computation."""
    base = dict(detection_s=10.0, restart_s=5.0, remesh_s=2.0,
                repair_s=100.0, spare_activation_s=3.0,
                checkpoint_bytes=0.0, ckpt_bandwidth=1e9,
                ckpt_latency_s=1.0)
    base.update(kw)
    return RecoveryModel(**base)


# ================================================================ events
class TestEvents:
    def test_seeded_timelines_are_reproducible(self):
        a = exponential_failures(8, 3600.0, 86400.0, seed=7)
        b = exponential_failures(8, 3600.0, 86400.0, seed=7)
        assert a == b
        assert a.events == b.events
        c = exponential_failures(8, 3600.0, 86400.0, seed=8)
        assert a.events != c.events

    def test_per_worker_streams_stable_under_growth(self):
        small = exponential_failures(4, 3600.0, 86400.0, seed=1)
        big = exponential_failures(8, 3600.0, 86400.0, seed=1)
        for w in range(4):
            small_w = [e.time for e in small.events if e.worker == w]
            big_w = [e.time for e in big.events if e.worker == w]
            assert small_w == big_w

    def test_preemption_windows_deterministic(self):
        tl = preemption_windows(1000.0, 100.0, 3600.0, offset_s=500.0,
                                workers=2)
        assert [e.time for e in tl.events] == [500.0, 1500.0, 2500.0,
                                               3500.0]
        assert all(e.duration == 100.0 and e.count == 2
                   for e in tl.events)

    def test_merge_sorts_and_keeps_horizon(self):
        a = FaultTimeline((FaultEvent(5.0, "fail", worker=1),), 100.0)
        b = FaultTimeline((FaultEvent(2.0, "straggler", duration=3.0,
                                      slowdown=2.0),), 50.0)
        m = a | b
        assert [e.time for e in m.events] == [2.0, 5.0]
        assert m.horizon_s == 100.0

    def test_validation(self):
        with pytest.raises(ValueError):
            FaultEvent(1.0, "explode")
        with pytest.raises(ValueError):
            FaultEvent(-1.0, "fail")
        with pytest.raises(ValueError):
            preemption_windows(10.0, 20.0, 100.0)


# ================================================================ engine
class TestGoodputEngine:
    def test_quiet_horizon_closed_form(self):
        # no faults: blocks of K steps + one ckpt write; exact count
        rec = quiet_recovery()            # ckpt write = 1.0s
        rep = simulate_goodput(
            n_workers=4, horizon_s=1000.0, timeline=FaultTimeline(),
            recovery=rec, ckpt_interval_steps=10, step_s=1.0)
        # block = 10*1 + 1 = 11s -> 90 blocks = 990s, then 10 more steps
        assert rep.useful_steps == 910
        assert rep.committed_steps == 900
        assert rep.failures == 0 and rep.lost_steps == 0
        assert rep.ckpt_s == pytest.approx(90.0)
        assert rep.useful_s == pytest.approx(910.0)

    def test_single_failure_rolls_back_to_last_commit(self):
        rec = quiet_recovery()            # downtime 10+100+1+5 = 116s
        tl = FaultTimeline((FaultEvent(25.0, "fail", worker=0),), 200.0)
        rep = simulate_goodput(
            n_workers=2, horizon_s=200.0, timeline=tl, recovery=rec,
            ckpt_interval_steps=10, step_s=1.0)
        # blocks (10 steps + 1s ckpt) commit at t=11 and t=22; at t=25 the
        # job is 3 steps into the third block.  Rollback loses those 3.
        assert rep.failures == 1
        assert rep.lost_steps == 3
        assert rep.lost_s == pytest.approx(3.0)
        # resumes at 25+116=141: 59s left -> 5 blocks (55s) + 4 steps
        assert rep.useful_steps == 20 + 54
        assert rep.committed_steps == 20 + 50
        assert rep.max_lost_steps_per_failure == 3

    def test_lost_work_bounded_by_interval(self):
        rec = quiet_recovery()
        tl = exponential_failures(8, 1800.0, 43200.0, seed=3)
        rep = simulate_goodput(
            n_workers=8, horizon_s=43200.0, timeline=tl, recovery=rec,
            ckpt_interval_steps=25, step_s=0.5)
        assert rep.failures > 10
        assert rep.max_lost_steps_per_failure <= 25
        assert rep.lost_steps <= rep.failures * 25

    def test_deterministic_bit_identical(self):
        rec = quiet_recovery()
        tl = exponential_failures(8, 3600.0, 86400.0, seed=11) | \
            transient_stragglers(2.0, 2.5, 300.0, 86400.0, seed=11)
        a = simulate_goodput(n_workers=8, horizon_s=86400.0, timeline=tl,
                             recovery=rec, ckpt_interval_steps=50,
                             step_s=0.25)
        b = simulate_goodput(n_workers=8, horizon_s=86400.0, timeline=tl,
                             recovery=rec, ckpt_interval_steps=50,
                             step_s=0.25)
        assert a == b

    def test_goodput_below_fault_free(self):
        rec = quiet_recovery()
        tl = exponential_failures(4, 7200.0, 86400.0, seed=5)
        rep = simulate_goodput(n_workers=4, horizon_s=86400.0, timeline=tl,
                               recovery=rec, ckpt_interval_steps=100,
                               step_s=1.0)
        assert 0.0 < rep.goodput_fraction <= 1.0

    def test_elastic_beats_halting_at_long_repair(self):
        rec = quiet_recovery(repair_s=1200.0)
        tl = exponential_failures(8, 7200.0, 43200.0, seed=2)
        halt = simulate_goodput(n_workers=8, horizon_s=43200.0, timeline=tl,
                                recovery=rec, ckpt_interval_steps=50,
                                step_s=lambda n: 8.0 / n)
        ela = simulate_goodput(n_workers=8, horizon_s=43200.0, timeline=tl,
                               recovery=rec, ckpt_interval_steps=50,
                               step_s=lambda n: 8.0 / n, elastic=True)
        assert ela.useful_steps > halt.useful_steps
        assert ela.availability > halt.availability

    def test_hot_spare_beats_cold_repair(self):
        rec = quiet_recovery(repair_s=1200.0)
        tl = exponential_failures(8, 7200.0, 43200.0, seed=2)
        cold = simulate_goodput(n_workers=8, horizon_s=43200.0, timeline=tl,
                                recovery=rec, ckpt_interval_steps=50,
                                step_s=1.0)
        spare = simulate_goodput(n_workers=8, horizon_s=43200.0,
                                 timeline=tl, recovery=rec,
                                 ckpt_interval_steps=50, step_s=1.0,
                                 hot_spares=2)
        assert spare.useful_steps > cold.useful_steps

    def test_preemption_graceful_no_lost_work(self):
        rec = quiet_recovery()
        tl = preemption_windows(600.0, 120.0, 3600.0, offset_s=300.0)
        rep = simulate_goodput(n_workers=4, horizon_s=3600.0, timeline=tl,
                               recovery=rec, ckpt_interval_steps=1000,
                               step_s=1.0)
        assert rep.preemptions == 6
        assert rep.lost_steps == 0 and rep.failures == 0
        assert rep.availability < 1.0

    def test_young_daly_crosscheck(self):
        # engine-level golden case: the simulated optimum agrees with the
        # closed form.  s=1.0s, c=10s, job MTBF 1h -> K* ~= 268 steps.
        rec = quiet_recovery(ckpt_latency_s=10.0, detection_s=30.0,
                             repair_s=60.0, restart_s=10.0)
        n, mtbf = 8, 8 * 3600.0            # job MTBF = 3600s
        horizon = 14 * 86400.0             # ~340 failures
        tl = exponential_failures(n, mtbf, horizon, seed=0)
        k_yd = young_daly_steps(rec.checkpoint_write_s, mtbf / n, 1.0)
        assert k_yd == pytest.approx(math.sqrt(2 * 10.0 * 3600.0), rel=0.01)
        best_k, best_useful, at_yd = None, -1, None
        for k in (34, 67, 134, 201, k_yd, 402, 536, 1072, 2144):
            rep = simulate_goodput(n_workers=n, horizon_s=horizon,
                                   timeline=tl, recovery=rec,
                                   ckpt_interval_steps=k, step_s=1.0)
            if rep.useful_steps > best_useful:
                best_k, best_useful = k, rep.useful_steps
            if k == k_yd:
                at_yd = rep.useful_steps
        # the sweep optimum lands within a factor 2 of Young/Daly and the
        # Young/Daly point is within 2% of the best swept goodput
        assert best_k is not None and k_yd / 2 <= best_k <= k_yd * 2
        assert at_yd >= 0.98 * best_useful

    def test_timeline_samples_consistent(self):
        rec = quiet_recovery()
        tl = exponential_failures(4, 3600.0, 14400.0, seed=9)
        rep = simulate_goodput(n_workers=4, horizon_s=14400.0, timeline=tl,
                               recovery=rec, ckpt_interval_steps=20,
                               step_s=1.0)
        # capacity starts at full N, dips to 0 during recovery
        assert rep.capacity_samples[0] == (0.0, 4)
        assert any(v == 0 for _, v in rep.capacity_samples)
        # progress is monotone non-decreasing
        vals = [v for _, v in rep.progress_samples]
        assert vals == sorted(vals)
        assert vals[-1] == rep.committed_steps

    def test_validation(self):
        rec = quiet_recovery()
        with pytest.raises(ValueError):
            simulate_goodput(n_workers=0, horizon_s=1.0,
                             timeline=FaultTimeline(), recovery=rec,
                             ckpt_interval_steps=1, step_s=1.0)
        with pytest.raises(ValueError):
            simulate_goodput(n_workers=1, horizon_s=1.0,
                             timeline=FaultTimeline(), recovery=rec,
                             ckpt_interval_steps=0, step_s=1.0)
        with pytest.raises(ValueError):
            simulate_goodput(n_workers=1, horizon_s=1.0,
                             timeline=FaultTimeline(), recovery=rec,
                             ckpt_interval_steps=1, step_s=-1.0)


# ============================================================== recovery
class TestRecoveryModel:
    def test_from_scenario_sizes_from_grad_bytes(self):
        scn = demo_scenario(workers=4, layers=8)
        rec = scn.recovery
        # 8 layers * 64 MB grads * 3x optimizer-state factor
        assert rec.checkpoint_bytes == pytest.approx(8 * 64e6 * 3.0)
        assert rec.ckpt_bandwidth == pytest.approx(scn.cost.hw.pcie_bandwidth)
        assert rec.restore_s > 0

    def test_from_scenario_params_tree(self):
        np = pytest.importorskip("numpy")
        scn = demo_scenario(workers=2)
        tree = {"w": np.zeros((1024, 1024), np.float32)}
        rec = RecoveryModel.from_scenario(scn, params_tree=tree)
        assert rec.checkpoint_bytes == 1024 * 1024 * 4

    def test_downtime_paths(self):
        rec = quiet_recovery()
        assert rec.downtime_s() == pytest.approx(10 + 100 + 1 + 5)
        assert rec.downtime_s(hot_spare=True) == pytest.approx(10 + 3 + 1 + 5)
        assert rec.downtime_s(elastic=True) == pytest.approx(10 + 1 + 5 + 2)


# ============================================================== scenario
class TestFaultScenario:
    def test_registry_round_trip(self):
        names = available()
        for n in ("ckpt_interval", "elastic", "hot_spare",
                  "straggler_mitigation"):
            assert n in names
        opt, overrides = parse_stack("ddp,elastic,ckpt_interval:steps=250")
        assert not overrides
        assert "ckpt_interval:steps=250" in opt.spec()

    def test_fault_opt_on_plain_scenario_raises(self):
        scn = demo_scenario(workers=4)
        plain = Scenario(graph=scn.graph, cost=scn.cost,
                         layer_grad_bytes=scn.layer_grad_bytes, workers=4)
        with pytest.raises(OptimizationError, match="FaultScenario"):
            plain.predict("ckpt_interval:steps=10")

    def test_predict_deterministic(self):
        scn = demo_scenario(workers=8, mtbf_s=4 * 3600.0,
                            horizon_s=43200.0, seed=5)
        a = scn.predict("ddp,ckpt_interval:steps=200")
        b = scn.predict("ddp,ckpt_interval:steps=200")
        assert a.report == b.report
        assert isinstance(a, GoodputPrediction)
        # fresh scenario, same seed: still identical
        scn2 = demo_scenario(workers=8, mtbf_s=4 * 3600.0,
                             horizon_s=43200.0, seed=5)
        c = scn2.predict("ddp,ckpt_interval:steps=200")
        assert c.report == a.report

    def test_goodput_fraction_below_one(self):
        scn = demo_scenario(workers=8, mtbf_s=4 * 3600.0,
                            horizon_s=43200.0, seed=5)
        p = scn.predict("ddp")
        assert 0.0 < p.goodput_fraction <= 1.0
        assert p.report.useful_steps > 0

    def test_elastic_and_spare_beat_baseline(self):
        scn = demo_scenario(workers=8, mtbf_s=3 * 3600.0,
                            horizon_s=43200.0, seed=1)
        base = scn.predict("ddp")
        ela = scn.predict("ddp,elastic")
        spare = scn.predict("ddp,hot_spare:count=2")
        assert ela.goodput > base.goodput
        assert spare.goodput > base.goodput

    def test_steady_cache_shared_across_policy_points(self):
        scn = demo_scenario(workers=8, mtbf_s=4 * 3600.0,
                            horizon_s=14400.0)
        scn.predict("ddp,ckpt_interval:steps=100")
        n_cached = len(scn._steady_cache)
        scn.predict("ddp,ckpt_interval:steps=400")
        scn.predict("ddp,hot_spare")
        assert len(scn._steady_cache) == n_cached  # no new steady builds

    def test_sweep_routes_stacked_params(self):
        scn = demo_scenario(workers=4, mtbf_s=4 * 3600.0,
                            horizon_s=14400.0)
        preds = scn.sweep("ddp,ckpt_interval", {"steps": [50, 200]})
        assert [p.point["steps"] for p in preds] == [50, 200]
        assert all(isinstance(p, GoodputPrediction) for p in preds)
        assert preds[0].policy.ckpt_interval_steps == 50

    def test_straggler_mitigation_pay_and_no_pay(self):
        heavy = demo_scenario(workers=8, mtbf_s=0.0, horizon_s=43200.0,
                              seed=3, straggler_rate_per_hour=6.0,
                              straggler_slowdown=3.0,
                              straggler_duration_s=600.0)
        assert heavy.predict("ddp,straggler_mitigation").goodput > \
            heavy.predict("ddp").goodput
        light = demo_scenario(workers=8, mtbf_s=0.0, horizon_s=43200.0,
                              seed=3, straggler_rate_per_hour=0.05,
                              straggler_slowdown=1.3,
                              straggler_duration_s=60.0)
        assert light.predict(
            "ddp,straggler_mitigation:overhead=0.05").goodput < \
            light.predict("ddp").goodput

    def test_optimal_interval_matches_young_daly(self):
        scn = demo_scenario(workers=16, mtbf_s=6 * 3600.0,
                            horizon_s=86400.0, seed=1)
        best, preds, k_yd = scn.optimal_ckpt_interval("ddp")
        best_k = best.policy.ckpt_interval_steps
        assert k_yd / 2 <= best_k <= k_yd * 2
        at_yd = next(p for p in preds
                     if p.policy.ckpt_interval_steps == k_yd)
        best_useful = max(p.report.useful_steps for p in preds)
        assert at_yd.report.useful_steps >= 0.98 * best_useful

    def test_surfaces_critical_path_and_timelines(self):
        scn = demo_scenario(workers=4, mtbf_s=6 * 3600.0,
                            horizon_s=14400.0)
        p = scn.predict("ddp")
        cp = p.critical_path
        assert cp.makespan == pytest.approx(p.steady_step_s)
        assert p.timelines is not None
        assert p.capacity_timeline.peak == 4
        # samples are sparse (event times + horizon); the final one at the
        # horizon carries the committed-step count.
        tl = p.progress_timeline
        assert tl.value_at(scn.horizon_s) == p.report.committed_steps
        assert tl.values == tuple(sorted(tl.values))  # monotone progress
        assert "steps/h" in format_goodput_table([p])

    def test_elastic_on_trace_route_raises(self, tmp_path):
        from repro_torch.traceio import write_synthetic_trace_dir
        d = str(tmp_path / "traces")
        write_synthetic_trace_dir(d, 2)
        scn = FaultScenario(trace_dir=d, mtbf_s=3600.0, horizon_s=7200.0)
        scn.predict("noop")  # non-elastic works
        with pytest.raises(OptimizationError, match="trace route"):
            scn.predict("elastic")

    def test_young_daly_helpers(self):
        assert young_daly_interval(10.0, 3600.0) == \
            pytest.approx(math.sqrt(2 * 10 * 3600))
        assert math.isinf(young_daly_interval(0.0, 3600.0))
        assert young_daly_steps(10.0, 3600.0, 1.0) == \
            round(math.sqrt(72000))


# ================================================================ golden
class TestGolden:
    def scenario(self):
        return demo_scenario(workers=16, mtbf_s=6 * 3600.0,
                             horizon_s=86400.0, seed=1)

    def compute(self):
        scn = self.scenario()
        out = {}
        for spec in ("ddp,ckpt_interval:steps=200",
                     "ddp,elastic,ckpt_interval:steps=200",
                     "ddp,hot_spare:count=2,ckpt_interval:steps=200"):
            r = scn.predict(spec).report
            out[spec] = {"useful_steps": r.useful_steps,
                         "failures": r.failures,
                         "lost_steps": r.lost_steps,
                         "goodput_steps_per_hour": r.goodput_steps_per_hour,
                         "availability": r.availability}
        return out

    def test_golden_goodput(self):
        got = self.compute()
        with open(GOLDEN) as f:
            want = json.load(f)
        assert set(got) == set(want)
        for spec, vals in want.items():
            for k, v in vals.items():
                assert got[spec][k] == pytest.approx(v, rel=1e-12), \
                    (spec, k)


# ======================================================= both packages
def _events(tl):
    return [dataclasses.astuple(e) for e in tl.events], tl.horizon_s


def _report(pred_or_report):
    r = getattr(pred_or_report, "report", pred_or_report)
    return dataclasses.asdict(r)


def _prediction(p):
    return (p.optimization.spec(), p.baseline, p.predicted, p.speedup,
            p.steady_step_s, dataclasses.asdict(p.policy), _report(p),
            dict(p.point))


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_timelines_equal_reference(seed):
    def timeline(pkg):
        return (pkg.exponential_failures(8, 3600.0, 86400.0, seed)
                | pkg.preemption_windows(7200.0, 300.0, 86400.0,
                                         offset_s=900.0, workers=2)
                | pkg.transient_stragglers(2.0, 2.5, 300.0, 86400.0, seed))
    assert _events(timeline(port_faults)) == _events(timeline(ref_faults))


@pytest.mark.parametrize("kw", [
    dict(ckpt_interval_steps=50, step_s=0.25),
    dict(ckpt_interval_steps=7, step_s=1.5, hot_spares=1),
    dict(ckpt_interval_steps=20, step_s=None, elastic=True, min_workers=3),
    dict(ckpt_interval_steps=30, step_s=0.5, straggler_mitigation=True,
         mitigation_overhead=0.05, mitigation_cap=1.5)])
def test_goodput_reports_equal_reference(kw):
    def run(pkg):
        rec = pkg.RecoveryModel(detection_s=10.0, restart_s=5.0, remesh_s=2.0,
                                repair_s=300.0, spare_activation_s=3.0,
                                checkpoint_bytes=4e9, ckpt_bandwidth=8e9,
                                ckpt_latency_s=0.7)
        tl = (pkg.exponential_failures(8, 3 * 3600.0, 43200.0, 5)
              | pkg.preemption_windows(5000.0, 200.0, 43200.0, offset_s=600.0)
              | pkg.transient_stragglers(1.5, 2.0, 240.0, 43200.0, 5))
        args = dict(kw)
        if args["step_s"] is None:
            args["step_s"] = lambda n: 8.0 / n
        return pkg.simulate_goodput(n_workers=8, horizon_s=43200.0, timeline=tl,
                                    recovery=rec, **args)
    assert _report(run(port_faults)) == _report(run(ref_faults))


SPECS = ("ddp", "ddp,ckpt_interval:steps=50", "ddp,elastic",
         "ddp,hot_spare:count=2,ckpt_interval:steps=200",
         "ddp,straggler_mitigation:overhead=0.03",
         "ddp,elastic:min_workers=6,ckpt_interval:steps=80", "amp,ddp")


@pytest.fixture(scope="module")
def demo_pair():
    kw = dict(workers=8, mtbf_s=3 * 3600.0, horizon_s=43200.0, seed=4,
              straggler_rate_per_hour=1.0, straggler_duration_s=300.0,
              preempt_period_s=9000.0, preempt_duration_s=400.0)
    return port_faults.demo_scenario(**kw), ref_faults.demo_scenario(**kw)


@pytest.mark.parametrize("spec", SPECS)
def test_demo_predictions_equal_reference(demo_pair, spec):
    port, ref = demo_pair
    p, r = port.predict(spec), ref.predict(spec)
    assert _prediction(p) == _prediction(r)
    assert p.progress_timeline.samples() == r.progress_timeline.samples()
    assert p.capacity_timeline.samples() == r.capacity_timeline.samples()
    assert p.critical_path.makespan == r.critical_path.makespan
    assert format_goodput_table([p]) == ref_faults.format_goodput_table([r])


def test_recovery_model_equals_reference(demo_pair):
    port, ref = demo_pair
    assert dataclasses.asdict(port.recovery) == dataclasses.asdict(ref.recovery)
    assert port.recovery.describe() == ref.recovery.describe()
    for kw in ({}, {"elastic": True}, {"hot_spare": True}):
        assert port.recovery.downtime_s(**kw) == ref.recovery.downtime_s(**kw)


def test_sweep_and_optimal_interval_equal_reference(demo_pair):
    port, ref = demo_pair
    grid = {"steps": [25, 100, 400]}
    assert ([_prediction(p) for p in port.sweep("ddp,ckpt_interval", grid)]
            == [_prediction(p) for p in ref.sweep("ddp,ckpt_interval", grid)])
    for opt in ("ddp", "ddp,elastic"):
        pb, pp, pk = port.optimal_ckpt_interval(opt)
        rb, rp, rk = ref.optimal_ckpt_interval(opt)
        assert pk == rk and _prediction(pb) == _prediction(rb)
        assert [_prediction(p) for p in pp] == [_prediction(p) for p in rp]


@pytest.mark.parametrize("workers,spec", [
    (1, "ckpt_interval:steps=20"), (4, "ddp,ckpt_interval:steps=20"),
    (4, "ddp,elastic,ckpt_interval:steps=20"), (6, "ddp,bandwidth:factor=2,hot_spare")])
def test_synthgraph_scenarios_equal_reference(workers, spec):
    """``tests/torch_synthgraphs.py``'s training step under a fault process,
    built and predicted in each package."""
    def scn(pkg, graphs):
        g = graphs.training_step_graph(layers=6)
        grads = {f"l{i}": 32e6 for i in range(6)}
        return pkg.FaultScenario(graph=g, layer_grad_bytes=grads,
                                 workers=workers, mtbf_s=2 * 3600.0,
                                 horizon_s=21600.0, seed=3)
    p = scn(port_faults, port_graphs).predict(spec)
    r = scn(ref_faults, ref_graphs).predict(spec)
    assert _prediction(p) == _prediction(r)


def test_explicit_timeline_equals_reference():
    """One fail-stop at a chosen time, as ``chip_smoke.py``'s drill
    predicts it: the progress curve's samples, each package's own."""
    def scn(pkg, graphs):
        rec = pkg.RecoveryModel(detection_s=0.0, restart_s=0.0, repair_s=0.0,
                                checkpoint_bytes=3.7e9, ckpt_bandwidth=2.1e9,
                                ckpt_latency_s=0.3)
        tl = pkg.FaultTimeline((pkg.FaultEvent(1.37, "fail"),), 3600.0)
        return pkg.FaultScenario(graph=graphs.training_step_graph(layers=4),
                                 recovery=rec, timeline=tl, horizon_s=3600.0,
                                 ckpt_interval_steps=4)
    port, ref = scn(port_faults, port_graphs), scn(ref_faults, ref_graphs)
    for spec in ("noop", "ckpt_interval:steps=2"):
        p, r = port.predict(spec), ref.predict(spec)
        assert _prediction(p) == _prediction(r)
        assert p.report.failures == 1


@pytest.mark.parametrize("argv", [
    ["--workers", "8", "--mtbf-hours", "3", "--horizon-s", "43200",
     "--what-if", "ddp,elastic", "--what-if", "ddp,hot_spare:count=2"],
    ["--workers", "4", "--layers", "4", "--mtbf-hours", "2", "--seed", "9",
     "--straggler-rate", "1", "--what-if", "ddp,straggler_mitigation",
     "--json"],
    ["--workers", "16", "--sweep-interval", "--preempt-period", "7200",
     "--preempt-duration", "300"]])
def test_goodput_cli_equals_reference(capsys, argv):
    assert port_goodput.main(argv) == 0
    port = capsys.readouterr()
    assert ref_goodput.main(argv) == 0
    ref = capsys.readouterr()
    assert port.out == ref.out and port.err == ref.err
    if "--json" in argv:
        assert json.loads(port.out) == json.loads(ref.out)
    else:
        assert "steps/h" in port.out


def test_fault_policies_land_in_each_package_s_own_registry():
    for name in ("ckpt_interval", "elastic", "hot_spare",
                 "straggler_mitigation"):
        assert port_core.get_optimization(name).__module__ == \
            "repro_torch.faults.scenario"
        assert ref_core.get_optimization(name).__module__ == \
            "repro.faults.scenario"
