"""repro_torch.serving against the JAX package's repro.serving.

The first part is ``tests/test_serving.py`` run on the port (its graphs
built by ``tests/torch_synthgraphs.py``), with its contracts:

* static-batch drain-time invariant: one full batch at t=0 simulates to
  ``sum(prefill_i) + budget * decode_step`` to float precision, and the
  exported serving trace self-diffs to ~zero error;
* seed determinism: same seed -> bit-identical ServingPrediction metrics;
* continuous batching beats static slots at saturating rate (>1x goodput),
  with the headroom bound covering the realized speedup, every value of
  ``tests/golden/serving.json`` reproduced from ``repro_torch``;
* stacks compose through the registry and ``critical_path`` diagnosis
  works unchanged on serving graphs.

Then the same inputs through both packages, held ``==``: workloads, the
generated graphs per policy, the predictions of every registered serving
optimization (``tp:degree=8`` through the cluster route), the analytic
cost models of the three ported archs on the reference's TPU spec; and the
timing harness: the fit's one divergence from the reference (ROADMAP C7)
shown with fixed times, and a run end to end on the CPU at smoke size.
"""

import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.configs as ref_configs  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
import repro.serving.measure as ref_measure  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.serving as port_serving  # noqa: E402
import repro_torch.serving.measure as port_measure  # noqa: E402
from repro_torch.analysis import diff_graph  # noqa: E402
from repro_torch.analysis.opportunity import opportunity_bound  # noqa: E402
from repro_torch.configs import ARCHS, serving_cost  # noqa: E402
from repro_torch.core import available, get_optimization, parse_stack  # noqa: E402
from repro_torch.serving import (ContinuousBatching, ServingCostModel,  # noqa: E402
                                 ServingPolicy, ServingPrediction,
                                 ServingScenario, build_serving_graph,
                                 explicit_workload, format_serving_table,
                                 poisson_workload, scale_arrivals, slot_lane,
                                 trace_workload)

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "serving.json")

COST = ServingCostModel()
SERVING_OPTS = ("continuous_batching", "static_slots", "chunked_prefill",
                "tp", "kv_offload")


@pytest.fixture(scope="module")
def golden():
    with open(_GOLDEN) as f:
        return json.load(f)


def _check(golden, key, value):
    want = golden[key]["value"]
    assert value == pytest.approx(want, rel=golden[key]["rtol"]), (
        f"{key}: got {value!r}, golden {want!r}")


def saturating_scenario(golden, pkg=port_serving) -> ServingScenario:
    p = golden["saturating_workload"]
    wl = pkg.poisson_workload(p["rate"], p["duration"], seed=p["seed"],
                              prompt_mean=p["prompt_mean"],
                              prompt_sigma=p["prompt_sigma"],
                              output_mean=p["output_mean"],
                              output_sigma=p["output_sigma"])
    return pkg.ServingScenario(workload=wl,
                               policy=pkg.ServingPolicy(mode="static",
                                                        slots=p["slots"]),
                               serving_cost=pkg.ServingCostModel())


# ------------------------------------------------------------- invariants
class TestStaticDrainInvariant:
    def test_single_full_batch_drain_time(self):
        """Simulated makespan of one full batch arriving at t=0 equals the
        analytic prefill + budget*decode_step drain time to float
        precision (see repro_torch.serving.graphgen's docstring)."""
        slots, prompt, budget = 4, 100, 16
        wl = explicit_workload([(0.0, prompt, budget)] * slots)
        scn = ServingScenario(
            workload=wl, policy=ServingPolicy(mode="static", slots=slots),
            serving_cost=COST)
        kv = slots * (prompt + budget)
        analytic = slots * COST.prefill_time(prompt) \
            + budget * COST.decode_step_time(slots, kv)
        assert scn.baseline().makespan == pytest.approx(analytic, rel=1e-12)

    def test_uneven_budgets_drain_to_max(self):
        """Finished slots idle until the batch drains (the engine's
        semantics): the drain time is set by the max member budget."""
        wl = explicit_workload([(0.0, 50, 4), (0.0, 50, 12)])
        scn = ServingScenario(
            workload=wl, policy=ServingPolicy(mode="static", slots=2),
            serving_cost=COST)
        kv = 2 * 50 + 4 + 12
        analytic = 2 * COST.prefill_time(50) \
            + 12 * COST.decode_step_time(2, kv)
        assert scn.baseline().makespan == pytest.approx(analytic, rel=1e-12)

    def test_self_diff_is_zero(self, tmp_path):
        """Exporting the predicted serving timeline and diffing the graph
        against its own export round-trips with ~zero error."""
        from repro_torch import traceio
        sg = build_serving_graph(
            poisson_workload(100, 0.2, seed=3, prompt_mean=32,
                             output_mean=8),
            COST, ServingPolicy(mode="continuous", slots=4))
        res = port_core.simulate(sg.graph)
        path = str(tmp_path / "serving.trace.json")
        traceio.export_graph_trace(sg.graph, res, path)
        diff = diff_graph(sg.graph, res, path)
        assert not diff.unmatched_predicted and not diff.unmatched_captured
        assert diff.max_abs_error() <= 1e-9
        assert abs(diff.makespan_rel_error) <= 1e-9


class TestDeterminism:
    def test_same_seed_bit_identical_prediction(self, golden):
        a = saturating_scenario(golden).predict("continuous_batching")
        b = saturating_scenario(golden).predict("continuous_batching")
        assert a.predicted == b.predicted
        assert (a.ttft_p50, a.ttft_p99, a.tpot_p50, a.tpot_p99,
                a.latency_p50, a.latency_p99, a.goodput) == \
               (b.ttft_p50, b.ttft_p99, b.tpot_p50, b.tpot_p99,
                b.latency_p50, b.latency_p99, b.goodput)
        assert a.lane_util == b.lane_util

    def test_different_seed_differs(self):
        w1 = poisson_workload(100, 0.5, seed=0)
        w2 = poisson_workload(100, 0.5, seed=1)
        assert [r.arrival for r in w1.requests] != \
               [r.arrival for r in w2.requests]


# ------------------------------------------------------------ what-ifs
class TestWhatIfs:
    def test_continuous_beats_static_at_saturation(self, golden):
        """Continuous batching >1x predicted goodput over static slots at
        saturating rate, bound >= realized; the golden's three values."""
        scn = saturating_scenario(golden)
        noop = scn.predict("noop")
        cb = scn.predict("continuous_batching")
        assert isinstance(cb, ServingPrediction)
        assert cb.goodput > noop.goodput
        assert cb.speedup > 1.0
        bound = opportunity_bound(scn, ContinuousBatching())
        assert bound >= cb.speedup
        _check(golden, "cb_vs_static_goodput", cb.goodput / noop.goodput)
        _check(golden, "cb_speedup", cb.speedup)
        _check(golden, "cb_headroom_bound", bound)

    def test_chunked_prefill_ttft_win(self, golden):
        """Short interactive requests stuck behind huge prompts: chunking
        the prefill removes the stall and improves TTFT p50/p99."""
        specs, t = [], 0.0
        for i in range(60):
            t += 0.002
            specs.append((t, 4096, 8) if i % 15 == 7 else (t, 32, 16))
        wl = explicit_workload(specs, duration=t)
        scn = ServingScenario(
            workload=wl, policy=ServingPolicy(mode="continuous", slots=8),
            serving_cost=COST)
        plain = scn.predict("noop")
        chunked = scn.predict("chunked_prefill:chunk=256")
        assert chunked.ttft_p99 < plain.ttft_p99
        assert chunked.ttft_p50 < plain.ttft_p50
        _check(golden, "chunked_ttft_p99_win",
               plain.ttft_p99 / chunked.ttft_p99)
        _check(golden, "chunked_ttft_p50_win",
               plain.ttft_p50 / chunked.ttft_p50)

    def test_stack_with_tp_routes_through_cluster(self, golden):
        """continuous_batching,chunked_prefill,tp:degree=2 composes: TP
        shards the cost model, the graph routes through ClusterGraph with
        per-step all-reduce rings, and critical-path diagnosis works."""
        scn = saturating_scenario(golden)
        pred = scn.predict("continuous_batching,chunked_prefill:chunk=64,"
                           "tp:degree=2")
        assert pred.cluster is not None
        names = [t.name for t in pred.graph.tasks()]
        assert any("tp-ar" in n and ":leg" in n for n in names), \
            "per-step all-reduces should be ring-wired by the cluster"
        cp = pred.critical_path
        assert cp.makespan == pytest.approx(pred.predicted, rel=1e-9)

    def test_sweep_grid_returns_serving_predictions(self, golden):
        scn = saturating_scenario(golden)
        preds = scn.sweep("continuous_batching", {"slots": [4, 8, 16]})
        assert len(preds) == 3
        assert all(isinstance(p, ServingPrediction) for p in preds)
        assert all(p.tokens_generated ==
                   scn.workload.total_output_tokens for p in preds)

    def test_headroom_floor_is_last_arrival(self, golden):
        """Erasing all engine work leaves the open-loop arrival chain:
        the idealized makespan is exactly the last arrival."""
        scn = saturating_scenario(golden)
        from repro_torch.analysis.opportunity import _Headroom
        pred = scn.predict(_Headroom(ContinuousBatching()))
        assert pred.predicted == pytest.approx(scn.workload.last_arrival,
                                               rel=1e-12)


# --------------------------------------------------------------- policy
class TestPolicy:
    def test_kv_capacity_caps_static_batch(self):
        """A tight KV budget admits fewer requests per batch than slots."""
        wl = explicit_workload([(0.0, 100, 10)] * 4)
        cap = 2 * 110 + 1          # fits two requests, not four
        tight = ServingScenario(
            workload=wl, serving_cost=COST,
            policy=ServingPolicy(mode="static", slots=4,
                                 kv_capacity_tokens=cap))
        assert tight._sgraph.num_batches == 2
        roomy = ServingScenario(
            workload=wl, serving_cost=COST,
            policy=ServingPolicy(mode="static", slots=4))
        assert roomy._sgraph.num_batches == 1

    def test_kv_offload_adds_dma_and_admits(self):
        wl = explicit_workload([(0.0, 100, 10)] * 4)
        cap = 2 * 110 + 1
        scn = ServingScenario(
            workload=wl, serving_cost=COST,
            policy=ServingPolicy(mode="static", slots=4,
                                 kv_capacity_tokens=cap))
        off = scn.predict("kv_offload")
        sg = scn.serving_graph("kv_offload")
        assert sg.num_batches == 1        # admits past the cap
        assert any(t.attrs.get("serving") == "dma"
                   for t in sg.graph.tasks())
        assert off.predicted > 0

    def test_token_conservation_all_modes(self):
        wl = poisson_workload(150, 0.3, seed=7, prompt_mean=32,
                              output_mean=8)
        for policy in (ServingPolicy(mode="static", slots=4),
                       ServingPolicy(mode="continuous", slots=4),
                       ServingPolicy(mode="continuous", slots=4,
                                     prefill_chunk=16)):
            sg = build_serving_graph(wl, COST, policy)
            assert sg.tokens_emitted == {
                r.rid: r.output_tokens for r in wl.requests}, policy.mode

    def test_slot_lanes_and_utilization(self, golden):
        scn = saturating_scenario(golden)
        pred = scn.predict("continuous_batching")
        assert any(th.startswith("slot:") for th in pred.lane_util)
        assert all(0.0 <= u <= 1.0 + 1e-9 for u in pred.lane_util.values())
        assert slot_lane(0) in pred.lane_util


# -------------------------------------------------------------- registry
class TestRegistry:
    def test_serving_opts_registered_and_roundtrip(self):
        for name in SERVING_OPTS:
            assert name in available()
            cls = get_optimization(name)
            opt = cls()
            parsed, over = parse_stack(opt.spec())
            assert parsed == opt and over == {}

    def test_serving_opts_land_in_each_package_s_own_registry(self):
        """The port's classes in the port's registry, the reference's in
        the reference's, and the same names listed by both."""
        for name in SERVING_OPTS + ("cb", "tensor_parallel"):
            port_cls = port_core.get_optimization(name)
            ref_cls = ref_core.get_optimization(name)
            assert port_cls.__module__ == "repro_torch.serving.scenario"
            assert ref_cls.__module__ == "repro.serving.scenario"
            assert port_cls.__name__ == ref_cls.__name__

        def own(core, module):
            return [n for n in core.available()
                    if core.get_optimization(n).__module__ == module]

        assert own(port_core, "repro_torch.serving.scenario") == \
            own(ref_core, "repro.serving.scenario") == sorted(SERVING_OPTS)

    def test_serving_opt_on_training_scenario_raises(self):
        from repro_torch.core import Scenario, OptimizationError
        from torch_synthgraphs import training_step_graph
        scn = Scenario(training_step_graph(layers=2))
        with pytest.raises(OptimizationError, match="ServingScenario"):
            scn.predict("continuous_batching")

    def test_stack_order_folds_policy(self, golden):
        scn = saturating_scenario(golden)
        scn.predict("continuous_batching:slots=4,static_slots")
        scn.predict("static_slots")
        # rightmost serving member wins the mode; slots=4 persists
        sg = scn.serving_graph("continuous_batching:slots=4,static_slots")
        assert sg.policy.mode == "static" and sg.policy.slots == 4


# ------------------------------------------------------------- workloads
class TestWorkloads:
    def test_trace_roundtrip(self, tmp_path):
        wl = poisson_workload(50, 0.2, seed=5)
        path = tmp_path / "reqs.jsonl"
        with open(path, "w") as f:
            for r in wl.requests:
                f.write(json.dumps({"rid": r.rid, "arrival": r.arrival,
                                    "prompt_tokens": r.prompt_tokens,
                                    "output_tokens": r.output_tokens})
                        + "\n")
        back = trace_workload(str(path))
        assert back.requests == wl.requests

    def test_scale_arrivals_compresses_clock(self):
        wl = poisson_workload(50, 0.2, seed=5)
        fast = scale_arrivals(wl, 0.5)
        assert fast.offered_rate() == pytest.approx(2 * wl.offered_rate())
        assert [r.prompt_tokens for r in fast.requests] == \
               [r.prompt_tokens for r in wl.requests]

    def test_bad_inputs_raise(self):
        with pytest.raises(ValueError):
            poisson_workload(0, 1.0)
        with pytest.raises(ValueError):
            explicit_workload([(0.0, 0, 4)])
        with pytest.raises(ValueError):
            ServingPolicy(mode="banana")


# ------------------------------------------------------------------- CLI
class TestCLI:
    def test_serve_sim_table(self, capsys):
        from repro_torch.launch import serve_sim
        rc = serve_sim.main(["--model", "tinyllama_1.1b", "--smoke",
                             "--rate", "20", "--duration", "0.5",
                             "--what-if", "continuous_batching"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "goodput" in out and "continuous_batching" in out

    def test_serve_sim_json(self, capsys):
        from repro_torch.launch import serve_sim
        rc = serve_sim.main(["--model", "tinyllama-1.1b", "--smoke",
                             "--rate", "20", "--duration", "0.5",
                             "--json"])
        assert rc == 0
        data = json.loads(capsys.readouterr().out)
        assert data[0]["spec"].startswith("noop")
        assert data[0]["tokens_generated"] > 0

    def test_serve_sim_prices_the_full_405b_on_h100(self, capsys):
        """The CLI's default model at full size, on the port's H100 spec."""
        from repro_torch.launch import serve_sim
        rc = serve_sim.main(["--rate", "50", "--duration", "0.2", "--json",
                             "--what-if", "tp:degree=8"])
        assert rc == 0
        data = json.loads(capsys.readouterr().out)
        assert [d["spec"] for d in data] == ["noop", "tp:degree=8"]
        assert all(d["makespan"] > 0 and math.isfinite(d["makespan"])
                   for d in data)
        assert serving_cost("llama3_405b").hw.name == "h100-sxm"

    def test_format_table(self, golden):
        scn = saturating_scenario(golden)
        table = format_serving_table([scn.predict("noop")])
        assert "ttft p50" in table and "noop" in table


# ================================================ parity with repro.serving
def _requests(wl):
    return [dataclasses.astuple(r) for r in wl.requests]


WORKLOADS = {
    "poisson": lambda pkg: pkg.poisson_workload(
        120, 0.5, seed=11, prompt_mean=48, output_mean=12),
    "poisson-wide": lambda pkg: pkg.poisson_workload(
        300, 0.3, seed=2, prompt_sigma=1.2, output_sigma=0.9,
        max_prompt=2048, max_output=64),
    "trace": lambda pkg: pkg.trace_workload(
        [{"arrival": 0.3, "prompt_tokens": 40, "output_tokens": 5},
         {"rid": 7, "arrival": 0.1, "prompt_tokens": 900, "output_tokens": 2},
         {"arrival": 0.1, "prompt_tokens": 12, "output_tokens": 30}]),
    "scaled": lambda pkg: pkg.scale_arrivals(
        pkg.poisson_workload(80, 0.25, seed=4, prompt_mean=24,
                             output_mean=6), 0.37),
    "explicit": lambda pkg: pkg.explicit_workload(
        [(0.0, 512, 32)] * 4 + [(0.01, 128, 8)]),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workloads_equal_the_reference(name):
    port, ref = WORKLOADS[name](port_serving), WORKLOADS[name](ref_serving)
    assert _requests(port) == _requests(ref)
    assert (port.duration, port.seed, port.source) == \
        (ref.duration, ref.seed, ref.source)


POLICIES = {
    "static": dict(mode="static", slots=4),
    "continuous": dict(mode="continuous", slots=4),
    "chunked": dict(mode="continuous", slots=4, prefill_chunk=16),
    "offload": dict(mode="continuous", slots=2, kv_capacity_tokens=400.0,
                    kv_offload=True),
    "static-offload": dict(mode="static", slots=4, kv_capacity_tokens=150.0,
                           kv_offload=True),
    "tp": dict(mode="static", slots=4, tp_degree=4),
}


def _graph_rows(sg):
    return [(t.name, t.kind.name, t.thread, t.duration, t.gap, t.flops,
             t.bytes_accessed, t.comm_bytes)
            for t in sg.graph.tasks()], sorted(
        (p.name, c.name) for c in sg.graph.tasks()
        for p in sg.graph.parents(c))


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_serving_graph_equals_the_reference(policy):
    graphs = []
    for pkg in (port_serving, ref_serving):
        wl = pkg.poisson_workload(150, 0.3, seed=7, prompt_mean=32,
                                  output_mean=8)
        graphs.append(pkg.build_serving_graph(
            wl, pkg.ServingCostModel(), pkg.ServingPolicy(**POLICIES[policy])))
    port, ref = graphs
    assert len(port.graph) == len(ref.graph)
    assert _graph_rows(port) == _graph_rows(ref)
    assert (port.tokens_emitted, port.num_steps, port.num_batches) == \
        (ref.tokens_emitted, ref.num_steps, ref.num_batches)


def _metrics(p):
    return (p.predicted, p.speedup, p.goodput, p.ttft_p50, p.ttft_p99,
            p.tpot_p50, p.tpot_p99, p.latency_p50, p.latency_p99,
            p.tokens_generated, p.requests_completed, p.lane_util,
            p.slot_classes)


@pytest.mark.parametrize("spec", [
    "noop", "continuous_batching", "static_slots:slots=16",
    "chunked_prefill:chunk=32", "continuous_batching,chunked_prefill:chunk=32",
    "kv_offload", "tp:degree=8", "continuous_batching,tp:degree=8"])
def test_predictions_equal_the_reference(golden, spec):
    """Baseline makespan, goodput, TTFT/TPOT/latency p50/p99 and lane
    utilizations ``==`` for each serving what-if; ``tp:degree=8`` through
    the cluster route of both packages."""
    port = saturating_scenario(golden, port_serving)
    ref = saturating_scenario(golden, ref_serving)
    assert port.baseline().makespan == ref.baseline().makespan
    p, r = port.predict(spec), ref.predict(spec)
    assert _metrics(p) == _metrics(r)
    assert (p.cluster is None) == (r.cluster is None) == ("tp" not in spec)


def _fields(model):
    return dataclasses.asdict(model)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_serving_cost_equals_the_reference(arch, smoke):
    """The analytic model (``fitted=False``) on the reference's TPU spec,
    from the port's ``count_params``/``active_params`` on meta tensors."""
    port = serving_cost(arch, port_core.TPU_V5E, smoke=smoke, fitted=False)
    ref = ref_configs.serving_cost(arch, smoke=smoke, fitted=False)
    assert _fields(port) == _fields(ref)


def test_serving_cost_defaults_to_h100_and_folds_names():
    from repro_torch.configs import SERVING_COSTS, normalize_arch
    assert normalize_arch("llama3_2_1b") == "llama3.2-1b"
    assert normalize_arch("tinyllama_1.1b") == "tinyllama-1.1b"
    with pytest.raises(KeyError):
        normalize_arch("seamless_m4t_large_v2")
    for arch in ARCHS:
        cost = serving_cost(arch)
        assert cost.hw == port_core.H100_SXM
        want = SERVING_COSTS.get(arch, {})
        assert {k: getattr(cost, k) for k in want} == want
    assert set(SERVING_COSTS) <= set(ARCHS)


# ------------------------------------------------------------ measure (C7)
C7_SHAPE = dict(smoke=True, prompt_tokens=16, batch=2, max_seq=32)
T_PREFILL, T_DECODE = 0.0123, 0.0045


def _fixed_times(monkeypatch, module, t_decode_sample):
    """``module._time`` returning the prefill time, then the decode sample's
    (both harnesses time the prefill first)."""
    times = iter([T_PREFILL, t_decode_sample])
    monkeypatch.setattr(module, "_time", lambda *a, **k: next(times))


def _static_prefill_sum(pkg, cost, batch, prompt):
    wl = pkg.explicit_workload([(0.0, prompt, 4)] * batch)
    sg = pkg.build_serving_graph(wl, cost,
                                 pkg.ServingPolicy(mode="static", slots=batch))
    return sum(t.duration for t in sg.graph.tasks()
               if t.attrs.get("serving") == "prefill")


def test_fit_prices_the_batch_prefill_as_measured_c7(monkeypatch):
    """With the same fixed times in both harnesses, the decode constants
    are equal, and a static batch of the fitted shape is priced at the
    measured prefill by the port and at ``batch`` times it by the
    reference (C7: its prefill fit divides by one request's roofline).
    The port's decode sample is a run of ``DECODE_STEPS`` steps, the
    reference's one step: each is given the same time per step."""
    run = T_DECODE * port_measure.DECODE_STEPS
    _fixed_times(monkeypatch, port_measure, run)
    _fixed_times(monkeypatch, ref_measure, run / port_measure.DECODE_STEPS)
    port, pc = port_measure.measure_serving_costs(
        "tinyllama-1.1b", hw=port_core.TPU_V5E, device="cpu", **C7_SHAPE)
    ref, rc = ref_measure.measure_serving_costs(
        "tinyllama-1.1b", hw=ref_core.TPU_V5E, **C7_SHAPE)
    assert (pc["decode_scale"], pc["step_overhead"]) == \
        (rc["decode_scale"], rc["step_overhead"])
    B, P = C7_SHAPE["batch"], C7_SHAPE["prompt_tokens"]
    got = _static_prefill_sum(port_serving, port, B, P)
    ref_got = _static_prefill_sum(ref_serving, ref, B, P)
    assert got == pytest.approx(T_PREFILL, rel=1e-12), (got, ref_got)
    assert ref_got == pytest.approx(B * T_PREFILL, rel=1e-12), (got, ref_got)
    assert pc["prefill_scale"] != rc["prefill_scale"]


def test_measure_runs_end_to_end_on_cpu():
    fitted, consts = port_measure.measure_serving_costs(
        "tinyllama-1.1b", device="cpu", **C7_SHAPE)
    assert set(consts) == {"prefill_scale", "decode_scale", "step_overhead"}
    assert all(math.isfinite(v) and v > 0 for v in consts.values())
    assert fitted.hw == port_core.H100_SXM
    assert {k: getattr(fitted, k) for k in consts} == consts


def test_measure_cli_on_cpu(capsys):
    assert port_measure.main(["--smoke", "--device", "cpu", "--batch", "2",
                              "--prompt-tokens", "8", "--max-seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and ".with_constants({'prefill_scale'" in out


def test_measure_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_measure.measure_serving_costs("tinyllama-1.1b", **C7_SHAPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_measure.main(["--smoke"])
