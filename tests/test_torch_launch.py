"""repro_torch.launch's Daydream CLIs against the JAX package's.

* **Trace route.** The reference's own exports (a synthetic 3-worker
  capture as native JSONL, and the same capture re-exported by the
  reference's ``perf_report --export-trace`` as Chrome JSON) go through
  both packages' ``diagnose``, ``calibrate``, ``perf_report --trace-dir``
  (``--what-if``, ``--critical-path``, ``--timeline``, ``--goodput``,
  ``--straggler``, ``--export-trace``) and ``perf_report --serving``:
  stdout ``==``, exports byte for byte.  The port's CLIs also read the
  committed card capture ``tests/data/kineto_smoke_step.json.gz``.
* **Compiled route.** The reference compiles a 256-chip cell; the port
  traces one device's train step on meta tensors.  The graphs differ by
  route, so both packages get the same ``DependencyGraph`` (moved across
  as native JSONL) and their ``build_scenario`` scenarios must predict
  ``==`` and search the registry in the same order.  The port's
  ``perf_report --arch/--shape`` and ``hillclimb --search-whatif`` run end
  to end on the smoke config (``--set``), with the reference's JSON keys.

``repro.launch.*`` is imported inside the tests, with ``XLA_FLAGS`` held
(its modules set a 512-device default at import).
"""

import ast
import dataclasses
import importlib
import json
import os
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as ref_core  # noqa: E402
import repro.faults  # noqa: E402,F401  (registers the fault policies)
import repro.serving  # noqa: E402,F401  (registers the serving what-ifs)
import repro.traceio as ref_traceio  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.faults  # noqa: E402,F401
import repro_torch.serving  # noqa: E402,F401
import synthgraphs as ref_graphs  # noqa: E402
import torch_synthgraphs as port_graphs  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro_torch import traceio  # noqa: E402
from repro_torch.configs import SHAPES, get_smoke_config  # noqa: E402
from repro_torch.core import DEVICE_STREAM, H100_SXM, TaskKind  # noqa: E402
from repro_torch.launch import (calibrate, diagnose, hillclimb,  # noqa: E402
                                perf_report)
from repro_torch.models.model import active_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CAPTURE = ROOT / "tests" / "data" / "kineto_smoke_step.json.gz"
ARCH = "tinyllama-1.1b"
SMOKE = get_smoke_config(ARCH)
# --set overrides that turn the full config into its smoke config
SMOKE_SET = [f"{k}={getattr(SMOKE, k)}" for k in
             ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab")]
GRADS = {f"l{i}": 30e6 for i in range(4)}


@pytest.fixture
def ref(monkeypatch):
    """Import ``repro.launch.<name>`` without its 512-device XLA default."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    return lambda name: importlib.import_module(f"repro.launch.{name}")


def run(main, argv, monkeypatch, capsys):
    """stdout of a CLI's ``main()`` with ``sys.argv`` set, as a user runs it."""
    monkeypatch.setattr("sys.argv", [main.__module__] + list(argv))
    main()
    return capsys.readouterr().out


@pytest.fixture(scope="module", params=["native", "chrome"])
def trace_dir(request, tmp_path_factory):
    """A capture the reference wrote: 3 workers, a 1.5x straggler, skewed
    clocks; as native JSONL or re-exported by the reference as Chrome."""
    d = tmp_path_factory.mktemp("native")
    ref_traceio.write_synthetic_trace_dir(
        str(d), 3, layers=4, compute_scales=[1.0, 1.5, 1.0],
        clock_offsets=[0.0, 2e-3, -1e-3], clock_drifts=[1.0, 1.0001, 0.9999])
    if request.param == "native":
        return str(d)
    imp = ref_traceio.load_trace_dir(str(d))
    pred, tf, cg = ref_core.Scenario(traces=imp).evaluate("noop")
    out = tmp_path_factory.mktemp("chrome")
    ref_traceio.export_cluster_traces(cg, pred.cluster, str(out))
    return str(out)


def card_capture(tmp_path) -> str:
    d = tmp_path / "card"
    d.mkdir()
    shutil.copy(CAPTURE, d / "worker0.pt.trace.json.gz")
    return str(d)


# ------------------------------------------------------------ trace route
@pytest.mark.parametrize("argv", [
    [],
    ["--calibrate", "--what-if", "amp", "--timeline", "--top", "5"],
    ["--no-diff", "--no-rank", "--straggler", "0:2.0", "--what-if", "ddp"],
])
def test_diagnose_stdout_equals_reference(trace_dir, argv, ref, monkeypatch,
                                          capsys):
    argv = ["--trace-dir", trace_dir] + argv
    port = run(diagnose.main, argv, monkeypatch, capsys)
    assert port == run(ref("diagnose").main, argv, monkeypatch, capsys)
    assert "== critical path" in port and "imported cluster x3" in port


@pytest.mark.parametrize("argv", [
    ["--diff"],
    ["--max-rounds", "2", "--constants", "kind_scale:compute,ici_factor",
     "--strict-align", "--straggler", "2:1.5"],
])
def test_calibrate_stdout_equals_reference(trace_dir, argv, ref, monkeypatch,
                                           capsys):
    argv = ["--trace-dir", trace_dir] + argv
    port = run(calibrate.main, argv, monkeypatch, capsys)
    assert port == run(ref("calibrate").main, argv, monkeypatch, capsys)
    assert "wape before" in port and "wape after" in port


@pytest.mark.parametrize("argv", [
    [],
    ["--what-if", "amp,bandwidth:factor=2", "--critical-path", "--timeline"],
    ["--straggler", "1:2.0", "--what-if", "ddp", "--critical-path"],
    ["--goodput", "--what-if", "ckpt_interval:steps=50", "--mtbf-hours", "2",
     "--goodput-horizon", "7200", "--ckpt-interval", "20"],
    ["--goodput", "--straggler", "0:1.5"],
])
def test_perf_report_trace_route_equals_reference(trace_dir, argv, ref,
                                                  monkeypatch, capsys):
    argv = ["--trace-dir", trace_dir] + argv
    port = run(perf_report.main, argv, monkeypatch, capsys)
    assert port == run(ref("perf_report").main, argv, monkeypatch, capsys)
    assert port.startswith(f"== imported 3 worker trace(s) from {trace_dir}")


def test_perf_report_export_equals_reference(trace_dir, ref, monkeypatch,
                                             capsys, tmp_path):
    """``--export-trace``: the same stdout and byte-equal per-worker files,
    which re-import to the predicted makespan."""
    outs = {}
    for name, main in (("port", perf_report.main),
                       ("ref", ref("perf_report").main)):
        dest = tmp_path / "export"
        argv = ["--trace-dir", trace_dir, "--what-if", "overlap",
                "--export-trace", str(dest)]
        outs[name] = (run(main, argv, monkeypatch, capsys),
                      {p.name: p.read_bytes() for p in sorted(dest.iterdir())})
        shutil.move(str(dest), str(tmp_path / name))
    assert outs["port"] == outs["ref"]
    assert sorted(outs["port"][1]) == [f"worker{i}.trace.json" for i in range(3)]
    imp = traceio.load_trace_dir(str(tmp_path / "port"))
    back = port_core.Scenario(traces=imp).baseline().makespan
    line = next(l for l in outs["port"][0].splitlines() if "global makespan" in l)
    assert f"{back * 1e3:.3f}" in line


def test_perf_report_serving_equals_reference(ref, monkeypatch, capsys):
    """``--serving`` with both packages pricing the same analytic model
    (the port's default is ``H100_SXM`` with constants fitted on the card)."""
    import repro.configs as ref_configs
    import repro_torch.configs as port_configs
    port_cost, ref_cost = port_configs.serving_cost, ref_configs.serving_cost
    monkeypatch.setattr(port_configs, "serving_cost", lambda a: port_cost(
        a, port_core.TPU_V5E, fitted=False))
    monkeypatch.setattr(ref_configs, "serving_cost",
                        lambda a: ref_cost(a, fitted=False))
    argv = ["--serving", "--arch", "tinyllama_1.1b", "--rate", "20",
            "--duration", "1", "--what-if", "continuous_batching",
            "--critical-path", "--timeline"]
    port = run(perf_report.main, argv, monkeypatch, capsys)
    assert port == run(ref("perf_report").main, argv, monkeypatch, capsys)
    assert port.startswith("== serving tinyllama-1.1b:")


def test_perf_report_serving_prices_on_h100(monkeypatch, capsys):
    port = run(perf_report.main, ["--serving", "--arch", ARCH, "--rate", "5",
                                  "--duration", "1"], monkeypatch, capsys)
    assert "== serving tinyllama-1.1b" in port and "noop" in port


def test_format_cluster_report():
    """``tests/test_cluster.py::test_format_cluster_report`` on the port."""
    g = port_graphs.training_step_graph()
    res = port_core.whatif.cluster_what_if_straggler(g, GRADS, 4, straggler=1,
                                                     slowdown=2.0)
    out = perf_report.format_cluster_report(res, title="test")
    assert "test: 4 workers" in out
    rows = [l for l in out.splitlines()
            if l.startswith("w") and not l.startswith("worker")]
    assert len(rows) == 4
    assert any("2.0" in r for r in rows)   # straggler's vs-best column


def test_format_cluster_report_equals_reference(ref):
    kw = dict(straggler=2, slowdown=1.7)
    port = port_core.whatif.cluster_what_if_straggler(
        port_graphs.training_step_graph(), GRADS, 3, **kw)
    want = ref_core.whatif.cluster_what_if_straggler(
        ref_graphs.training_step_graph(), GRADS, 3, **kw)
    assert perf_report.format_cluster_report(port, title="x", unit=1e6) == \
        ref("perf_report").format_cluster_report(want, title="x", unit=1e6)


@pytest.mark.parametrize("bad", ["1", "a:2", "7:2.0"])
def test_parse_straggler_equals_reference(bad, ref):
    with pytest.raises(SystemExit) as port:
        perf_report._parse_straggler(bad, 4)
    with pytest.raises(SystemExit) as want:
        ref("perf_report")._parse_straggler(bad, 4)
    assert str(port.value) == str(want.value)


@pytest.mark.parametrize("cli, argv, key", [
    (diagnose, ["--calibrate", "--what-if", "fused_optimizer"], "fused_optimizer"),
    (calibrate, ["--diff"], "makespan rel err"),
    (perf_report, ["--what-if", "fused_optimizer", "--critical-path",
                   "--timeline"], "== timelines"),
    (perf_report, ["--goodput"], "== goodput: 1 worker(s)"),
])
def test_clis_read_the_card_capture(cli, argv, key, tmp_path, monkeypatch,
                                    capsys):
    d = card_capture(tmp_path)
    out = run(cli.main, ["--trace-dir", d] + argv, monkeypatch, capsys)
    assert out.startswith(f"== imported 1 worker trace(s) from {d}")
    assert key in out


def test_card_capture_export_reimports(tmp_path, monkeypatch, capsys):
    d, dest = card_capture(tmp_path), tmp_path / "export"
    out = run(perf_report.main, ["--trace-dir", d, "--what-if", "fused_optimizer",
                                 "--export-trace", str(dest)], monkeypatch, capsys)
    predicted = float(out.split("predicted :")[1].split("ms")[0])
    back = port_core.Scenario(traces=traceio.load_trace_dir(str(dest)))
    assert back.baseline().makespan * 1e3 == pytest.approx(predicted, abs=1e-3)


def test_strict_align_goes_through_load_trace_dir(tmp_path, monkeypatch, capsys):
    seen = []
    real = traceio.load_trace_dir

    def spy(path, **kw):
        seen.append(kw)
        return real(path, **kw)
    monkeypatch.setattr(traceio, "load_trace_dir", spy)
    run(calibrate.main, ["--trace-dir", card_capture(tmp_path), "--strict-align",
                         "--max-rounds", "1"], monkeypatch, capsys)
    assert seen[0] == {"align": "strict"}


# --------------------------------------------------------- compiled route
@pytest.fixture(scope="module")
def smoke_bundle():
    return perf_report.trace_cell(SMOKE, SHAPES["train_4k"])


def test_trace_cell_is_the_per_device_step_on_h100(smoke_bundle):
    """One sequence of 4096 per device at 256 chips, priced on H100_SXM,
    with one kernel task per launch the card would make."""
    L = SMOKE.n_layers
    dev = smoke_bundle.graph.lane_tasks(DEVICE_STREAM)
    kernels = {k: sum(t.attrs.get("kernel") == k for t in dev)
               for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    assert kernels == {"flash_attention": L, "rmsnorm": 2 * L + 1,
                       "fused_adam": 1, "dgc_mask": 0}
    assert smoke_bundle.cost.hw == H100_SXM
    flash = next(t for t in dev if t.attrs.get("kernel") == "flash_attention")
    dims = next(e for e in smoke_bundle.module if e.get("name") ==
                "repro_torch::flash_attention")["args"]["Input Dims"]
    assert dims[0] == [1, SMOKE.n_heads, 4096, SMOKE.d_model // SMOKE.n_heads]
    assert flash.duration == smoke_bundle.cost.compute_time(
        flash.flops, flash.bytes_accessed)
    assert not any(t.kind == TaskKind.COLLECTIVE for t in dev)


def test_attention_core_split(smoke_bundle):
    """The totals are ``trace_compiled``'s aggregates; the attention core
    is the flash operators and their plain backward: no projection."""
    tot = perf_report.aggregate_with_attention_split(smoke_bundle.module)
    agg = smoke_bundle.aggregates
    assert tot["flops"] == agg["flops"] and tot["bytes"] == agg["bytes"]
    assert tot["collective_s"] == 0.0 and tot["collective_bytes"] == 0.0
    assert 0 < tot["attn_bytes"] < tot["bytes"]
    assert 0 < tot["attn_flops"] < tot["flops"]
    core = [op for op in perf_report.task_ops(_host_side(smoke_bundle.module))
            if perf_report._in_attention_core(op)]
    names = {op.name for op in core}
    assert "repro_torch::flash_attention" in names and "aten::bmm" in names
    assert not names & {"aten::mm", "aten::addmm", "aten::linear"}
    assert sum(op.name == "repro_torch::flash_attention" for op in core) == \
        SMOKE.n_layers


def _host_side(events):
    ev = [perf_report._Event(e) for e in events if e.get("ph") == "X"
          and "ts" in e and e.get("cat") in perf_report.OP_CATS]
    perf_report._nest(ev)
    return ev


def test_flash_traffic_equals_reference(ref):
    pr = ref("perf_report")
    from repro.configs import registry as ref_registry
    for arch in ("tinyllama-1.1b", "llama3.2-1b"):
        for shape in ("train_4k", "prefill_32k"):
            assert perf_report.flash_traffic(
                get_smoke_config(arch), SHAPES[shape], 256) == pr.flash_traffic(
                ref_smoke(arch), ref_registry.SHAPES[shape], 256)


def test_rooflines_equal_reference_roofline_report(smoke_bundle):
    """Both rows are ``roofline_report`` of the reference on the same
    aggregates and the same hardware numbers: same keys, same values."""
    from repro.core.roofline import roofline_report as ref_roofline
    from repro.core.task import HardwareSpec as RefSpec
    tot, fb, base, modeled = perf_report.flash_rooflines(
        smoke_bundle, SMOKE, SHAPES["train_4k"])
    hw = RefSpec(**dataclasses.asdict(H100_SXM))
    kw = dict(chips=256, kind="train", n_active_params=active_params(SMOKE),
              seq_len=4096, global_batch=256, hw=hw)
    agg = {k: tot[k] for k in ("flops", "bytes", "collective_bytes",
                               "collective_s")}
    assert base == ref_roofline(agg, **kw)
    assert modeled == ref_roofline({**agg, "bytes": tot["bytes"]
                                    - tot["attn_bytes"] + fb}, **kw)
    assert base["collective_s"] == 0.0 and modeled["memory_s"] < base["memory_s"]


def _reference_record_keys(module: str, var: str = "rec") -> set:
    """The keys of the dict literal assigned to ``var`` in a reference
    launcher's source."""
    src = (ROOT / "src" / "repro" / "launch" / f"{module}.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                any(getattr(t, "id", None) == var for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no {var} dict in {module}")


def test_perf_report_compiled_route_end_to_end(tmp_path, monkeypatch, capsys):
    out = run(perf_report.main, ["--arch", ARCH, "--shape", "train_4k", "--out",
                                 str(tmp_path), "--tag", "t"]
              + [a for kv in SMOKE_SET for a in ("--set", kv)],
              monkeypatch, capsys)
    lines = out.splitlines()
    assert lines[0].startswith("compiled    : tinyllama-1.1b           train_4k")
    assert lines[1].startswith("with flash  : ") and "coll=    0.000ms" in lines[1]
    assert lines[-1].startswith("attention-loop bytes replaced: ")
    rec = json.loads((tmp_path / "tinyllama-1.1b__train_4k__single__t.json")
                     .read_text())
    assert set(rec) == _reference_record_keys("perf_report")
    assert rec["roofline"]["chips"] == 256 and rec["what_if"] is None
    assert rec["attn_bytes_removed"] > rec["flash_bytes_added"] > 0


@pytest.mark.parametrize("argv, key", [
    (["--cluster", "3", "--straggler", "1:2.0", "--critical-path", "--timeline"],
     "== cluster x3 (w1 2.0x slower): 3 workers"),
    (["--what-if", "amp,fused_optimizer", "--cluster", "2"], "== what-if amp,"),
    (["--what-if", "ddp:workers=4"], "predicted : "),
    (["--critical-path", "--timeline"], "== timelines"),
    (["--goodput", "--cluster", "2", "--what-if", "elastic"],
     "== goodput: 2 worker(s)"),
])
def test_perf_report_compiled_route_options(argv, key, tmp_path, monkeypatch,
                                            capsys):
    out = run(perf_report.main, ["--arch", ARCH, "--shape", "train_4k", "--out",
                                 str(tmp_path)] + argv
              + [a for kv in SMOKE_SET for a in ("--set", kv)],
              monkeypatch, capsys)
    assert key in out


def test_compiled_route_export_reimports(tmp_path, monkeypatch, capsys):
    dest = tmp_path / "export"
    out = run(perf_report.main, ["--arch", ARCH, "--shape", "train_4k", "--out",
                                 str(tmp_path), "--cluster", "2",
                                 "--export-trace", str(dest)]
              + [a for kv in SMOKE_SET for a in ("--set", kv)],
              monkeypatch, capsys)
    assert "exported 2 per-worker Chrome traces" in out
    assert traceio.load_trace_dir(str(dest)).num_workers == 2


def test_no_collectives_traced_cluster_inserts_them(smoke_bundle):
    """Diverged on purpose (meshes not ported): the traced per-device
    program has no collective and ``collective_s`` is 0; ``--cluster``
    inserts the gradient all-reduce as on every other route."""
    cost = perf_report.cell_cost()
    scn, _ = perf_report.build_scenario(smoke_bundle.graph, SMOKE, cost,
                                        workers=2)
    pred = scn.predict("ddp")
    comm = [t for t in pred.graph.tasks() if t.kind == TaskKind.COLLECTIVE]
    assert comm and pred.cluster is not None
    assert all(r.thread_busy.get("device", 0) > 0
               for r in pred.cluster.per_worker.values())


@pytest.mark.parametrize("argv, match", [
    (["--shape", "train_4k", "--mesh", "multi"], "A10"),
    (["--shape", "prefill_32k"], "train steps only"),
    (["--shape", "train_4k", "--set", "layout=v2"], "A10"),
])
def test_perf_report_routes_not_ported_raise(argv, match, tmp_path, monkeypatch,
                                             capsys):
    with pytest.raises(SystemExit, match=match):
        run(perf_report.main, ["--arch", ARCH, "--out", str(tmp_path)] + argv,
            monkeypatch, capsys)


def _same_graph(tmp_path, graph):
    """The port's graph written once as native JSONL and read back by each
    package: ``(port graph, reference graph)``."""
    d = tmp_path / "graph"
    d.mkdir()
    traceio.write_jsonl(traceio.events_from_graph(graph), str(d / "worker0.jsonl"))
    return (traceio.load_trace_dir(str(d)).graphs[0],
            ref_traceio.load_trace_dir(str(d)).graphs[0])


@pytest.mark.parametrize("workers, straggler", [(1, ""), (3, "2:1.5")])
def test_build_scenario_predictions_equal_reference(smoke_bundle, tmp_path,
                                                    workers, straggler, ref,
                                                    monkeypatch):
    pr = ref("perf_report")
    monkeypatch.setattr(pr, "extract_graph", lambda module, cost: module)
    port_g, ref_g = _same_graph(tmp_path, smoke_bundle.graph)
    assert port_core.simulate(port_g).makespan == pytest.approx(
        smoke_bundle.simulate().makespan, rel=1e-9)
    port_cost = perf_report.cell_cost()
    ref_cost = ref_core.CostModel(
        hw=ref_core.HardwareSpec(**dataclasses.asdict(H100_SXM)),
        topo=ref_core.MeshTopology.single_pod(16, 16))
    port_s, port_t = perf_report.build_scenario(
        port_g, SMOKE, port_cost, workers=workers, straggler=straggler)
    ref_s, ref_t = pr.build_scenario(ref_g, ref_smoke(ARCH), ref_cost,
                                     workers=workers, straggler=straggler)
    assert port_t == ref_t and port_s.layer_grad_bytes == ref_s.layer_grad_bytes
    for spec in ("noop", "amp", "fused_optimizer", "ddp", "zero",
                 "amp,overlap"):
        p, r = port_s.predict(spec), ref_s.predict(spec)
        assert (p.baseline, p.predicted) == (r.baseline, r.predicted), spec
    port_best, port_trail = port_core.greedy_search(port_s, max_depth=2)
    ref_best, ref_trail = ref_core.greedy_search(ref_s, max_depth=2)
    assert [(p.optimization.spec(), p.predicted) for p in port_trail] == \
        [(p.optimization.spec(), p.predicted) for p in ref_trail]
    assert port_trail and port_best.spec() == ref_best.spec()
    kw = dict(workers=workers if workers > 1 else 0, straggler=straggler,
              critical_path=True, timeline=True)
    assert perf_report.whatif_stack_report(port_g, SMOKE, port_cost, "amp,ddp",
                                           **kw) == \
        pr.whatif_stack_report(ref_g, ref_smoke(ARCH), ref_cost, "amp,ddp", **kw)
    if workers > 1:
        kw.pop("workers")
        assert perf_report.cluster_whatif_report(
            port_g, SMOKE, port_cost, workers=workers, **kw) == \
            pr.cluster_whatif_report(ref_g, ref_smoke(ARCH), ref_cost,
                                     workers=workers, **kw)


def test_hillclimb_search_end_to_end(tmp_path, monkeypatch, capsys):
    out = run(hillclimb.main, ["--arch", ARCH, "--shape", "train_4k", "--tag",
                               "t", "--search-whatif", "1", "--candidate",
                               "dgc:compression=0.01", "--out", str(tmp_path)]
              + [a for kv in SMOKE_SET for a in ("--set", kv)],
              monkeypatch, capsys)
    assert "== what-if search ordering" in out and "round 1: " in out
    rec = json.loads((tmp_path / "tinyllama-1.1b__train_4k__single__t.json")
                     .read_text())
    assert set(rec) == _reference_record_keys("hillclimb")
    assert rec["mode"] == "whatif_search" and len(rec["trail"]) == 1
    assert rec["best_stack"] == rec["trail"][0]["stack"]
    assert rec["trail"][0]["predicted_ms"] < rec["baseline_ms"]
    assert any(o["candidate"].startswith("dgc:compression=0.01")
               for o in rec["opportunities"])


@pytest.mark.parametrize("argv, match", [
    ([], "A10"),
    (["--search-whatif", "1", "--mesh", "multi"], "A10"),
    (["--search-whatif", "1", "--candidate", "ddp:workers=4"],
     "belong in --cluster"),
])
def test_hillclimb_modes_not_ported_raise(argv, match, tmp_path, monkeypatch,
                                          capsys):
    with pytest.raises(SystemExit, match=match):
        run(hillclimb.main, ["--arch", ARCH, "--shape", "train_4k", "--tag", "t",
                             "--out", str(tmp_path)] + argv
            + [a for kv in SMOKE_SET for a in ("--set", kv)], monkeypatch, capsys)
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("v", ["3", "2.5", "true", "False", "dots", "1e-3"])
def test_parse_value_equals_reference(v, ref):
    got, want = hillclimb.parse_value(v), ref("hillclimb").parse_value(v)
    assert got == want and type(got) is type(want)
