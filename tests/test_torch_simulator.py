"""repro_torch's simulator core and what-if registry against the JAX package's.

The graphs are the reference's own (``tests/synthgraphs.py``), built by the
JAX package and copied record by record into the port
(``Task.to_record``/``from_record``, ``add_task(..., link_lane=False)``, then
every edge): the two packages' ``TaskKind`` are different enums, so no task
of one ever reaches the other.  The carried-over code is the reference's, so
everything is held exactly (``==``): makespans, per-task start and finish
times, every registered optimization's prediction, and the golden speedups
to the rtol stored beside them.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.core import whatif  # noqa: E402
from synthgraphs import random_dag, training_step_graph  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "speedups.json"
SEEDS = range(8)


def to_port(g):
    """The reference graph ``g`` as a ``repro_torch.core.DependencyGraph``
    with the same uids, lanes and edges."""
    pg = port.DependencyGraph()
    made = {}
    for t in g.tasks():                        # uid order
        made[t.uid] = pg.add_task(port.Task.from_record(t.to_record()),
                                  link_lane=False)
        assert made[t.uid].uid == t.uid
    for t in g.tasks():
        for c in g.children(t):
            pg.add_edge(made[t.uid], made[c.uid])
    assert dict(pg.lanes) == dict(g.lanes)
    return pg


GRAPHS = {"training_step": training_step_graph,
          **{f"random_dag_{s}": (lambda s=s: random_dag(s)) for s in SEEDS}}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("engine", ["simulate", "simulate_reference"])
def test_engine_matches_reference(name, engine):
    g = GRAPHS[name]()
    want = getattr(ref_core, engine)(g)
    got = getattr(port, engine)(to_port(g))
    assert got.makespan == want.makespan
    assert got.start == want.start
    assert got.finish == want.finish
    assert got.thread_busy == want.thread_busy


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_incremental_engine_matches_reference(name):
    """Re-simulating a retuned cone: the same result (or the same refusal,
    ``None``) in both packages, and equal to a full replay."""
    g = GRAPHS[name]()
    pg = to_port(g)
    prevs = ref_core.simulate(g), port.simulate(pg)
    dirty = {t.uid for t in g.tasks()[-len(g) // 4:]}
    for graph in (g, pg):
        for t in graph.tasks():
            if t.uid in dirty:
                t.duration *= 1.5
    want = ref_core.simulate_incremental(g, prevs[0], dirty)
    got = port.simulate_incremental(pg, prevs[1], dirty)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.makespan == want.makespan
        assert got.start == want.start
        assert got.makespan == port.simulate(pg).makespan


# the what-ifs ``repro.core`` itself registers: ``repro.serving`` and
# ``repro.faults`` add theirs to the same registry when some other test
# imports them, so the list is fixed here rather than read at collection
CORE_OPTIMIZATIONS = ["amp", "bandwidth", "blueconnect", "ddp", "dgc",
                      "fused_norm", "fused_optimizer", "gist", "grad_accum",
                      "noop", "offload", "overlap", "p3", "pipeline",
                      "remove_layer", "scale_layer", "straggler", "zero"]


def test_registries_hold_the_same_optimizations():
    """The core's own optimizations (each package's ``serving`` adds its
    own to the same registry when imported, as ``faults`` does the
    reference's, so both sides are read by the module that registered)."""
    ref_own = [n for n in ref_core.available()
               if ref_core.get_optimization(n).__module__ == "repro.core.optimize"]
    port_own = [n for n in port.available()
                if port.get_optimization(n).__module__ == "repro_torch.core.optimize"]
    assert port_own == ref_own == CORE_OPTIMIZATIONS


@pytest.mark.parametrize("opt", CORE_OPTIMIZATIONS)
def test_optimization_matches_reference(opt):
    """Every registered what-if on the reference's step graph: the same
    baseline and prediction, or the same exception type."""
    g = training_step_graph()
    results = []
    for core, graph in ((ref_core, g), (port, to_port(g))):
        try:
            p = core.Scenario(graph=graph).predict(opt)
            results.append((p.baseline, p.predicted))
        except Exception as e:                    # noqa: BLE001
            results.append(type(e).__name__)
    assert results[0] == results[1]


@pytest.mark.parametrize("spec", ["pipeline:stages=3,microbatches=4",
                                  "pipeline:stages=2,microbatches=8,schedule=1f1b",
                                  "amp:matmul_speedup=2.0", "scale_layer:layer_pattern=l3,scale=0.5",
                                  "remove_layer:layer_pattern=l0"])
def test_parameterised_optimization_matches_reference(spec):
    g = training_step_graph()
    want = ref_core.Scenario(graph=g).predict(spec)
    got = port.Scenario(graph=to_port(g)).predict(spec)
    assert (got.baseline, got.predicted) == (want.baseline, want.predicted)


# ------------------------------------------------------------ golden values
@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(scope="module")
def golden_setup(golden):
    layers = golden["graph"]["layers"]
    grads = {f"l{i}": golden["graph"]["grad_bytes_per_layer"]
             for i in range(layers)}
    return to_port(training_step_graph(layers=layers)), grads


def _amp(g, grads):
    return port.simulate(g).makespan / whatif.what_if_amp(g).simulate().makespan


def _p3(g, grads):
    plain = whatif.what_if_p3(g, grads, 4, bandwidth=5e9, priority=False,
                              slice_bytes=float("inf")).simulate().makespan
    prio = whatif.what_if_p3(g, grads, 4, bandwidth=5e9,
                             priority=True).simulate().makespan
    return plain / prio


def _zero(g, grads):
    ddp = whatif.cluster_what_if_distributed(g, grads, 8).makespan
    return ddp / whatif.cluster_what_if_zero(g, grads, 8).makespan


def _straggler(g, grads):
    ddp = whatif.cluster_what_if_distributed(g, grads, 8).makespan
    return ddp / whatif.cluster_what_if_straggler(g, grads, 8, straggler=0,
                                                  slowdown=2.0).makespan


@pytest.mark.parametrize("key,fn", [
    ("amp_speedup", _amp), ("p3_priority_speedup_over_plain_ps", _p3),
    ("zero_speedup_over_ddp", _zero), ("cluster_straggler_2x_slowdown", _straggler)])
def test_golden_speedup_from_port(golden, golden_setup, key, fn):
    g, grads = golden_setup
    assert fn(g, grads) == pytest.approx(golden[key]["value"],
                                         rel=golden[key]["rtol"])


# ------------------------------------------- the port's FusedOptimizer on GPU
def _launch_graph(core):
    """host launch -> kernel for a fwd and three update kernels, then a sync:
    the shape a measured GPU step has (one launch per kernel)."""
    g = core.DependencyGraph()
    prev = None
    for i, (phase, dur) in enumerate([("fwd", 4e-3), ("update", 1e-3),
                                      ("update", 1e-3), ("update", 1e-3)]):
        h = g.add_task(core.Task(f"launch{i}", core.TaskKind.HOST,
                                 core.HOST_THREAD, 2e-3, gap=1e-3, phase=phase))
        k = g.add_task(core.Task(f"k{i}", core.TaskKind.COMPUTE,
                                 core.DEVICE_STREAM, dur, phase=phase,
                                 bytes_accessed=3e9))
        g.add_edge(h, k)
        prev = k
    s = g.add_task(core.Task("sync", core.TaskKind.SYNC, core.HOST_THREAD, 1e-6))
    g.add_edge(prev, s)
    return g


def test_fused_optimizer_removes_update_launches():
    pred, tf, _ = port.Scenario(graph=_launch_graph(port)).evaluate(
        "fused_optimizer")
    names = sorted(t.name for t in tf.graph.tasks())
    assert names == ["fused_optimizer_kernel", "k0", "launch0", "launch1", "sync"]
    assert pred.predicted < pred.baseline


def test_fused_optimizer_keeps_the_fused_kernels_launch():
    _, tf, _ = port.Scenario(graph=_launch_graph(port)).evaluate(
        "fused_optimizer")
    g = tf.graph
    by_name = {t.name: t for t in g.tasks()}
    fused = by_name["fused_optimizer_kernel"]
    assert sorted(t.name for t in g.parents(fused)) == ["k0", "launch1"]
    assert [t.name for t in g.lane_tasks(port.HOST_THREAD)] == [
        "launch0", "launch1", "sync"]
    assert fused in g.parents(by_name["sync"])


def test_h100_spec_is_the_data_sheet():
    hw = port.H100_SXM
    assert (hw.peak_flops, hw.hbm_bandwidth, hw.ici_bandwidth, hw.hbm_bytes,
            hw.pcie_bandwidth) == (989e12, 3.35e12, 450e9, 80 * 2 ** 30, 64e9)
    assert vars(port.TPU_V5E) == vars(ref_core.TPU_V5E)


def test_import_core_loads_no_jax_and_no_trace_module():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro.")
                     or m in ("repro_torch.core.trace", "repro_torch.core.kineto"))
        assert not bad, bad
        assert repro_torch.core.trace_measured.__module__ == "repro_torch.core.trace"
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr
