"""repro_torch's trace route: torch.profiler (Kineto) events -> dependency graph.

First a hand-written capture in the shape torch.profiler exports on CUDA
(complete events, microseconds): one forward matmul under an ``mlp`` scope,
its backward on the autograd engine's thread, an in-place update under an
``update`` scope, three launches with their kernels and one
``cudaStreamSynchronize``.  The graph built from it is pinned exactly: tasks,
durations, gaps (the untraced host time after a launch as a task of its own),
edges of all four kinds, layers (the backward kernel's via the autograd
sequence number) and phases, FLOPs and bytes, and the simulated timeline.

Then a hand-written capture whose launch queue fills (C6): three launches
block on a full command buffer, each with the ``Command Buffer Full``
overhead event CUPTI records, and the host's own time runs on after the last
kernel.  Each blocked launch is released by the kernel that ended last
before its wait ended and keeps only the time after the release; the graph
still simulates to the capture's span, and halving the device now shortens
the step (with the waits kept as host time, it did not).  Without the wait
events the same capture builds the graph it built before.

Then a real capture from the card (``tests/data/kineto_smoke_step.json.gz``,
written by ``tests/data/capture_kineto.py``: one per-leaf AdamW training step
of the smoke config on an H100): its graph must be acyclic, carry every
phase, launch every kernel from a host task, map >= 90% of its device time
to a layer, and simulate to the capture's own span.

Last, ``trace_measured`` on the CPU on the smoke model's training step (the
CPU route: operators are the tasks).  Timing on a shared CPU is no gate, so
only structure is asserted.
"""

import collections
import gzip
import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (DEVICE_STREAM, HOST_THREAD, Scenario,  # noqa: E402
                              TaskKind, graph_from_events, measure_wallclock,
                              simulate, trace_measured)
from repro_torch.core.trace import PACE_CALLS, host_span_s  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import init_params, make_train_step  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

MAIN, AUTOGRAD, GPU = (100, 1), (100, 2), (0, 7)


def _ev(cat, name, where, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": where[0],
            "tid": where[1], "ts": ts, "dur": dur, "args": args}


EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 100, "args": {"name": "python"}},
    _ev("user_annotation", "mlp", MAIN, 0, 30),
    _ev("cpu_op", "aten::mm", MAIN, 2, 20, **{
        "Sequence number": 7, "Fwd thread id": 0,
        "Input Dims": [[4, 8], [8, 16]], "Input type": ["float", "float"]}),
    _ev("cuda_runtime", "cudaLaunchKernel", MAIN, 5, 4, correlation=11),
    _ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", AUTOGRAD,
        50, 40, **{"Sequence number": 7, "Fwd thread id": 1}),
    _ev("cpu_op", "MmBackward0", AUTOGRAD, 51, 38,
        **{"Sequence number": 7, "Fwd thread id": 1}),
    _ev("cpu_op", "aten::mm", AUTOGRAD, 52, 30, **{
        "Input Dims": [[8, 4], [4, 16]], "Input type": ["float", "float"]}),
    _ev("cuda_runtime", "cudaLaunchKernel", AUTOGRAD, 60, 5, correlation=12),
    _ev("user_annotation", "update", MAIN, 200, 30),
    _ev("cpu_op", "aten::add_", MAIN, 202, 10, **{
        "Input Dims": [[16], [16], []],
        "Input type": ["float", "float", "Scalar"]}),
    _ev("cuda_runtime", "cudaLaunchKernel", MAIN, 204, 3, correlation=13),
    _ev("cuda_runtime", "cudaStreamSynchronize", MAIN, 240, 100, correlation=14),
    _ev("kernel", "gemm_fwd", GPU, 10, 40, correlation=11, stream=7),
    _ev("kernel", "gemm_bwd", GPU, 66, 50, correlation=12, stream=7),
    _ev("kernel", "add_kernel", GPU, 208, 20, correlation=13, stream=7),
    {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 11, "pid": 0, "tid": 7,
     "ts": 10, "bp": "e"},
]


@pytest.fixture(scope="module")
def graph():
    return graph_from_events(EVENTS)


def test_tasks_durations_gaps_layers_phases(graph):
    got = {t.name + ("" if t.thread == DEVICE_STREAM else f"@{t.uid}"):
           (t.thread, t.kind, round(t.duration * 1e6, 9), round(t.gap * 1e6, 9),
            t.layer, t.phase)
           for t in graph.tasks()}
    host, dev = HOST_THREAD, DEVICE_STREAM
    assert got == {
        "cudaLaunchKernel@0": (host, TaskKind.HOST, 4, 0, "mlp", "fwd"),
        # the untraced host time to the next record (9 -> 60)
        "untraced host@1": (host, TaskKind.HOST, 51, 0, "mlp", "fwd"),
        "cudaLaunchKernel@2": (host, TaskKind.HOST, 5, 0, "mlp", "bwd"),
        "untraced host@3": (host, TaskKind.HOST, 139, 0, "mlp", "bwd"),
        "cudaLaunchKernel@4": (host, TaskKind.HOST, 3, 0, "update", "update"),
        "untraced host@5": (host, TaskKind.HOST, 33, 0, "update", "update"),
        # the wait is the edge: 340 - max(240, end of add_kernel 228)
        "cudaStreamSynchronize@6": (host, TaskKind.SYNC, 100, 0, None, "fwd"),
        "gemm_fwd": (dev, TaskKind.COMPUTE, 40, 0, "mlp", "fwd"),
        "gemm_bwd": (dev, TaskKind.COMPUTE, 50, 0, "mlp", "bwd"),
        "add_kernel": (dev, TaskKind.COMPUTE, 20, 0, "update", "update"),
    }


def test_edges_of_all_four_kinds(graph):
    name = {t.uid: (t.name if t.thread == DEVICE_STREAM else f"h{t.uid}")
            for t in graph.tasks()}
    edges = {(name[t.uid], name[c.uid]) for t in graph.tasks()
             for c in graph.children(t)}
    assert edges == {
        ("h0", "h1"), ("h1", "h2"), ("h2", "h3"), ("h3", "h4"),      # host order
        ("h4", "h5"), ("h5", "h6"),
        ("gemm_fwd", "gemm_bwd"), ("gemm_bwd", "add_kernel"),        # stream order
        ("h0", "gemm_fwd"), ("h2", "gemm_bwd"), ("h4", "add_kernel"),  # launches
        ("add_kernel", "h6"),                                         # sync
    }
    graph.toposort()


def test_costs_from_the_launching_operator(graph):
    cost = {t.name: (t.flops, t.bytes_accessed, t.attrs["op"])
            for t in graph.tasks() if t.thread == DEVICE_STREAM}
    assert cost == {
        # (4, 8) @ (8, 16): 2*4*8*16 FLOPs; reads 4*(32 + 128), writes 4*64
        "gemm_fwd": (1024.0, 896.0, "aten::mm"),
        "gemm_bwd": (1024.0, 896.0, "aten::mm"),
        # add_ reads two (16,) f32 tensors and writes the first
        "add_kernel": (0.0, 192.0, "aten::add_"),
    }


def test_simulated_timeline(graph):
    """Daydream's engine (paper Algorithm 1, the reference's ``simulate``)
    releases a task's children at its end plus its gap; the launches have no
    gap, so each kernel is ready when its launch ends, and only the next
    record waits for the untraced host time.  Relative to the first record
    (5 us) the capture starts the kernels at 5, 61 and 203 us and the sync at
    235 us: the simulation puts each kernel 1 us earlier (the launch latency,
    which the graph does not carry), the sync where the capture has it, and
    spans the capture's 335 us (5 to 340)."""
    res = simulate(graph)
    start = {t.name: round(res.start[t.uid] * 1e6, 9) for t in graph.tasks()
             if t.thread == DEVICE_STREAM or t.kind == TaskKind.SYNC}
    assert start == {"gemm_fwd": 4, "gemm_bwd": 60, "add_kernel": 202,
                     "cudaStreamSynchronize": 235}
    assert res.makespan == pytest.approx(335e-6, abs=1e-12)


def test_nested_runtime_record_is_part_of_the_outer_one():
    inner = _ev("cuda_driver", "cuLaunchKernelEx", MAIN, 6, 2, correlation=21)
    kernel = _ev("kernel", "k2", GPU, 12, 3, correlation=21)
    g = graph_from_events(EVENTS + [inner, kernel])
    host = g.lane_tasks(HOST_THREAD)
    assert [t.name for t in host][:3] == ["cudaLaunchKernel", "untraced host",
                                          "cudaLaunchKernel"]
    k2 = next(t for t in g.tasks() if t.name == "k2")
    assert host[0] in g.parents(k2)


def test_route_follows_the_device_not_the_capture():
    """A CUDA capture in which CUPTI traced nothing raises instead of being
    read as a CPU step; the operator route is taken only on the CPU."""
    host_only = [e for e in EVENTS if e.get("cat") != "kernel"]
    with pytest.raises(ValueError, match="no kernel"):
        graph_from_events(host_only)
    with pytest.raises(ValueError, match="device"):
        graph_from_events(EVENTS, device="tpu")
    g = graph_from_events(host_only, device="cpu")
    assert [t.name for t in g.tasks()] == ["aten::mm", "aten::mm", "aten::add_"]
    assert all(t.thread == DEVICE_STREAM for t in g.tasks())


# ----------------------------------------------- a launch queue that fills (C6)
def _blocked(ts, dur, wait_from, wait_to, corr):
    """A launch that blocked on a full command buffer: its record and the
    overhead event CUPTI writes for the wait (Kineto's pid -1, tid 0)."""
    return [_ev("cuda_runtime", "cudaLaunchKernel", MAIN, ts, dur, correlation=corr),
            _ev("overhead", "Command Buffer Full", (-1, 0), wait_from,
                wait_to - wait_from)]


# k1..k5 run back to back from t = 4 us, 100 us each; the host launches two,
# then each further launch waits until the kernel two back has finished (its
# wait ends 2 us after that kernel), and after the last launch the host runs
# 290 us of its own (untraced) until a final non-launching record
QUEUE = [
    _ev("cuda_runtime", "cudaLaunchKernel", MAIN, 0, 4, correlation=1),
    _ev("cuda_runtime", "cudaLaunchKernel", MAIN, 6, 4, correlation=2),
    *_blocked(12, 98, 14, 106, 3),      # released by k1 (ends 104)
    *_blocked(112, 98, 114, 206, 4),    # by k2 (204)
    *_blocked(212, 98, 214, 306, 5),    # by k3 (304)
    _ev("cuda_runtime", "cudaFuncGetAttributes", MAIN, 600, 2, correlation=6),
    *(_ev("kernel", f"k{i}", GPU, 4 + 100 * (i - 1), 100, correlation=i, stream=7)
      for i in range(1, 6)),
]
NEVER_WAITS = [e for e in QUEUE if e.get("cat") != "overhead"]


def _named_edges(g):
    name = {t.uid: (t.name if t.thread == DEVICE_STREAM else f"h{t.uid}")
            for t in g.tasks()}
    return {(name[t.uid], name[c.uid]) for t in g.tasks() for c in g.children(t)}


def test_waiting_launch_is_released_by_the_kernel_that_freed_the_queue():
    g = graph_from_events(QUEUE)
    host = g.lane_tasks(HOST_THREAD)
    assert [t.name for t in host] == ["cudaLaunchKernel", "untraced host"] * 5 \
        + ["cudaFuncGetAttributes"]
    released = {(p.name, f"h{t.uid}") for t in host for p in g.parents(t)
                if p.thread == DEVICE_STREAM}
    assert released == {("k1", "h4"), ("k2", "h6"), ("k3", "h8")}
    assert {("k1", "h4"), ("h0", "k1"), ("h8", "k5")} <= _named_edges(g)
    g.toposort()


def test_waiting_launch_keeps_only_its_own_issue_time():
    g = graph_from_events(QUEUE)
    us = [round(t.duration * 1e6, 9) for t in g.lane_tasks(HOST_THREAD)]
    # each blocked launch: its end (110, 210, 310) less its release (104, 204, 304)
    assert us == [4, 2, 4, 2, 6, 2, 6, 2, 6, 290, 2]


def test_queue_capture_simulates_to_its_span():
    res = simulate(graph_from_events(QUEUE))
    assert res.makespan == pytest.approx(602e-6, abs=1e-12)


def test_halving_the_device_now_shortens_the_step():
    """With the waits on device -> host edges, the host is released when the
    halved kernels finish: 452 us (k3 ends at 154, the last launch at 160,
    then the host's own 290 + 2 us).  With the waits kept as host time (the
    graph without the wait events) the host lane still takes 602 us."""
    def halved(events):
        g = graph_from_events(events)
        for t in g.lane_tasks(DEVICE_STREAM):
            t.duration /= 2
        return simulate(g).makespan
    assert halved(QUEUE) == pytest.approx(452e-6, abs=1e-12)
    assert halved(NEVER_WAITS) == pytest.approx(602e-6, abs=1e-12)


def test_capture_that_never_waits_builds_todays_graph():
    """No wait event: every record keeps its whole duration, the only
    device -> host edges are synchronising calls' (none here), and the
    hand-written capture above (no wait either) is pinned exactly by the
    tests before these."""
    g = graph_from_events(NEVER_WAITS)
    us = [round(t.duration * 1e6, 9) for t in g.lane_tasks(HOST_THREAD)]
    assert us == [4, 2, 4, 2, 98, 2, 98, 2, 98, 290, 2]
    assert not any(p.thread == DEVICE_STREAM for t in g.lane_tasks(HOST_THREAD)
                   for p in g.parents(t))
    assert simulate(g).makespan == pytest.approx(602e-6, abs=1e-12)


def test_wait_in_untraced_time_moves_to_an_edge_too():
    """A wait that ends between two records is charged to the untraced host
    task there (after a non-launching record, that time becomes a task of
    its own for it)."""
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", MAIN, 0, 4, correlation=1),
        _ev("cuda_runtime", "cudaFuncGetAttributes", MAIN, 6, 2, correlation=2),
        _ev("overhead", "Command Buffer Full", (-1, 0), 10, 95),
        _ev("cuda_runtime", "cudaLaunchKernel", MAIN, 110, 4, correlation=3),
        _ev("kernel", "k1", GPU, 4, 100, correlation=1, stream=7),
        _ev("kernel", "k3", GPU, 114, 10, correlation=3, stream=7),
    ]
    g = graph_from_events(events)
    host = g.lane_tasks(HOST_THREAD)
    assert [(t.name, round(t.duration * 1e6, 9), round(t.gap * 1e6, 9))
            for t in host] == [("cudaLaunchKernel", 4, 0), ("untraced host", 2, 0),
                               ("cudaFuncGetAttributes", 2, 0),
                               # 110 less the release (k1 ends at 104)
                               ("untraced host", 6, 0), ("cudaLaunchKernel", 4, 0)]
    k1 = next(t for t in g.tasks() if t.name == "k1")
    assert host[3] in g.children(k1)
    assert simulate(g).makespan == pytest.approx(124e-6, abs=1e-12)


# ------------------------------------------------------ a capture from the card
@pytest.fixture(scope="module")
def card_capture():
    path = Path(__file__).resolve().parent / "data" / "kineto_smoke_step.json.gz"
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return events, graph_from_events(events)


def test_card_capture_graph(card_capture):
    _, g = card_capture
    g.toposort()
    dev = g.lane_tasks(DEVICE_STREAM)
    assert len(dev) > 500 and len(g.lane_tasks(HOST_THREAD)) > len(dev)
    assert {t.phase for t in dev} == {"fwd", "bwd", "update"}
    assert all(any(p.thread == HOST_THREAD for p in g.parents(t)) for t in dev)
    total = sum(t.duration for t in dev)
    mapped = sum(t.duration for t in dev if t.layer is not None)
    assert mapped >= 0.9 * total
    assert {t.layer for t in dev if t.phase == "update"} == {"update"}
    assert {"attn", "mlp", "norm", "loss", "embed"} <= {t.layer for t in dev
                                                        if t.phase == "bwd"}


def test_card_capture_never_waited(card_capture):
    """The smoke step's host never filled the launch queue: no wait event,
    and no host task but a synchronising call has a device parent."""
    events, g = card_capture
    assert not any(e.get("name") == "Command Buffer Full" for e in events)
    assert all(t.kind == TaskKind.SYNC for t in g.lane_tasks(HOST_THREAD)
               if any(p.thread == DEVICE_STREAM for p in g.parents(t)))


def test_card_capture_simulates_to_its_span(card_capture):
    events, g = card_capture
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    span = (max(e["ts"] + e["dur"] for e in host) - min(e["ts"] for e in host)) * 1e-6
    assert simulate(g).makespan == pytest.approx(span, rel=0.01)


def test_card_capture_fused_optimizer(card_capture):
    _, g = card_capture
    pred, tf, _ = Scenario(graph=g).evaluate("fused_optimizer")
    left = [t for t in tf.graph.tasks() if t.phase == "update"]
    fused = [t for t in left if t.thread == DEVICE_STREAM]
    launches = [t for t in left if t.kind == TaskKind.HOST]
    assert [t.name for t in fused] == ["fused_optimizer_kernel"]
    assert len(launches) == 1 and launches[0] in tf.graph.parents(fused[0])
    assert pred.predicted < pred.baseline


# ------------------------------------------------ trace_measured on the CPU
@pytest.fixture(scope="module")
def cpu_bundle():
    cfg = get_smoke_config("tinyllama-1.1b").with_(dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    opt = AdamW()
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, seq_len=16, batch=2, step=0).items()}
    step = make_train_step(cfg, opt)
    return trace_measured(step, state, batch, device="cpu", warmup=1), step, \
        (state, batch)


def test_cpu_trace_structure(cpu_bundle):
    bundle, _, _ = cpu_bundle
    g = bundle.graph
    g.toposort()                                  # acyclic
    tasks = g.tasks()
    assert tasks and all(t.thread == DEVICE_STREAM for t in tasks)
    assert {t.phase for t in tasks} == {"fwd", "bwd", "update"}
    layers = collections.Counter(t.layer for t in tasks)
    assert {"embed", "norm", "attn", "mlp", "loss", "update"} <= set(layers)
    assert all(t.layer == "update" for t in tasks if t.phase == "update")
    assert bundle.module and bundle.aggregates["device_tasks"] == len(tasks)
    assert simulate(g).makespan > 0


def test_cpu_trace_fused_optimizer_removes_the_update(cpu_bundle):
    bundle, _, _ = cpu_bundle
    n_update = sum(t.phase == "update" for t in bundle.graph.tasks())
    assert n_update > 1
    pred, tf, _ = Scenario(graph=bundle.graph, cost=bundle.cost).evaluate(
        "fused_optimizer")
    left = [t for t in tf.graph.tasks() if t.phase == "update"]
    assert [t.name for t in left] == ["fused_optimizer_kernel"]
    assert len(tf.graph) == len(bundle.graph) - n_update + 1
    assert pred.predicted < pred.baseline


def test_cpu_trace_costs_each_operator_from_its_own_shapes(cpu_bundle):
    """On the CPU route every matrix product is a task of its own, with the
    FLOPs of its own recorded shapes (2·M·N·K) and the reference's ``dot``
    opcode, so AMP divides it by the matrix-product factor; no task comes
    from a view or an allocation."""
    from repro_torch.core.kineto import NO_WORK
    bundle, _, _ = cpu_bundle
    tasks = bundle.graph.tasks()
    dots = [t for t in tasks if t.name in ("aten::mm", "aten::addmm", "aten::bmm")]
    assert len(dots) > 10 and {t.name for t in dots} >= {"aten::mm", "aten::bmm"}
    assert all(t.flops > 0 and t.attrs["opcode"] == "dot" for t in dots)
    assert not [t.name for t in tasks if t.name in NO_WORK]
    _, tf, _ = Scenario(graph=bundle.graph, cost=bundle.cost).evaluate("amp")
    after = {t.uid: t.duration for t in tf.graph.tasks()}
    assert all(after[t.uid] == pytest.approx(t.duration / 3) for t in dots)
    adds = [t for t in tasks if t.name == "aten::add_"]
    assert adds and all(after[t.uid] == pytest.approx(t.duration / 2) for t in adds)


def test_host_span_of_a_capture():
    # the first host-side record (aten::mm at 2 us) to the end of the sync (340)
    assert host_span_s(EVENTS) == pytest.approx(338e-6, abs=1e-12)


def test_trace_measured_keeps_the_fastest_capture():
    """Of three profiled calls, the one the host ran slowest (a 50 ms stall
    between two operators) is not the one the graph is built from."""
    a = torch.ones(8)
    calls = []

    def step():
        calls.append(None)
        b = a + 1
        if len(calls) == 2:                      # the first profiled call
            time.sleep(0.05)
        return b * 2

    bundle = trace_measured(step, device="cpu", warmup=1, profiles=3)
    assert len(calls) == 4
    assert bundle.aggregates["slowest_span_s"] >= 0.05
    assert bundle.aggregates["span_s"] < 0.05
    assert host_span_s(bundle.module) == bundle.aggregates["span_s"]


def test_scale_host_lane_scales_host_tasks_and_gaps_only():
    """``scale_host_lane`` multiplies each host task's duration and gap by
    the scale and leaves the device tasks; a host-bound graph's makespan
    falls by the host's share."""
    from repro_torch.core.kineto import scale_host_lane
    g = graph_from_events(EVENTS)
    before = {t.uid: (t.thread, t.duration, t.gap) for t in g.tasks()}
    assert scale_host_lane(g, 0.5) is g
    for t in g.tasks():
        thread, dur, gap = before[t.uid]
        want = 0.5 if thread == HOST_THREAD else 1.0
        assert (t.duration, t.gap) == (dur * want, gap * want)
    assert simulate(g).makespan < simulate(graph_from_events(EVENTS)).makespan


def test_a_capture_s_own_key_reads_back_unscaled(tmp_path):
    """A capture document with ``CAPTURE_KEY`` (what ``trace_measured``
    saves: its issue time) reads back as the graph of its events, host lane
    unscaled, with or without the key."""
    from repro_torch.core.kineto import CAPTURE_KEY
    from repro_torch.traceio.torch_profiler import read_torch_profiler
    want = graph_from_events(EVENTS)
    host = {t.uid: (t.duration, t.gap) for t in want.lane_tasks(HOST_THREAD)}
    for key in (False, True):
        doc = {"schemaVersion": 1, "traceEvents": EVENTS}
        if key:
            doc[CAPTURE_KEY] = {"issue_s": 1e-3}
        path = tmp_path / f"w{key}.pt.trace.json"
        path.write_text(json.dumps(doc))
        g, _, _ = read_torch_profiler(str(path))
        assert {t.uid: (t.duration, t.gap) for t in g.lane_tasks(HOST_THREAD)} == host


def test_trace_measured_counts_its_calls_and_scales_nothing_on_cpu():
    """On the CPU the operators are the device's work: no unprofiled pace
    calls even when asked, host scale 1; ``calls`` counts warm-up and
    captures, and each capture carries its issue time under
    ``CAPTURE_KEY``."""
    from repro_torch.core.kineto import CAPTURE_KEY
    from repro_torch.core.trace import profile_trace
    a = torch.ones(8)
    calls = []

    def step():
        calls.append(None)
        return (a + 1) * 2

    bundle = trace_measured(step, device="cpu", warmup=2, profiles=2,
                            pace_calls=PACE_CALLS)
    agg = bundle.aggregates
    assert len(calls) == agg["calls"] == 4
    assert agg["host_scale"] == 1.0 and agg["unprofiled_issue_s"] is None
    assert agg["issue_s"] > 0
    assert profile_trace(step, device="cpu")[CAPTURE_KEY]["issue_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("pace_calls", [0, PACE_CALLS])
def test_trace_measured_reports_the_host_scale_on_cuda(pace_calls):
    """On the card ``trace_measured`` times ``pace_calls`` calls without the
    profiler and reports the median of their issue times over the kept
    capture's host-lane total (at most 1) as the host scale, leaving the
    graph as captured; without pace calls the scale is 1.  ``calls`` counts
    every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    a = torch.ones(1 << 10, device="cuda")
    calls = []

    def step():
        calls.append(None)
        for _ in range(50):
            a.add_(1.0)

    bundle = trace_measured(step, device="cuda", warmup=1, profiles=2,
                            pace_calls=pace_calls)
    agg = bundle.aggregates
    assert len(calls) == agg["calls"] == 3 + pace_calls
    lane = sum(t.duration + t.gap for t in bundle.graph.lane_tasks(HOST_THREAD))
    assert lane == pytest.approx(agg["host_lane_s"])
    if pace_calls:
        assert 0 < agg["host_scale"] <= 1.0
        assert agg["host_scale"] == pytest.approx(min(
            1.0, agg["unprofiled_issue_s"] / agg["host_lane_s"]))
    else:
        assert agg["host_scale"] == 1.0 and agg["unprofiled_issue_s"] is None


def test_measure_wallclock_on_cpu(cpu_bundle):
    _, step, args = cpu_bundle
    assert measure_wallclock(step, *args, device="cpu", iters=2, warmup=0) > 0
