"""repro_torch.core.calibrate against the JAX package's repro.core.calibrate.

The hop-latency half of ``tests/test_traceio.py`` on the port (the formula,
its fallbacks and the plumbing into ring legs), ``==`` the reference; the
measuring half on the CPU (``device="cpu"``: three positive rates, a
``CostModel`` carrying them, the cache keyed by device); the default device
is CUDA and raises without it; a ``gpu``-marked test reads the card's rates
against its data sheet.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core.calibrate as ref_calibrate  # noqa: E402
import torch_synthgraphs as port_graphs  # noqa: E402
from repro_torch.core import (H100_SXM, ClusterGraph, CollectiveModel,  # noqa: E402
                              CostModel, whatif)
from repro_torch.core import calibrate  # noqa: E402
from repro_torch.core.calibrate import (calibrated_cost_model,  # noqa: E402
                                        hop_latency_from_measurement,
                                        measure_collective_bandwidth,
                                        measure_collective_hop_latency,
                                        measure_local_backend)

SIZE = 64          # a matrix product and an element-wise pass of 32k elements


def test_hop_latency_calibration_plumbing():
    """Measured hop latency flows CostModel -> CollectiveModel -> ring legs,
    the way compute calibration already flows into durations."""
    # formula: solve the ring model for hop
    n, bw, payload = 4, 8e9, 4096.0
    hop = 3e-6
    t = 2 * (n - 1) / n * payload / bw + 2 * (n - 1) * hop
    assert hop_latency_from_measurement(t, payload, n, bw) == \
        pytest.approx(hop, rel=1e-9)
    # degenerate inputs fall back to the analytical default
    assert hop_latency_from_measurement(t, payload, 1, bw) == \
        CollectiveModel.HOP_LATENCY
    assert measure_collective_hop_latency(1, device="cpu") == \
        CollectiveModel.HOP_LATENCY
    # plumbing: CostModel(hop_latency=...) reaches ring legs
    cost = CostModel(hop_latency=hop)
    assert cost.collectives.hop_latency == hop
    base = CostModel()
    assert base.collectives.hop_latency == CollectiveModel.HOP_LATENCY
    g = port_graphs.training_step_graph(layers=2)
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


@pytest.mark.parametrize("t_small, payload, n, bw", [
    (2.5e-5, 4096.0, 4, 8e9), (1e-6, 4096.0, 8, 1e9), (0.0, 4096.0, 4, 8e9),
    (3e-5, 4096.0, 1, 8e9), (7.7e-5, 1e6, 2, 4.5e11), (1e-4, 1.0, 16, 0.0)])
def test_hop_latency_from_measurement_equals_reference(t_small, payload, n, bw):
    assert hop_latency_from_measurement(t_small, payload, n, bw) == \
        ref_calibrate.hop_latency_from_measurement(t_small, payload, n, bw)


def test_one_device_collectives_are_the_analytical_defaults():
    assert measure_collective_bandwidth(device="cpu") == 8e9 == \
        ref_calibrate.measure_collective_bandwidth(1)
    assert measure_collective_hop_latency(device="cpu") == \
        ref_calibrate.measure_collective_hop_latency(1)
    with pytest.raises(ValueError, match="2 devices asked for"):
        measure_collective_bandwidth(2, device="cpu")


@pytest.mark.parametrize("dtype_str", ["float32", "bfloat16"])
def test_measure_local_backend_on_cpu(dtype_str):
    m = measure_local_backend(SIZE, dtype_str, device="cpu")
    assert set(m) == {"matmul_flops_per_s", "elementwise_bytes_per_s",
                      "op_overhead_s"}
    assert all(v > 0 for v in m.values()), m
    # cached per (size, dtype, device): the same dict back
    assert measure_local_backend(SIZE, dtype_str, device=torch.device("cpu")) is m


def test_time_is_the_median_after_warmups(monkeypatch):
    calls, ticks = [], iter([0, 3, 10, 11, 20, 29, 40, 42, 50, 57])
    monkeypatch.setattr(calibrate.time, "perf_counter", lambda: next(ticks))
    assert calibrate._time(lambda: calls.append(1), device="cpu") == 3
    assert len(calls) == 7                      # 2 warm-ups + 5 timed


def test_calibrated_cost_model_carries_the_measured_rates():
    m = measure_local_backend(SIZE, device="cpu")
    cost = calibrated_cost_model(device="cpu", size=SIZE)
    hw = cost.hw
    assert hw.name == "local-cpu"
    assert (hw.peak_flops, hw.hbm_bandwidth) == (m["matmul_flops_per_s"],
                                                 m["elementwise_bytes_per_s"])
    assert hw.op_overhead == m["op_overhead_s"] * 0.25
    assert hw.host_dispatch == m["op_overhead_s"]
    assert (hw.ici_bandwidth, hw.dcn_bandwidth) == (8e9, 8e9)
    assert cost.collectives.hop_latency == CollectiveModel.HOP_LATENCY
    assert cost.topo.axis_sizes == {"data": 1}
    assert cost.compute_time(1e9, 0.0) == pytest.approx(
        1e9 / hw.peak_flops + hw.op_overhead)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (measure_local_backend, calibrated_cost_model,
                 measure_collective_bandwidth, measure_collective_hop_latency):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_card_rates_within_the_data_sheet():
    """On the card: positive rates no higher than 1.05x the H100 data
    sheet (bf16 at a card-filling size; f32 off the tensor cores)."""
    bf16 = measure_local_backend(8192, "bfloat16")
    assert 0 < bf16["matmul_flops_per_s"] <= 1.05 * H100_SXM.peak_flops
    assert 0 < bf16["elementwise_bytes_per_s"] <= 1.05 * H100_SXM.hbm_bandwidth
    cost = calibrated_cost_model()
    assert cost.hw.name == "local-cuda" and cost.hw.op_overhead > 0
