"""repro_torch's modeled optimizations: the twin of ``tests/test_whatif.py``.

``TestDirections`` asks the reference's nine direction questions of a graph
from the port's analytical route: a small LM-style step written in PyTorch
(embedding, two GELU MLP blocks under ``blk0/mlp`` and ``blk1/mlp`` scopes,
tied unembedding and cross-entropy under ``loss``, an SGD update under
``update``), run on meta tensors by ``trace_compiled``.

``test_amp_analogue_prediction_on_gpu`` is the card's twin of the
reference's CPU precision analogue (f64 -> f32 there): a chain of matrix
products and tanh in f32 traced on the card, AMP (paper Algorithm 3, its
3x / 2x factors) predicted on the trace, and the same chain measured in f32
and in bf16; the prediction must be within the reference's 0.75 of the
measured speedup.  It is marked ``gpu`` and skips without CUDA.

This file imports no JAX, so ``pytest -m gpu tests/test_torch_whatif.py``
runs on a machine with a card and no JAX.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from repro_torch.core import (TaskKind, measure_wallclock, simulate,  # noqa: E402
                              trace_compiled, trace_measured, whatif)

D, FF, V, BS, SQ = 64, 256, 512, 4, 32


def _loss(W, toks, labels):
    x = F.embedding(toks, W["emb"])
    for i in range(2):
        with record_function(f"blk{i}/mlp"):
            h = F.gelu(x @ W["w1"])
            x = x + h @ W["w2"]
    with record_function("loss"):
        logits = x @ W["emb"].T
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))


def _step(W, toks, labels):
    leaves = [w.detach().requires_grad_() for w in W.values()]
    with torch.enable_grad():
        grads = torch.autograd.grad(_loss(dict(zip(W, leaves)), toks, labels), leaves)
    with torch.no_grad(), record_function("update"):
        return {k: w - 1e-3 * g for (k, w), g in zip(W.items(), grads)}


@pytest.fixture(scope="module")
def lm_bundle():
    meta = {"device": "meta"}
    W = {"emb": torch.empty(V, D, **meta), "w1": torch.empty(D, FF, **meta),
         "w2": torch.empty(FF, D, **meta)}
    toks = torch.zeros(BS, SQ, dtype=torch.long, **meta)
    return trace_compiled(_step, W, toks, toks)


class TestDirections:
    def test_amp_speeds_up(self, lm_bundle):
        base = lm_bundle.simulate().makespan
        opt = whatif.what_if_amp(lm_bundle.graph).simulate().makespan
        assert opt < base

    def test_bandwidth_scaling_monotone(self, lm_bundle):
        g = whatif.what_if_distributed(
            lm_bundle.graph, {"blk0": 1e6, "blk1": 1e6}, num_workers=8).graph
        base = simulate(g).makespan
        faster = whatif.what_if_bandwidth(g, 4.0).simulate().makespan
        slower = whatif.what_if_bandwidth(g, 0.25).simulate().makespan
        assert faster <= base <= slower

    def test_dgc_reduces_comm(self, lm_bundle):
        g = whatif.what_if_distributed(
            lm_bundle.graph, {"blk0": 50e6, "blk1": 50e6},
            num_workers=32).graph
        base = simulate(g).makespan
        dgc = whatif.what_if_dgc(g, compression=0.01).simulate().makespan
        assert dgc < base

    def test_straggler_slows(self, lm_bundle):
        g = whatif.what_if_distributed(
            lm_bundle.graph, {"blk0": 1e6}, num_workers=8).graph
        base = simulate(g).makespan
        s = whatif.what_if_straggler(g, slowdown=2.0).simulate().makespan
        assert s > base

    def test_zero_replaces_allreduce(self, lm_bundle):
        g = whatif.what_if_distributed(
            lm_bundle.graph, {"blk0": 8e6, "blk1": 8e6}, num_workers=16).graph
        tf = whatif.what_if_zero(g, num_workers=16)
        colls = [t.attrs.get("collective") for t in tf.graph.tasks()
                 if t.kind == TaskKind.COLLECTIVE]
        assert "all-reduce" not in colls
        assert "reduce-scatter" in colls and "all-gather" in colls

    def test_blueconnect_decomposes(self, lm_bundle):
        g = whatif.what_if_distributed(
            lm_bundle.graph, {"blk0": 32e6}, num_workers=16).graph
        tf = whatif.what_if_blueconnect(g, [("data", 4), ("model", 4)])
        names = [t.name for t in tf.graph.tasks()]
        assert any("reduce-scatter" in n for n in names)
        assert any("all-gather" in n for n in names)
        tf.graph.validate()

    def test_p3_priority_helps_at_low_bandwidth(self, lm_bundle):
        grads = {"blk0": 20e6, "blk1": 20e6}
        bw = 1e9
        plain = whatif.what_if_p3(lm_bundle.graph, grads, 4, bandwidth=bw,
                                  priority=False).simulate().makespan
        prio = whatif.what_if_p3(lm_bundle.graph, grads, 4, bandwidth=bw,
                                 priority=True).simulate().makespan
        assert prio <= plain * 1.001

    def test_gist_and_offload_add_overhead(self, lm_bundle):
        base = lm_bundle.simulate().makespan
        act = {l: 4e6 for l in ("blk0", "blk1")}
        gist = whatif.what_if_gist(lm_bundle.graph, "blk",
                                   act).simulate().makespan
        off = whatif.what_if_offload(lm_bundle.graph, "blk",
                                     act).simulate().makespan
        assert gist >= base and off >= base

    def test_fused_norm_removes_tasks(self, lm_bundle):
        tf = whatif.what_if_fused_norm(lm_bundle.graph, norm_layer="mlp")
        assert len(tf.graph) <= len(lm_bundle.graph)


def test_the_step_graph_has_its_scopes(lm_bundle):
    """The what-ifs above select by these layers and phases."""
    dev = [t for t in lm_bundle.graph.tasks() if t.thread == "device"]
    assert {"blk0/mlp", "blk1/mlp", "loss", "update"} <= {t.layer for t in dev}
    assert {t.phase for t in dev} == {"fwd", "bwd", "update"}
    assert sum(t.attrs.get("opcode") == "dot" for t in dev) >= 5 * 3


@pytest.mark.gpu
def test_amp_analogue_prediction_on_gpu():
    """fp32 -> bf16 on the card: a chain of eight ``tanh(a @ w / k)`` with a
    (2^20, 128) and w (128, 128), so each kernel runs for well over the
    profiled host's time per launch and the products and the elementwise
    work take shares of the same order.  A chain of small kernels (the
    reference's square form at n = 1024) is host-bound under the profiler,
    and the trace keeps the profiled host's pace, which AMP does not divide,
    so its prediction stays at 1x (ROADMAP C5, C6).  Predicted from the f32
    chain's trace with AMP's default factors; measured in f32
    (``allow_tf32`` as it stands, off by default) and in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    m, k = 1 << 20, 128
    a32, w32 = torch.ones(m, k, device="cuda"), torch.ones(k, k, device="cuda")
    a16, w16 = a32.bfloat16(), w32.bfloat16()

    def chain(a, w):
        for _ in range(8):
            a = torch.tanh(a @ w * (1.0 / k))
        return a

    bundle = trace_measured(chain, a32, w32, device="cuda")
    base = bundle.simulate().makespan
    pred = base / whatif.what_if_amp(bundle.graph).simulate().makespan
    t32 = measure_wallclock(chain, a32, w32, device="cuda", iters=10)
    t16 = measure_wallclock(chain, a16, w16, device="cuda", iters=10)
    true = t32 / t16
    print(f"AMP analogue on the card: predicted {pred:.3f}x, measured {true:.3f}x "
          f"(f32 {t32 * 1e3:.3f} ms, bf16 {t16 * 1e3:.3f} ms, simulated f32 "
          f"{base * 1e3:.3f} ms)")
    assert pred > 1.0
    assert abs(pred - true) / true < 0.75, (pred, true)
