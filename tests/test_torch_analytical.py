"""repro_torch's analytical trace route (``core.trace_compiled``): the train
step run on meta tensors, priced by the cost model, with no card.

Held against the reference's ``repro.core.trace_compiled`` (its HLO route)
and against a capture of the same step on the card
(``tests/data/kineto_smoke_step.json.gz``), at the tinyllama smoke size;
one test builds the full-width step (train_4k, micro-batch 2).

What is compared with the reference, and what is not: the matrix products
of the attention projections, the MLP and the unembedding are the same
computation in both packages, so their FLOPs must agree.  The attention
core is not compared: the reference runs masked XLA chunks
(``repro/models/attention.py:51``), the port a causal kernel forward (one
``repro_torch::flash_attention`` task, no matrix-product task) and a plain
f32 recompute backward in query chunks.  The reference is traced with
``remat="none"`` because the port's ``remat`` knob has no effect yet (it
keeps every activation); with the reference's default ``"full"`` its
backward also recomputes each layer's forward.
"""

import collections
import gzip
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro import data as jax_data  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.core import trace_compiled as jax_trace_compiled  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import (DEVICE_STREAM, H100_SXM, HOST_THREAD,  # noqa: E402
                              CostModel, TaskKind, graph_from_events, simulate,
                              trace_compiled)
from repro_torch.core.kineto import NO_WORK  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import cost as kernel_cost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import init_params, make_train_step  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

ARCH = "tinyllama-1.1b"
ROOT = Path(__file__).resolve().parents[1]
REF_KEYS = {"flops", "bytes", "collective_bytes", "collective_s", "compute_ops",
            "memory_ops", "collective_ops", "device_time_s"}


def _meta_step(cfg, seq, batch, fused):
    """(train step, meta state, meta batch) of ``cfg``."""
    params = init_params(cfg, device="meta")
    opt = AdamW(fused=fused)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    data = {k: torch.from_numpy(v).to("meta")
            for k, v in make_batch(cfg, seq_len=seq, batch=batch, step=0).items()}
    return make_train_step(cfg, opt), state, data


def _trace(cfg, seq, batch, fused, **kw):
    step, state, data = _meta_step(cfg, seq, batch, fused)
    return trace_compiled(step, state, data, **kw)


def _device(bundle):
    return bundle.graph.lane_tasks(DEVICE_STREAM)


def _dot_flops(tasks, key):
    out = collections.defaultdict(float)
    for t in tasks:
        if t.attrs.get("opcode") == "dot":
            out[key(t)] += t.flops
    return dict(out)


@pytest.fixture(scope="module")
def smoke_fused():
    cfg = get_smoke_config(ARCH)
    return cfg, _trace(cfg, 32, 2, fused=True)


# ------------------------------------------------------------ meta init
def test_meta_init_has_the_reference_spec_leaves():
    """``init_params(cfg, device="meta")`` at full width: the reference's
    ``init_params(cfg, None)`` SpecLeaf shapes and dtypes, leaf for leaf
    (the reference stacks the layers on a leading axis), with no storage."""
    cfg = get_config(ARCH)
    params = init_params(cfg, device="meta")
    spec = jax_build_model(jax_configs.get_config(ARCH)).init(None)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], tree

    ref = dict(leaves({k: v for k, v in spec.items() if k != "blocks"}))
    ref_block = dict(leaves(spec["blocks"]))
    got = dict(leaves({k: v for k, v in params.items() if k != "blocks"}))
    assert sorted(got) == sorted(ref)
    assert len(params["blocks"]) == cfg.n_layers
    pairs = [(got[k], ref[k].shape, ref[k].dtype) for k in ref]
    for lp in params["blocks"]:
        blk = dict(leaves(lp))
        assert sorted(blk) == sorted(ref_block)
        pairs += [(blk[k], ref_block[k].shape[1:], ref_block[k].dtype)
                  for k in ref_block]
    for t, shape, dtype in pairs:
        assert t.is_meta and tuple(t.shape) == tuple(shape)
        assert str(t.dtype).replace("torch.", "") == np.dtype(dtype).name
    assert all(v.shape[0] == cfg.n_layers for v in ref_block.values())


def test_meta_route_of_each_kernel():
    """Each kernel entry point on meta tensors: outputs of the right shape
    and dtype, one operator of its own in a capture, no launch counted."""
    bf = torch.bfloat16
    q = torch.empty(2, 16, 4, 8, dtype=bf, device="meta").transpose(1, 2)
    k = torch.empty(2, 16, 2, 8, dtype=bf, device="meta").transpose(1, 2)
    x, w = (torch.empty(s, dtype=bf, device="meta") for s in ((3, 5, 8), (8,)))
    p = torch.empty(100, device="meta")
    ops.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        o = ops.flash_attention(q, k, k)
        y = ops.rmsnorm(x, w)
        adam = ops.fused_adam(p, p.clone(), p.clone(), p.clone(), lr=1e-3, b1=0.9,
                              b2=0.95, eps=1e-8, wd=0.1, c1=0.1, c2=0.2)
        sparse, count = ops.dgc_mask(x, 0.5)
    assert (o.shape, o.stride(), o.dtype) == (q.shape, q.stride(), bf)
    assert (y.shape, y.dtype) == (x.shape, bf)
    assert adam[0] is p and all(t.is_meta for t in adam)
    assert (sparse.shape, sparse.dtype, count.shape, count.dtype) == \
        (x.shape, bf, (), torch.int64)
    names = collections.Counter(e.name for e in prof.events())
    for kern in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask"):
        assert names[f"repro_torch::{kern}"] == 1
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


# ----------------------------------------------------------- the graph
def test_kernel_tasks_and_no_view_tasks(smoke_fused):
    """One task per launch the card would make: L flash, 2L + 1 RMSNorm, one
    fused_adam and no DGC task; no task from a view or an allocation;
    every device task has a phase; host dispatch before, sync after."""
    cfg, bundle = smoke_fused
    dev = _device(bundle)
    kernels = collections.Counter(t.attrs.get("kernel") for t in dev)
    L = cfg.n_layers
    assert (kernels["flash_attention"], kernels["rmsnorm"], kernels["fused_adam"],
            kernels["dgc_mask"]) == (L, 2 * L + 1, 1, 0)
    assert not [t.name for t in dev if t.name in NO_WORK]
    assert all(t.name.startswith(("aten::", "repro_torch::")) for t in dev)
    assert all(t.phase in ("fwd", "bwd", "update") for t in dev)
    assert {t.phase for t in dev} == {"fwd", "bwd", "update"}
    assert {t.layer for t in dev if t.attrs.get("kernel") == "flash_attention"} == {"attn"}
    assert {t.layer for t in dev if t.attrs.get("kernel") == "rmsnorm"} == {"norm"}
    host = bundle.graph.lane_tasks(HOST_THREAD)
    assert [t.name for t in host] == ["host:dispatch", "host:sync"]
    assert host[0] in bundle.graph.parents(dev[0])
    assert dev[-1] in bundle.graph.parents(host[1])
    bundle.graph.toposort()


def test_durations_are_the_cost_model(smoke_fused):
    _, bundle = smoke_fused
    cm = CostModel(hw=H100_SXM)
    dev = _device(bundle)
    assert all(t.duration == cm.compute_time(t.flops, t.bytes_accessed) for t in dev)
    assert bundle.cost.hw is H100_SXM
    flash = next(t for t in dev if t.attrs.get("kernel") == "flash_attention")
    H, KH, D = 4, 2, 16
    assert (flash.flops, flash.bytes_accessed) == kernel_cost.flash_attention(
        2, H, KH, 32, D, causal=True, itemsize=2)
    assert simulate(bundle.graph).makespan == pytest.approx(
        sum(t.duration for t in dev) + bundle.cost.host_dispatch_time() + 1e-6)


def test_aggregates_carry_the_reference_keys(smoke_fused):
    _, bundle = smoke_fused
    agg, dev = bundle.aggregates, _device(bundle)
    assert set(agg) == REF_KEYS
    assert bundle.compiled is None and bundle.module
    assert agg["flops"] == pytest.approx(sum(t.flops for t in dev))
    assert agg["bytes"] == pytest.approx(sum(t.bytes_accessed for t in dev))
    assert agg["device_time_s"] == pytest.approx(sum(t.duration for t in dev))
    assert agg["compute_ops"] + agg["memory_ops"] == len(dev)
    assert agg["memory_ops"] == sum(t.kind == TaskKind.MEMORY for t in dev)
    assert agg["collective_ops"] == agg["collective_bytes"] == agg["collective_s"] == 0


def test_max_tasks_caps_the_graph_not_the_aggregates(smoke_fused):
    cfg, bundle = smoke_fused
    capped = _trace(cfg, 32, 2, fused=True, max_tasks=50)
    assert len(_device(capped)) == 50
    assert [t.name for t in _device(capped)] == [t.name for t in _device(bundle)[:50]]
    assert capped.aggregates == pytest.approx(bundle.aggregates)


def test_real_tensors_are_refused():
    cfg = get_smoke_config(ARCH)
    step, state, data = _meta_step(cfg, 16, 2, fused=True)
    data = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in data.items()}
    with pytest.raises(ValueError, match="meta"):
        trace_compiled(step, state, data)


def test_core_import_loads_no_trace_module():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core
        loaded = {m for m in sys.modules if m.startswith("repro_torch.core.")}
        bad = {"repro_torch.core." + n for n in ("trace", "kineto", "analytical")}
        assert not loaded & bad, loaded & bad
        from repro_torch.core import trace_compiled
        assert "repro_torch.core.analytical" in sys.modules
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ----------------------------------------------- FLOPs against the reference
# the reference's einsum names of the products compared, by the port's layer
_REF_DOTS = {"bsd,dhk->bshk": "attn", "bshk,hkd->bsd": "attn",
             "...d,df->...f": "mlp", "...f,fd->...d": "mlp", "bsd,vd->bsv": "loss"}


def test_matmul_flops_match_the_reference():
    """Smoke config, seq 32, micro-batch 2, per-leaf AdamW in both packages.
    Forward: the attention projections and the MLP, exactly.  Backward: the
    same plus the unembedding, within 1% (they are equal).  The unembedding's
    forward: the reference's compiled program computes its product three
    times, all in the backward's chunk loop (the checkpointed chunk's
    recompute, whose logits also give the loss, and the two gradients); the
    port computes it for the loss in the forward and again when the
    checkpoint recomputes the chunk, so its forward product equals the
    reference's recompute."""
    jcfg = jax_configs.get_smoke_config(ARCH).with_(scan_layers=False, remat="none")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = jax_optim.AdamW()
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in
              jax_data.make_batch(jcfg, seq_len=32, batch=2, step=0).items()}
    ref = jax_trace_compiled(jax_make_train_step(jcfg, jopt), jstate, jbatch)
    ref_flops = _dot_flops(
        ref.graph.tasks(),
        lambda t: (t.phase, _REF_DOTS.get(t.layer.split("/")[-1]),
                   "rematted_computation" in t.layer))

    cfg = get_smoke_config(ARCH)
    port = _dot_flops(_device(_trace(cfg, 32, 2, fused=False)),
                      lambda t: (t.phase, t.layer, t.name))
    for layer in ("attn", "mlp"):
        assert port[("fwd", layer, "aten::mm")] == ref_flops[("fwd", layer, False)]
    port_bwd = sum(port[("bwd", layer, "aten::mm")] for layer in ("attn", "mlp", "loss"))
    ref_bwd = sum(v for (phase, layer, _), v in ref_flops.items()
                  if phase == "bwd" and layer is not None)
    assert port_bwd == pytest.approx(ref_bwd, rel=0.01)
    assert port[("fwd", "loss", "aten::mm")] == ref_flops[("bwd", "loss", True)]
    assert ("fwd", "loss", False) not in ref_flops


def test_matmul_flops_match_the_card_capture():
    """Per (phase, layer), the matrix-product FLOPs of the meta step equal
    those the measured route reads from the card's capture of the same step
    (smoke config in bf16, seq 64, micro-batch 2, per-leaf AdamW;
    ``tests/data/capture_kineto.py``).  A few other operators take another
    form on meta tensors (in-place ``add_``/``exp_`` run as ``add``/``exp``,
    ``pow`` as ``mul``, the softmax backward as its elementwise parts), so
    the task counts differ a little; their ratio is printed."""
    path = ROOT / "tests" / "data" / "kineto_smoke_step.json.gz"
    with gzip.open(path, "rt") as f:
        card = graph_from_events(json.load(f)["traceEvents"]).lane_tasks(DEVICE_STREAM)
    meta = _device(_trace(get_smoke_config(ARCH), 64, 2, fused=False))
    key = lambda t: (t.phase, t.layer)  # noqa: E731
    got, want = _dot_flops(meta, key), _dot_flops(card, key)
    assert got == want and len(got) == 6
    print(f"device tasks: {len(meta)} on meta, {len(card)} kernels and copies "
          f"on the card (ratio {len(meta) / len(card):.3f})")


# ------------------------------------------------------------- full width
def test_full_width_step_against_the_closed_form():
    """tinyllama-1.1b at full width, train_4k (seq 4096), micro-batch 2,
    ``AdamW(fused=True)``: 22 flash, 45 RMSNorm and 1 fused_adam tasks, a
    phase on every device task, and the total FLOPs within 2% of the closed
    form behind ``chip_smoke.py``'s mfu (6·N·tokens plus causal attention
    forward and backward) once the closed form is given what the port does
    differently: the embedding gathers and the norms scale (no products for
    their 6·N·tokens),
    the loss chunk's checkpoint recomputes the unembedding product
    (2·N_emb·tokens more), and the attention backward recomputes in f32 over
    1024-row query chunks, each against every key up to its last row.  What
    is left is the elementwise operators' one FLOP per element."""
    cfg = get_config(ARCH)
    B, S, L = 2, 4096, cfg.n_layers
    H, D, V, d = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.vocab, cfg.d_model
    bundle = _trace(cfg, S, B, fused=True)
    dev = _device(bundle)
    kernels = collections.Counter(t.attrs.get("kernel") for t in dev)
    assert (kernels["flash_attention"], kernels["rmsnorm"], kernels["fused_adam"]) \
        == (22, 45, 1)
    assert all(t.phase is not None for t in dev)

    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        init_params(cfg, device="meta")))
    tokens, pairs = B * S, B * H * S * (S + 1) // 2
    closed = 6 * n_params * tokens + 3 * 4 * D * pairs * L
    rows = (1 << 28) // (B * H * S)               # ref.BWD_SCORE_ELEMS
    chunk_pairs = B * H * sum(rows * min(q0 + rows, S) for q0 in range(0, S, rows))
    port_attn = (4 * D * pairs + 6 * 2 * D * chunk_pairs) * L
    no_products = V * d + (2 * L + 1) * d          # embedding table, norm scales
    expected = closed - 6 * no_products * tokens + 2 * V * d * tokens \
        + port_attn - 3 * 4 * D * pairs * L
    dots = sum(t.flops for t in dev if t.attrs.get("opcode") == "dot")
    flash = sum(t.flops for t in dev if t.attrs.get("kernel") == "flash_attention")
    assert dots + flash == pytest.approx(expected, rel=1e-6)
    assert bundle.aggregates["flops"] == pytest.approx(expected, rel=0.02)
    print(f"full width: {len(dev)} device tasks, {bundle.aggregates['flops']:.6g} "
          f"FLOPs against the bare closed form {closed:.6g} "
          f"({bundle.aggregates['flops'] / closed - 1:+.2%}), simulated "
          f"{simulate(bundle.graph).makespan * 1e3:.3f} ms")
