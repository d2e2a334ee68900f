"""repro_torch's hybrid family (RecurrentGemma: RG-LRU recurrent blocks and
local-window attention, recurrentgemma-9b) against the JAX package, and the
flash kernel's local ``window``.

The JAX model is initialised with ``PRNGKey(0)`` for the recurrentgemma-9b
smoke config (4 layers = one (rec, rec, attn) group + one recurrent tail
layer; d_model 64, 4 heads of 16, one KV head, window 8, d_rnn 64) in
float32, its params converted with ``params_from_jax``, and the same numpy
inputs go through both.  Unless a test states otherwise, outputs must agree
within ``atol = 1e-4 * max|reference|`` and the loss within ``rtol 1e-5``
(f32 sums taken in another order: the port's scan doubles where the
reference's ``associative_scan`` takes its own tree).  The full config is
only ever built on meta tensors.

On the CPU the flash wrapper runs its plain version
(``ref.flash_attention_ref``), which is held here against the reference's
``chunked_attention(window=)``; the CUDA kernel's window is held against
that plain version by the ``gpu``-marked test and by ``chip_smoke.py``.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro import data as jax_data  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro_torch.configs import (SHAPES, cells, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import (opt_state_from_jax, params_from_jax,  # noqa: E402
                                 params_to_jax)
from repro_torch.core import DEVICE_STREAM, trace_compiled  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import cost as kernel_cost  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import (active_params, build_model,  # noqa: E402
                                cache_axes, cache_seq_axes, count_params,
                                init_cache, init_params, loss_and_grads,
                                make_train_step)
from repro_torch.models import rglru  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
CSRC = Path(flash_kernel.__file__).resolve().parent.parent / "csrc"
bf16 = torch.bfloat16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol_of_max=1e-4):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol_of_max * np.abs(want).max())


def _named(tree, prefix=""):
    """{dotted path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}{k}."))
    return out


def _close_trees(got, want, rtol_of_max=1e-4):
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=rtol_of_max * np.abs(w).max(),
                                   err_msg=name)


def _models(arch=ARCH, dtype="float32", seed=0, **kw):
    """(jax model, jax params, port config, port params) of the smoke
    config with ``kw`` set."""
    jcfg = jax_configs.get_smoke_config(arch).with_(dtype=dtype, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch).with_(dtype=dtype, **kw)
    return jmodel, jparams, cfg, params_from_jax(cfg, jax.device_get(jparams),
                                                 device="cpu")


@pytest.fixture(scope="module")
def smoke():
    return _models()


def _x(d, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in b.items()}


def _rnn0(smoke):
    """Group 0's first recurrent sub-block's RG-LRU params, reference and port."""
    _, jparams, _, params = smoke
    return (jax.tree.map(lambda t: t[0], jparams["blocks"]["rec1"]["rnn"]),
            params["blocks"][0]["rec1"]["rnn"])


def _port_cache_as_reference(cache, n_blocks):
    """The port's cache list as the reference's ``{"groups", "tail"}`` tree,
    stacked on a leading axis."""
    def stack(entries):
        if isinstance(entries[0], dict):
            return {k: stack([e[k] for e in entries]) for k in entries[0]}
        return torch.stack(entries)
    return {"groups": stack(cache[:n_blocks]), "tail": stack(cache[n_blocks:])}


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("S", [37, 2], ids=["S37", "shorter-than-the-conv"])
def test_rglru_forward_with_state_matches_reference(smoke, S):
    """``rglru_forward(return_state=True)``: the output, the float32 state
    ``h`` after the last position and the conv tail (the last 3 pre-conv
    rows, left-padded when S < 3)."""
    jp, pp = _rnn0(smoke)
    x = _x(smoke[2].d_model, 2, S, 1)
    jout, jcache = jax_rglru.rglru_forward(jp, jnp.asarray(x), return_state=True)
    out, cache = rglru.rglru_forward(pp, torch.from_numpy(x), return_state=True)
    _close(out, jout)
    assert sorted(cache) == ["conv", "h"] and cache["h"].dtype == torch.float32
    _close(cache["h"], jcache["h"])
    _close(cache["conv"], jcache["conv"])
    assert cache["conv"].shape == (2, rglru.CONV_K - 1, pp["w_in"].shape[1])


def test_rglru_decode_steps_match_reference_and_the_forward(smoke):
    """Five ``rglru_decode`` steps from a forward's state over 10 tokens:
    each output and the final cache against the reference's decode, and
    each output against the port's own forward over all 15 tokens."""
    jp, pp = _rnn0(smoke)
    x = _x(smoke[2].d_model, 2, 15, 2)
    _, jcache = jax_rglru.rglru_forward(jp, jnp.asarray(x[:, :10]), return_state=True)
    _, cache = rglru.rglru_forward(pp, torch.from_numpy(x[:, :10]), return_state=True)
    full = rglru.rglru_forward(pp, torch.from_numpy(x))
    jdec = jax.jit(jax_rglru.rglru_decode)
    for t in range(10, 15):
        jout, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        out, cache = rglru.rglru_decode(pp, torch.from_numpy(x[:, t:t + 1]), cache)
        _close(out, jout)
        _close(out, full[:, t:t + 1])
    _close(cache["h"], jcache["h"])
    _close(cache["conv"], jcache["conv"])


def test_scan_stays_finite_where_the_decays_sum_past_float32():
    """The doubling scan against the step-by-step recurrence at 4096 steps
    where ``log_a`` sums to about -22700: ``exp(cumsum(log_a))`` underflows
    to 0 there (and its inverse overflows), the log-domain combine does not."""
    g = torch.Generator().manual_seed(0)
    log_a = torch.full((1, 4096, 3), -8.0 * float(np.log(2.0)))
    log_a[..., 1] = -1e-3
    b = torch.randn(1, 4096, 3, generator=g)
    assert torch.exp(-torch.cumsum(log_a, 1)).isinf().any()
    h = rglru._scan(log_a, b)
    want, state = torch.empty_like(b), torch.zeros(1, 3)
    for t in range(4096):
        state = torch.exp(log_a[:, t]) * state + b[:, t]
        want[:, t] = state
    assert torch.isfinite(h).all()
    _close(h, want, 1e-5)


# ---------------------------------------------------- windowed attention
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_windowed_flash_plain_version_matches_chunked_attention(causal):
    """``ops.flash_attention(window=8)`` on CPU tensors (the plain version)
    against the reference's ``chunked_attention(window=8)`` at S = 37 with
    GQA (4 query heads, one KV head), chunks of 16 keys."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 37, h, 16)).astype(np.float32) for h in (4, 1, 1))
    want = jax_attention.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=8, chunk=16)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=8).transpose(1, 2)
    _close(got, want)
    assert torch.equal(ref.flash_attention_ref(tq, tk, tv, causal=causal, window=8),
                       got.transpose(1, 2))
    assert not torch.equal(got, ops.flash_attention(tq, tk, tv, causal=causal)
                           .transpose(1, 2))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_windowed_flash_backward_matches_autograd_of_the_plain_version(causal,
                                                                       monkeypatch):
    """``flash_attention_bwd(window=8)`` in chunks of 4 query rows (each
    reading keys from its first row's first, ``q0 - 7``) against autograd
    of ``flash_attention_ref(window=8)`` over the whole sequence."""
    monkeypatch.setattr(ref, "BWD_SCORE_ELEMS", 4 * 2 * 4 * 37)
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(s, generator=g) for s in
                   ((2, 4, 37, 16), (2, 1, 37, 16), (2, 1, 37, 16), (2, 4, 37, 16)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal, window=8), leaves, do)
    got = ref.flash_attention_bwd(q, k, v, do, causal=causal, window=8)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def test_windowed_pairs_count_only_the_kept_keys():
    """``kernel_cost.flash_attention(window=)`` counts the (query, key) pairs
    the mask keeps, causal or not, by brute force at small sizes; the
    bound at recurrentgemma's training shape is about window / S of the
    full causal one."""
    for S in (1, 7, 8, 9, 37):
        for causal in (True, False):
            for window in (0, 1, 3, 8, 40):
                q, kk = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
                keep = np.ones((S, S), bool)
                if causal:
                    keep &= kk <= q
                if window:
                    keep &= q - kk < window
                flops, nbytes = kernel_cost.flash_attention(1, 1, 1, S, 16, causal=causal,
                                                            window=window, itemsize=4)
                assert flops == 2.0 * 32 * keep.sum()
                assert nbytes == 4.0 * 4 * S * 16
    full = kernel_cost.flash_attention(1, 16, 1, 4096, 256)[0]
    local = kernel_cost.flash_attention(1, 16, 1, 4096, 256, window=2048)[0]
    assert local / full == pytest.approx((2048 * 2049 / 2 + 2048 * 2048)
                                         / (4096 * 4097 / 2))


# --------------------------------------------------------- kernel plumbing
def _cases():
    """Inputs of both kernels: bf16 aligned at head dims 64, 128, 80 and
    256 (the tensor-core kernel's), f32 and an odd head dim (the CUDA-core
    kernel's)."""
    def bshd(B, H, KH, S, D, dt=bf16):
        return tuple(torch.zeros(B, S, h, D, dtype=dt).transpose(1, 2)
                     for h in (H, KH, KH))
    return [bshd(4, 32, 4, 512, 64), bshd(2, 4, 2, 256, 128), bshd(1, 8, 2, 96, 80),
            bshd(2, 32, 4, 64, 64, torch.float32), bshd(4, 16, 1, 512, 256),
            bshd(1, 2, 1, 64, 12)]


def _fake_kernels(monkeypatch) -> list:
    """The compiled kernels replaced by a fake that records (variant,
    causal, window) per launch; every tensor pretends to lie on the card."""
    calls = []

    def fake(variant):
        def fn(*args):
            calls.append((variant, args[11], args[12]))
            return 0
        return fn, lambda err: b""

    monkeypatch.setattr(flash_kernel, "_fn", fake)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls


def test_variant_with_a_window_is_the_cuda_core_kernel(monkeypatch):
    """A window no longer chooses the kernel: only the CUDA-core kernel's
    inputs (f32, an odd head dim) take it with a window, and the
    tensor-core kernel's (bf16 aligned, head dims up to 256) keep theirs,
    window 0 or not."""
    want = ["wgmma", "wgmma", "wgmma", "scalar", "wgmma", "scalar"]
    calls = _fake_kernels(monkeypatch)
    for (q, k, v), w in zip(_cases(), want):
        assert flash_kernel._variant(q, k, v) == w
        for window in (0, 8):
            flash_kernel.flash_attention(q, k, v, window=window)
            assert calls[-1] == (w, 1, window)
    ops.reset_launch_counts()


def _entry(source: str) -> str:
    """The C entry point's declaration, from its name to its body."""
    text = (CSRC / source).read_text()
    start = re.search(r"int repro_flash_attention\w*_fwd\(", text).start()
    return text[start:text.index("{", start)]


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_wgmma.cu"])
def test_both_entry_points_take_the_wrappers_arguments(source, monkeypatch):
    """Each kernel's C entry point declares as many parameters as ``_fn``
    gives its ctypes binding, ``int window`` right after ``int causal``."""
    sig = _entry(source)
    params = [p.strip() for p in sig[sig.index("(") + 1:sig.rindex(")")].split(",")]
    assert [p.split()[-1] for p in params[11:13]] == ["causal", "window"]
    assert params[12].startswith("int ")
    bound = {}

    class Lib:
        def __getattr__(self, name):
            fn = bound.setdefault(name, SimpleNamespace())
            return fn

    monkeypatch.setattr(flash_kernel._build, "load", lambda name: Lib())
    flash_kernel._fn.cache_clear()
    try:
        variant = "scalar" if source == "flash_attention.cu" else "wgmma"
        fn, _ = flash_kernel._fn(variant)
        assert len(fn.argtypes) == len(params)
    finally:
        flash_kernel._fn.cache_clear()


def test_tensor_core_entry_point_refuses_a_window():
    """The tensor-core kernel's entry point refuses only a negative window,
    in its host check (no ``window != 0`` refusal is left), and hands the
    window to the bucket's launch right after ``causal``."""
    text = (CSRC / "flash_attention_wgmma.cu").read_text()
    entry = text[text.index("int repro_flash_attention_wgmma_fwd("):]
    body = entry[entry.index("{") + 1:]
    check = body[:body.index("return (int)cudaErrorInvalidValue;")]
    assert "window != 0" not in body
    assert re.search(r"\|\| window < 0 \|\|", check)
    call = re.search(r"bucket\(([^;]*)\);", body)[1]
    args = [a.strip() for a in call.split(",")]
    assert args[args.index("causal") + 1] == "window"


def test_window_reaches_the_c_call_and_the_cuda_core_kernel(monkeypatch):
    """With the compiled kernels replaced by a fake: the window is the
    argument after ``causal`` of either kernel's C call, a windowed call
    launches ``"wgmma"`` where the tensor-core kernel takes the inputs and
    ``"scalar"`` where called so, and a negative window raises before any
    launch."""
    calls = _fake_kernels(monkeypatch)
    q, k, v = _cases()[0]
    ops.reset_launch_counts()
    flash_kernel.flash_attention(q, k, v)
    flash_kernel.flash_attention(q, k, v, window=8)
    flash_kernel.flash_attention(q, k, v, causal=False, window=2048)
    flash_kernel.flash_attention_scalar(q, k, v, window=3)
    with pytest.raises(ValueError, match="window"):
        flash_kernel.flash_attention(q, k, v, window=-1)
    assert calls == [("wgmma", 1, 0), ("wgmma", 1, 8), ("wgmma", 0, 2048),
                     ("scalar", 1, 3)]
    assert flash_kernel.launches_by_variant == {"wgmma": 3, "scalar": 1}
    ops.reset_launch_counts()


def test_meta_route_carries_the_window_into_the_analytical_price():
    """On meta tensors ``ops.flash_attention(window=)`` is one
    ``repro_torch::flash_attention`` operator with the window among its
    concrete inputs, and ``core.analytical`` prices it at the windowed
    pairs; no launch is counted."""
    from repro_torch.core import kineto
    from repro_torch.core.analytical import classify
    q = torch.empty(1, 64, 4, 16, device="meta").transpose(1, 2)
    k = torch.empty(1, 64, 1, 16, device="meta").transpose(1, 2)
    ops.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        o = ops.flash_attention(q, k, k, window=8)
    assert o.shape == q.shape and o.is_meta
    assert ops.launch_counts()["flash_attention"] == 0
    events = [kineto._Event(e) for e in _chrome_events(prof)
              if e.get("name") == "repro_torch::flash_attention"]
    assert len(events) == 1
    flops, _ = classify(events[0])[1:3]
    assert flops == kernel_cost.flash_attention(1, 4, 1, 64, 16, window=8,
                                                itemsize=4)[0]
    assert flops < kernel_cost.flash_attention(1, 4, 1, 64, 16, itemsize=4)[0]


def _chrome_events(prof):
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "t.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


# ------------------------------------------------------------ the model
def test_loss_and_gradients_match_reference(smoke):
    jmodel, jparams, cfg, params = smoke
    b = jax_data.make_batch(cfg, seq_len=37, batch=2, step=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, _jax(b))
    loss, grads = loss_and_grads(cfg, params, _torch(b))
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5)
    _close_trees(grads, params_from_jax(cfg, jax.device_get(jgrads), "cpu"))


def test_one_fused_adamw_train_step_matches_reference(smoke):
    """One step of ``make_train_step`` with the fused AdamW, JAX against the
    port: loss, grad norm, params and moments (test_torch_train.py's
    tolerances), count exact."""
    jmodel, jparams, cfg, params = smoke
    jopt, opt = jax_optim.AdamW(lr=1e-3, fused=True), AdamW(lr=1e-3, fused=True)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    b = jax_data.make_batch(cfg, seq_len=20, batch=2, step=1)
    jstate, jm = jax.jit(jax_make_train_step(jmodel.cfg, jopt))(jstate, _jax(b))
    state, m = make_train_step(cfg, opt)(state, _torch(b))
    np.testing.assert_allclose(_np(m["loss"]), _np(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(_np(m["grad_norm"]), _np(jm["grad_norm"]), rtol=1e-4)
    want = opt_state_from_jax(cfg, jax.device_get(jstate["opt"]), "cpu")
    assert int(state["opt"]["count"]) == int(want["count"]) == 1
    jp = _named(params_from_jax(cfg, jax.device_get(jstate["params"]), "cpu"))
    d = np.concatenate([np.abs(_np(got) - _np(jp[name])).ravel()
                        for name, got in _named(state["params"]).items()])
    assert d.max() <= 1e-4 and (d <= 1e-6).mean() >= 0.999, (d.max(), (d > 1e-6).mean())
    _close_trees(state["opt"]["m"], want["m"])
    _close_trees(state["opt"]["v"], want["v"], 1e-3)


@pytest.mark.parametrize("S", [5, 20], ids=["inside-the-window", "past-the-window"])
def test_prefill_and_decode_match_reference(smoke, S):
    """``prefill_fn`` (logits; every group's and the tail's cache, the K/V
    ring rolled past the window) and two ``decode_fn`` steps from it,
    against the reference's on its cache grown to the window (its engine
    does not grow a windowed cache)."""
    jmodel, jparams, cfg, params = smoke
    toks = _tokens(cfg, 2, S + 2, seed=1)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    model = build_model(cfg)
    t = torch.from_numpy(toks).long()
    logits, cache = model.prefill(params, {"tokens": t[:, :S]})
    _close(logits, jlogits)
    assert len(cache) == 2
    assert cache[0]["attn"]["k"].shape[1] == min(S, cfg.window)
    _close_trees(_port_cache_as_reference(cache, 1), jcache)
    grow = max(cfg.window - S, 0)
    jcache["groups"]["attn"] = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, grow), (0, 0), (0, 0)]),
        jcache["groups"]["attn"])
    cache = ServeEngine(cfg, params, max_seq=64, device="cpu")._grow_cache(cache, S)
    decode = jax.jit(jmodel.decode)
    for i in range(2):
        jlogits, jcache = decode(jparams, jcache, jnp.asarray(toks[:, S + i:S + i + 1]),
                                 jnp.asarray(S + i, jnp.int32))
        logits, cache = model.decode(params, cache, t[:, S + i:S + i + 1], S + i)
        _close(logits, jlogits)
    _close_trees(_port_cache_as_reference(cache, 1), jcache)


@pytest.mark.parametrize("S", [5, 8, 12], ids=["inside", "at", "past"])
def test_decode_matches_prefill_of_one_more_token(S):
    """The port's decode of token S on its engine-grown prefill of S
    tokens against its own prefill of S + 1 tokens, inside, at and past
    the window of 8 (the ring wrapped)."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    t = torch.from_numpy(_tokens(cfg, 2, S + 1, seed=4)).long()
    model = build_model(cfg)
    full, _ = model.prefill(params, {"tokens": t})
    _, cache = model.prefill(params, {"tokens": t[:, :S]})
    cache = ServeEngine(cfg, params, max_seq=S + 1, device="cpu")._grow_cache(cache, S)
    dec, _ = model.decode(params, cache, t[:, S:], S)
    _close(dec, full)


@pytest.mark.parametrize("plen", [5, 20], ids=["inside-the-window", "wraps-the-ring"])
def test_engine_greedy_tokens_match_reference(smoke, plen):
    """The engine's greedy tokens on a left-padded batch equal the JAX
    model's prefill followed by greedy decode steps (its windowed K/V grown
    to the window, as the port's engine grows it); at a 20-token prompt
    the ring has wrapped before the first decode step."""
    jmodel, jparams, cfg, params = smoke
    rng = np.random.default_rng(plen)
    prompts = [[int(x) for x in rng.integers(1, cfg.vocab, n)] for n in (plen, plen - 2)]
    n_new = 10
    got = ServeEngine(cfg, params, max_seq=48, device="cpu").generate(
        [Request(p, n_new) for p in prompts])
    toks = np.zeros((2, plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    logits, cache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    grow = max(cfg.window - plen, 0)
    cache["groups"]["attn"] = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, grow), (0, 0), (0, 0)]),
        cache["groups"]["attn"])
    decode = jax.jit(jmodel.decode)
    want = []
    for i in range(n_new):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(nxt))
        if i < n_new - 1:
            logits, cache = decode(jparams, cache, nxt, jnp.asarray(plen + i, jnp.int32))
    assert [r.tokens for r in got] == np.concatenate(want, axis=1).tolist()


def test_dense_block_with_a_window_matches_reference():
    """A dense config with ``window=8`` (tinyllama's smoke config): prefill
    logits and its ring cache at 12 tokens, and a decode step on the cache
    grown to the window, against the reference's."""
    jmodel, jparams, cfg, params = _models("tinyllama-1.1b", window=8)
    toks = _tokens(cfg, 2, 13, seed=6)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :12])})
    model = build_model(cfg)
    t = torch.from_numpy(toks).long()
    logits, cache = model.prefill(params, {"tokens": t[:, :12]})
    _close(logits, jlogits)
    for i, layer in enumerate(cache):
        assert layer["k"].shape[1] == 8
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])
    loss, _ = loss_and_grads(cfg, params, _torch(jax_data.make_batch(cfg, seq_len=12,
                                                                     batch=2, step=0)))
    jloss = jmodel.loss(jparams, _jax(jax_data.make_batch(cfg, seq_len=12, batch=2,
                                                          step=0)))
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5)
    jlogits, _ = jax.jit(jmodel.decode)(jparams, jcache, jnp.asarray(toks[:, 12:]),
                                        jnp.asarray(12, jnp.int32))
    cache = ServeEngine(cfg, params, max_seq=32, device="cpu")._grow_cache(cache, 12)
    logits, _ = model.decode(params, cache, t[:, 12:], 12)
    _close(logits, jlogits)


# ---------------------------------------------------------------- caches
def test_cache_dtypes_shapes_and_sequence_axes():
    """In the bf16 config: ``h`` float32 (the reference's spec), ``conv``
    and the K/V ring bfloat16, the ring ``min(max_seq, window)`` long, one
    entry per group and per tail layer; ``cache_seq_axes`` nests as a
    group's cache, and the prefill's cache has the spec's dtypes."""
    cfg = get_smoke_config(ARCH)
    jspec = jax_model.cache_spec(jax_configs.get_smoke_config(ARCH), 2, 6)
    for max_seq, ring in ((6, 6), (900, 8)):
        cache = init_cache(cfg, 2, max_seq, "cpu")
        assert len(cache) == 2
        got = {k: (tuple(t.shape), t.dtype) for k, t in _named(cache[0]).items()}
        assert got == {
            "rec1.conv": ((2, 3, 64), bf16), "rec1.h": ((2, 64), torch.float32),
            "rec2.conv": ((2, 3, 64), bf16), "rec2.h": ((2, 64), torch.float32),
            "attn.k": ((2, ring, 1, 16), bf16), "attn.v": ((2, ring, 1, 16), bf16)}
        assert {k: (tuple(t.shape), t.dtype) for k, t in cache[1].items()} == {
            "conv": ((2, 3, 64), bf16), "h": ((2, 64), torch.float32)}
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name) for k, v in _named(
        jspec, "").items()}
    port = {**{f"groups.{k}": (tuple(t.shape), str(t.dtype)[6:]) for k, t in
               _named(init_cache(cfg, 2, 6, "cpu")[0]).items()},
            **{f"tail.{k}": (tuple(t.shape), str(t.dtype)[6:]) for k, t in
               init_cache(cfg, 2, 6, "cpu")[1].items()}}
    assert port == want
    axes = {"rec1": {"conv": None, "h": None}, "rec2": {"conv": None, "h": None},
            "attn": {"k": 1, "v": 1}}
    assert cache_seq_axes(cfg) == axes
    assert cache_axes(cfg) == [axes, {"conv": None, "h": None}]
    assert cache_axes(get_smoke_config("tinyllama-1.1b")) == [{"k": 1, "v": 1}] * 2
    params = init_params(cfg, seed=0, device="cpu")
    _, pre = build_model(cfg).prefill(params, {"tokens": torch.ones(2, 11, dtype=torch.long)})
    assert pre[0]["rec1"]["h"].dtype == pre[1]["h"].dtype == torch.float32
    assert pre[0]["attn"]["k"].dtype == pre[0]["rec1"]["conv"].dtype == bf16


def test_engine_cache_bytes_do_not_grow_past_the_window():
    """The engine's grown cache holds the same bytes at max_seq 16 and 4096
    (a ring of the window and constant states), and a 12-token prefill's
    rolled ring and states arrive whole."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    _, pre = build_model(cfg).prefill(params, {"tokens": torch.arange(1, 25).view(2, 12)})
    sizes = []
    for max_seq in (16, 4096):
        grown = ServeEngine(cfg, params, max_seq=max_seq, device="cpu")._grow_cache(pre, 12)
        sizes.append(sum(t.numel() * t.element_size()
                         for entry in grown for t in _named(entry).values()))
        for got, want in zip(grown, pre):
            g, w = _named(got), _named(want)
            assert sorted(g) == sorted(w) and all(torch.equal(g[k], w[k]) for k in w)
    assert sizes[0] == sizes[1]


def test_engine_refuses_a_nested_constant_leaf_of_another_shape():
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    engine = ServeEngine(cfg, None, max_seq=10, device="cpu")
    prefix = init_cache(cfg, 2, 4, "cpu")
    prefix[0]["rec2"]["h"] = prefix[0]["rec2"]["h"][:, :1]
    with pytest.raises(ValueError, match="rec2.h"):
        engine._grow_cache(prefix, 4)


# --------------------------------------------------------------- params
def test_conversion_round_trip_keeps_the_gate_biases_and_lambda_float32():
    """A bf16 JAX init converted both ways: ``b_a``, ``b_i`` and ``lam``
    stay float32 and every other leaf bfloat16, 1 group and 1 tail layer,
    values kept exactly (``==``)."""
    jcfg = jax_configs.get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = jax.device_get(jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(1)))
    params = params_from_jax(cfg, jparams, device="cpu")
    names = _named(params)
    assert len(params["blocks"]) == 1 and len(params["tail"]) == 1
    assert "blocks.0.attn.attn.wq" in names and "tail.0.rnn.lam" in names
    for k, t in names.items():
        want = (torch.float32 if k.rsplit(".", 1)[-1] in ("b_a", "b_i", "lam")
                else bf16)
        assert t.dtype == want, k
    back = params_to_jax(cfg, params)
    again = params_from_jax(cfg, back, device="cpu")
    jflat = _named(jparams)
    assert sorted(_named(back)) == sorted(jflat)
    for k, t in _named(back).items():
        assert np.array_equal(t, np.asarray(jflat[k], np.float32)), k
    for k, t in _named(again).items():
        assert t.dtype == names[k].dtype and torch.equal(t, names[k])


def test_init_layout_dtypes_and_scales_match_reference():
    """Same tree, shapes and dtypes as the JAX init at smoke size; the gate
    biases and ``lam`` zeros, the conv at std 0.5 and the projections at
    the reference's fan-in rule."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    jspec = jax_build_model(jax_configs.get_smoke_config(ARCH)).init(None)
    for key in ("blocks", "tail"):
        want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
                for k, v in _named(jspec[key]).items()}
        for lp in params[key]:
            assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                    _named(lp).items()} == want
    r = params["blocks"][0]["rec1"]["rnn"]
    assert not r["b_a"].any() and not r["b_i"].any() and not r["lam"].any()
    for t, want_std in ((r["conv"], 0.5), (r["w_in"], cfg.d_model ** -0.5),
                        (r["w_a"], cfg.d_rnn ** -0.5)):
        assert abs(t.float().std().item() / want_std - 1) < 0.15


def test_full_config_on_meta_tensors_matches_reference():
    """At full width on meta tensors: 12 groups and 2 tail layers, every
    leaf's shape and dtype the reference's spec-mode init's,
    ``count_params`` 10,444,877,824 (the reference's), its four cells
    (``long_500k`` included) registered."""
    cfg = get_config(ARCH)
    jcfg = jax_configs.get_config(ARCH)
    params = init_params(cfg, device="meta")
    spec = jax_build_model(jcfg).init(None)
    assert (len(params["blocks"]), len(params["tail"])) == (12, 2)
    for key in ("blocks", "tail"):
        want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
                for k, v in _named(spec[key]).items()}
        for lp in (params[key][0], params[key][-1]):
            assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                    _named(lp).items()} == want
    assert all(t.is_meta for t in _named(params).values())
    assert count_params(cfg) == jax_model.count_params(jcfg) == 10_444_877_824
    assert active_params(cfg) == jax_model.active_params(jcfg)
    assert sorted(s for a, s in cells() if a == ARCH) == sorted(SHAPES)


# ------------------------------------------------------ analytical route
def test_trace_compiled_of_the_hybrid_train_step():
    """The smoke hybrid step on meta tensors: one windowed
    ``repro_torch::flash_attention`` per group, RMSNorm 2 per sub-block and
    the final norm, one fused_adam, nothing counted as launched; the
    ``rglru`` scope in both phases."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, device="meta")
    opt = AdamW(fused=True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    batch = {k: torch.from_numpy(v).to("meta")
             for k, v in make_batch(cfg, seq_len=64, batch=1, step=0).items()}
    ops.reset_launch_counts()
    bundle = trace_compiled(make_train_step(cfg, opt), state, batch)
    dev = bundle.graph.lane_tasks(DEVICE_STREAM)
    kernels = {k: sum(t.attrs.get("kernel") == k for t in dev)
               for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    assert kernels == {"flash_attention": cfg.n_layers // 3,
                       "rmsnorm": 2 * cfg.n_layers + 1, "fused_adam": 1, "dgc_mask": 0}
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    flash = [t for t in dev if t.attrs.get("kernel") == "flash_attention"]
    assert {t.flops for t in flash} == {
        kernel_cost.flash_attention(1, 4, 1, 64, 16, window=8)[0]}
    assert {t.phase for t in dev if t.layer == "rglru"} == {"fwd", "bwd"}


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_kernel_matches_its_plain_version_on_the_card(cuda, causal, dtype):
    """Both kernels with a window against ``flash_attention_ref(window=)``:
    ``ops.flash_attention`` (the tensor-core kernel in bf16, the CUDA-core
    kernel in f32) and ``flash_attention_scalar``, at head dims 16 to 256
    (q/k 256 with v 128 too), KH 1 and 2, S not a multiple of 64 or 128,
    windows whose edge falls inside a 64-key tile (1, 63, 65, 300) and
    windows of S or more."""
    g = torch.Generator(device=cuda).manual_seed(0)
    atol = {torch.float32: 2e-3, torch.bfloat16: 3e-2}[dtype]
    variant = "wgmma" if dtype == torch.bfloat16 else "scalar"
    for B, H, KH, S, D, Dv, window in (
            (2, 4, 1, 37, 16, 16, 8), (1, 16, 1, 300, 256, 256, 64),
            (1, 4, 2, 130, 64, 64, 1), (1, 8, 1, 200, 128, 128, 256),
            (1, 4, 1, 333, 256, 256, 1), (1, 4, 2, 333, 256, 256, 63),
            (1, 4, 1, 333, 256, 256, 65), (1, 4, 2, 700, 256, 256, 300),
            (1, 4, 1, 200, 256, 256, 200), (1, 4, 2, 200, 256, 256, 500),
            (1, 4, 1, 333, 256, 128, 65), (1, 4, 2, 257, 192, 128, 63)):
        q, k, v = (torch.randn(B, S, h, d, generator=g, device=cuda).to(dtype)
                   .transpose(1, 2) for h, d in ((H, D), (KH, D), (KH, Dv)))
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        before = dict(flash_kernel.launches_by_variant)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert flash_kernel.launches_by_variant[variant] == before[variant] + 1
        assert (got.float() - want.float()).abs().max() <= atol
        got = flash_kernel.flash_attention_scalar(q, k, v, causal=causal, window=window)
        assert (got.float() - want.float()).abs().max() <= atol


def test_a_fused_step_leaves_no_param_holding_the_flat_update_vector():
    """After a fused AdamW step on the mixed-dtype hybrid model (``b_a``,
    ``b_i``, ``lam`` float32 among bfloat16 leaves), every param's storage
    is its own size: a view of the step's flat f32 vector would keep one
    f32 copy of every parameter alive (the 3-layer step on the card ran out
    of memory so)."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    opt = AdamW(fused=True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    b = {k: torch.from_numpy(v).long()
         for k, v in make_batch(cfg, seq_len=16, batch=1, step=0).items()}
    state, _ = make_train_step(cfg, opt)(state, b)
    for name, t in _named(state["params"]).items():
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
    assert state["params"]["tail"][0]["rnn"]["lam"].dtype == torch.float32
