"""repro_torch's ssm family (Mamba-2's SSD chunked scan and O(1) decode,
mamba2-2.7b) against the JAX package.

The JAX model is initialised with ``PRNGKey(0)`` for the mamba2-2.7b smoke
config (d_model 64, d_inner 128: 2 SSD heads of 64, ``ssm_state`` 16) in
float32, its params converted with ``params_from_jax``, and the same numpy
inputs go through both.  Unless a test states otherwise, outputs must agree
within ``atol = 1e-4 * max|reference|`` (f32 sums taken in another order:
the port batches the chunks the reference scans one by one).  The full
config is only ever built on meta tensors.

The port's one deliberate divergence is pinned here: the reference's
``where(causal, exp(seg), 0)`` has NaN gradients at the config's chunk of
128, the port's ``exp(where(causal, seg, -inf))`` has finite ones, equal to
the reference's wherever those are finite.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro import data as jax_data  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import (SHAPES, cells, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import (opt_state_from_jax, params_from_jax,  # noqa: E402
                                 params_to_jax)
from repro_torch.core import DEVICE_STREAM, TaskKind, trace_compiled  # noqa: E402
from repro_torch.core import kineto  # noqa: E402
from repro_torch.core.analytical import classify  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import perf_report  # noqa: E402
from repro_torch.models import (active_params, build_model,  # noqa: E402
                                cache_seq_axes, count_params, init_cache,
                                init_params, loss_and_grads, make_train_step)
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "mamba2-2.7b"
# the NaN trap's probe: the smoke config widened to 8 heads, 2 layers
PROBE = dict(d_model=256, n_heads=8, n_kv_heads=8, ssm_state=64)


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


def _models(dtype="float32", seed=0, **kw):
    """(jax model, jax params, port config, port params) of the smoke
    config with ``kw`` set."""
    jcfg = jax_configs.get_smoke_config(ARCH).with_(dtype=dtype, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    cfg = get_smoke_config(ARCH).with_(dtype=dtype, **kw)
    return jmodel, jparams, cfg, params_from_jax(cfg, jax.device_get(jparams),
                                                 device="cpu")


@pytest.fixture(scope="module")
def smoke():
    return _models()


def _layer0(smoke):
    _, jparams, _, params = smoke
    return (jax.tree.map(lambda t: t[0], jparams["blocks"]["ssm"]),
            params["blocks"][0]["ssm"])


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


def _batch(cfg, seq=16, batch=2, step=0):
    return jax_data.make_batch(cfg, seq_len=seq, batch=batch, step=step)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("chunk,S", [(4, 10), (5, 10), (128, 2), (3, 7)],
                         ids=["padded", "exact", "short", "odd"])
def test_mamba2_forward_with_state_matches_reference(smoke, chunk, S):
    """``mamba2_forward(return_state=True)``: the output, the final state
    and the conv tail (the last 3 pre-conv rows, left-padded when S < 3),
    at chunks that leave padding, divide S, exceed it, over several chunks."""
    jp, pp = _layer0(smoke)
    x = _x(smoke[2], 2, S, 1)
    jout, jcache = jax.jit(functools.partial(
        jax_ssm.mamba2_forward, chunk=chunk, return_state=True))(jp, jnp.asarray(x))
    out, cache = ssm.mamba2_forward(pp, torch.from_numpy(x), chunk=chunk,
                                    return_state=True)
    _close(out, jout)
    assert sorted(cache) == ["conv", "state"]
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])
    assert cache["conv"].shape == (2, ssm.CONV_K - 1, pp["wx"].shape[1])


@pytest.mark.parametrize("block,chunk,S", [(1, 4, 10), (2, 4, 10), (2, 3, 19), (3, 2, 13)],
                         ids=["one-chunk-blocks", "padded-last-block", "ragged", "odd"])
def test_mamba2_forward_in_blocks_of_chunks_matches_reference(smoke, monkeypatch,
                                                              block, chunk, S):
    """Above ``SSD_BLOCK_CHUNKS`` chunks the scan goes block by block with
    the state carried between blocks: output, state and conv tail still the
    reference's, and the gradient through the carried state finite."""
    jp, pp = _layer0(smoke)
    x = _x(smoke[2], 2, S, 3)
    jout, jcache = jax.jit(functools.partial(
        jax_ssm.mamba2_forward, chunk=chunk, return_state=True))(jp, jnp.asarray(x))
    monkeypatch.setattr(ssm, "SSD_BLOCK_CHUNKS", block)
    xt = torch.from_numpy(x).requires_grad_()
    out, cache = ssm.mamba2_forward(pp, xt, chunk=chunk, return_state=True)
    _close(out, jout)
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])
    (out.sum() + cache["state"].sum()).backward()
    assert torch.isfinite(xt.grad).all()


def test_one_closed_form_covers_8192_tokens_at_the_config_s_chunk():
    """A block is 64 chunks: the chip's train step (4096 tokens) and its
    8192-token context are one closed form each, at the config's chunk."""
    assert ssm.SSD_BLOCK_CHUNKS == 64
    assert ssm.SSD_BLOCK_CHUNKS * get_config(ARCH).ssm_chunk == 8192


def test_mamba2_decode_over_several_tokens_matches_reference(smoke):
    """Five ``mamba2_decode`` steps from a forward's state (S = 10, chunk
    4): each output and the final cache against the reference's."""
    jp, pp = _layer0(smoke)
    x = _x(smoke[2], 2, 15, 2)
    _, jcache = jax_ssm.mamba2_forward(jp, jnp.asarray(x[:, :10]), chunk=4,
                                       return_state=True)
    _, cache = ssm.mamba2_forward(pp, torch.from_numpy(x[:, :10]), chunk=4,
                                  return_state=True)
    jdec = jax.jit(jax_ssm.mamba2_decode)
    for t in range(10, 15):
        jout, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        out, cache = ssm.mamba2_decode(pp, torch.from_numpy(x[:, t:t + 1]), cache)
        _close(out, jout)
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])


def test_cache_spec_and_init_cache_match_reference():
    """The cache spec is the reference's (conv window and state, no
    sequence axis), ``init_cache`` makes it in the config's dtype whatever
    ``max_seq``, and ``cache_seq_axes`` finds no sequence axis in it (K/V's
    at 1)."""
    cfg = get_config(ARCH)
    spec = jax_transformer.ssm_cache_spec(jax_configs.get_config(ARCH), 3, 17)
    assert transformer.ssm_cache_spec(cfg, 3, 17) == {
        k: tuple(v.shape) for k, v in spec.items()} == {
        "conv": (3, 3, 5120), "state": (3, 80, 64, 128)}
    smoke_cfg = get_smoke_config(ARCH)
    for max_seq in (9, 900):
        cache = init_cache(smoke_cfg, 2, max_seq, "cpu")
        assert len(cache) == 2 and all(
            {k: (tuple(t.shape), t.dtype) for k, t in layer.items()}
            == {"conv": ((2, 3, 128), torch.bfloat16),
                "state": ((2, 2, 64, 16), torch.bfloat16)} for layer in cache)
    assert cache_seq_axes(smoke_cfg) == {"conv": None, "state": None}
    assert cache_seq_axes(get_smoke_config("tinyllama-1.1b")) == {"k": 1, "v": 1}
    assert cache_seq_axes(get_smoke_config("deepseek-v2-236b")) == {
        "c_kv": 1, "k_rope": 1}


# ------------------------------------------------------------ the model
def test_a_step_trains_after_an_inference_mode_prefill():
    """The causal masks are made once per size and device: made first under
    ``torch.inference_mode`` (the engine's prefill), they must still be
    saved for a training step's backward at the same chunk."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", ssm_chunk=7)
    params = init_params(cfg, seed=2, device="cpu")
    b = _torch(_batch(cfg, seq=21))
    with torch.inference_mode():
        build_model(cfg).prefill(params, {"tokens": b["tokens"]})
    loss, grads = loss_and_grads(cfg, params, b)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in _named(grads).values())


def test_block_apply_returns_the_number_zero_for_aux(smoke):
    _, _, cfg, params = smoke
    x = torch.from_numpy(_x(cfg, 2, 6, 3))
    out, aux = transformer.ssm_block_apply(cfg, params["blocks"][0], x, None, None)
    assert aux == 0.0 and isinstance(aux, float) and out.shape == x.shape


def test_loss_and_gradients_match_reference(smoke):
    jmodel, jparams, cfg, params = smoke
    b = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, _jax(b))
    loss, grads = loss_and_grads(cfg, params, _torch(b))
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5)
    _close_trees(grads, params_from_jax(cfg, jax.device_get(jgrads), "cpu"))


@pytest.mark.parametrize("fused", [False, True])
def test_one_adamw_train_step_matches_reference(smoke, fused):
    """One step of ``make_train_step`` with AdamW, JAX against the port,
    from the same params and batch: loss, grad norm, params and moments
    (test_torch_train.py's tolerances), count exact."""
    jmodel, jparams, cfg, params = smoke
    jopt = jax_optim.AdamW(lr=1e-3, fused=fused)
    opt = AdamW(lr=1e-3, fused=fused)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    b = _batch(cfg, step=1)
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


def test_prefill_and_decode_match_reference(smoke):
    """``prefill_fn`` (logits, every layer's cache) and one ``decode_fn``
    step from it, against the reference's."""
    jmodel, jparams, cfg, params = smoke
    S = 12
    toks = _tokens(cfg, 2, S + 1, seed=1)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    model = build_model(cfg)
    t = torch.from_numpy(toks).long()
    logits, cache = model.prefill(params, {"tokens": t[:, :S]})
    _close(logits, jlogits)
    assert len(cache) == cfg.n_layers
    for i, layer in enumerate(cache):
        for key in ("conv", "state"):
            _close(layer[key], jcache[key][i])
    jlogits, jcache = jax.jit(jmodel.decode)(
        jparams, jcache, jnp.asarray(toks[:, S:]), jnp.asarray(S, jnp.int32))
    logits, cache = model.decode(params, cache, t[:, S:], S)
    _close(logits, jlogits)
    for i, layer in enumerate(cache):
        for key in ("conv", "state"):
            _close(layer[key], jcache[key][i])


@pytest.mark.parametrize("S,chunk", [(12, 4), (12, 128), (2, 4)])
def test_decode_matches_prefill_of_one_more_token(S, chunk):
    """The port's decode of token S on its prefill of S tokens against its
    own prefill of S + 1 tokens: the same recurrence, within 1e-4 of the
    logits' largest magnitude (the reference's test holds it to 0.05)."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", ssm_chunk=chunk)
    params = init_params(cfg, seed=3, device="cpu")
    t = torch.from_numpy(_tokens(cfg, 2, S + 1, seed=4)).long()
    model = build_model(cfg)
    full, _ = model.prefill(params, {"tokens": t})
    _, cache = model.prefill(params, {"tokens": t[:, :S]})
    dec, _ = model.decode(params, cache, t[:, S:], S)
    _close(dec, full)


@pytest.fixture(scope="module")
def bf16():
    return _models("bfloat16")


def test_bf16_forward_matches_reference_bf16(bf16):
    """``mamba2_forward`` in bfloat16 (dt, the decays, ``seg``, ``L`` and the
    scores in float32; M, the state and the output in bfloat16, as the
    reference): output and state within 3e-2 of their largest magnitude.
    (XLA fuses element-wise chains in float32 where eager PyTorch rounds
    each operator's output to bfloat16: measured 0.74% of the output's
    largest magnitude apart.)"""
    jp = jax.tree.map(lambda t: t[0], bf16[1]["blocks"]["ssm"])
    pp = bf16[3]["blocks"][0]["ssm"]
    x = _x(bf16[2], 2, 20, 1)
    jout, jcache = jax_ssm.mamba2_forward(jp, jnp.asarray(x, jnp.bfloat16), chunk=8,
                                          return_state=True)
    out, cache = ssm.mamba2_forward(pp, torch.from_numpy(x).bfloat16(), chunk=8,
                                    return_state=True)
    assert out.dtype == cache["state"].dtype == torch.bfloat16
    _close(out, jnp.asarray(jout, jnp.float32), 3e-2)
    _close(cache["state"], jnp.asarray(jcache["state"], jnp.float32), 3e-2)


def test_bf16_model_is_as_close_to_float32_as_the_reference_s(smoke, bf16):
    """The smoke model's bf16 prefill logits, port and reference, each
    against the reference in float32: the port's error is no larger than
    the reference's own (2.9% against 7.3% of the largest logit here: two
    layers and the unembedding amplify the roundings above)."""
    toks = {"tokens": _tokens(bf16[2], 2, 20, seed=5)}
    want = _np(jax.jit(smoke[0].prefill)(smoke[1], _jax(toks))[0])
    ref16 = _np(jnp.asarray(jax.jit(bf16[0].prefill)(bf16[1], _jax(toks))[0], jnp.float32))
    got, cache = build_model(bf16[2]).prefill(bf16[3], _torch(toks))
    assert got.dtype == cache[0]["state"].dtype == torch.bfloat16
    assert np.abs(_np(got) - want).max() <= np.abs(ref16 - want).max()


# --------------------------------------------------------------- engine
def test_engine_greedy_tokens_match_recomputed_prefills():
    """``ServeEngine`` at 8 SSD heads with a 3-token prompt (shorter than
    the head count: a cache written into ``[:, :plen]`` would cut the
    state's head axis): each generated token equals the argmax of a fresh
    prefill of the tokens before it, and the engine's cache is the spec's
    size whatever ``max_seq``."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32", **PROBE)
    params = init_params(cfg, seed=1, device="cpu")
    prompts, n_new = [[5, 7, 9], [3]], 6
    engine = ServeEngine(cfg, params, max_seq=16, device="cpu")
    got = [r.tokens for r in engine.generate([Request(p, n_new) for p in prompts])]
    model = build_model(cfg)
    toks = torch.tensor([[5, 7, 9], [0, 0, 3]])
    gen = torch.tensor(got)
    for t in range(n_new):
        logits, _ = model.prefill(params, {"tokens": torch.cat([toks, gen[:, :t]], 1)})
        assert logits.argmax(-1).tolist() == gen[:, t].tolist(), t
    pre = model.prefill(params, {"tokens": toks})[1]
    for max_seq in (16, 4096):
        grown = ServeEngine(cfg, params, max_seq=max_seq, device="cpu")._grow_cache(pre, 3)
        for layer, p in zip(grown, pre):
            for key in ("conv", "state"):
                assert torch.equal(layer[key], p[key])


def test_engine_refuses_a_constant_leaf_of_another_shape():
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    engine = ServeEngine(cfg, None, max_seq=10, device="cpu")
    prefix = init_cache(cfg, 2, 4, "cpu")
    prefix[1]["state"] = prefix[1]["state"][:, :1]
    with pytest.raises(ValueError, match="state"):
        engine._grow_cache(prefix, 4)


def test_engine_greedy_tokens_match_reference(smoke):
    """The engine's tokens on a left-padded batch equal the JAX model's
    prefill followed by greedy decode steps."""
    jmodel, jparams, cfg, params = smoke
    prompts, n_new = [[3, 5, 7, 9, 11, 13], [2, 4, 6, 8]], 8
    got = ServeEngine(cfg, params, max_seq=32, device="cpu").generate(
        [Request(p, n_new) for p in prompts])
    toks = np.zeros((2, 6), np.int32)
    for i, p in enumerate(prompts):
        toks[i, 6 - len(p):] = p
    logits, cache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    decode = jax.jit(jmodel.decode)
    want = []
    for i in range(n_new):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(nxt))
        if i < n_new - 1:
            logits, cache = decode(jparams, cache, nxt, jnp.asarray(6 + i, jnp.int32))
    assert [r.tokens for r in got] == np.concatenate(want, axis=1).tolist()


# ------------------------------------------------------------- the trap
@pytest.fixture(scope="module")
def probe_grads():
    """{chunk: (reference grads, port grads)} of the probe config's loss on
    1 x 256 tokens, float32, ``PRNGKey(0)``."""
    out = {}
    toks = _tokens(get_smoke_config(ARCH), 1, 257, seed=0)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for chunk in (128, 32):
        jmodel, jparams, cfg, params = _models(ssm_chunk=chunk, **PROBE)
        jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, _jax(b))
        loss, grads = loss_and_grads(cfg, params, {k: torch.from_numpy(v).long()
                                                   for k, v in b.items()})
        np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5)
        out[chunk] = (_named(params_from_jax(cfg, jax.device_get(jgrads), "cpu")),
                      _named(grads))
    return out


def test_reference_gradient_is_nan_at_chunk_128_and_the_port_s_is_finite(probe_grads):
    """The reference's ``where(causal, exp(seg), 0)`` overflows above the
    diagonal at chunk 128 (``seg`` reaches ~100 with this init): NaN
    gradients (pinned: the reference is not to be edited).  The port's
    masked exponential: every gradient finite, equal to the reference's on
    the leaves where those are finite."""
    want, got = probe_grads[128]
    nan = [k for k, g in want.items() if not np.isfinite(_np(g)).all()]
    assert nan, "the reference's gradients are all finite at chunk 128"
    assert all(torch.isfinite(g).all() for g in got.values())
    for k in sorted(set(want) - set(nan)):
        _close(got[k], want[k])


def test_gradients_agree_at_chunk_32(probe_grads):
    """At chunk 32 ``seg`` stays in range: both finite and equal."""
    want, got = probe_grads[32]
    assert all(np.isfinite(_np(g)).all() for g in want.values())
    _close_trees(got, want)


# --------------------------------------------------------------- params
def test_conversion_round_trip_keeps_dt_bias_a_log_and_d_float32_in_bf16():
    """A bf16 JAX init converted both ways: ``dt_bias``, ``A_log`` and ``D``
    stay float32, every other leaf bfloat16, values kept; the depth read
    from a stacked leaf (an ssm block has no ``ln1``)."""
    jcfg = jax_configs.get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = jax.device_get(jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(1)))
    params = params_from_jax(cfg, jparams, device="cpu")
    names = _named(params)
    assert "blocks.1.ln.scale" in names and len(params["blocks"]) == 2
    for k, t in names.items():
        want = (torch.float32 if k.rsplit(".", 1)[-1] in ("dt_bias", "A_log", "D")
                else torch.bfloat16)
        assert t.dtype == want, k
    back = params_to_jax(cfg, params)
    again = params_from_jax(cfg, back, device="cpu")
    jflat = _named(jparams)
    assert sorted(_named(back)) == sorted(jflat)
    for k, t in _named(back).items():
        assert np.array_equal(t, np.asarray(jflat[k], np.float32)), k
    for k, t in _named(again).items():
        assert t.dtype == names[k].dtype and torch.equal(t, names[k])


def test_init_layout_dtypes_and_values_match_reference():
    """Same tree, shapes and dtypes as the JAX init at smoke size;
    ``dt_bias`` and ``A_log`` zeros, ``D`` and the norms ones, the conv at
    std 0.5 and the projections at the reference's fan-in rule."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    jspec = jax_build_model(jax_configs.get_smoke_config(ARCH)).init(None)
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
            for k, v in _named(jspec["blocks"]).items()}
    for lp in params["blocks"]:
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                _named(lp).items()} == want
    s = params["blocks"][0]["ssm"]
    assert not s["dt_bias"].any() and not s["A_log"].any()
    assert torch.equal(s["D"], torch.ones_like(s["D"]))
    assert torch.equal(s["norm"]["scale"], torch.ones_like(s["norm"]["scale"]))
    for t, want_std in ((s["conv"], 0.5), (s["wx"], cfg.d_model ** -0.5),
                        (s["w_out"], (2 * cfg.d_model) ** -0.5)):
        assert abs(t.float().std().item() / want_std - 1) < 0.15


def test_full_config_on_meta_tensors_matches_reference():
    """At full width on meta tensors: every leaf's shape and dtype is the
    reference's spec-mode init's, ``count_params`` 2,830,886,400 (the
    reference's), its four cells (``long_500k`` included) registered."""
    cfg = get_config(ARCH)
    jcfg = jax_configs.get_config(ARCH)
    params = init_params(cfg, device="meta")
    spec = jax_build_model(jcfg).init(None)
    assert len(params["blocks"]) == 64
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
            for k, v in _named(spec["blocks"]).items()}
    for lp in (params["blocks"][0], params["blocks"][-1]):
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                _named(lp).items()} == want
    assert all(t.is_meta for t in _named(params).values())
    assert count_params(cfg) == jax_model.count_params(jcfg) == 2_830_886_400
    assert active_params(cfg) == jax_model.active_params(jcfg)
    assert sorted(s for a, s in cells() if a == ARCH) == sorted(SHAPES)


# ------------------------------------------------------ analytical route
@pytest.fixture(scope="module")
def smoke_meta_bundle():
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, device="meta")
    opt = AdamW(fused=True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    batch = {k: torch.from_numpy(v).to("meta")
             for k, v in make_batch(cfg, seq_len=64, batch=1, step=0).items()}
    ops.reset_launch_counts()
    bundle = trace_compiled(make_train_step(cfg, opt), state, batch)
    return cfg, bundle, ops.launch_counts()


def test_trace_compiled_of_the_ssm_train_step(smoke_meta_bundle):
    """The smoke ssm step on meta tensors: RMSNorm recorded as one
    ``repro_torch::rmsnorm`` operator per launch the card would make (ln
    and the gated norm of each layer, the final norm), one fused_adam, no
    flash, nothing counted as launched; the ``ssm`` scope in both phases,
    its products priced as dots, its cumsum and softplus as compute
    (softplus one task, as on the card) and its padding as memory
    traffic."""
    cfg, bundle, launched = smoke_meta_bundle
    L = cfg.n_layers
    dev = bundle.graph.lane_tasks(DEVICE_STREAM)
    kernels = {k: sum(t.attrs.get("kernel") == k for t in dev)
               for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    assert kernels == {"flash_attention": 0, "rmsnorm": 2 * L + 1,
                       "fused_adam": 1, "dgc_mask": 0}
    assert sum(e.get("name") == "repro_torch::rmsnorm" for e in bundle.module) == 2 * L + 1
    assert launched == dict.fromkeys(launched, 0)
    ssm_tasks = [t for t in dev if t.layer == "ssm"]
    assert {t.phase for t in ssm_tasks} == {"fwd", "bwd"}
    by_name = {}
    for t in ssm_tasks:
        by_name.setdefault(t.name, set()).add(t.kind.name)
    assert by_name["aten::cumsum"] == by_name["aten::softplus"] == {"COMPUTE"}
    assert by_name["aten::softplus_backward"] == {"COMPUTE"}
    fwd = [t.name for t in ssm_tasks if t.phase == "fwd"]
    assert fwd.count("aten::softplus") == L
    # a pad is a fill and a copy on the card and on meta tensors: memory
    host_side = [kineto._Event(e) for e in bundle.module if e.get("ph") == "X"
                 and "ts" in e and e.get("cat") in kineto.OP_CATS]
    kineto._nest(host_side)
    pads = [op for op in kineto.task_ops(host_side)
            if any(a.name == "aten::constant_pad_nd" for a in op.ancestors())]
    assert len(pads) >= L
    assert {classify(op)[0] for op in pads} == {TaskKind.MEMORY}
    assert sum(t.attrs.get("opcode") == "dot" for t in ssm_tasks if t.phase == "fwd") > 0
    norm = [t for t in dev if t.attrs.get("kernel") == "rmsnorm"]
    assert sorted({t.flops > 0 for t in norm}) == [True]


def test_perf_report_compiled_route_accepts_the_ssm_arch(tmp_path, monkeypatch,
                                                         capsys):
    """``perf_report --arch mamba2-2.7b --shape train_4k`` (layout dp, the
    per-device 1 x 4096 step) at full width and 2 of its 64 layers through
    ``--set`` (all 64 trace in ~50 s here): exit 0, both roofline rows, no
    collective; its flash row prices the reference's 80 accounting heads of
    32 (ROADMAP C23), as the reference's ``flash_traffic`` does."""
    cfg = get_config(ARCH)
    monkeypatch.setattr("sys.argv", ["perf_report", "--arch", ARCH, "--shape",
                                     "train_4k", "--out", str(tmp_path),
                                     "--set", "n_layers=2"])
    perf_report.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"compiled    : {ARCH}")
    assert "coll=    0.000ms" in lines[0] and lines[1].startswith("with flash  : ")
    cut = cfg.with_(n_layers=2)
    assert perf_report.flash_head_dims(cut) == (32, 32)
    assert perf_report.flash_traffic(cut, SHAPES["train_4k"], 256) == (
        3.0 * 2 * 4 * 256 * 4096 * 80 * 32 * 2 / 256)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_path_matches_plain_path_on_the_card(cuda, monkeypatch):
    """The smoke ssm model's prefill and decode in float32 on the card
    through the RMSNorm kernel (2L + 1 launches a forward), against the
    same with its plain version: logits within 1e-5 of their largest
    magnitude."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 64, seed=5)).long().to(cuda)
    model = build_model(cfg)
    with torch.no_grad():
        ops.reset_launch_counts()
        got, cache = model.prefill(params, {"tokens": toks})
        got_dec, _ = model.decode(params, cache, toks[:, :1], 64)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rmsnorm"] == 2 * (2 * cfg.n_layers + 1)
        monkeypatch.setattr(ops, "rmsnorm", ref.rmsnorm_ref)
        want, cache = model.prefill(params, {"tokens": toks})
        want_dec, _ = model.decode(params, cache, toks[:, :1], 64)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (got_dec - want_dec).abs().max() <= 1e-5 * want_dec.abs().max()


@pytest.mark.gpu
def test_train_gradients_finite_at_chunk_128_on_the_card(cuda):
    """The probe config in bfloat16 on the card at chunk 128, 1 x 256: every
    gradient finite (the reference's form gives NaN there)."""
    cfg = get_smoke_config(ARCH).with_(**PROBE)
    params = init_params(cfg, seed=0, device=cuda)
    b = {k: torch.from_numpy(v).to(cuda)
         for k, v in make_batch(cfg, seq_len=256, batch=1, step=0).items()}
    loss, grads = loss_and_grads(cfg, params, b)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in _named(grads).values())


def test_flash_traffic_of_the_ssm_arch_is_the_reference_s(monkeypatch):
    """``flash_traffic`` for mamba2 (no attention) equals the reference's
    arithmetic, which the CLIs are held ``==`` to (inherited, ROADMAP C23)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import perf_report as jax_perf_report
    for shape in ("train_4k", "prefill_32k"):
        assert perf_report.flash_traffic(get_config(ARCH), SHAPES[shape], 256) == \
            jax_perf_report.flash_traffic(jax_configs.get_config(ARCH),
                                          jax_configs.SHAPES[shape], 256)

