"""repro_torch's mla_moe family (DeepSeek-V2's multi-head latent attention in
front of the moe layer) against the JAX package.

The JAX model is initialised with ``PRNGKey(0)`` for the deepseek-v2-236b
smoke config (4 heads, q/k head dim 16 + 8, v head dim 16, 8 experts,
top-2, one shared expert) in float32, its params converted with
``params_from_jax``, and the same numpy inputs go through both.  Float32
because the JAX model keeps bf16 scores in ``chunked_attention`` while the
flash kernel keeps f32.  Unless a test states otherwise, outputs must agree
within ``atol = 1e-4 * max|reference|`` (f32 sums taken in another order).
The full config is only ever built on meta tensors.
"""

import dataclasses
import functools

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
from repro.models import transformer as jax_transformer  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (opt_state_from_jax, params_from_jax,  # noqa: E402
                                 params_to_jax)
from repro_torch.core import DEVICE_STREAM, trace_compiled  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import perf_report  # noqa: E402
from repro_torch.models import (active_params, build_model, count_params,  # noqa: E402
                                init_cache, init_params, loss_and_grads,
                                make_train_step)
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "deepseek-v2-236b"


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


@pytest.fixture(scope="module")
def smoke():
    """(jax model, jax params, port config, port params) in float32."""
    jcfg = jax_configs.get_smoke_config(ARCH).with_(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    return jmodel, jparams, cfg, params_from_jax(cfg, jax.device_get(jparams),
                                                 device="cpu")


def _layer0(smoke, key):
    _, jparams, _, params = smoke
    return (jax.tree.map(lambda t: t[0], jparams["blocks"][key]),
            params["blocks"][0][key])


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


# ------------------------------------------------- attention, two head dims
@pytest.mark.parametrize("H,KH", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_with_its_own_v_head_dim_matches_chunked_attention(H, KH, causal):
    """``ref.flash_attention_ref`` with q/k head dim 24 and v head dim 16
    against the reference's ``chunked_attention`` (which takes ``hd_v !=
    hd``; scale 1/sqrt(24)), and ``flash_attention_bwd`` against
    ``jax.grad`` of it: within 1e-5 of the largest magnitude."""
    B, S, D, Dv = 2, 40, 24, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, H, S, D), np.float32)
    k = rng.standard_normal((B, KH, S, D), np.float32)
    v = rng.standard_normal((B, KH, S, Dv), np.float32)
    do = rng.standard_normal((B, H, S, Dv), np.float32)

    def jattn(q, k, v):   # (B, H, S, D) in and out, as the port's layout
        o = jax_attention.chunked_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), causal=causal, chunk=16)
        return o.transpose(0, 2, 1, 3)

    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    assert got.shape == (B, H, S, Dv)
    _close(got, jattn(q, k, v), 1e-5)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=causal), got)
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jattn(q, k, v) * do),
                      argnums=(0, 1, 2))(q, k, v)
    grads = ref.flash_attention_bwd(tq, tk, tv, torch.from_numpy(do), causal=causal)
    for g, jg, shape in zip(grads, jgrads, (q.shape, k.shape, v.shape)):
        assert tuple(g.shape) == shape
        _close(g, jg, 1e-5)


def test_flash_meta_route_returns_the_v_head_dim():
    """``flash_attention_meta`` (the analytical route's operator) gives
    (B, H, S, D_v), in q's memory layout, as the launch would."""
    q = torch.empty(2, 7, 4, 24, device="meta").transpose(1, 2)   # (B, H, S, D)
    k = torch.empty(2, 7, 4, 24, device="meta").transpose(1, 2)
    v = torch.empty(2, 7, 4, 16, device="meta").transpose(1, 2)
    o = flash_kernel.flash_attention_meta(q, k, v, True)
    assert o.shape == (2, 4, 7, 16) and o.is_meta
    assert o.transpose(1, 2).is_contiguous()
    same = flash_kernel.flash_attention_meta(q, k, k, False)
    assert same.shape == q.shape and same.stride() == q.stride()


# ------------------------------------------------------------- the layer
def test_mla_attend_and_its_cache_match_reference(smoke):
    jp, p = _layer0(smoke, "attn")
    cfg = smoke[2]
    B, S = 2, 12
    x = _x(cfg, B, S, 1)
    out, cache = attention.mla_attend(p, torch.from_numpy(x), torch.arange(S),
                                      cfg.rope_theta, return_cache=True)
    jout, jcache = jax.jit(functools.partial(
        jax_attention.mla_attend, theta=cfg.rope_theta, return_cache=True))(
            jp, jnp.asarray(x), jnp.arange(S))
    _close(out, jout)
    assert sorted(cache) == sorted(jcache) == ["c_kv", "k_rope"]
    for key in cache:
        _close(cache[key], jcache[key])


def test_mla_decode_matches_reference_on_a_grown_cache(smoke):
    """The absorbed decode of one token at position S against the cache of
    an S-token prefill, written in place: output and both cache leaves."""
    jp, p = _layer0(smoke, "attn")
    cfg = smoke[2]
    B, S = 2, 12
    x = _x(cfg, B, S + 1, 2)
    _, pre = attention.mla_attend(p, torch.from_numpy(x[:, :S]), torch.arange(S),
                                  cfg.rope_theta, return_cache=True)
    cache = init_cache(cfg.with_(n_layers=1), B, S + 1, "cpu")[0]
    for key, leaf in pre.items():
        cache[key][:, :S] = leaf
    out, got = attention.mla_decode(p, torch.from_numpy(x[:, S:]), cache, S,
                                    cfg.rope_theta)
    assert got is cache
    _, jpre = jax_attention.mla_attend(jp, jnp.asarray(x[:, :S]), jnp.arange(S),
                                       cfg.rope_theta, return_cache=True)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 1), (0, 0)]) for k, v in jpre.items()}
    jout, jcache = jax.jit(functools.partial(
        jax_attention.mla_decode, theta=cfg.rope_theta))(
            jp, jnp.asarray(x[:, S:]), jcache, jnp.asarray(S, jnp.int32))
    _close(out, jout)
    for key in cache:
        _close(cache[key], jcache[key])


def test_mla_cache_spec_matches_reference():
    cfg = get_config(ARCH)
    spec = jax_transformer.mla_cache_tree(jax_configs.get_config(ARCH), 3, 17)
    assert transformer.mla_cache_spec(cfg, 3, 17) == {
        k: tuple(v.shape) for k, v in spec.items()}
    cache = init_cache(get_smoke_config(ARCH), 2, 9, "cpu")
    assert len(cache) == 2 and all(
        {k: tuple(t.shape) for k, t in layer.items()}
        == {"c_kv": (2, 9, 32), "k_rope": (2, 9, 8)} for layer in cache)


# ------------------------------------------------------------- the block
def test_block_apply_and_prefill_match_reference(smoke):
    """``mla_block_apply`` (x, aux) and ``mla_block_prefill`` (x, cache) of
    layer 0 against the reference's."""
    _, jparams, cfg, params = smoke
    jb = jax.tree.map(lambda t: t[0], jparams["blocks"])
    pb = params["blocks"][0]
    x = _x(cfg, 2, 12, 3)
    jcfg = jax_configs.get_smoke_config(ARCH).with_(dtype="float32")
    out, aux = transformer.mla_block_apply(cfg, pb, torch.from_numpy(x), None, None)
    jout, jaux = jax_transformer.mla_block_apply(jcfg, jb, jnp.asarray(x), None, None)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    out, cache = transformer.mla_block_prefill(cfg, pb, torch.from_numpy(x), None, None)
    jout, jcache = jax_transformer.mla_block_prefill(jcfg, jb, jnp.asarray(x), None, None)
    _close(out, jout)
    for key in cache:
        _close(cache[key], jcache[key])


# ------------------------------------------------------------ whole model
def _batch(cfg, seq=16, batch=2, step=0):
    return jax_data.make_batch(cfg, seq_len=seq, batch=batch, step=step)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def test_loss_with_aux_and_gradients_match_reference(smoke):
    jmodel, jparams, cfg, params = smoke
    b = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, _jax(b))
    loss, grads = loss_and_grads(cfg, params, _torch(b))
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5)
    no_aux = build_model(cfg.with_(aux_loss_coef=0.0)).loss(params, _torch(b))
    assert abs(float(loss) - float(no_aux)) > 1e-4
    _close_trees(grads, params_from_jax(cfg, jax.device_get(jgrads), "cpu"))


def test_prefill_logits_and_caches_match_reference(smoke):
    jmodel, jparams, cfg, params = smoke
    toks = _tokens(cfg, 2, 12)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = build_model(cfg).prefill(
        params, {"tokens": torch.from_numpy(toks).long()})
    _close(logits, jlogits)
    assert len(cache) == cfg.n_layers
    for i, layer in enumerate(cache):
        assert sorted(layer) == ["c_kv", "k_rope"]
        for key in layer:
            _close(layer[key], jcache[key][i])


def _grown(model, params, cfg, t, S):
    """The port's prefill of ``t[:, :S]`` written into a cache of S + 1."""
    _, prefix = model.prefill(params, {"tokens": t[:, :S]})
    cache = init_cache(cfg, t.shape[0], S + 1, "cpu")
    for layer, pre in zip(cache, prefix):
        for key, leaf in pre.items():
            layer[key][:, :S] = leaf
    return cache


def test_decode_matches_reference_on_grown_cache(smoke):
    jmodel, jparams, cfg, params = smoke
    S = 12
    toks = _tokens(cfg, 2, S + 1, seed=1)
    _, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    jcache = jax.tree.map(lambda t: jnp.pad(t, [(0, 0), (0, 0), (0, 1), (0, 0)]),
                          jcache)
    jlogits, jcache = jax.jit(jmodel.decode)(
        jparams, jcache, jnp.asarray(toks[:, S:]), jnp.asarray(S, jnp.int32))
    model = build_model(cfg)
    t = torch.from_numpy(toks).long()
    logits, cache = model.decode(params, _grown(model, params, cfg, t, S),
                                 t[:, S:], S)
    _close(logits, jlogits)
    for i, layer in enumerate(cache):
        for key in layer:
            _close(layer[key], jcache[key][i])


def test_decode_matches_prefill_at_the_reference_moe_tolerance(smoke):
    """tests/test_models.py's check for MoE archs: capacity differs between
    a prefill of S + 1 tokens and one decode step, so routing may differ:
    top-1 agreement >= 0.5 and relative max error < 0.15."""
    _, _, cfg, params = smoke
    S = 12
    t = torch.from_numpy(_tokens(cfg, 2, S + 1, seed=2)).long()
    model = build_model(cfg)
    full, _ = model.prefill(params, {"tokens": t})
    dec, _ = model.decode(params, _grown(model, params, cfg, t, S), t[:, S:], S)
    assert (full.argmax(-1) == dec.argmax(-1)).float().mean() >= 0.5
    assert (full - dec).abs().max() / (full.abs().max() + 1e-6) < 0.15


def test_engine_greedy_tokens_match_reference(smoke):
    """The engine's tokens on a left-padded batch equal the JAX model's
    prefill followed by greedy decode steps on a cache of ``max_seq``
    positions (the engine's own schedule, as for the moe family)."""
    jmodel, jparams, cfg, params = smoke
    prompts, n_new, max_seq = [[3, 5, 7, 9, 11, 13], [2, 4, 6, 8]], 8, 32
    engine = ServeEngine(cfg, params, max_seq=max_seq, device="cpu")
    got = engine.generate([Request(p, n_new) for p in prompts])

    plen = max(map(len, prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    logits, cache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    cache = jax.tree.map(lambda t: jnp.pad(
        t, [(0, 0), (0, 0), (0, max_seq - plen), (0, 0)]), cache)
    decode = jax.jit(jmodel.decode)
    want = []
    for i in range(n_new):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(nxt))
        if i < n_new - 1:
            logits, cache = decode(jparams, cache, nxt, jnp.asarray(plen + i, jnp.int32))
    assert [r.tokens for r in got] == np.concatenate(want, axis=1).tolist()


def test_engine_grows_every_cache_leaf_as_before():
    """``_grow_cache`` copies each leaf of a layer's prefix whatever its
    keys: the dense cache comes out as the k/v copy made it, MLA's has
    c_kv and k_rope."""
    for arch, keys in (("tinyllama-1.1b", ["k", "v"]), (ARCH, ["c_kv", "k_rope"])):
        cfg = get_smoke_config(arch).with_(dtype="float32")
        engine = ServeEngine(cfg, None, max_seq=10, device="cpu")
        prefix = init_cache(cfg, 2, 4, "cpu")
        for i, layer in enumerate(prefix):
            for j, key in enumerate(layer):
                layer[key].normal_(generator=torch.Generator().manual_seed(10 * i + j))
        grown = engine._grow_cache(prefix, 4)
        for layer, pre in zip(grown, prefix):
            assert sorted(layer) == keys
            for key in keys:
                assert layer[key].shape[1] == 10
                assert torch.equal(layer[key][:, :4], pre[key])
                assert not layer[key][:, 4:].any()


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_reference(smoke, fused):
    """3 steps of make_train_step, JAX against the port, from the same params
    and batches, with test_torch_train.py's tolerances (params: 99.9% of
    entries within 1e-6 and all within 1e-4; m within 1e-4 and v within
    1e-3 of their largest entries; count exact)."""
    jmodel, jparams, cfg, params = smoke
    jopt = jax_optim.AdamW(lr=1e-3, fused=fused)
    opt = AdamW(lr=1e-3, fused=fused)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jax_make_train_step(jmodel.cfg, jopt))
    step = make_train_step(cfg, opt)
    for i in range(3):
        b = _batch(cfg, step=i)
        jstate, jm = jstep(jstate, _jax(b))
        state, m = step(state, _torch(b))
        np.testing.assert_allclose(_np(m["loss"]), _np(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(_np(m["grad_norm"]), _np(jm["grad_norm"]),
                                   rtol=1e-4)
    want = opt_state_from_jax(cfg, jax.device_get(jstate["opt"]), "cpu")
    assert int(state["opt"]["count"]) == int(want["count"]) == 3
    jp = _named(params_from_jax(cfg, jax.device_get(jstate["params"]), "cpu"))
    d = np.concatenate([np.abs(_np(got) - _np(jp[name])).ravel()
                        for name, got in _named(state["params"]).items()])
    assert d.max() <= 1e-4 and (d <= 1e-6).mean() >= 0.999, (d.max(), (d > 1e-6).mean())
    _close_trees(state["opt"]["m"], want["m"])
    _close_trees(state["opt"]["v"], want["v"], 1e-3)


# -------------------------------------------------------------- params
def test_conversion_round_trip_keeps_the_router_float32_in_bf16():
    """A bf16 JAX init converted both ways: every leaf keeps the reference's
    dtype (the router float32, the rest, MLA's leaves too, bfloat16) and its
    values."""
    jcfg = jax_configs.get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = jax.device_get(jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(1)))
    params = params_from_jax(cfg, jparams, device="cpu")
    names = _named(params)
    assert {"blocks.0.attn." + k for k in ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
                                           "wk_b", "wv_b", "wo")} <= set(names)
    for k, t in names.items():
        want = torch.float32 if k.endswith("router") else torch.bfloat16
        assert t.dtype == want, k
    back = params_to_jax(cfg, params)
    again = params_from_jax(cfg, back, device="cpu")
    jflat = _named(jparams)
    assert sorted(_named(back)) == sorted(jflat)
    for k, t in _named(back).items():
        assert np.array_equal(t, np.asarray(jflat[k], np.float32)), k
    for k, t in _named(again).items():
        assert t.dtype == names[k].dtype and torch.equal(t, names[k])


def test_init_layout_dtypes_and_scale_match_reference():
    """Same tree, shapes and dtypes as the JAX init at smoke size, the
    norms' scales ones, and the reference's fan-in rule (``shape[-2]``)."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    jspec = jax_build_model(jax_configs.get_smoke_config(ARCH)).init(None)
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
            for k, v in _named(jspec["blocks"]).items()}
    for lp in params["blocks"]:
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                _named(lp).items()} == want
    a = params["blocks"][0]["attn"]
    assert torch.equal(a["q_norm"], torch.ones_like(a["q_norm"]))
    assert torch.equal(a["kv_norm"], torch.ones_like(a["kv_norm"]))
    for t, want_std in ((a["wq_a"], cfg.d_model ** -0.5), (a["wq_b"], cfg.n_heads ** -0.5),
                        (a["wk_b"], cfg.n_heads ** -0.5), (a["wo"], cfg.v_head_dim ** -0.5)):
        assert abs(t.float().std().item() / want_std - 1) < 0.15


def test_full_config_on_meta_tensors_matches_reference():
    """At full width on meta tensors (nothing allocated): every leaf's shape
    and dtype is the reference's spec-mode init's; ``count_params`` within
    the reference's 236e9 +- 5% (tests/test_models.py) and equal to the
    reference's count, ``active_params`` equal to the reference's."""
    cfg = get_config(ARCH)
    jcfg = jax_configs.get_config(ARCH)
    params = init_params(cfg, device="meta")
    spec = jax_build_model(jcfg).init(None)
    assert len(params["blocks"]) == 60
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
            for k, v in _named(spec["blocks"]).items()}
    for lp in (params["blocks"][0], params["blocks"][-1]):
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                _named(lp).items()} == want
    assert all(t.is_meta for t in _named(params).values())
    n = count_params(cfg)
    assert abs(n - 236e9) / 236e9 < 0.05
    assert n == jax_model.count_params(jcfg)
    assert active_params(cfg) == jax_model.active_params(jcfg)
    assert build_model(cfg).cfg is cfg


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
    return cfg, trace_compiled(make_train_step(cfg, opt), state, batch)


def test_trace_compiled_of_the_mla_train_step(smoke_meta_bundle):
    """The smoke mla_moe step on meta tensors: one kernel task per launch the
    card would make (flash once per layer at q/k head dim 24 and v head dim
    16; RMSNorm for ln1, q_norm, kv_norm and ln2 of each layer and the final
    norm), flash priced with its two head dims, and attention and moe
    layers in both phases."""
    cfg, bundle = smoke_meta_bundle
    L = cfg.n_layers
    dev = bundle.graph.lane_tasks(DEVICE_STREAM)
    kernels = {k: sum(t.attrs.get("kernel") == k for t in dev)
               for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    assert kernels == {"flash_attention": L, "rmsnorm": 4 * L + 1,
                       "fused_adam": 1, "dgc_mask": 0}
    flash = [t for t in dev if t.attrs.get("kernel") == "flash_attention"]
    D, Dv = cfg.qk_nope + cfg.qk_rope, cfg.v_head_dim
    pairs = cfg.n_heads * 64 * 65 // 2
    assert all(t.flops == 2.0 * (D + Dv) * pairs for t in flash)
    for layer in ("attn", "moe"):
        assert {t.phase for t in dev if t.layer == layer} >= {"fwd", "bwd"}


def test_perf_report_compiled_route_accepts_the_mla_arch(tmp_path, monkeypatch,
                                                         capsys):
    """``perf_report --arch deepseek-v2-236b --shape train_4k`` (its v2
    expert-parallel layout traced as the per-device 1 x 4096 step), at smoke
    width through ``--set``: both roofline rows, no collective, the flash
    operator at q/k head dim 24 and v head dim 16."""
    smoke = get_smoke_config(ARCH)
    sets = [f"{f.name}={getattr(smoke, f.name)}" for f in dataclasses.fields(smoke)
            if getattr(smoke, f.name) != getattr(get_config(ARCH), f.name)]
    monkeypatch.setattr("sys.argv", ["perf_report", "--arch", ARCH, "--shape",
                                     "train_4k", "--out", str(tmp_path)]
                        + [a for kv in sets for a in ("--set", kv)])
    perf_report.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"compiled    : {ARCH}")
    assert "coll=    0.000ms" in lines[0] and lines[1].startswith("with flash  : ")
    bundle = perf_report.trace_cell(smoke, SHAPES["train_4k"])
    dims = next(e for e in bundle.module if e.get("name") ==
                "repro_torch::flash_attention")["args"]["Input Dims"]
    H = smoke.n_heads
    assert dims[0] == [1, H, 4096, 24] and dims[2] == [1, H, 4096, 16]
    assert perf_report.flash_head_dims(smoke) == (24, 16)
    assert perf_report.flash_traffic(smoke, SHAPES["train_4k"], 256) == (
        3.0 * smoke.n_layers * 2 * 256 * 4096 * H * (24 + 16) * 2 / 256)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


SWEEP = [(D, Dv, dtype, causal, H, KH)
         for D in (24, 192) for Dv in (16, 128)
         for dtype in (torch.float32, torch.bfloat16) for causal in (True, False)
         for H, KH in ((4, 4), (8, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv,dtype,causal,H,KH", SWEEP)
def test_flash_kernels_with_two_head_dims_match_plain_version(cuda, D, Dv, dtype,
                                                              causal, H, KH):
    """Both flash kernels at q/k head dim 24 or 192 and v head dim 16 or 128,
    against ``ref.flash_attention_ref``: f32 (the CUDA-core kernel) within
    2e-3; bf16 (the tensor-core kernel) within 2^-6 of the output's largest
    magnitude, a few bf16 roundings of P and the output."""
    g = torch.Generator(device=cuda).manual_seed(D + Dv + H)
    B, S = 2, 300
    q = torch.randn(B, H, S, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, KH, S, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, KH, S, Dv, generator=g, device=cuda).to(dtype)
    want_variant = "wgmma" if dtype == torch.bfloat16 else "scalar"
    assert flash_kernel._variant(q, k, v) == want_variant
    got = flash_kernel.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.shape == (B, H, S, Dv) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    atol = 2e-3 if dtype == torch.float32 else 2.0 ** -6 * want.float().abs().max().item()
    assert err <= atol, (err, atol)


@pytest.mark.gpu
def test_kernel_path_matches_plain_path_on_the_card(cuda, monkeypatch):
    """The smoke mla_moe model's prefill in float32 on the card through the
    flash and RMSNorm kernels, against the same with their plain versions:
    at least 0.999 of the expert indices equal, logits within 1e-3 of their
    largest magnitude (``chip_smoke.py``'s deepseek gates)."""
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = init_params(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(_tokens(cfg, 2, 64, seed=5)).long().to(cuda)
    routes = []
    plain_route = moe._route

    def spy(*a):
        out = plain_route(*a)
        routes.append(out[1])
        return out

    monkeypatch.setattr(moe, "_route", spy)
    model = build_model(cfg)
    with torch.no_grad():
        got, _ = model.prefill(params, {"tokens": toks})
        monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, causal=True, **_:
                            ref.flash_attention_ref(q, k, v, causal=causal))
        monkeypatch.setattr(ops, "rmsnorm", ref.rmsnorm_ref)
        want, _ = model.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    half = len(routes) // 2
    same = sum(int((a == b).sum()) for a, b in zip(routes[:half], routes[half:]))
    assert same / sum(r.numel() for r in routes[:half]) >= 0.999
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()
