"""repro_torch's dense model and serve engine against the JAX package.

The JAX model is initialised with ``PRNGKey(0)`` for the tinyllama smoke
config in float32, its params converted with ``params_from_jax``, and the
same numpy inputs go through both.  Float32 because the JAX model keeps bf16
scores in ``chunked_attention`` while the flash kernel keeps f32.  Logits and
caches must agree within ``atol = 1e-4 * max|reference|``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import (active_params, build_model,  # noqa: E402
                                count_params, init_cache, init_params)
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "tinyllama-1.1b"


def _close(got, want, rtol_of_max=1e-4):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol_of_max * np.abs(want).max())


@pytest.fixture(scope="module")
def smoke():
    """(jax model, jax params, port config, port params) in float32."""
    jcfg = jax_configs.get_smoke_config(ARCH).with_(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    params = params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    return jmodel, jparams, cfg, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_configs_match_reference(getter, arch):
    port = {"get_config": get_config, "get_smoke_config": get_smoke_config}[getter]
    assert dataclasses.asdict(port(arch)) == dataclasses.asdict(
        getattr(jax_configs, getter)(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_param_counts_match_reference(getter, arch):
    """``count_params``/``active_params`` from meta tensors equal the
    reference's from its spec-mode init (tied llama3.2-1b has no unembed)."""
    port_cfg = getattr(port_configs, getter)(arch)
    ref_cfg = getattr(jax_configs, getter)(arch)
    assert count_params(port_cfg) == jax_model.count_params(ref_cfg)
    assert active_params(port_cfg) == jax_model.active_params(ref_cfg)


def test_param_count_of_tinyllama_is_the_pool_s():
    assert count_params(get_config(ARCH)) == 1_100_048_384


def test_registry_matches_reference_for_ported_archs():
    assert port_configs.list_archs() == ARCHS
    assert set(ARCHS) <= set(jax_configs.list_archs())
    assert {k: dataclasses.astuple(v) for k, v in port_configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_configs.SHAPES.items()}
    for arch in ARCHS:
        for shape in port_configs.SHAPES:
            assert port_configs.runnable(arch, shape) == \
                jax_configs.runnable(arch, shape)
    for skipped in (False, True):
        assert sorted(port_configs.cells(skipped)) == sorted(
            c for c in jax_configs.cells(skipped) if c[0] in ARCHS)


def test_unported_arch_family_and_options_raise():
    with pytest.raises(NotImplementedError):
        get_config("seamless-m4t-large-v2")
    cfg = get_smoke_config(ARCH)
    for family in ("encdec", "vlm"):
        with pytest.raises(NotImplementedError):
            build_model(cfg.with_(family=family))
    for kw in ({"attn_bias": True}, {"norm": "layernorm"}):
        with pytest.raises(NotImplementedError):
            init_params(cfg.with_(**kw), device="cpu")


def test_init_params_layout_and_scale_match_reference():
    """Same tree, shapes and dtype as the JAX init; same fan-in scale rule."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    jspec = jax_build_model(jax_configs.get_smoke_config(ARCH)).init(None)

    def shapes(tree, drop_layer_axis=False):
        if isinstance(tree, dict):
            return {k: shapes(v, drop_layer_axis) for k, v in tree.items()}
        return tuple(tree.shape[1:] if drop_layer_axis else tree.shape)

    jshapes = {k: shapes(v, k == "blocks") for k, v in jspec.items()}
    assert len(params["blocks"]) == cfg.n_layers
    for lp in params["blocks"]:
        assert shapes(lp) == jshapes["blocks"]
    assert {k: shapes(v) for k, v in params.items() if k != "blocks"} == \
        {k: v for k, v in jshapes.items() if k != "blocks"}
    assert all(t.dtype == torch.bfloat16 for lp in params["blocks"]
               for sub in lp.values() for t in sub.values())
    attn, mlp = params["blocks"][0]["attn"], params["blocks"][0]["mlp"]
    # fan-in = shape[-2]: wq (d, H, hd) -> 1/sqrt(H); w_up (d, f) -> 1/sqrt(d)
    for t, want in ((attn["wq"], cfg.n_heads ** -0.5),
                    (mlp["w_up"], cfg.d_model ** -0.5),
                    (params["embed"]["table"], 0.02)):
        assert abs(t.float().std().item() / want - 1) < 0.1
    assert torch.equal(params["final_norm"]["scale"],
                       torch.ones(cfg.d_model, dtype=torch.bfloat16))
    again = init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["blocks"][1]["mlp"]["w_down"],
                       params["blocks"][1]["mlp"]["w_down"])


# ------------------------------------------------------------------ layers
def _layer0(jparams):
    return jax.tree.map(lambda t: t[0], jparams["blocks"])


def test_rmsnorm_layer_matches_reference(smoke):
    _, jparams, cfg, params = smoke
    x = np.random.default_rng(1).standard_normal((2, 5, cfg.d_model), np.float32)
    scale = np.random.default_rng(2).standard_normal(cfg.d_model).astype(np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    _close(got, jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


def test_mlp_matches_reference(smoke):
    _, jparams, cfg, params = smoke
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model), np.float32)
    got = layers.mlp(params["blocks"][0]["mlp"], torch.from_numpy(x))
    _close(got, jax_layers.mlp(_layer0(jparams)["mlp"], jnp.asarray(x)))


def test_rope_matches_reference(smoke):
    cfg = smoke[2]
    hd = cfg.d_model // cfg.n_heads
    x = np.random.default_rng(4).standard_normal((2, 7, cfg.n_heads, hd), np.float32)
    pos = np.arange(3, 10)
    cos, sin = attention.rope_angles(torch.from_numpy(pos), hd)
    jcos, jsin = jax_attention.rope_angles(jnp.asarray(pos), hd)
    _close(cos, jcos, 1e-6)
    _close(attention.apply_rope(torch.from_numpy(x), cos, sin),
           jax_attention.apply_rope(jnp.asarray(x), jcos, jsin))


def test_gqa_attend_matches_reference(smoke):
    """Prefill attention: the port's flash path against chunked_attention."""
    _, jparams, cfg, params = smoke
    S, hd = 12, cfg.d_model // cfg.n_heads
    x = np.random.default_rng(5).standard_normal((2, S, cfg.d_model), np.float32)
    cos, sin = attention.rope_angles(torch.arange(S), hd)
    out, cache = attention.gqa_attend(params["blocks"][0]["attn"],
                                      torch.from_numpy(x), cos, sin,
                                      return_cache=True)
    jcos, jsin = jax_attention.rope_angles(jnp.arange(S), hd)
    jout, jcache = jax_attention.gqa_attend(_layer0(jparams)["attn"],
                                            jnp.asarray(x), jcos, jsin,
                                            return_cache=True)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_gqa_decode_matches_reference(smoke):
    _, jparams, cfg, params = smoke
    hd, pos = cfg.d_model // cfg.n_heads, 9
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, cfg.d_model), np.float32)
    kc, vc = (rng.standard_normal((2, 16, cfg.n_kv_heads, hd), np.float32)
              for _ in range(2))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, cache = attention.gqa_decode(params["blocks"][0]["attn"],
                                      torch.from_numpy(x), cache, pos, cfg.rope_theta)
    jout, jcache = jax_attention.gqa_decode(
        _layer0(jparams)["attn"], jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, jnp.asarray(pos),
        cfg.rope_theta)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("length,as_tensor", [([3, 7], True), (5, True), (9, False)],
                         ids=["per-request", "0-d", "int"])
def test_decode_attention_length_matches_reference(length, as_tensor):
    """``decode_attention`` takes the reference's per-request ``(B,)`` length
    and a 0-d tensor as well as the serve path's host int: each entry of the
    batch sees only its own first ``length`` cache rows.  f32, atol 1e-5."""
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 2, 10, 4, 2, 8
    q = rng.standard_normal((B, 1, H, hd), np.float32)
    kc, vc = (rng.standard_normal((B, S, K, hd), np.float32) for _ in range(2))
    want = jax_attention.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                          jnp.asarray(vc), jnp.asarray(length))
    ln = torch.tensor(length) if as_tensor else length
    got = attention.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)), ln)
    assert got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_engine_decode_passes_a_host_int_length(smoke, monkeypatch):
    """The serve path keeps its no-sync length: every decode step hands
    ``decode_attention`` a Python int."""
    cfg, params = smoke[2], smoke[3]
    seen = []
    plain = attention.decode_attention

    def spy(q, k, v, length):
        seen.append(type(length))
        return plain(q, k, v, length)

    monkeypatch.setattr(attention, "decode_attention", spy)
    ServeEngine(cfg, params, max_seq=16, device="cpu").generate(
        [Request([3, 5, 7], 3), Request([2, 4], 3)])
    assert seen and set(seen) == {int}


# ------------------------------------------------------------- whole model
def test_prefill_logits_and_caches_match_reference(smoke):
    jmodel, jparams, cfg, params = smoke
    toks = _tokens(cfg, 2, 12)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = build_model(cfg).prefill(
        params, {"tokens": torch.from_numpy(toks).long()})
    _close(logits, jlogits)
    assert len(cache) == cfg.n_layers
    for i, layer in enumerate(cache):
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])


def test_decode_matches_reference_on_grown_cache(smoke):
    """Decode at position S on a cache grown to S + 1 (the reference's own
    decode test grows the stacked cache on its sequence axis, 2)."""
    jmodel, jparams, cfg, params = smoke
    S = 12
    toks = _tokens(cfg, 2, S + 1, seed=1)
    _, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    jcache = jax.tree.map(lambda t: jnp.pad(t, [(0, 0), (0, 0), (0, 1), (0, 0),
                                                (0, 0)]), jcache)
    jlogits, jcache = jax.jit(jmodel.decode)(
        jparams, jcache, jnp.asarray(toks[:, S:]), jnp.asarray(S, jnp.int32))

    model = build_model(cfg)
    t = torch.from_numpy(toks).long()
    _, prefix = model.prefill(params, {"tokens": t[:, :S]})
    cache = init_cache(cfg, 2, S + 1, "cpu")
    for layer, pre in zip(cache, prefix):
        layer["k"][:, :S], layer["v"][:, :S] = pre["k"], pre["v"]
    logits, cache = model.decode(params, cache, t[:, S:], S)
    _close(logits, jlogits)
    for i, layer in enumerate(cache):
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])


def test_decode_matches_prefill_of_one_more_token(smoke):
    """The port's own consistency, with tests/test_models.py's tolerance."""
    _, _, cfg, params = smoke
    S = 12
    t = torch.from_numpy(_tokens(cfg, 2, S + 1, seed=2)).long()
    model = build_model(cfg)
    full, _ = model.prefill(params, {"tokens": t})
    _, prefix = model.prefill(params, {"tokens": t[:, :S]})
    cache = init_cache(cfg, 2, S + 1, "cpu")
    for layer, pre in zip(cache, prefix):
        layer["k"][:, :S], layer["v"][:, :S] = pre["k"], pre["v"]
    dec, _ = model.decode(params, cache, t[:, S:], S)
    assert (full.argmax(-1) == dec.argmax(-1)).float().mean() >= 0.5
    assert (full - dec).abs().max() / (full.abs().max() + 1e-6) < 0.05


def test_engine_greedy_tokens_match_reference_prefill_recompute(smoke):
    """The engine's tokens on a left-padded batch equal greedy decoding by
    re-running the JAX ``model.prefill`` over everything generated so far."""
    jmodel, jparams, cfg, params = smoke
    prompts, n_new = [[3, 5, 7, 9, 11, 13], [2, 4, 6, 8]], 8
    engine = ServeEngine(cfg, params, max_seq=32, device="cpu")
    got = engine.generate([Request(p, n_new) for p in prompts])
    assert engine.stats["decode_steps"] == n_new - 1

    plen = max(map(len, prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    prefill = jax.jit(jmodel.prefill)
    want = []
    for _ in range(n_new):
        logits, _ = prefill(jparams, {"tokens": jnp.asarray(toks)})
        nxt = np.asarray(jnp.argmax(logits, -1), np.int32)[:, None]
        want.append(nxt)
        toks = np.concatenate([toks, nxt], axis=1)
    want = np.concatenate(want, axis=1)
    assert [r.tokens for r in got] == want.tolist()


@pytest.fixture(scope="module")
def llama_smoke():
    """llama3.2-1b's smoke config (tied embeddings) in float32, as ``smoke``."""
    arch = "llama3.2-1b"
    jcfg = jax_configs.get_smoke_config(arch).with_(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch).with_(dtype="float32")
    params = params_from_jax(cfg, jax.device_get(jparams), device="cpu")
    return jmodel, jparams, cfg, params


def test_tied_llama_prefill_and_decode_match_reference(llama_smoke):
    """llama3.2-1b smoke: prefill logits and caches, then one decode step on
    the grown cache, against the JAX model (the unembedding is the
    embedding table)."""
    jmodel, jparams, cfg, params = llama_smoke
    assert "unembed" not in params and "unembed" not in jparams
    S = 12
    toks = _tokens(cfg, 2, S + 1, seed=3)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    model = build_model(cfg)
    t = torch.from_numpy(toks).long()
    logits, prefix = model.prefill(params, {"tokens": t[:, :S]})
    _close(logits, jlogits)
    for i, layer in enumerate(prefix):
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])

    jcache = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0),
                                                (0, 0)]), jcache)
    jlogits, jcache = jax.jit(jmodel.decode)(
        jparams, jcache, jnp.asarray(toks[:, S:]), jnp.asarray(S, jnp.int32))
    cache = init_cache(cfg, 2, S + 1, "cpu")
    for layer, pre in zip(cache, prefix):
        layer["k"][:, :S], layer["v"][:, :S] = pre["k"], pre["v"]
    logits, cache = model.decode(params, cache, t[:, S:], S)
    _close(logits, jlogits)
    for i, layer in enumerate(cache):
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])


def test_engine_rejects_prompt_that_fills_the_cache(smoke):
    cfg, params = smoke[2], smoke[3]
    engine = ServeEngine(cfg, params, max_seq=4, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        engine.generate([Request([1, 2, 3, 4], 2)])
