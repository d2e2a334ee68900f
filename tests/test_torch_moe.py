"""repro_torch's moe family against the JAX package.

The JAX model is initialised with ``PRNGKey(0)`` for the moonshot-v1-16b-a3b
smoke config (8 experts, top-2, one shared expert) in float32, its params
converted with ``params_from_jax``, and the same numpy inputs go through
both.  Float32 because the JAX model keeps bf16 scores in
``chunked_attention`` while the flash kernel keeps f32.  Unless a test
states otherwise, outputs must agree within ``atol = 1e-4 * max|reference|``
(f32 sums taken in another order) and the routing exactly.  The full config
is only ever built on meta tensors.
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
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import (opt_state_from_jax, params_from_jax,  # noqa: E402
                                 params_to_jax)
from repro_torch.core import DEVICE_STREAM, TaskKind, trace_compiled  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import perf_report  # noqa: E402
from repro_torch.models import (build_model, init_cache, init_params,  # noqa: E402
                                loss_and_grads, make_train_step)
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"


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


def _layer0_moe(smoke):
    _, jparams, _, params = smoke
    return (jax.tree.map(lambda t: t[0], jparams["blocks"]["moe"]),
            params["blocks"][0]["moe"])


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


# --------------------------------------------------------------- the layer
def test_route_matches_reference(smoke):
    jp, p = _layer0_moe(smoke)
    cfg = smoke[2]
    x2 = _x(cfg, 1, 40, 1)[0]
    gate, idx, aux = moe._route(p["router"], torch.from_numpy(x2), cfg.top_k)
    jgate, jidx, jaux = jax_moe._route(jp["router"], jnp.asarray(x2), cfg.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_matches_reference(smoke, capacity_factor):
    """Out and aux, at the config's capacity factor (capacity 4 for 24 slots
    per row over 8 experts) and at 0.5 (capacity 2), which drops slots."""
    jp, p = _layer0_moe(smoke)
    cfg = smoke[2]
    B, S = 2, 12
    x = _x(cfg, B, S, 2)
    out, aux = moe.moe_ffn(p, torch.from_numpy(x), top_k=cfg.top_k,
                           capacity_factor=capacity_factor)
    jout, jaux = jax.jit(functools.partial(
        jax_moe.moe_ffn, top_k=cfg.top_k, capacity_factor=capacity_factor))(
            jp, jnp.asarray(x))
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    if capacity_factor == 0.5:
        # drops: some expert gets more of a row's slots than capacity 2 holds
        _, idx, _ = moe._route(p["router"], torch.from_numpy(x.reshape(B * S, -1)),
                               cfg.top_k)
        most = max(int(torch.bincount(r, minlength=cfg.n_experts).max())
                   for r in idx.reshape(B, -1))
        assert most > 2


def test_moe_ffn_gradients_match_reference(smoke):
    """Gradients of sum(out * r) + aux in x and every layer parameter,
    against ``jax.grad`` (at capacity factor 0.5, so dropped slots too)."""
    jp, p = _layer0_moe(smoke)
    cfg = smoke[2]
    x = _x(cfg, 2, 12, 3)
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(jp, x):
        out, aux = jax_moe.moe_ffn(jp, x, top_k=cfg.top_k, capacity_factor=0.5)
        return jnp.sum(out * r) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    req = {k: t.detach().clone().requires_grad_() for k, t in _named(p).items()}
    tp = {k: req[k] for k in ("router", "w_gate", "w_up", "w_down")}
    tp["shared"] = {k: req[f"shared.{k}"] for k in p["shared"]}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ffn(tp, tx, top_k=cfg.top_k, capacity_factor=0.5)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    _close(tx.grad, jgx)
    jflat = _named(jgp)
    assert sorted(jflat) == sorted(req)
    for k, t in req.items():
        _close(t.grad, jflat[k])


def test_moe_param_count_matches_reference():
    c = get_config(ARCH)
    args = (c.d_model, c.d_ff_expert, c.n_experts, c.n_shared_experts)
    assert moe.moe_param_count(*args) == jax_moe.moe_param_count(*args)


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
    # the aux term is in it: without it the loss is another number
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
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])


def _grown(model, params, cfg, t, S):
    """The port's prefill of ``t[:, :S]`` written into a cache of S + 1."""
    _, prefix = model.prefill(params, {"tokens": t[:, :S]})
    cache = init_cache(cfg, t.shape[0], S + 1, "cpu")
    for layer, pre in zip(cache, prefix):
        layer["k"][:, :S], layer["v"][:, :S] = pre["k"], pre["v"]
    return cache


def test_decode_matches_reference_on_grown_cache(smoke):
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
    logits, cache = model.decode(params, _grown(model, params, cfg, t, S),
                                 t[:, S:], S)
    _close(logits, jlogits)
    for i, layer in enumerate(cache):
        _close(layer["k"], jcache["k"][i])
        _close(layer["v"], jcache["v"][i])


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
    positions (the engine's own schedule: decode routes at capacity 1, so
    a prefill recompute is not the same function for MoE)."""
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
        t, [(0, 0), (0, 0), (0, max_seq - plen), (0, 0), (0, 0)]), cache)
    decode = jax.jit(jmodel.decode)
    want = []
    for i in range(n_new):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(nxt))
        if i < n_new - 1:
            logits, cache = decode(jparams, cache, nxt, jnp.asarray(plen + i, jnp.int32))
    assert [r.tokens for r in got] == np.concatenate(want, axis=1).tolist()


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
def test_init_layout_dtypes_and_scale_match_reference():
    """Same tree, shapes and dtypes as the JAX init (the router float32 in
    the bf16 config), the same fan-in scale rule and the router's 0.02."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    jspec = jax_build_model(jax_configs.get_smoke_config(ARCH)).init(None)
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
            for k, v in _named(jspec["blocks"]).items()}
    assert len(params["blocks"]) == cfg.n_layers
    for lp in params["blocks"]:
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                _named(lp).items()} == want
    m = params["blocks"][0]["moe"]
    assert m["router"].dtype == torch.float32 and m["w_gate"].dtype == torch.bfloat16
    # fan-in = shape[-2]: (E, d, f) -> 1/sqrt(d), (E, f, d) -> 1/sqrt(f)
    for t, want_std in ((m["router"], 0.02), (m["w_gate"], cfg.d_model ** -0.5),
                        (m["w_down"], cfg.d_ff_expert ** -0.5),
                        (m["shared"]["w_up"], cfg.d_model ** -0.5)):
        assert abs(t.float().std().item() / want_std - 1) < 0.1


def test_full_config_meta_leaves_match_reference_spec():
    """At full width on meta tensors (nothing allocated): every leaf's shape
    and dtype is the reference's spec-mode init's."""
    cfg = get_config(ARCH)
    params = init_params(cfg, device="meta")
    spec = jax_build_model(jax_configs.get_config(ARCH)).init(None)
    assert len(params["blocks"]) == 48
    want = {k: (tuple(v.shape[1:]), np.dtype(v.dtype).name)
            for k, v in _named(spec["blocks"]).items()}
    for lp in (params["blocks"][0], params["blocks"][-1]):
        assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in
                _named(lp).items()} == want
    rest = {k: v for k, v in params.items() if k != "blocks"}
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in _named(rest).items()} \
        == {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in
            _named({k: v for k, v in spec.items() if k != "blocks"}).items()}
    assert all(t.is_meta for t in _named(params).values())


def test_router_stays_float32_through_conversion_in_bf16():
    """A bf16 JAX init converted both ways: every leaf keeps the reference's
    dtype (the router float32, the rest bfloat16) and its values."""
    jcfg = jax_configs.get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = jax.device_get(jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(1)))
    params = params_from_jax(cfg, jparams, device="cpu")
    for k, t in _named(params).items():
        want = torch.float32 if k.endswith("router") else torch.bfloat16
        assert t.dtype == want, k
    back = params_to_jax(cfg, params)
    again = params_from_jax(cfg, back, device="cpu")
    jflat = _named(jparams)
    for k, t in _named(back).items():
        assert np.array_equal(t, np.asarray(jflat[k], np.float32)), k
    for k, t in _named(again).items():
        assert t.dtype == _named(params)[k].dtype and torch.equal(t, _named(params)[k])


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


def test_trace_compiled_of_the_moe_train_step(smoke_meta_bundle):
    """The smoke moe step runs on meta tensors (no sync, no data-dependent
    shape: either would raise there), one kernel task per launch the card
    would make, a ``moe`` layer in both phases, and its dispatch and
    combine priced as memory traffic."""
    cfg, bundle = smoke_meta_bundle
    L = cfg.n_layers
    dev = bundle.graph.lane_tasks(DEVICE_STREAM)
    kernels = {k: sum(t.attrs.get("kernel") == k for t in dev)
               for k in ("flash_attention", "rmsnorm", "fused_adam", "dgc_mask")}
    assert kernels == {"flash_attention": L, "rmsnorm": 2 * L + 1,
                       "fused_adam": 1, "dgc_mask": 0}
    moe_tasks = [t for t in dev if t.layer == "moe"]
    assert {t.phase for t in moe_tasks} == {"fwd", "bwd"}
    kinds = {t.name: t.kind for t in moe_tasks}
    for name in ("aten::index_put", "aten::index", "aten::gather"):
        assert kinds[name] == TaskKind.MEMORY, name
    assert sum(t.name == "aten::bmm" and t.phase == "fwd" for t in moe_tasks) == 3 * L
    assert sum(t.name == "aten::topk" for t in moe_tasks) == L


def test_perf_report_compiled_route_accepts_the_moe_arch(tmp_path, monkeypatch,
                                                         capsys):
    """``perf_report --arch moonshot-v1-16b-a3b --shape train_4k`` (the
    expert-parallel v2 layout, traced as the per-device 1 x 4096 step), at
    smoke width through ``--set``: both roofline rows, no collective."""
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
    assert dims[0] == [1, smoke.n_heads, 4096, smoke.d_model // smoke.n_heads]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_path_matches_plain_path_on_the_card(cuda, monkeypatch):
    """The smoke moe model's prefill in float32 on the card through the
    flash and RMSNorm kernels, against the same with their plain versions
    (``kernels/ref.py``): at least 0.999 of the expert indices equal, logits
    within 1e-3 of their largest magnitude (``chip_smoke.py``'s moe gates)."""
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
