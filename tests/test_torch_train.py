"""repro_torch's training path against the JAX package.

The JAX model is initialised with ``PRNGKey(0)`` for the tinyllama smoke
config in float32 and its params converted with ``params_from_jax``; the same
numpy batches (``make_batch``) go through both.  Float32 because the JAX
model keeps bf16 scores in ``chunked_attention`` while the port's attention
keeps f32.  Losses and gradients must agree within
``atol = 1e-4 * max|reference|`` per leaf (f32 sums taken in another order);
optimizer states after 3 steps within the tolerances stated at each test.
The JAX side's ``AdamW(fused=True)`` runs its Pallas kernel in interpret mode
(``repro.kernels.ops``'s default), as tests/test_kernels.py does.
"""

import statistics

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
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import make_train_step as jax_make_train_step  # noqa: E402
from repro.runtime import StragglerMonitor as JaxStragglerMonitor  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.data import (Prefetcher, SyntheticLM, host_shard,  # noqa: E402
                              make_batch)
from repro_torch.models import (build_model, init_params,  # noqa: E402
                                loss_and_grads, make_train_step)
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import (AdamW, dgc_init, dgc_step,  # noqa: E402
                               global_norm, warmup_cosine)
from repro_torch.runtime import StragglerMonitor  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ARCH = "tinyllama-1.1b"


def _named(tree, prefix=""):
    """{dotted path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_named(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_trees(got, want, rtol_of_max=1e-4):
    """Every leaf of ``got`` within ``rtol_of_max * max|leaf of want|``."""
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = _np(got[name]), _np(want[name])
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=rtol_of_max * np.abs(w).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def smoke():
    """(jax config, jax params, port config, port params) in float32."""
    jcfg = jax_configs.get_smoke_config(ARCH).with_(dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).with_(dtype="float32")
    return jcfg, jparams, cfg, params_from_jax(cfg, jax.device_get(jparams),
                                               device="cpu")


def _batch(cfg, seq=16, batch=2, step=0):
    return jax_data.make_batch(cfg, seq_len=seq, batch=batch, step=step)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ------------------------------------------------------------------ loss
def test_loss_and_every_gradient_match_reference(smoke):
    jcfg, jparams, cfg, params = smoke
    b = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jax_build_model(jcfg).loss))(
        jparams, _jax(b))
    loss, grads = loss_and_grads(cfg, params, _torch(b))
    assert loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5)
    assert float(build_model(cfg).loss(params, _torch(b))) == pytest.approx(
        float(jloss), rel=1e-5)
    _close_trees(grads, params_from_jax(cfg, jax.device_get(jgrads), "cpu"))


@pytest.mark.parametrize("chunk,masked", [(10, False), (10, True), (64, True)])
def test_cross_entropy_chunked_matches_reference(chunk, masked):
    """Chunk 10 at B=2 gives 5-position chunks over S=12 (the last one short);
    chunk 64 gives one chunk.  Loss and its gradients in x and the table."""
    rng = np.random.default_rng(7)
    B, S, D, V = 2, 12, 16, 40
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None

    def jloss(x, table):
        return jax_layers.softmax_cross_entropy_chunked(
            {"table": table}, x, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk=chunk)

    jl, (jdx, jdt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    loss = layers.softmax_cross_entropy_chunked(
        {"table": tt}, tx, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(_np(loss), _np(jl), rtol=1e-5)
    for got, want in ((tx.grad, jdx), (tt.grad, jdt)):
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=1e-4 * np.abs(_np(want)).max())


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_reference(smoke, fused):
    """3 steps of make_train_step, JAX against the port, from the same params
    and batches.  Params: 99.9% of entries within 1e-6 and all within 1e-4, a
    tenth of one step at lr 1e-3 — Adam's step m/sqrt(v) does not shrink with
    the gradient, so an entry whose gradient is at the f32 rounding floor
    moves by a rounding-chosen fraction of lr.  m within 1e-4 and v within
    1e-3 of their largest entries (they carry the gradients' f32
    differences); count exact."""
    jcfg, jparams, cfg, params = smoke
    jopt = jax_optim.AdamW(lr=1e-3, fused=fused)
    opt = AdamW(lr=1e-3, fused=fused)
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep, step = jax.jit(jax_make_train_step(jcfg, jopt)), make_train_step(cfg, opt)
    for i in range(3):
        b = _batch(jcfg, step=i)
        jstate, jm = jstep(jstate, _jax(b))
        state, m = step(state, _torch(b))
        np.testing.assert_allclose(_np(m["loss"]), _np(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(_np(m["grad_norm"]), _np(jm["grad_norm"]),
                                   rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 3
    want = opt_state_from_jax(cfg, jax.device_get(jstate["opt"]), "cpu")
    assert int(state["opt"]["count"]) == int(want["count"]) == 3
    jp = _named(params_from_jax(cfg, jax.device_get(jstate["params"]), "cpu"))
    d = np.concatenate([np.abs(_np(got) - _np(jp[name])).ravel()
                        for name, got in _named(state["params"]).items()])
    assert d.max() <= 1e-4 and (d <= 1e-6).mean() >= 0.999, (d.max(), (d > 1e-6).mean())
    _close_trees(state["opt"]["m"], want["m"])
    _close_trees(state["opt"]["v"], want["v"], 1e-3)


def test_smoke_train_step():
    """Port of tests/test_models.py::test_smoke_train_step (bf16 config)."""
    cfg = get_smoke_config(ARCH)
    opt = AdamW(lr=1e-3)
    params = init_params(cfg, 0, "cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state, metrics = make_train_step(cfg, opt)(state, _torch(make_batch(
        cfg, seq_len=32, batch=2, step=0)))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    assert int(state["step"]) == 1
    leaves = list(_named(state["params"]).values())
    assert all(t.dtype == torch.bfloat16 and torch.isfinite(t.float()).all()
               for t in leaves)
    assert not torch.equal(leaves[0], list(_named(params).values())[0])


def test_grad_accum_equivalence(smoke):
    """Port of tests/test_models.py::test_grad_accum_equivalence, plus the
    gradient: grad_accum=2 on one batch of 4 equals accum=1 within f32
    rounding, and both losses equal the JAX package's."""
    jcfg, jparams, cfg, params = smoke
    b = _batch(jcfg, seq=16, batch=4)
    opt = AdamW(lr=0.0, weight_decay=0.0, grad_clip=0.0)
    out = []
    for accum in (1, 2):
        c = cfg.with_(grad_accum=accum)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, m = make_train_step(c, opt)(state, _torch(b))
        out.append(m)
    jopt = jax_optim.AdamW(lr=0.0, weight_decay=0.0, grad_clip=0.0)
    _, jm = jax.jit(jax_make_train_step(jcfg.with_(grad_accum=2), jopt))(
        {"params": jparams, "opt": jopt.init(jparams),
         "step": jnp.zeros((), jnp.int32)}, _jax(b))
    assert float(out[0]["loss"]) == pytest.approx(float(out[1]["loss"]), rel=1e-4)
    assert float(out[1]["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(out[0]["grad_norm"]) == pytest.approx(
        float(out[1]["grad_norm"]), rel=1e-4)


def _batches(cfg, seq, batch):
    step = 0
    while True:
        yield make_batch(cfg, seq_len=seq, batch=batch, step=step)
        step += 1


def test_training_reduces_loss():
    """Port of tests/test_system.py::test_training_reduces_loss, through the
    port's Trainer on the CPU."""
    cfg = get_smoke_config(ARCH)
    tr = Trainer(cfg, TrainerConfig(steps=40, log_every=0),
                 optimizer=AdamW(lr=3e-3), device="cpu")
    seen = []
    tr.fit(Prefetcher(_batches(cfg, 64, 8)), hooks=lambda i, m: seen.append(i))
    losses = [m["loss"] for m in tr.metrics_log]
    assert seen == list(range(40)) and len(tr.straggler.times) == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert all(np.isfinite(l) for l in losses)
    assert all(m["step_time_s"] > 0 for m in tr.metrics_log)


def test_trainer_refuses_checkpoint_dir(tmp_path):
    """A checkpoint directory is taken (the trainer checkpoints:
    tests/test_torch_ckpt.py); a path that is a file is refused, as the
    reference's trainer refuses it."""
    from repro.train import Trainer as JaxTrainer
    from repro.train import TrainerConfig as JaxTrainerConfig
    Trainer(get_smoke_config(ARCH), TrainerConfig(ckpt_dir=str(tmp_path / "ck")),
            device="cpu")
    assert (tmp_path / "ck").is_dir()
    (tmp_path / "file").write_text("not a directory")
    with pytest.raises(FileExistsError):
        Trainer(get_smoke_config(ARCH),
                TrainerConfig(ckpt_dir=str(tmp_path / "file")), device="cpu")
    with pytest.raises(FileExistsError):
        JaxTrainer(jax_configs.get_smoke_config(ARCH),
                   JaxTrainerConfig(ckpt_dir=str(tmp_path / "file")))


# -------------------------------------------------------------- substrate
@pytest.mark.parametrize("seq,batch,step,seed", [(16, 4, 3, 0), (64, 8, 0, 5),
                                                 (4096, 2, 1, 0)])
def test_make_batch_identical_to_reference(seq, batch, step, seed):
    cfg = get_smoke_config(ARCH)
    jcfg = jax_configs.get_smoke_config(ARCH)
    for kind in ("train", "prefill"):
        got = make_batch(cfg, seq_len=seq, batch=batch, step=step, seed=seed,
                         kind=kind)
        want = jax_data.make_batch(jcfg, seq_len=seq, batch=batch, step=step,
                                   seed=seed, kind=kind)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_make_batch_unported_families_raise():
    cfg = get_smoke_config(ARCH)
    for family in ("vlm", "encdec"):
        with pytest.raises(NotImplementedError):
            make_batch(cfg.with_(family=family), seq_len=8, batch=2, step=0)


class TestData:
    """Port of tests/test_substrate.py::TestData."""

    def test_deterministic(self):
        a = SyntheticLM(100, 16, 4).batch_at(3)
        b = SyntheticLM(100, 16, 4).batch_at(3)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_labels_are_next_tokens(self):
        b = SyntheticLM(100, 16, 4).batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_shard_partitions(self):
        idx = []
        for s in (host_shard(10, i, 3) for i in range(3)):
            idx.extend(range(s.start, s.stop))
        assert sorted(idx) == list(range(10))
        assert [host_shard(10, i, 3) for i in range(3)] == \
            [jax_data.host_shard(10, i, 3) for i in range(3)]

    def test_prefetcher_order_and_error(self):
        assert list(Prefetcher(iter([1, 2, 3]))) == [1, 2, 3]

        def boom():
            yield 1
            raise ValueError("x")
        it = Prefetcher(boom())
        assert next(it) == 1
        with pytest.raises(ValueError):
            next(it)

    def test_structured_stream_learnable(self):
        b = SyntheticLM(97, 64, 8, noise=0.0).batch_at(0)
        np.testing.assert_array_equal((5 * b["tokens"] + 131) % 97, b["labels"])

    # (vocab, seq_len, batch, seed, step, noise): the tinyllama and moonshot
    # vocabularies at the train length; vocabularies where numpy's bounded
    # integers redraw 7% and 2% of their draws (2**32 % vocab is large);
    # vocabularies of 2 and 3; no flips and only flips; a vocabulary where
    # the reference's int32 arithmetic wraps (its own loop is run)
    @pytest.mark.parametrize("case", [
        (32000, 4096, 1, 0, 0, 0.05), (163840, 4096, 1, 1, 5, 0.05),
        (400_000_001, 1000, 3, 2, 9, 0.05), (100_000_007, 200, 7, 3, 3, 0.5),
        (2, 50, 5, 0, 0, 0.05), (3, 33, 1, 4, 2, 0.05),
        (97, 64, 8, 0, 0, 0.0), (1000, 64, 4, 0, 1, 1.0),
        (2 ** 30, 40, 2, 0, 0, 0.3)])
    def test_batches_equal_reference(self, case):
        vocab, seq, batch, seed, step, noise = case
        got = SyntheticLM(vocab, seq, batch, seed, noise=noise).batch_at(step)
        want = jax_data.SyntheticLM(vocab, seq, batch, seed, noise=noise).batch_at(step)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])

    def test_batch_draws_in_bulk(self, monkeypatch):
        """A batch of 4096 positions makes no per-position numpy draw (the
        reference's loop makes 8193): the prefetch thread holds the GIL
        for milliseconds, not for a Python loop over the sequence."""
        calls = []
        real = np.random.default_rng

        class Counting:
            def __init__(self, seed):
                self._rng = real(seed)
                self.bit_generator = self._rng.bit_generator

            def __getattr__(self, name):
                calls.append(name)
                return getattr(self._rng, name)

        monkeypatch.setattr(np.random, "default_rng", Counting)
        SyntheticLM(32000, 4096, 1).batch_at(0)
        assert calls == []
        jax_data.SyntheticLM(32000, 64, 1).batch_at(0)
        assert len(calls) == 1 + 2 * 64


class TestOptim:
    """Port of tests/test_substrate.py::TestOptim, each against the JAX
    package's numbers."""

    @pytest.mark.parametrize("fused", [False, True])
    def test_adamw_decreases_quadratic(self, fused):
        opt = AdamW(lr=0.1, weight_decay=0.0, fused=fused)
        jopt = jax_optim.AdamW(lr=0.1, weight_decay=0.0, fused=fused)
        p, jp = {"x": torch.tensor([5.0, -3.0])}, {"x": jnp.asarray([5.0, -3.0])}
        s, js = opt.init(p), jopt.init(jp)
        for _ in range(50):
            p, s = opt.apply({"x": 2 * p["x"]}, s, p)
            jp, js = jopt.apply({"x": 2 * jp["x"]}, js, jp)
        assert float(p["x"].abs().max()) < 1.0
        np.testing.assert_allclose(_np(p["x"]), _np(jp["x"]), atol=1e-5)

    def test_grad_clip_records_norm(self):
        opt = AdamW(lr=0.1, grad_clip=1.0)
        p = {"x": torch.ones(4)}
        p, s = opt.apply({"x": torch.full((4,), 100.0)}, opt.init(p), p)
        assert float(opt.last_grad_norm(s)) == pytest.approx(200.0)
        jopt = jax_optim.AdamW(lr=0.1, grad_clip=1.0)
        jp, _ = jopt.apply({"x": jnp.full((4,), 100.0)},
                           jopt.init({"x": jnp.ones(4)}), {"x": jnp.ones(4)})
        np.testing.assert_allclose(_np(p["x"]), _np(jp["x"]), rtol=1e-6)
        assert float(global_norm({"a": torch.full((4,), 3.0)})) == pytest.approx(6.0)

    def test_warmup_cosine_shape(self):
        f, jf = warmup_cosine(1.0, 10, 100), jax_optim.warmup_cosine(1.0, 10, 100)
        assert float(f(torch.tensor(0))) == pytest.approx(0.0)
        assert float(f(torch.tensor(10))) == pytest.approx(1.0, rel=0.2)
        assert float(f(torch.tensor(100))) < 0.01
        for c in (0, 3, 10, 11, 55, 99, 100, 120):
            assert float(f(torch.tensor(c, dtype=torch.int32))) == pytest.approx(
                float(jf(jnp.asarray(c, jnp.int32))), rel=1e-6, abs=1e-7)

    def test_fused_and_per_leaf_agree_over_steps(self):
        """Port of tests/test_kernels.py::
        test_fused_adam_multi_step_agrees_with_optimizer."""
        params = {"a": torch.ones(130) * 0.3,
                  "b": {"w": torch.linspace(-1, 1, 77)}}
        grads = {"a": params["a"] * 0.1 + 0.01,
                 "b": {"w": params["b"]["w"] * 0.1 + 0.01}}
        o1, o2 = AdamW(lr=1e-2), AdamW(lr=1e-2, fused=True)
        s1, s2 = o1.init(params), o2.init(params)
        p1 = p2 = params
        for _ in range(3):
            p1, s1 = o1.apply(grads, s1, p1)
            p2, s2 = o2.apply(grads, s2, p2)
        for name, a in _named(p1).items():
            np.testing.assert_allclose(_np(a), _np(_named(p2)[name]), atol=1e-5)
        assert int(s1["count"]) == int(s2["count"]) == 3

    def test_fused_state_must_be_flat_backed(self):
        params = {"a": torch.ones(3), "b": torch.ones(2)}
        state = AdamW.init(params)
        state["m"] = {"a": torch.zeros(3), "b": torch.zeros(2)}
        with pytest.raises(ValueError, match="flat-backed"):
            AdamW(fused=True).apply(params, state, params)

    def test_dgc_error_feedback_conserves(self):
        g = np.array(jax.random.normal(jax.random.PRNGKey(0), (1000,)))
        st = dgc_init({"w": torch.from_numpy(g)})
        sent, st = dgc_step({"w": torch.from_numpy(g)}, st, ratio=0.05)
        np.testing.assert_allclose(_np(sent["w"]) + _np(st.residual["w"]), g,
                                   atol=1e-6)
        nz = int((sent["w"] != 0).sum())
        assert 40 <= nz <= 80
        jsent, _ = jax_optim.dgc_step({"w": jnp.asarray(g)},
                                      jax_optim.dgc_init({"w": jnp.asarray(g)}),
                                      ratio=0.05)
        np.testing.assert_array_equal(_np(sent["w"]), _np(jsent["w"]))


def test_straggler_monitor_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 3.0, 1.0, 2.4, 2.6, 1.0]
    port, ref = [], []
    a = StragglerMonitor(threshold=2.5, window=4,
                         on_straggler=lambda *x: port.append(x))
    b = JaxStragglerMonitor(threshold=2.5, window=4,
                            on_straggler=lambda *x: ref.append(x))
    assert [a.record(i, t) for i, t in enumerate(times)] == \
        [b.record(i, t) for i, t in enumerate(times)]
    assert a.flagged == b.flagged and port == ref and a.flagged
    assert a.median() == b.median() == statistics.median(times)
