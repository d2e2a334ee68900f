"""repro_torch kernels against the JAX package's kernels and oracles.

On the CPU the port's ``ops`` run the plain versions (``repro_torch.kernels.
ref``); they are held against ``repro.kernels.ops`` (Pallas, interpret mode,
as tests/test_kernels.py runs it) and ``repro.kernels.ref`` on the same numpy
inputs, over tests/test_kernels.py's sweeps and tolerances.  The tests marked
``gpu`` hold the CUDA/Triton kernels against the plain versions on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import dgc_topk as dgc_kernel  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
from repro_torch.kernels import fused_adam as adam_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_kernel  # noqa: E402

FLASH_SHAPES = [            # (B, H, KH, S, D), as tests/test_kernels.py
    (1, 2, 1, 128, 64),
    (2, 4, 2, 256, 128),
    (1, 8, 2, 96, 80),
    (1, 1, 1, 64, 128),
]
RMS_SHAPES = [(4, 64), (3, 5, 300), (16, 1024), (1, 7)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_ATOL = {"float32": 2e-3, "bfloat16": 3e-2}
RMS_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,KH,S,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(B, H, KH, S, D, dtype, causal):
    rng = np.random.default_rng(0)
    jq, tq = _both(rng.standard_normal((B, H, S, D), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, KH, S, D), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, KH, S, D), np.float32), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    atol = FLASH_ATOL[dtype]
    np.testing.assert_allclose(
        _f32(ref.flash_attention_ref(tq, tk, tv, causal=causal)),
        _f32(jax_ref.flash_attention_ref(jq, jk, jv, causal=causal)), atol=atol)
    np.testing.assert_allclose(
        _f32(got), _f32(jax_ops.flash_attention(jq, jk, jv, causal=causal)),
        atol=atol)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(shape, dtype):
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal(shape, np.float32), dtype)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    atol = RMS_ATOL[dtype]
    np.testing.assert_allclose(_f32(ref.rmsnorm_ref(tx, tw)),
                               _f32(jax_ref.rmsnorm_ref(jx, jw)), atol=atol)
    np.testing.assert_allclose(_f32(got), _f32(jax_ops.rmsnorm(jx, jw)),
                               atol=atol)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' own wrappers never compute on the CPU: only ``ops``
    routes a CPU tensor to the plain version, and no launch is counted."""
    ops.reset_launch_counts()
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel.rmsnorm(torch.zeros(3, 16), torch.ones(16))
    vec, one = [torch.zeros(8) for _ in range(4)], torch.ones(1)
    with pytest.raises(ValueError, match="CUDA"):
        adam_kernel.fused_adam(*vec, one, one, one, b1=0.9, b2=0.95, eps=1e-8,
                               wd=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        dgc_kernel.dgc_threshold(torch.zeros(8), torch.ones(1))
    ops.flash_attention(q, q[:, :1], q[:, :1])
    ops.rmsnorm(torch.zeros(3, 16), torch.ones(16))
    ops.fused_adam(*vec, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=0.1,
                   c2=0.05)
    ops.dgc_mask(torch.zeros(8), 0.5)
    assert ops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0,
                                   "fused_adam": 0, "dgc_mask": 0}


@pytest.mark.parametrize("q_shape,k_shape,v_shape,dtype,match", [
    ((1, 2, 8, 200), (1, 1, 8, 200), None, torch.float32, "q/k head dim 200"),
    ((1, 3, 8, 16), (1, 2, 8, 16), None, torch.float32, "H % KH"),
    ((1, 2, 8, 16), (1, 1, 9, 16), None, torch.float32, "do not match"),
    ((1, 2, 8, 16), (1, 1, 8, 16), None, torch.float16, "dtypes"),
    ((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 9, 16), torch.float32, "bad shapes"),
    ((1, 2, 8, 192), (1, 1, 8, 192), (1, 1, 8, 136), torch.float32,
     "v head dim 136"),
])
def test_flash_wrapper_rejects_bad_inputs(q_shape, k_shape, v_shape, dtype, match):
    """q/k head dims past 192, v head dims past 128 and a v whose B/KH/S
    disagree with k's are refused before any launch (192 with 128 is
    MLA's, and legal)."""
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    v = k if v_shape is None else torch.zeros(v_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        flash_kernel.flash_attention(q, k, v)


def test_flash_attention_accepts_reference_block_keywords():
    """``ops.flash_attention`` takes the reference's ``block_q``/``block_k``
    and ignores them: the CUDA kernels choose their own tiles."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 40, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 40, 16), np.float32))
    for causal in (True, False):
        want = ops.flash_attention(q, k, k, causal=causal)
        got = ops.flash_attention(q, k, k, causal=causal, block_q=16, block_k=32)
        assert torch.equal(got, want)


ADAM_NS = [100, 1024, 5000, 1 << 14]       # as tests/test_kernels.py
ADAM_KW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=0.2, c2=0.1)
ADAM_ATOL = (1e-5, 1e-6, 1e-6)              # p, m, v: tests/test_kernels.py's
DGC_CASES = [((100,), 0.1), ((123, 45), 0.01), ((4096,), 0.001)]
# gradients through the kernels' Functions against autograd of the plain
# versions: f32 sums in another order (f32), bf16 rounding of the inputs and
# outputs (bf16); plus, in bf16, one ulp of the reference (2^-7 |x|), by
# which two bf16 roundings of f32 sums that differ in the last bits can
# differ where a gradient sums many rows (dv of early keys, RMSNorm's dw)
GRAD_ATOL = {"float32": 5e-3, "bfloat16": 5e-2}
GRAD_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _grad_close(a, b, dtype) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= GRAD_ATOL[dtype] + GRAD_RTOL[dtype] * b.abs()).all())


def _adam_inputs(n: int):
    rng = np.random.default_rng(1)
    p, g = rng.standard_normal(n), rng.standard_normal(n)
    m = rng.standard_normal(n) * 0.1
    v = np.abs(rng.standard_normal(n)) * 0.01
    return [a.astype(np.float32) for a in (p, g, m, v)]


@pytest.mark.parametrize("n", ADAM_NS)
def test_fused_adam_matches_jax(n):
    """``fused_adam_ref`` and ``ops.fused_adam`` (CPU) against the JAX Pallas
    kernel (interpret mode) and the JAX oracle, with tests/test_kernels.py's
    tolerances."""
    arrs = _adam_inputs(n)
    want = jax_ops.fused_adam(*map(jnp.asarray, arrs), **ADAM_KW)
    want_ref = jax_ref.fused_adam_ref(*map(jnp.asarray, arrs), **ADAM_KW)
    for got in (ref.fused_adam_ref(*map(torch.from_numpy, arrs), **ADAM_KW),
                ops.fused_adam(*map(torch.from_numpy, arrs), **ADAM_KW)):
        for a, b, c, atol in zip(got, want, want_ref, ADAM_ATOL):
            assert a.dtype == torch.float32 and a.shape == (n,)
            np.testing.assert_allclose(_f32(a), _f32(b), atol=atol)
            np.testing.assert_allclose(_f32(a), _f32(c), atol=atol)


@pytest.mark.parametrize("shape,ratio", DGC_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dgc_mask_matches_jax(shape, ratio, dtype):
    """``dgc_topk_ref`` and ``ops.dgc_mask`` (CPU) against the JAX oracle and
    the JAX Pallas kernel (interpret mode): exact, ``count >= k``."""
    jg, tg = _both(np.random.default_rng(3).standard_normal(shape, np.float32),
                   dtype)
    want, jk, jthr = jax_ref.dgc_topk_ref(jg, ratio)
    got, k, thr = ref.dgc_topk_ref(tg, ratio)
    assert k == jk and float(thr) == float(jthr)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    jsparse, jcount = jax_ops.dgc_mask(jg, jthr)
    for threshold in (thr, float(thr)):
        sparse, count = ops.dgc_mask(tg, threshold)
        assert sparse.dtype == tg.dtype and sparse.shape == tg.shape
        np.testing.assert_array_equal(_f32(sparse), _f32(jsparse))
        np.testing.assert_array_equal(_f32(sparse), _f32(want))
        assert int(count) == int(jcount) >= k


def _grad_inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(DTYPES[dtype][1]) for s in shapes]


def _autograd(fn, inputs, dout):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


@pytest.mark.parametrize("B,H,KH,S,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_matches_autograd(monkeypatch, B, H, KH, S, D,
                                              dtype, causal):
    """``ref.flash_attention_bwd`` (the Function's backward) against autograd
    through ``flash_attention_ref``, in query chunks of 7 rows (S % 7 != 0)
    so the chunking and the causal key cut are exercised."""
    q, k, v, do = _grad_inputs([(B, H, S, D), (B, KH, S, D), (B, KH, S, D),
                                (B, H, S, D)], dtype, 4)
    monkeypatch.setattr(ref, "BWD_SCORE_ELEMS", B * H * S * 7)
    got = ref.flash_attention_bwd(q, k, v, do, causal=causal)
    want = _autograd(lambda *a: ref.flash_attention_ref(*a, causal=causal),
                     (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), atol=GRAD_ATOL[dtype])


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_matches_autograd(shape, dtype):
    x, dy = _grad_inputs([shape, shape], dtype, 5)
    w = _grad_inputs([(shape[-1],)], "float32", 6)[0]
    got = ref.rmsnorm_bwd(x, w, dy)
    want = _autograd(ref.rmsnorm_ref, (x, w), dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), atol=GRAD_ATOL[dtype],
                                   rtol=GRAD_RTOL[dtype])


def test_functions_launch_forward_only_and_pass_gradients(monkeypatch):
    """FlashAttentionFn and RMSNormFn with their kernel wrappers replaced by
    the plain versions (there is no kernel on the CPU): gradients equal
    autograd of the plain versions, the backward calls no forward wrapper,
    and both run under ``torch.inference_mode``."""
    calls = []

    def fake(plain):
        def run(*args, **kw):
            calls.append(plain.__name__)
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(flash_kernel, "flash_attention", fake(ref.flash_attention_ref))
    monkeypatch.setattr(rmsnorm_kernel, "rmsnorm", fake(ref.rmsnorm_ref))
    # q, k, v as the model passes them: (B, S, H, D) tensors viewed as (B, H, S, D)
    q, k, v = (t.transpose(1, 2) for t in _grad_inputs(
        [(2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16)], "float32", 7))
    x, w = _grad_inputs([(2, 12, 16), (16,)], "float32", 8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, x, w)]
    out = (flash_kernel.FlashAttentionFn.apply(*leaves[:3], True).sum(1)
           + rmsnorm_kernel.RMSNormFn.apply(leaves[3], leaves[4], 1e-6)
           ).square().sum()
    assert calls == ["flash_attention_ref", "rmsnorm_ref"]
    got = torch.autograd.grad(out, leaves)
    assert calls == ["flash_attention_ref", "rmsnorm_ref"]
    want = _autograd(lambda q, k, v, x, w: (
        ref.flash_attention_ref(q, k, v).sum(1)
        + ref.rmsnorm_ref(x, w)).square().sum(), (q, k, v, x, w), None)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-4 * _f32(b).max())
    with torch.inference_mode():
        y = flash_kernel.FlashAttentionFn.apply(q, k, v, False)
        z = rmsnorm_kernel.RMSNormFn.apply(x, w, 1e-6)
    np.testing.assert_array_equal(_f32(y), _f32(ref.flash_attention_ref(
        q, k, v, causal=False)))
    np.testing.assert_array_equal(_f32(z), _f32(ref.rmsnorm_ref(x, w)))


@pytest.mark.parametrize("case,match", [
    ("short_m", "one length"), ("f64", "float32"), ("lr_shape", "one element"),
    ("aliased", "distinct"), ("strided", "contiguous")])
def test_fused_adam_wrapper_rejects_bad_inputs(monkeypatch, case, match):
    """The wrapper's checks, ahead of the device check (moved out of the way
    by pretending every tensor is on CUDA)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    p, g, m, v = (torch.zeros(8) for _ in range(4))
    lr = c1 = c2 = torch.ones(1)
    if case == "short_m":
        m = torch.zeros(7)
    elif case == "f64":
        g = g.double()
    elif case == "lr_shape":
        lr = torch.ones(2)
    elif case == "aliased":
        v = m
    elif case == "strided":
        p, g, m, v = (torch.zeros(16)[::2] for _ in range(4))
    with pytest.raises((ValueError, TypeError), match=match):
        adam_kernel.fused_adam(p, g, m, v, lr, c1, c2, b1=0.9, b2=0.95,
                               eps=1e-8, wd=0.1)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,D", FLASH_SHAPES + [(4, 32, 4, 512, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_gpu(cuda, B, H, KH, S, D, dtype, causal):
    td = DTYPES[dtype][1]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(td)
               for shape in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))
    before = flash_kernel.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= FLASH_ATOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 32, 96])
@pytest.mark.parametrize("S", [1, 7, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_small_head_dims_on_gpu(cuda, D, S, causal, layout):
    """bf16 head dims that the tensor-core kernel runs in a wider bucket with
    zero-filled columns, and S below one tile (S = 1 is a one-token prompt)."""
    B, H, KH = 1, 4, 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    if layout == "bshd":
        q, k, v = (torch.randn(B, S, h, D, generator=gen, device=cuda)
                   .bfloat16().transpose(1, 2) for h in (H, KH, KH))
    else:
        q, k, v = (torch.randn(B, h, S, D, generator=gen, device=cuda).bfloat16()
                   for h in (H, KH, KH))
    assert flash_kernel._variant(q, k, v) == "wgmma"
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= FLASH_ATOL["bfloat16"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RMS_SHAPES + [(4, 512, 2048), (4, 1, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_on_gpu(cuda, shape, dtype):
    td = DTYPES[dtype][1]
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=gen, device=cuda).to(td)
    w = torch.randn(shape[-1], generator=gen, device=cuda)
    before = rmsnorm_kernel.launches
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches == before + 1
    want = ref.rmsnorm_ref(x, w)
    assert (got.float() - want.float()).abs().max().item() <= RMS_ATOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("n", ADAM_NS + [(1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_adam_kernel_on_gpu(cuda, n, offset):
    """The kernel against the plain version, on vectors 16-byte aligned
    (offset 0) and not (offset 1: the scalar loop); updated in place."""
    arrs = [torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), a]))
            .to(cuda)[offset:] for a in _adam_inputs(n)]
    want = ref.fused_adam_ref(*arrs, **ADAM_KW)
    p, m, v = (arrs[i].clone() for i in (0, 2, 3))
    before = adam_kernel.launches
    got = ops.fused_adam(p, arrs[1], m, v, **ADAM_KW)
    torch.cuda.synchronize()
    assert adam_kernel.launches == before + 1
    assert got[0] is p and got[1] is m and got[2] is v
    for a, b, atol in zip(got, want, ADAM_ATOL):
        assert (a - b).abs().max().item() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ratio", DGC_CASES + [((32000, 2048), 0.01)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dgc_kernel_on_gpu(cuda, shape, ratio, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn(shape, generator=gen, device=cuda).to(DTYPES[dtype][1])
    want, k, thr = ref.dgc_topk_ref(g, ratio)
    before = dgc_kernel.launches
    got, count = ops.dgc_mask(g, thr)
    torch.cuda.synchronize()
    assert dgc_kernel.launches == before + 1
    plain, plain_count = ref.dgc_mask_ref(g, thr)
    assert torch.equal(got, want) and torch.equal(got, plain)
    assert int(count) == int(plain_count) >= k


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KH,S,D", FLASH_SHAPES + [(2, 32, 4, 1024, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grad_on_gpu(cuda, B, H, KH, S, D, dtype, causal):
    """Gradients through FlashAttentionFn against autograd of the plain
    version; the backward launches no kernel."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(s, generator=gen, device=cuda).to(DTYPES[dtype][1])
                   for s in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D), (B, H, S, D)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_kernel.launches
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    want = _autograd(lambda *a: ref.flash_attention_ref(*a, causal=causal),
                     (q, k, v), do)
    for a, b in zip(got, want):
        assert _grad_close(a, b, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RMS_SHAPES + [(2, 4096, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grad_on_gpu(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x, dy = (torch.randn(shape, generator=gen, device=cuda).to(DTYPES[dtype][1])
             for _ in range(2))
    w = torch.randn(shape[-1], generator=gen, device=cuda)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    before = rmsnorm_kernel.launches
    got = torch.autograd.grad(ops.rmsnorm(*leaves), leaves, dy)
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches == before + 1
    want = _autograd(ref.rmsnorm_ref, (x, w), dy)
    for a, b in zip(got, want):
        assert _grad_close(a, b, dtype)
