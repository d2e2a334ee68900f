"""repro_torch kernels against the JAX package's kernels and oracles.

On the CPU the port's ``ops`` run the plain versions (``repro_torch.kernels.
ref``); they are held against ``repro.kernels.ops`` (Pallas, interpret mode,
as tests/test_kernels.py runs it) and ``repro.kernels.ref`` on the same numpy
inputs, over tests/test_kernels.py's sweeps and tolerances.  The tests marked
``gpu`` hold the CUDA kernels against the plain versions on the card.
"""

import re
from pathlib import Path

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
from repro_torch.kernels import _build  # noqa: E402
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
    ((1, 2, 8, 264), (1, 1, 8, 264), None, torch.float32, "q/k head dim 264"),
    ((1, 3, 8, 16), (1, 2, 8, 16), None, torch.float32, "H % KH"),
    ((1, 2, 8, 16), (1, 1, 9, 16), None, torch.float32, "do not match"),
    ((1, 2, 8, 16), (1, 1, 8, 16), None, torch.float16, "dtypes"),
    ((1, 2, 8, 16), (1, 1, 8, 16), (1, 1, 9, 16), torch.float32, "bad shapes"),
    ((1, 2, 8, 256), (1, 1, 8, 256), (1, 1, 8, 264), torch.float32,
     "v head dim 264"),
])
def test_flash_wrapper_rejects_bad_inputs(q_shape, k_shape, v_shape, dtype, match):
    """q/k head dims past 256, v head dims past 256 and a v whose B/KH/S
    disagree with k's are refused before any launch (256 with 256 is
    RecurrentGemma's, and legal)."""
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    v = k if v_shape is None else torch.zeros(v_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        flash_kernel.flash_attention(q, k, v)


@pytest.mark.parametrize("D,Dv", [(256, 256), (256, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_takes_head_dim_256(D, Dv, dtype):
    """Head dim 256 (q/k, and v of 256 or 128) passes every shape and dtype
    check: CPU tensors get as far as the device check."""
    q = torch.zeros(1, 16, 8, D, dtype=dtype)
    k = torch.zeros(1, 1, 8, D, dtype=dtype)
    v = torch.zeros(1, 1, 8, Dv, dtype=dtype)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_kernel.flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_head_dim_256_matches_jax(dtype, causal):
    """recurrentgemma-9b's head dim (256) with one KV head: the port's
    ``ops.flash_attention`` against the JAX package's, which pads D to a
    multiple of 128 (none at 256)."""
    B, H, KH, S, D = 1, 4, 1, 40, 256
    rng = np.random.default_rng(7)
    jq, tq = _both(rng.standard_normal((B, H, S, D), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, KH, S, D), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, KH, S, D), np.float32), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(
        _f32(got), _f32(jax_ops.flash_attention(jq, jk, jv, causal=causal)),
        atol=FLASH_ATOL[dtype])


CSRC = Path(flash_kernel.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("source,limits", [
    ("flash_attention.cu", (flash_kernel.MAX_D, flash_kernel.MAX_D_V)),
    ("flash_attention_wgmma.cu", (flash_kernel.WGMMA_MAX_D, flash_kernel.WGMMA_MAX_D_V)),
])
def test_flash_wrapper_limits_match_the_kernels_host_checks(source, limits):
    """The head-dim limits each kernel's C entry point refuses past are the
    ones the wrapper admits to it: ``MAX_D``/``MAX_D_V`` for the CUDA-core
    kernel (every input), ``WGMMA_MAX_D``/``WGMMA_MAX_D_V`` for the
    tensor-core kernel (``_variant``)."""
    text = (CSRC / source).read_text()
    entry = text[text.index('extern "C"'):]
    got = (int(re.search(r"\bD > (\d+)", entry)[1]),
           int(re.search(r"\bDv > (\d+)", entry)[1]))
    assert got == limits


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


TILE, STAGES = adam_kernel.TILE, adam_kernel.STAGES
# the sizes at the ring's edges: none, under one 16-byte chunk, one chunk and
# a tail, a tile and one entry either side, and every block of a grid of two
# blocks on each of the H100's 132 SMs taking a full ring, plus a tail of 3
ADAM_EDGES = [0, 1, 3, 4, 5, TILE - 1, TILE, TILE + 1, STAGES * TILE * 2 * 132 + 3]
ADAM_OFFSETS = [(0, 0, 0, 0), (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]


@pytest.mark.parametrize("n", ADAM_EDGES)
@pytest.mark.parametrize("offsets", ADAM_OFFSETS,
                         ids=["aligned", "p-off", "g-off", "m-off", "v-off"])
def test_fused_adam_plan_splits_body_and_tail(n, offsets):
    """``_plan``: with all four base pointers 16-byte aligned, the body is all
    but the last ``n % 4`` entries (bulk copies move 16-byte multiples) and
    those are the tail; with any pointer one f32 entry off, the tail is all of
    it."""
    ptrs = [4096 * (i + 1) + 4 * off for i, off in enumerate(offsets)]
    plan = adam_kernel._plan(n, ptrs)
    aligned = not any(offsets)
    assert plan == adam_kernel.Plan(aligned, n - n % 4 if aligned else 0,
                                    n % 4 if aligned else n)
    assert plan.body % 4 == 0 and plan.body + plan.tail == n


def test_fused_adam_constants_match_the_kernel_source():
    """The wrapper's tile and stages are the kernel's."""
    src = (Path(_build.CSRC) / "fused_adam.cu").read_text()
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("kTile", "kStages")}
    assert got == {"kTile": adam_kernel.TILE, "kStages": adam_kernel.STAGES}


def _strided(rows, cols, width, dtype=torch.bfloat16):
    """``cols`` of each row of a (rows, width) tensor: rows ``width`` apart."""
    return torch.empty(rows, width, dtype=dtype)[:, :cols]


def _offset(shape, dtype=torch.bfloat16):
    """A tensor one element past a 16-byte-aligned base."""
    flat = torch.empty(int(np.prod(shape)) + 1, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    return flat[1:].view(shape)


bf16 = torch.bfloat16
Plan = rmsnorm_kernel.Plan


@pytest.mark.parametrize("make,want", [
    # 16-byte loads: 320 loads of 8 bf16 at 2560, 5 a lane of two warps
    (lambda: (torch.empty(4096, 2560, dtype=bf16), torch.empty(2560, dtype=bf16)),
     Plan(8, 5, 2, 4, 528)),
    (lambda: (torch.empty(3, 5, 300), torch.empty(300)), Plan(4, 3, 1, 8, 2)),
    (lambda: (_strided(2048, 512, 576), torch.empty(512, dtype=bf16)),
     Plan(8, 2, 1, 8, 256)),
    (lambda: (torch.empty(2048, 1536, dtype=bf16), torch.empty(1536)),
     Plan(8, 3, 2, 4, 512)),
    (lambda: (torch.empty(4, 1, 2048, dtype=bf16), torch.empty(2048, dtype=bf16)),
     Plan(8, 2, 4, 2, 2)),
    # one element a load: D, pointer or row stride off the 16-byte grain
    (lambda: (torch.empty(1, 7, dtype=bf16), torch.empty(7, dtype=bf16)),
     Plan(1, 1, 1, 8, 1)),
    (lambda: (_offset((64, 2048)), torch.empty(2048, dtype=bf16)), Plan(1, 0, 8, 1, 64)),
    (lambda: (_offset((8, 1024)), torch.empty(1024, dtype=bf16)), Plan(1, 4, 8, 1, 8)),
    (lambda: (_strided(16, 512, 516), torch.empty(512, dtype=bf16)), Plan(1, 2, 8, 1, 16)),
    (lambda: (torch.empty(16, 512, dtype=bf16), _offset((512,), torch.float32)),
     Plan(1, 2, 8, 1, 16)),
    # 2 loads a lane where a split leaves no lane idle; more warps a row past a
    # warp's 5 loads a lane; chunks past eight warps'
    (lambda: (torch.empty(4096, 5120, dtype=bf16), torch.empty(5120, dtype=bf16)),
     Plan(8, 5, 4, 2, 528)),
    (lambda: (torch.empty(16, 4096, dtype=bf16), torch.empty(4096, dtype=bf16)),
     Plan(8, 2, 8, 1, 16)),
    (lambda: (torch.empty(8192, 2048), torch.empty(2048)), Plan(4, 2, 8, 1, 528)),
    (lambda: (torch.empty(8192, 2048, dtype=bf16), torch.empty(2048, dtype=bf16)),
     Plan(8, 2, 4, 2, 528)),
    (lambda: (torch.empty(8, 20000, dtype=bf16), torch.empty(20000, dtype=bf16)),
     Plan(8, 0, 8, 1, 8)),
], ids=["bf16-2560", "f32-300", "bf16-mla-kv-512-of-576", "bf16-1536-f32-w",
        "bf16-decode", "bf16-7", "bf16-offset-2048", "bf16-offset-1024",
        "bf16-stride-516", "bf16-w-offset", "bf16-5120", "bf16-4096", "f32-2048",
        "bf16-2048", "bf16-20000"])
def test_rmsnorm_plan_from_dtype_shape_pointers_and_strides(make, want):
    """``_plan`` is a pure function of dtype, D, pointers and the row stride:
    16-byte loads sized to D where all allow them, else one element a load;
    the split of a row with no idle lane and the fewest loads a thread (2 to
    5), else the fewest warps whose threads hold it in at most 5 loads, past
    8 warps a loop in chunks; a grid of at most four blocks an SM (132
    SMs)."""
    x, w = make()
    assert rmsnorm_kernel._plan(x, w) == want


@pytest.mark.parametrize("case,exc,match", [
    ("weight shape", ValueError, "weight"),
    ("x dtype", TypeError, "dtype torch.float16"),
    ("w dtype", TypeError, "weight dtype torch.float16"),
    ("cpu", ValueError, "CUDA"),
])
def test_rmsnorm_wrapper_refuses_before_loading_the_library(monkeypatch, case, exc,
                                                            match):
    def no_build(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(_build, "load", no_build)
    rmsnorm_kernel._fn.cache_clear()
    x, w = torch.zeros(3, 16), torch.ones(16)
    if case == "weight shape":
        w = torch.ones(15)
    elif case == "x dtype":
        x = x.half()
    elif case == "w dtype":
        w = w.half()
    with pytest.raises(exc, match=match):
        rmsnorm_kernel.rmsnorm(x, w)
    assert rmsnorm_kernel.launches == 0


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


# the families' widths past the sweep (deepseek's q_norm, mamba2's two), and
# MLA's kv_norm: 512 columns of rows 576 wide, read in place (width)
RMS_WIDE = [((2048, 1536), 0), ((4096, 2560), 0), ((4096, 5120), 0), ((2048, 512), 576)]


def _rms_input(gen, shape, width, td, cuda):
    if not width:
        return torch.randn(shape, generator=gen, device=cuda).to(td)
    return torch.randn(*shape[:-1], width, generator=gen, device=cuda).to(td)[..., :shape[-1]]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,width", [(s, 0) for s in RMS_SHAPES
                                         + [(4, 512, 2048), (4, 1, 2048)]] + RMS_WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_on_gpu(cuda, shape, width, dtype):
    td = DTYPES[dtype][1]
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _rms_input(gen, shape, width, td, cuda)
    w = torch.randn(shape[-1], generator=gen, device=cuda)
    before = rmsnorm_kernel.launches
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches == before + 1
    want = ref.rmsnorm_ref(x, w)
    assert (got.float() - want.float()).abs().max().item() <= RMS_ATOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("n", ADAM_NS + [(1 << 20) + 3] + ADAM_EDGES)
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1)] + ADAM_OFFSETS[1:],
                         ids=["aligned", "all-off", "p-off", "g-off", "m-off", "v-off"])
def test_fused_adam_kernel_on_gpu(cuda, n, offsets):
    """The kernel against the plain version, on vectors 16-byte aligned (the
    ring of bulk copies and a tail of n % 4) and with one or all of them an
    entry off (the plain loop); updated in place, and nothing written past
    the vectors."""
    pad = 8
    bufs, arrs = [], []
    for a, off in zip(_adam_inputs(n), offsets):
        buf = torch.full((n + 2 * pad,), 7.0, device=cuda)
        buf[pad + off:pad + off + n] = torch.from_numpy(a).to(cuda)
        bufs.append(buf)
        arrs.append(buf[pad + off:pad + off + n])
    want = ref.fused_adam_ref(*(t.clone() for t in arrs), **ADAM_KW)
    p, g, m, v = arrs
    before = adam_kernel.launches
    got = ops.fused_adam(p, g, m, v, **ADAM_KW)
    torch.cuda.synchronize()
    assert adam_kernel.launches == before + 1
    assert got[0] is p and got[1] is m and got[2] is v
    for a, b, atol in zip(got, want, ADAM_ATOL):
        assert n == 0 or (a - b).abs().max().item() <= atol
    for buf, off in zip(bufs, offsets):
        assert bool((buf[:pad + off] == 7.0).all() and (buf[pad + off + n:] == 7.0).all())


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
@pytest.mark.parametrize("shape,width", [(s, 0) for s in RMS_SHAPES + [(2, 4096, 2048)]]
                         + RMS_WIDE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grad_on_gpu(cuda, shape, width, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _rms_input(gen, shape, width, DTYPES[dtype][1], cuda)
    dy = torch.randn(shape, generator=gen, device=cuda).to(DTYPES[dtype][1])
    w = torch.randn(shape[-1], generator=gen, device=cuda)
    leaves = [x.detach().requires_grad_(), w.clone().requires_grad_()]   # x keeps its strides
    before = rmsnorm_kernel.launches
    got = torch.autograd.grad(ops.rmsnorm(*leaves), leaves, dy)
    torch.cuda.synchronize()
    assert rmsnorm_kernel.launches == before + 1
    want = _autograd(ref.rmsnorm_ref, (x, w), dy)
    for a, b in zip(got, want):
        assert _grad_close(a, b, dtype)
