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
from repro_torch.kernels import flash_attention as flash_kernel  # noqa: E402
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
    ops.flash_attention(q, q[:, :1], q[:, :1])
    ops.rmsnorm(torch.zeros(3, 16), torch.ones(16))
    assert ops.launch_counts() == {"flash_attention": 0, "rmsnorm": 0}


@pytest.mark.parametrize("q_shape,k_shape,dtype,match", [
    ((1, 2, 8, 160), (1, 1, 8, 160), torch.float32, "head dim"),
    ((1, 3, 8, 16), (1, 2, 8, 16), torch.float32, "H % KH"),
    ((1, 2, 8, 16), (1, 1, 9, 16), torch.float32, "do not match"),
    ((1, 2, 8, 16), (1, 1, 8, 16), torch.float16, "dtypes"),
])
def test_flash_wrapper_rejects_bad_inputs(q_shape, k_shape, dtype, match):
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        flash_kernel.flash_attention(q, k, k)


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
