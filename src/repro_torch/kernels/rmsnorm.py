"""RMSNorm as a Triton kernel: ``y = x * rsqrt(mean(x^2) + eps) * w`` over the
last dimension, f32 statistics, output in ``x.dtype``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``rmsnorm_2d``).

What bounds it on the H100: bytes.  It does ~4 operations per element against
one read and one write of ``x`` (2 bytes each in bf16), so the floor is
``(2 * rows * D + D) * itemsize / 3.35e12`` s, far above any operation bound.
The design does about that what the TPU kernel did, with nothing padded:
one program per row (several rows per program when D is small, so each
program still moves a few KB), the whole row in registers as one block of
``BLOCK_D = next_power_of_2(D)`` with a masked tail, so ``x`` is read once and
``y`` written once; the sum of squares and the scale are f32.

``triton`` is imported at the first launch, not with this module, so the
module imports on machines without it (the CPU tests use ``ops.rmsnorm``'s
plain path).  ``RMSNormFn`` gives the kernel a gradient through a plain
PyTorch backward; on ``meta`` tensors it calls ``rmsnorm_meta``, the operator
``repro_torch::rmsnorm``, which stands for the launch in a profiler capture
(the analytical trace route), returns the output's shape and dtype and
computes and counts nothing.
"""

from __future__ import annotations

import functools
import os

import torch

from . import _build, ref
from ._meta import meta_library

launches = 0   # kernel launches since the last reset (see ops.launch_counts)

tl = None      # triton.language, bound by _kernel() before the first compile


def _rmsnorm_rows(x_ptr, w_ptr, y_ptr, n_rows, n_cols, x_row_stride,
                  y_row_stride, eps, BLOCK_D: "tl.constexpr",
                  ROWS: "tl.constexpr"):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_D)
    col_ok = cols < n_cols
    mask = (rows < n_rows)[:, None] & col_ok[None, :]
    rows64 = rows.to(tl.int64)[:, None]
    x = tl.load(x_ptr + rows64 * x_row_stride + cols[None, :], mask=mask,
                other=0.0).to(tl.float32)
    inv = tl.rsqrt(tl.sum(x * x, axis=1) / n_cols + eps)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
    y = x * inv[:, None] * w[None, :]
    tl.store(y_ptr + rows64 * y_row_stride + cols[None, :],
             y.to(y_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _kernel():
    global tl
    # Triton's compile cache goes beside the CUDA builds, not under $HOME
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.BUILD_DIR.parent / "triton_cache"))
    import triton
    import triton.language
    tl = triton.language
    return triton, triton.jit(_rmsnorm_rows)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) CUDA f32/bf16, w: (D,) on the same device -> x.shape."""
    global launches
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} for last dim {D}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: dtype {x.dtype}; need float32 or bfloat16")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("rmsnorm: x and w must be on one CUDA device")
    triton, kernel = _kernel()
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w = w.contiguous()
    y2 = torch.empty((x2.shape[0], D), dtype=x.dtype, device=x.device)
    block_d = triton.next_power_of_2(D)
    rows = max(1, min(16, 4096 // block_d))
    warps = max(1, min(16, block_d * rows // 256))
    grid = (triton.cdiv(x2.shape[0], rows),)
    kernel[grid](x2, w, y2, x2.shape[0], D, x2.stride(0), y2.stride(0), eps,
                 BLOCK_D=block_d, ROWS=rows, num_warps=warps)
    launches += 1
    return y2.reshape(x.shape)


_META_LIB = meta_library(
    "rmsnorm(Tensor x, Tensor w, float eps) -> Tensor",
    lambda x, w, eps: torch.empty(x.shape, dtype=x.dtype, device=x.device))


def rmsnorm_meta(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's launch on meta tensors: its output, of x's shape and
    dtype, and nothing computed or counted."""
    return torch.ops.repro_torch.rmsnorm(x, w, eps)


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm`` with a gradient: the forward launches the kernel
    (``rmsnorm_meta`` on meta tensors); the backward is plain PyTorch
    (``ref.rmsnorm_bwd``, recomputing from the saved x and w) and launches
    no kernel of this module."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if x.is_meta:
            return rmsnorm_meta(x, w, eps)
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return (*ref.rmsnorm_bwd(x, w, dy, ctx.eps), None)
