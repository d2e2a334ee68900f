"""RMSNorm: the wrapper of the CUDA C++ kernel in ``repro_torch/csrc/rmsnorm.cu``,
bound with ctypes.  ``y = x * rsqrt(mean(x^2) + eps) * w`` over the last
dimension, f32 statistics, output in ``x.dtype``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``_rmsnorm_kernel`` / ``rmsnorm_2d``).  The source file carries the
kernel's note: what bounds it on the H100 (bytes) and what its design does
about it.  ``_plan`` chooses the launch from dtype, D, base pointers and
strides alone, before it: 16-byte loads where D, the row stride and the
pointers allow them (else one element a load), the loads a thread holds
per row and the warps per row (``_split``), the rows a block holds at once
and a grid of at most ``BLOCKS_PER_SM`` blocks an SM, whose groups of warps
walk the rows.  Nothing is padded or copied: x is read through its row
stride.

``RMSNormFn`` gives the kernel a gradient through a plain PyTorch backward;
on ``meta`` tensors it calls ``rmsnorm_meta``, the operator
``repro_torch::rmsnorm``, which stands for the launch in a profiler capture
(the analytical trace route), returns the output's shape and dtype and
computes and counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, ref
from ._meta import meta_library

launches = 0   # kernel launches since the last reset (see ops.launch_counts)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                  # a block: 8 warps (csrc/rmsnorm.cu, kThreads)
NV_MAX = 5                     # loads a thread may hold per row (1..5 instantiated)
WARPS_PER_ROW = (1, 2, 4, 8)
BLOCKS_PER_SM = 4              # the grid's cap, by measurement (PERF.md)
H100_SMS = 132


class Plan(NamedTuple):
    vec: int              # elements a load: 16 bytes' worth, or 1
    nv: int               # loads a thread holds per row; 0 loops over the row
    warps_per_row: int
    rows_per_block: int   # rows a block holds at once
    grid: int             # blocks; each group of warps walks rows with a stride


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as (rows, D) with a contiguous last dim: a view where one exists."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(-1) == 1 else x2.contiguous()


def _plan(x: torch.Tensor, w: torch.Tensor, sms: int = H100_SMS) -> Plan:
    """The launch for x (..., D) and w (D,): from dtype, D, base pointers and
    the row stride only (``sms``: the card's SM count)."""
    x2 = _rows(x)
    rows, D = x2.shape
    vec = 16 // x2.element_size()
    w_bytes = min(16, vec * w.element_size())
    if (D % vec or (rows > 1 and x2.stride(0) % vec) or x2.data_ptr() % 16
            or w.data_ptr() % w_bytes):
        vec = 1
    wpr, nv = _split(-(-D // vec))
    rows_per_block = THREADS // 32 // wpr
    grid = max(1, min(-(-rows // rows_per_block), sms * BLOCKS_PER_SM))
    return Plan(vec, nv, wpr, rows_per_block, grid)


def _split(nvec: int) -> tuple:
    """(warps a row, loads a thread) for a row of ``nvec`` loads: the split
    with no idle lane and the fewest loads a thread, from 2 to NV_MAX;
    without one, the fewest warps whose threads hold the row in at most
    NV_MAX loads (some lanes idle); past 8 warps' worth, (8, 0): the loop
    over the row in chunks.  Measured on the H100 (PERF.md): at 2048
    bf16 columns 4 warps of 2 loads beat 2 of 4 and 8 of 1; at 2560, 2 warps
    of 5 beat 4 of 3 and 8 of 2, which leave lanes idle."""
    exact = [(nvec // (32 * wpr), wpr) for wpr in WARPS_PER_ROW
             if nvec % (32 * wpr) == 0 and 2 <= nvec // (32 * wpr) <= NV_MAX]
    if exact:
        nv, wpr = min(exact)
        return wpr, nv
    for wpr in WARPS_PER_ROW:
        nv = -(-nvec // (32 * wpr))
        if nv <= NV_MAX:
            return wpr, nv
    return WARPS_PER_ROW[-1], 0


@functools.cache
def _fn():
    lib = _build.load("rmsnorm")
    fn = lib.repro_rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) CUDA f32/bf16, w: (D,) f32/bf16 on the same device ->
    x.shape in x's dtype."""
    global launches
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} for last dim {D}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: dtype {x.dtype}; need float32 or bfloat16")
    if w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: weight dtype {w.dtype}; need float32 or bfloat16")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("rmsnorm: x and w must be on one CUDA device")
    x2 = _rows(x)
    w = w.contiguous()
    y2 = torch.empty((x2.shape[0], D), dtype=x.dtype, device=x.device)
    if y2.numel() == 0:
        return y2.reshape(x.shape)
    plan = _plan(x2, w, _sms(x.device))
    fn, err_str = _fn()
    x_stride = x2.stride(0) if x2.shape[0] > 1 else D   # one row's stride is any
    err = fn(x2.data_ptr(), w.data_ptr(), y2.data_ptr(), _DTYPES[x.dtype],
             _DTYPES[w.dtype], x2.shape[0], D, x_stride, D, eps, plan.vec, plan.nv,
             plan.warps_per_row, plan.grid,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: {err_str(err).decode()} "
                           f"(cudaError {err}, {plan})")
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
