"""DGC threshold pass: the wrapper of the CUDA C++ kernel in
``repro_torch/csrc/dgc_topk.cu``, bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/dgc_topk.py``
(``_dgc_kernel`` / ``dgc_threshold_2d``), the selection stage of Deep
Gradient Compression: the threshold (the k-th magnitude, estimated outside
the kernel) zeroes every entry below it in one pass that also counts the
survivors.  The source file carries the kernel's note.  Unlike the TPU
wrapper nothing is padded, and a bf16 gradient is read and written as bf16.
``dgc_threshold_meta`` is the launch on meta tensors (the analytical trace
route): the operator ``repro_torch::dgc_mask`` in a profiler capture,
returning the outputs' shapes and dtypes and computing and counting nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from ._meta import meta_library

launches = 0   # kernel launches since the last reset (see ops.launch_counts)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    lib = _build.load("dgc_topk")
    fn = lib.repro_dgc_threshold
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def dgc_threshold(g: torch.Tensor, thr: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g: CUDA f32 or bf16, any shape; thr: a one-element f32 tensor on the
    same device.  Returns (g with ``|g| < thr`` zeroed, in g's dtype and
    shape; the int64 0-dim count of entries kept, on the device)."""
    global launches
    if g.dtype not in _DTYPES:
        raise TypeError(f"dgc_threshold: dtype {g.dtype}; need float32 or bfloat16")
    if thr.dtype != torch.float32 or thr.numel() != 1:
        raise ValueError("dgc_threshold: thr must be one float32 element")
    if not (g.is_cuda and thr.device == g.device):
        raise ValueError("dgc_threshold: g and thr must be on one CUDA device")
    g, thr = g.contiguous(), thr.contiguous()
    out = torch.empty_like(g)
    count = torch.zeros((), dtype=torch.int64, device=g.device)
    fn, err_str = _fn()
    err = fn(g.data_ptr(), out.data_ptr(), thr.data_ptr(), _DTYPES[g.dtype],
             g.numel(), count.data_ptr(),
             torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"dgc_threshold kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    return out, count


_META_LIB = meta_library(
    "dgc_mask(Tensor g, Tensor thr) -> (Tensor, Tensor)",
    lambda g, thr: (torch.empty(g.shape, dtype=g.dtype, device=g.device),
                    torch.empty((), dtype=torch.int64, device=g.device)))


def dgc_threshold_meta(g: torch.Tensor, thr: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch on meta tensors: (g's shape and dtype, an int64
    0-dim count)."""
    return torch.ops.repro_torch.dgc_mask(g, thr)
