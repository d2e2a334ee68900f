"""Fused AdamW update: the wrapper of the CUDA C++ kernel in
``repro_torch/csrc/fused_adam.cu``, bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/fused_adam.py``
(``_adam_kernel`` / ``fused_adam_2d``).  The source file carries the kernel's
note: what bounds it on the H100 and what its design does about it.  Unlike
the TPU wrapper nothing is padded or reshaped, and the update is in place:
``p``, ``m`` and ``v`` are overwritten and returned.  ``_plan`` splits the
vectors before the launch: where all four base pointers are 16-byte aligned
the body (all but the last ``N % 4`` entries) goes through the kernel's ring
of bulk copies in tiles of ``TILE`` entries, ``STAGES`` deep, and the tail
through a plain loop in the same launch; otherwise the tail is all of it.
``fused_adam_meta`` is the launch on meta tensors (the analytical trace
route): the operator ``repro_torch::fused_adam`` in a profiler capture,
computing and counting nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build
from ._meta import meta_library

launches = 0   # kernel launches since the last reset (see ops.launch_counts)

TILE = 2048     # entries of each vector a bulk copy moves (csrc/fused_adam.cu, kTile)
STAGES = 3      # tiles in a block's ring (kStages)


class Plan(NamedTuple):
    aligned: bool   # all four base pointers 16-byte aligned
    body: int       # entries through the ring of bulk copies: a multiple of 4
    tail: int       # entries through the plain loop after it


def _plan(n: int, ptrs: Sequence[int]) -> Plan:
    """The split of ``n`` entries at the base pointers ``ptrs`` (p, g, m, v):
    bulk copies need 16-byte addresses and sizes."""
    aligned = all(ptr % 16 == 0 for ptr in ptrs)
    body = n - n % 4 if aligned else 0
    return Plan(aligned, body, n - body)


@functools.cache
def _fn():
    lib = _build.load("fused_adam")
    fn = lib.repro_fused_adam
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 6
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_fused_adam_blocks_per_sm.argtypes = []
    lib.repro_fused_adam_blocks_per_sm.restype = ctypes.c_int
    return fn, lib.repro_cuda_error_string, lib.repro_fused_adam_blocks_per_sm


def blocks_per_sm() -> int:
    """The blocks an SM the kernel's launch runs on the current CUDA device
    (the occupancy API's count beside its shared memory)."""
    _, err_str, per_sm = _fn()
    got = per_sm()
    if got < 0:
        raise RuntimeError(f"fused_adam occupancy query failed: "
                           f"{err_str(-got).decode()} (cudaError {-got})")
    return got


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
               c2: torch.Tensor, *, b1: float, b2: float, eps: float,
               wd: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """p, g, m, v: flat contiguous f32 CUDA vectors of one length, four
    distinct buffers; lr, c1, c2: one-element f32 tensors on the same device
    (read by the kernel there, so no host sync).  Updates p, m, v in place
    and returns them."""
    global launches
    vecs = (p, g, m, v)
    if any(t.dim() != 1 or t.shape != p.shape for t in vecs):
        raise ValueError("fused_adam: p, g, m, v must be 1-D of one length, got "
                         f"{[tuple(t.shape) for t in vecs]}")
    scalars = (lr, c1, c2)
    if any(t.dtype != torch.float32 for t in vecs + scalars):
        raise TypeError("fused_adam: all tensors must be float32")
    if any(t.numel() != 1 for t in scalars):
        raise ValueError("fused_adam: lr, c1, c2 must hold one element each")
    if not (p.is_cuda and all(t.device == p.device for t in vecs + scalars)):
        raise ValueError("fused_adam: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in vecs + scalars):
        raise ValueError("fused_adam: all tensors must be contiguous")
    if p.numel() and len({t.data_ptr() for t in vecs}) != 4:
        raise ValueError("fused_adam: p, g, m, v must be distinct buffers")
    fn, err_str, _ = _fn()
    ptrs = [t.data_ptr() for t in vecs]
    err = fn(*ptrs, lr.data_ptr(), c1.data_ptr(), c2.data_ptr(),
             b1, 1 - b1, b2, 1 - b2, eps, wd, p.numel(), _plan(p.numel(), ptrs).body,
             torch.cuda.current_stream(p.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_adam kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    return p, m, v


_META_LIB = meta_library(
    "fused_adam(Tensor(a!) p, Tensor g, Tensor(b!) m, Tensor(c!) v, Tensor lr, "
    "Tensor c1, Tensor c2, float b1, float b2, float eps, float wd) -> ()",
    lambda *args: None)


def fused_adam_meta(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
                    c2: torch.Tensor, b1: float, b2: float, eps: float,
                    wd: float) -> None:
    """The kernel's launch on meta tensors (p, m, v "updated in place")."""
    torch.ops.repro_torch.fused_adam(p, g, m, v, lr, c1, c2, b1, b2, eps, wd)
