"""Flash attention forward: the wrapper of the CUDA C++ kernel in
``repro_torch/csrc/flash_attention.cu``, bound with ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``).  The source file carries the
kernel's note: what bounds it on the H100 and what its design does about it.
Unlike the TPU wrapper, nothing is padded: the kernel masks the ragged S edge
and the D columns itself, and the scale uses the real D.  ``FlashAttentionFn``
gives it a gradient through a plain PyTorch backward (the TPU kernel has no
backward kernel either).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref

launches = 0   # kernel launches since the last reset (see ops.launch_counts)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KH, S, D), CUDA, f32 or bf16 -> (B, H, S, D).

    Any strides with a contiguous last dimension; the output has q's memory
    layout (``empty_like``), so a (B, S, H, D) tensor passed as a transposed
    view comes back the same way.
    """
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    B, H, S, D = q.shape
    KH = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or H % KH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (need (B, KH, S, D), H % KH == 0)")
    if not 0 < D <= 128:
        raise ValueError(f"flash_attention: head dim {D} not in 1..128")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                        "; need all float32 or all bfloat16")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the last dimension must be contiguous")
    o = torch.empty_like(q)
    fn, err_str = _fn()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPES[q.dtype], B, H, KH, S, D, int(causal),
             math.log2(math.e) / math.sqrt(D),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    return o


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward launches the kernel;
    the backward is plain PyTorch (``ref.flash_attention_bwd``, recomputing
    from the saved q, k, v) and launches no kernel of this module."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*ref.flash_attention_bwd(q, k, v, do, causal=ctx.causal), None)
