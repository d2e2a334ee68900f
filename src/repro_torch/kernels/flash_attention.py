"""Flash attention forward: the wrappers of two CUDA C++ kernels, bound with
ctypes.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``).  ``_variant`` chooses the kernel
from dtype, head dim, base pointers and strides alone, before the launch:

* ``"wgmma"``, ``repro_torch/csrc/flash_attention_wgmma.cu``: bf16 with
  both head dims multiples of 8 up to 256 (head-dim buckets (64, 64),
  (128, 128), (192, 128) and (256, 256): RecurrentGemma's 256 too),
  16-byte-aligned base pointers and b/h/s strides that are positive
  multiples of 8 elements (what its TMA loads need), with or without a
  local ``window``; both products on the tensor cores;
* ``"scalar"``, ``repro_torch/csrc/flash_attention.cu``: everything else, on
  the f32 CUDA cores.  f32 stays there because it must meet atol 2e-3, which
  TF32 tensor cores do not; bf16 with an odd head dim or unaligned strides
  goes there too.

``window > 0`` keeps key ``k`` for query ``q`` only where ``q - k < window``
(the reference's ``chunked_attention(window=)``, RecurrentGemma's local
attention), with or without ``causal``; both kernels take it.

q and k share one head dim ``D`` and v and the output have their own,
``D_v`` (DeepSeek-V2's MLA: 192 and 128); ``D <= 256`` and ``D_v <= 256``
(``MAX_D``, ``MAX_D_V``: the CUDA-core kernel's limits; the tensor-core
kernel's, ``WGMMA_MAX_D``, ``WGMMA_MAX_D_V``, are the same).  Past them the
wrapper raises, where the reference pads D to a multiple of 128.
The scale is ``1/sqrt(D)``.

A build or launch error of either kernel raises; nothing falls back to the
other.  Each source carries its kernel's note: what bounds it on the H100 and
what its design does about it.  Unlike the TPU wrapper, nothing is padded:
the kernels mask the ragged S edge and the D columns themselves, and the
scale uses the real D.  ``FlashAttentionFn`` gives it a gradient through a
plain PyTorch backward (the TPU kernel has no backward kernel either).

On ``meta`` tensors (the analytical trace route) ``FlashAttentionFn`` calls
``flash_attention_meta`` instead: the operator ``repro_torch::flash_attention``,
which returns the output's shape, dtype and layout and computes nothing, so
a profiler capture holds one operator where the card would launch one
kernel.  No launch is counted; the backward is the same plain recompute, op
by op on meta tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, ref
from ._meta import meta_library

launches = 0   # kernel launches since the last reset (see ops.launch_counts)
launches_by_variant = {"wgmma": 0, "scalar": 0}   # the same launches, per kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D, MAX_D_V = 256, 256   # q/k's and v's largest head dims: the CUDA-core kernel's
WGMMA_MAX_D, WGMMA_MAX_D_V = 256, 256   # the tensor-core kernel's largest
_LIBS = {"scalar": ("flash_attention", "repro_flash_attention_fwd"),
         "wgmma": ("flash_attention_wgmma", "repro_flash_attention_wgmma_fwd")}


@functools.cache
def _fn(variant: str):
    lib_name, symbol = _LIBS[variant]
    lib = _build.load(lib_name)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"wgmma"`` where the tensor-core kernel takes q, k, v, else
    ``"scalar"``: from dtype, head dims, base pointers and strides only
    (both kernels take any ``window``)."""
    D, Dv = q.shape[-1], v.shape[-1]
    if (q.dtype != torch.bfloat16 or D % 8 or Dv % 8 or D > WGMMA_MAX_D
            or Dv > WGMMA_MAX_D_V):
        return "scalar"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s <= 0 or s % 8 for s in t.stride()[:3]):
            return "scalar"
    return "wgmma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} (need v's "
                         "B, KH, S equal to k's)")
    B, H, S, D = q.shape
    KH = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or H % KH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (need (B, KH, S, D), H % KH == 0)")
    if not 0 < D <= MAX_D:
        raise ValueError(f"flash_attention: q/k head dim {D} not in 1..{MAX_D}")
    if not 0 < v.shape[3] <= MAX_D_V:
        raise ValueError(f"flash_attention: v head dim {v.shape[3]} not in "
                         f"1..{MAX_D_V}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                        "; need all float32 or all bfloat16")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the last dimension must be contiguous")


def _window(window: int) -> int:
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0 (0 = none)")
    return window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k: (B, KH, S, D); v: (B, KH, S, D_v), CUDA, f32 or
    bf16 -> (B, H, S, D_v); ``window > 0`` masks keys ``window`` or more
    positions before the query.

    Any strides with a contiguous last dimension; the output has q's memory
    layout (``_out``), so a (B, S, H, D) tensor passed as a transposed view
    comes back the same way.  The kernel is ``_variant``'s choice.
    """
    _check(q, k, v)
    window = _window(window)
    return _launch(_variant(q, k, v), q, k, v, causal, window)


def flash_attention_scalar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """``flash_attention`` through the CUDA-core kernel whatever the inputs
    (it takes all of them), to time it beside the tensor-core kernel."""
    _check(q, k, v)
    return _launch("scalar", q, k, v, causal, _window(window))


def _out(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The output: (B, H, S, D_v) in q's dtype, device and memory layout
    (its dims in the order of q's strides), ``empty_like(q)`` where
    ``D_v == D``."""
    if v.shape[-1] == q.shape[-1]:
        return torch.empty_like(q)
    order = sorted(range(4), key=lambda i: -q.stride(i))      # outermost first
    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    o = torch.empty([shape[i] for i in order], dtype=q.dtype, device=q.device)
    return o.permute([order.index(i) for i in range(4)])


def _launch(variant: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int = 0) -> torch.Tensor:
    global launches
    B, H, S, D = q.shape
    o = _out(q, v)
    fn, err_str = _fn(variant)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             _DTYPES[q.dtype], B, H, k.shape[1], S, D, v.shape[-1], int(causal),
             window, math.log2(math.e) / math.sqrt(D),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention ({variant}) kernel launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    launches += 1
    launches_by_variant[variant] += 1
    return o


_META_LIB = meta_library(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window=0) -> Tensor",
    lambda q, k, v, causal, window=0: _out(q, v))


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int = 0) -> torch.Tensor:
    """The kernel's launch on meta tensors: its output, (B, H, S, D_v) as
    ``_launch`` allocates it (``_out``), and nothing computed or counted."""
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward launches the kernel
    (``flash_attention_meta`` on meta tensors); the backward is plain
    PyTorch (``ref.flash_attention_bwd``, recomputing from the saved q, k,
    v) and launches no kernel of this module."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.is_meta:
            return flash_attention_meta(q, k, v, causal, window)
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*ref.flash_attention_bwd(q, k, v, do, causal=ctx.causal,
                                         window=ctx.window), None, None)
