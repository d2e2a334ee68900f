"""Public kernel entry points (counterpart of ``repro/kernels/ops.py``).

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to the
hand-written kernel, whose wrapper raises on what it cannot take.  There is no
fallback from a CUDA tensor to the plain version.  On CUDA, flash attention
and RMSNorm go through their ``autograd.Function`` (kernel forward, plain
backward), so gradients flow through them.  A ``meta`` tensor (the
analytical trace route) takes each kernel's meta route: one operator where
the card would launch the kernel, with the outputs' shapes and dtypes,
nothing computed and no launch counted.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import dgc_topk as _dg
from . import flash_attention as _fa
from . import fused_adam as _ad
from . import rmsnorm as _rn
from . import ref

_KERNELS = {"flash_attention": _fa, "rmsnorm": _rn, "fused_adam": _ad,
            "dgc_mask": _dg}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: (B, H, S, D); k: (B, KH, S, D); v: (B, KH, S, D_v) -> (B, H, S, D_v)
    in q's dtype (D <= 256, D_v <= 256; the scale is ``1/sqrt(D)``; past
    those the kernels' wrapper raises, where the reference pads D).
    ``window`` (None or 0: none) keeps only keys less than ``window``
    positions before each query, as ``chunked_attention(window=)``.

    ``block_q``/``block_k`` are the reference's tile keywords, accepted so its
    callers run unchanged and ignored: the CUDA kernels choose their tiles."""
    window = window or 0
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.FlashAttentionFn.apply(q, k, v, causal, window)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), w: (D,) -> RMSNorm over the last dim, in x's dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    return _rn.RMSNormFn.apply(x, w, eps)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A step constant as a (1,) f32 tensor on ``like``'s device; a tensor
    stays on the device, a number is a fill there (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=like.device, dtype=torch.float32)
    return torch.full((1,), float(x), dtype=torch.float32, device=like.device)


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, *, lr, b1: float, b2: float, eps: float,
               wd: float, c1, c2
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat f32 vectors (N,) -> updated (p, m, v).  ``lr``, ``c1``, ``c2``
    are numbers or one-element tensors.  On CUDA the kernel updates p, m, v
    in place and returns them; on the CPU the plain version returns new
    tensors."""
    if p.device.type == "cpu":
        return ref.fused_adam_ref(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                  wd=wd, c1=c1, c2=c2)
    if p.is_meta:
        _ad.fused_adam_meta(p, g, m, v, _scalar(lr, p), _scalar(c1, p),
                            _scalar(c2, p), b1, b2, eps, wd)
        return p, m, v
    return _ad.fused_adam(p, g, m, v, _scalar(lr, p), _scalar(c1, p),
                          _scalar(c2, p), b1=b1, b2=b2, eps=eps, wd=wd)


def dgc_mask(g: torch.Tensor, threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero entries with |g| < threshold.  Returns (sparse g, kept count)."""
    if g.device.type == "cpu":
        return ref.dgc_mask_ref(g, threshold)
    if g.is_meta:
        return _dg.dgc_threshold_meta(g, _scalar(threshold, g))
    return _dg.dgc_threshold(g, _scalar(threshold, g))


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launch_counts``
    (flash attention's split by kernel: ``flash_attention.launches_by_variant``)."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
    _fa.launches_by_variant.update(dict.fromkeys(_fa.launches_by_variant, 0))
