"""Public kernel entry points (counterpart of ``repro/kernels/ops.py``).

A CPU tensor goes to the plain version in ``ref``; a CUDA tensor goes to the
hand-written kernel, whose wrapper raises on what it cannot take.  There is no
fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import flash_attention as _fa
from . import rmsnorm as _rn
from . import ref

_KERNELS = {"flash_attention": _fa, "rmsnorm": _rn}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KH, S, D) -> (B, H, S, D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D), w: (D,) -> RMSNorm over the last dim, in x's dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    return _rn.rmsnorm(x, w, eps)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
