"""The work of one launch of each kernel: FLOPs and the bytes it must move.

Bytes count each input read once and each output written once; FLOPs count
what the kernel computes on these inputs (flash attention: the two matrix
products over the (query, key) pairs it visits, D + D_v multiply-adds each).
One copy of these counts serves both ``chip_smoke.py`` (each kernel's bound:
the larger of bytes over the card's memory rate and FLOPs over its peak) and
the analytical trace route (``core.analytical``), which prices each kernel's
launch on meta tensors with them.  Every function returns
``(flops, bytes)``.
"""

from __future__ import annotations

from typing import Optional, Tuple


def _pairs(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one head the mask keeps: ``k <= q`` under
    ``causal``, ``q - k < window`` where ``window > 0``."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    if causal:          # min(q + 1, window) keys for query q
        return window * (window + 1) // 2 + (S - window) * window
    past = S - window   # query q loses its first max(0, q - window + 1) keys
    return S * S - past * (past + 1) // 2


def flash_attention(B: int, H: int, KH: int, S: int, D: int, *,
                    D_v: Optional[int] = None, causal: bool = True,
                    window: int = 0, itemsize: int = 2) -> Tuple[float, float]:
    """q: (B, H, S, D), k: (B, KH, S, D), v: (B, KH, S, D_v), o: (B, H, S, D_v)
    (``D_v`` defaults to ``D``); elements of ``itemsize``; a local
    ``window`` counts only the pairs it keeps."""
    Dv = D if D_v is None else D_v
    pairs = B * H * _pairs(S, causal, window)
    return 2.0 * (D + Dv) * pairs, float(itemsize * (B * H * S * (D + Dv)
                                                      + B * KH * S * (D + Dv)))


def rmsnorm(rows: int, D: int, *, itemsize: int = 2,
            w_itemsize: Optional[int] = None) -> Tuple[float, float]:
    """x, y: (rows, D) of ``itemsize``; w: (D,) of ``w_itemsize`` (default
    ``itemsize``); about 4 operations per element."""
    w_size = itemsize if w_itemsize is None else w_itemsize
    return 4.0 * rows * D, float(itemsize * 2 * rows * D + w_size * D)


def fused_adam(n: int) -> Tuple[float, float]:
    """One AdamW pass over n f32 entries: reads p, g, m, v and writes p, m, v
    (28 bytes an entry), about 15 operations an entry."""
    return 15.0 * n, 28.0 * n


def dgc_mask(n: int, *, itemsize: int = 2) -> Tuple[float, float]:
    """n gradient entries of ``itemsize``, read once and written once; a
    compare and a select each (the kept count's 8 bytes are left out)."""
    return 2.0 * n, float(2 * n * itemsize)
