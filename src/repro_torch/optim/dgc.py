"""Deep Gradient Compression (counterpart of ``repro/optim/dgc.py``; Lin et
al., paper §5.2 / Algorithm 12).

Top-k gradient sparsification with local error feedback: each step transmits
only the largest-magnitude ``ratio`` fraction of gradient entries; the
residual accumulates locally and is added back next step.  Selection is exact
top-k (``torch.topk``), as in the reference; the ``dgc_mask`` kernel is the
threshold form of the same selection stage.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch.utils._pytree import tree_map


@dataclasses.dataclass
class DGCState:
    residual: Any      # error-feedback accumulator (same tree as grads)


def dgc_init(grads_like) -> DGCState:
    return DGCState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def dgc_compress(g: torch.Tensor, ratio: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense top-|k| selection on one leaf: returns (values, int32 indices).

    k = max(1, round(ratio * size)).  Ties resolve arbitrarily (torch.topk).
    """
    flat = g.reshape(-1).float()
    k = max(1, int(round(ratio * flat.numel())))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx.to(torch.int32)


def dgc_decompress(values: torch.Tensor, idx: torch.Tensor, shape
                   ) -> torch.Tensor:
    out = torch.zeros(math.prod(shape), dtype=torch.float32,
                      device=values.device)
    out[idx.long()] = values
    return out.reshape(shape)


def dgc_step(grads, state: DGCState, ratio: float = 0.01
             ) -> Tuple[Any, DGCState]:
    """One DGC round on a gradient tree: returns (sparse-equivalent dense
    gradients as transmitted, new state with residuals)."""
    def leaf(g, r):
        acc = g.float() + r
        vals, idx = dgc_compress(acc, ratio)
        out = dgc_decompress(vals, idx, acc.shape)
        return out.to(g.dtype), acc - out

    pairs = tree_map(leaf, grads, state.residual)
    is_pair = lambda x: isinstance(x, tuple)   # noqa: E731
    sent = tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
    resid = tree_map(lambda t: t[1], pairs, is_leaf=is_pair)
    return sent, DGCState(residual=resid)
