"""Parameter constructors (counterpart of ``repro/models/paramdecl.py``).

One init code path, two products, as in the reference:

* real mode (``gen`` is a ``torch.Generator``): parameters drawn from it, on
  the generator's device;
* spec mode (``gen`` is ``None``): ``meta`` tensors with the same shapes and
  dtypes and no storage -- the reference's ``SpecLeaf`` placeholders, which
  the analytical trace route (``core.trace_compiled``) runs a step on.

The reference's logical sharding axes are not ported.  The fan-in scale rule
is the reference's: ``1/sqrt(shape[-2])`` for arrays of two or more
dimensions, ``1/sqrt(shape[-1])`` for vectors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def is_spec_mode(gen: Optional[torch.Generator]) -> bool:
    return gen is None


def _spec(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def normal_param(gen: Optional[torch.Generator], shape: Sequence[int],
                 dtype: torch.dtype, *, scale: Optional[float] = None
                 ) -> torch.Tensor:
    """Fan-in scaled gaussian (the default dense/embedding initializer)."""
    if is_spec_mode(gen):
        return _spec(shape, dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * s).to(dtype)


def zeros_param(gen: Optional[torch.Generator], shape: Sequence[int],
                dtype: torch.dtype) -> torch.Tensor:
    if is_spec_mode(gen):
        return _spec(shape, dtype)
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_param(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    if is_spec_mode(gen):
        return _spec(shape, dtype)
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)
