"""Parameter constructors (counterpart of ``repro/models/paramdecl.py``).

Real parameters only, drawn from an explicit ``torch.Generator`` on the
generator's device; the JAX package's SpecLeaf/sharding route is not ported
yet.  The fan-in scale rule is the reference's: ``1/sqrt(shape[-2])`` for
arrays of two or more dimensions, ``1/sqrt(shape[-1])`` for vectors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def normal_param(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
                 *, scale: Optional[float] = None) -> torch.Tensor:
    """Fan-in scaled gaussian (the default dense/embedding initializer)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * s).to(dtype)


def ones_param(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype
               ) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)
