"""The kernels' meta routes: one operator per kernel in the ``repro_torch``
namespace, implemented for the ``Meta`` dispatch key only.

On meta tensors (the analytical trace route, ``core.trace_compiled``) each
kernel wrapper calls its operator instead of launching: the operator returns
outputs of the right shape and dtype and appears once in a profiler capture,
where the card would launch the kernel once.  A tensor on any other device
has no kernel for these operators and raises.
"""

from __future__ import annotations

from typing import Callable

import torch


def meta_library(schema: str, fn: Callable) -> torch.library.Library:
    """Define ``repro_torch::<schema>`` with ``fn`` as its meta kernel.  The
    caller keeps the returned library alive: the operator goes with it."""
    lib = torch.library.Library("repro_torch", "FRAGMENT")
    lib.define(schema)
    lib.impl(schema.split("(")[0], fn, "Meta")
    return lib
