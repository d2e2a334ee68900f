"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
functions of the step-count tensor that return a 0-dim f32 tensor on its
device, so the rate is computed there and nothing waits for the host."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda count: torch.full((), lr, dtype=torch.float32,
                                    device=count.device)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def fn(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = peak * c / max(warmup_steps, 1)
        prog = ((c - warmup_steps) / max(total_steps - warmup_steps, 1)
                ).clamp(0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup_steps, warm, cos)
    return fn
