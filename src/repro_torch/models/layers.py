"""Shared model building blocks (counterpart of ``repro/models/layers.py``).

Plain functions over dicts of tensors, with the reference's weight layouts.
``rmsnorm`` goes through the RMSNorm kernel; plain matmuls stay
``torch.matmul``, as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .paramdecl import normal_param, ones_param

Params = Dict[str, torch.Tensor]

ACTIVATIONS = {"silu": F.silu}   # the ported configs' only activation


def rmsnorm_init(gen: torch.Generator, d: int, dtype) -> Params:
    return {"scale": ones_param(gen, (d,), dtype)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps)


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": normal_param(gen, (vocab, d), dtype, scale=0.02)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, p["table"])


def unembed_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (vocab, d)^T -> (..., vocab)."""
    return x @ p["table"].T


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype, *,
             gated: bool = True) -> Params:
    p = {"w_up": normal_param(gen, (d, d_ff), dtype),
         "w_down": normal_param(gen, (d_ff, d), dtype)}
    if gated:
        p["w_gate"] = normal_param(gen, (d, d_ff), dtype)
    return p


def mlp(p: Params, x: torch.Tensor, *, activation: str = "silu") -> torch.Tensor:
    act = ACTIVATIONS[activation]
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
    return h @ p["w_down"]
