"""Shared model building blocks (counterpart of ``repro/models/layers.py``).

Plain functions over dicts of tensors, with the reference's weight layouts.
``rmsnorm`` goes through the RMSNorm kernel; plain matmuls stay
``torch.matmul``, as the JAX package left them to XLA.  Each building block
runs under the reference's ``jax.named_scope`` name as a
``torch.profiler.record_function`` scope, from which ``repro_torch.core.kineto``
maps every kernel to its layer.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from .paramdecl import normal_param, ones_param

Params = Dict[str, torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, as the reference's "gelu"."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu}


def rmsnorm_init(gen: torch.Generator, d: int, dtype) -> Params:
    return {"scale": ones_param(gen, (d,), dtype)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    with record_function("norm"):
        return ops.rmsnorm(x, p["scale"], eps)


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": normal_param(gen, (vocab, d), dtype, scale=0.02)}


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    with record_function("embed"):
        return F.embedding(ids, p["table"])


def unembed_logits(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (vocab, d)^T -> (..., vocab)."""
    with record_function("unembed"):
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
    with record_function("mlp"):
        up = x @ p["w_up"]
        h = act(x @ p["w_gate"]) * up if "w_gate" in p else act(up)
        return h @ p["w_down"]


# ------------------------------------------------------- chunked CE loss
def _chunk_nll(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Summed masked NLL of one sequence chunk; logits f32, (B, cs, vocab)."""
    logits = (x @ table.T).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum()


def softmax_cross_entropy_chunked(embed_params: Params, x: torch.Tensor,
                                  labels: torch.Tensor,
                                  mask: Optional[torch.Tensor],
                                  chunk: int = 2048) -> torch.Tensor:
    """Per-token CE against the unembedding, computed in *sequence* chunks of
    ``cs = max(1, min(max(chunk // B, 1), S))`` positions (the reference's
    chunk size with no mesh), so the full (tokens, vocab) logits never exist:
    each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
    Returns ``sum(nll * mask) / max(sum(mask), 1)``."""
    with record_function("loss"):
        B, S, _ = x.shape
        m = (mask.float() if mask is not None
             else torch.ones((B, S), dtype=torch.float32, device=x.device))
        cs = max(1, min(max(chunk // B, 1), S))
        table = embed_params["table"]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for s0 in range(0, S, cs):
            sl = slice(s0, s0 + cs)
            total = total + checkpoint(_chunk_nll, x[:, sl], table, labels[:, sl],
                                       m[:, sl], use_reentrant=False)
        return total / m.sum().clamp_min(1.0)
