"""RG-LRU recurrent block of Griffin / RecurrentGemma (counterpart of
``repro/models/rglru.py``).

Block layout (RecurrentGemma), as in the reference:

  x -> [x-branch: linear -> causal conv4 -> RG-LRU]
       [gate-branch: linear -> gelu]
  merge (h * gate) -> out-proj

  r_t = sigmoid(W_a x_t + b_a); i_t = sigmoid(W_i x_t + b_i)
  log a_t = -c * softplus(Lambda) * r_t        (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates, ``log_a``, ``b`` and the state ``h`` are float32 whatever the
model's dtype, as the reference keeps them; ``b_a``, ``b_i`` and ``lam`` are
float32 parameters.  The reference's train-time recurrence is
``jax.lax.associative_scan`` over the sequence; PyTorch has no such builtin,
so ``_scan`` takes the same combine, ``(la1, b1), (la2, b2) -> (la1 + la2,
exp(la2) * b1 + b2)``, over log-depth doublings (Hillis-Steele: 12 at 4096
tokens), in plain PyTorch as the reference leaves it to XLA (no
``pallas_call``).  The decays stay in the log domain: ``exp`` of a sum of
``log_a`` over at most the whole sequence is at most 1.  The closed form
``exp(cumsum(log_a))`` would divide by it, and ``log_a`` sums to about -1e4
over a prompt.  Decode carries ``{"conv" (B, 3, d_rnn), "h" (B, d_rnn)}``,
constant in the sequence length.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import gelu
from .paramdecl import normal_param, zeros_param

Params = Dict[str, torch.Tensor]

CONV_K = 4
LRU_C = 8.0


def rglru_init(gen: torch.Generator, d: int, d_rnn: int, dtype) -> Params:
    f32 = torch.float32
    return {"w_in": normal_param(gen, (d, d_rnn), dtype),
            "w_gate": normal_param(gen, (d, d_rnn), dtype),
            "conv": normal_param(gen, (CONV_K, d_rnn), dtype, scale=0.5),
            "w_a": normal_param(gen, (d_rnn, d_rnn), dtype),
            "b_a": zeros_param(gen, (d_rnn,), f32),
            "w_i": normal_param(gen, (d_rnn, d_rnn), dtype),
            "b_i": zeros_param(gen, (d_rnn,), f32),
            "lam": zeros_param(gen, (d_rnn,), f32),
            "w_out": normal_param(gen, (d_rnn, d), dtype)}


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width CONV_K over the sequence: x (B, S, e),
    kernel (CONV_K, e), the last tap on the current position."""
    S = x.shape[1]
    out = x * kernel[-1]
    for i in range(1, CONV_K):
        out = out + F.pad(x, (0, 0, i, 0))[:, :S] * kernel[CONV_K - 1 - i]
    return out


def _gates(p: Params, xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, beta * i * x) of the conv'd x-branch, float32, (B, S, d_rnn)."""
    r = torch.sigmoid((xb @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((xb @ p["w_i"]).float() + p["b_i"])
    log_a = -LRU_C * F.softplus(p["lam"]) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * xb.float()


def _scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t from h_{-1} = 0 over axis 1: the
    inclusive scan of the reference's combine by doublings.  After the
    doubling of distance d, entry t holds the combine of the 2d entries
    ending at t (fewer at the start)."""
    S, d = log_a.shape[1], 1
    while d < S:
        la = log_a[:, d:]
        b = torch.cat([b[:, :d], torch.exp(la) * b[:, :-d] + b[:, d:]], 1)
        log_a = torch.cat([log_a[:, :d], la + log_a[:, :-d]], 1)
        d *= 2
    return b


def rglru_forward(p: Params, x: torch.Tensor, *, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) [, {"conv", "h"}: the decode cache after the
    last position]."""
    with record_function("rglru"):
        gate = gelu(x @ p["w_gate"])
        xb_pre = x @ p["w_in"]
        log_a, b = _gates(p, _causal_conv(xb_pre, p["conv"]))
        h = _scan(log_a, b)
        out = (h.to(x.dtype) * gate) @ p["w_out"]
        if not return_state:
            return out
        S = x.shape[1]
        tail = F.pad(xb_pre, (0, 0, CONV_K - 1, 0))[:, S:S + CONV_K - 1]
        return out, {"conv": tail, "h": h[:, -1]}


def rglru_decode(p: Params, x: torch.Tensor, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token step.  x: (B, 1, d); cache: {"conv": (B, K-1, d_rnn),
    "h": (B, d_rnn) float32}.  Returns a new cache."""
    with record_function("rglru"):
        gate = gelu(x[:, 0] @ p["w_gate"])
        xb = x[:, 0] @ p["w_in"]                                  # (B, d_rnn)
        window = torch.cat([cache["conv"], xb[:, None]], 1)
        xc = torch.einsum("bke,ke->be", window, p["conv"].to(window.dtype))
        log_a, b = _gates(p, xc)
        h = torch.exp(log_a) * cache["h"] + b                      # f32 state
        out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None, :]
        return out, {"conv": window[:, 1:], "h": h}


def rglru_cache_spec(batch: int, d_rnn: int) -> Dict[str, tuple]:
    """One layer's decode cache: the conv window in the model's dtype (a
    shape) and the state in float32 (a ``(shape, dtype)`` pair), constant in
    the sequence length."""
    return {"conv": (batch, CONV_K - 1, d_rnn),
            "h": ((batch, d_rnn), torch.float32)}
