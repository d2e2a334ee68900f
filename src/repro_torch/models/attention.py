"""GQA attention with RoPE (counterpart of the GQA part of
``repro/models/attention.py``).

Prefill attention runs the flash-attention kernel (``ops.flash_attention``)
where the JAX model runs its XLA analogue ``chunked_attention``.  Decode
attention (one query row against the cache) stays plain PyTorch, as it is no
Pallas kernel in the reference.  Layouts are the reference's: weights
``wq/wk/wv (d, H|K, hd)`` and ``wo (H, hd, d)``, activations
``(B, S, H, hd)``, KV cache ``(B, S, K, hd)`` per layer.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
from torch.profiler import record_function

from repro_torch.kernels import ops
from .paramdecl import normal_param

Params = Dict[str, torch.Tensor]

NEG_INF = -2.0 ** 30   # the reference's mask value


# --------------------------------------------------------------------- rope
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs                # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2); half-split."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    c, s = c.to(x.dtype), s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


# ------------------------------------------------------------------ decode
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: Union[int, torch.Tensor]
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, K, hd); ``length``: count of valid cache
    entries *including* the current token, as the reference takes it: a 0-d
    or (B,) integer tensor (per request), or a host int (the serve path's: no
    tensor is copied to the device and the stream is not synchronised).
    """
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * (
        1.0 / math.sqrt(hd))
    pos = torch.arange(S, device=q.device)
    if isinstance(length, torch.Tensor):
        ln = length.to(q.device)
        ln = ln[:, None] if ln.dim() == 1 else ln.reshape(1, 1)
        valid = (pos[None, :] < ln)[:, None, None, :]           # (B or 1, 1, 1, S)
    else:
        valid = pos < length                                    # (S,)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(B, 1, H, hd)


# ----------------------------------------------------------------- GQA block
def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
             head_dim: int, dtype) -> Params:
    return {"wq": normal_param(gen, (d, n_heads, head_dim), dtype),
            "wk": normal_param(gen, (d, n_kv, head_dim), dtype),
            "wv": normal_param(gen, (d, n_kv, head_dim), dtype),
            "wo": normal_param(gen, (n_heads, head_dim, d), dtype)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * k, d)


def gqa_qkv(p: Params, x: torch.Tensor, cos, sin
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def gqa_attend(p: Params, x: torch.Tensor, cos, sin, *, causal: bool = True,
               return_cache: bool = False):
    """Prefill/training attention: x (B, S, d) -> (B, S, d) [, {"k","v"}]."""
    with record_function("attn"):
        q, k, v = gqa_qkv(p, x, cos, sin)
        # (B, S, H, hd) tensors go to the kernel as (B, H, S, hd) views; its
        # output keeps q's memory layout, so the transpose back is free
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal).transpose(1, 2)
        out = _out(o, p["wo"])
    if not return_cache:
        return out
    return out, {"k": k, "v": v}


def gqa_decode(p: Params, x: torch.Tensor, cache: Params, pos: int,
               theta: float) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); cache {"k","v"}: (B, S, K, hd); pos: int index.

    Writes the new token's K/V into the cache in place (the reference returns
    an updated copy) and returns it.
    """
    with record_function("attn"):
        positions = torch.full((1,), pos, device=x.device)   # no host copy
        cos, sin = rope_angles(positions, p["wq"].shape[-1], theta)
        q = apply_rope(_proj(x, p["wq"]), cos[None], sin[None])
        k = apply_rope(_proj(x, p["wk"]), cos[None], sin[None])
        cache["k"][:, pos:pos + 1] = k
        cache["v"][:, pos:pos + 1] = _proj(x, p["wv"])
        o = decode_attention(q, cache["k"], cache["v"], pos + 1)
        return _out(o, p["wo"]), cache
