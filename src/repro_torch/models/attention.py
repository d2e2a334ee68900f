"""GQA attention with RoPE and DeepSeek-V2's multi-head latent attention
(counterpart of the GQA and MLA parts of ``repro/models/attention.py``).

Prefill attention runs the flash-attention kernel (``ops.flash_attention``)
where the JAX model runs its XLA analogue ``chunked_attention``; MLA's runs
it with q/k head dim ``qk_nope + qk_rope`` and v head dim ``v_head_dim``.
Decode attention (one query row against the cache) stays plain PyTorch, as
it is no Pallas kernel in the reference; MLA decodes in the absorbed form,
against a cache of the compressed ``c_kv`` and the shared ``k_rope``.
A local ``window`` (RecurrentGemma's) runs in the flash kernel and keeps a
ring of ``min(seq, window)`` positions as the decode cache, as the
reference's ``gqa_attend``/``gqa_decode`` do.
Layouts are the reference's: weights ``wq/wk/wv (d, H|K, hd)`` and
``wo (H, hd, d)``, activations ``(B, S, H, hd)``, KV cache ``(B, S, K, hd)``
per layer; MLA's ``wq_a (d, q_lora)``, ``wq_b (q_lora, H, nope + rope)``,
``wkv_a (d, kv_lora + rope)``, ``wk_b/wv_b (kv_lora, H, nope|v)``,
``wo (H, v, d)`` and cache ``c_kv (B, S, kv_lora)``, ``k_rope (B, S, rope)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from repro_torch.kernels import ops
from .paramdecl import normal_param, ones_param

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
               window: Optional[int] = None, return_cache: bool = False):
    """Prefill/training attention: x (B, S, d) -> (B, S, d) [, {"k","v"}].
    With a ``window`` of at most S the cache is the last ``window``
    positions, rolled so that position t sits in slot ``t % window`` (the
    ring ``gqa_decode`` writes)."""
    with record_function("attn"):
        q, k, v = gqa_qkv(p, x, cos, sin)
        # (B, S, H, hd) tensors go to the kernel as (B, H, S, hd) views; its
        # output keeps q's memory layout, so the transpose back is free
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window).transpose(1, 2)
        out = _out(o, p["wo"])
    if not return_cache:
        return out
    S = k.shape[1]
    if window and S >= window:
        k = torch.roll(k[:, S - window:], S % window, dims=1)
        v = torch.roll(v[:, S - window:], S % window, dims=1)
    return out, {"k": k, "v": v}


def gqa_decode(p: Params, x: torch.Tensor, cache: Params, pos: int,
               theta: float, *, window: Optional[int] = None
               ) -> Tuple[torch.Tensor, Params]:
    """x: (B, 1, d); cache {"k","v"}: (B, S, K, hd); pos: int index.

    Writes the new token's K/V into the cache in place (the reference returns
    an updated copy) and returns it.  With a ``window`` the cache is a ring
    of its own length: slot ``pos % len``, and the ``min(pos + 1, len)``
    entries written so far attended (their order does not matter).
    """
    with record_function("attn"):
        positions = torch.full((1,), pos, device=x.device)   # no host copy
        cos, sin = rope_angles(positions, p["wq"].shape[-1], theta)
        q = apply_rope(_proj(x, p["wq"]), cos[None], sin[None])
        k = apply_rope(_proj(x, p["wk"]), cos[None], sin[None])
        W = cache["k"].shape[1]
        slot, length = (pos % W, min(pos + 1, W)) if window else (pos, pos + 1)
        cache["k"][:, slot:slot + 1] = k
        cache["v"][:, slot:slot + 1] = _proj(x, p["wv"])
        o = decode_attention(q, cache["k"], cache["v"], length)
        return _out(o, p["wo"]), cache


# ----------------------------------------------------------------- MLA block
def mla_init(gen: torch.Generator, d: int, n_heads: int, dtype, *,
             q_lora: int = 1536, kv_lora: int = 512, qk_nope: int = 128,
             qk_rope: int = 64, v_dim: int = 128) -> Params:
    return {"wq_a": normal_param(gen, (d, q_lora), dtype),
            "q_norm": ones_param(gen, (q_lora,), dtype),
            "wq_b": normal_param(gen, (q_lora, n_heads, qk_nope + qk_rope), dtype),
            "wkv_a": normal_param(gen, (d, kv_lora + qk_rope), dtype),
            "kv_norm": ones_param(gen, (kv_lora,), dtype),
            "wk_b": normal_param(gen, (kv_lora, n_heads, qk_nope), dtype),
            "wv_b": normal_param(gen, (kv_lora, n_heads, v_dim), dtype),
            "wo": normal_param(gen, (n_heads, v_dim, d), dtype)}


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    """The reference's ``_rms`` (q_norm, kv_norm): the function of
    ``ops.rmsnorm`` with the same eps, so the card runs the RMSNorm kernel."""
    return ops.rmsnorm(x, scale, eps)


def _mla_q(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> q (B, S, H, nope + rope), before RoPE."""
    return _proj(_rms(x @ p["wq_a"], p["q_norm"]), p["wq_b"])


def mla_attend(p: Params, x: torch.Tensor, positions: torch.Tensor,
               theta: float, *, return_cache: bool = False):
    """Training/prefill MLA: the compressed KV expanded per head, attention
    through the flash kernel on q, k (B, S, H, nope + rope) and v
    (B, S, H, v): x (B, S, d) -> (B, S, d) [, {"c_kv", "k_rope"}]."""
    with record_function("attn"):
        B, S, _ = x.shape
        qk_rope = p["wq_b"].shape[-1] - p["wk_b"].shape[-1]
        kv_lora = p["wk_b"].shape[0]
        q = _mla_q(p, x)
        kv = x @ p["wkv_a"]
        c_kv = _rms(kv[..., :kv_lora], p["kv_norm"])
        cos, sin = rope_angles(positions, qk_rope, theta)
        q = torch.cat([q[..., :-qk_rope], apply_rope(q[..., -qk_rope:], cos, sin)],
                      dim=-1)
        k_rope = apply_rope(kv[:, :, None, kv_lora:], cos, sin)   # (B, S, 1, rope)
        k_nope, v = _proj(c_kv, p["wk_b"]), _proj(c_kv, p["wv_b"])
        H = k_nope.shape[2]
        k = torch.cat([k_nope, k_rope.expand(B, S, H, qk_rope)], dim=-1)
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True).transpose(1, 2)
        out = _out(o, p["wo"])
    if not return_cache:
        return out
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]}


def mla_decode(p: Params, x: torch.Tensor, cache: Params, pos: int,
               theta: float) -> Tuple[torch.Tensor, Params]:
    """Absorbed MLA decode, x (B, 1, d) at position ``pos`` (an int): the
    cache holds (c_kv, k_rope) only, and

        score_h = q_nope_h^T Wk_b_h c_kv + q_rope_h^T k_rope,  / sqrt(nope + rope)
        out_h   = (softmax(score_h) . c_kv) Wv_b_h.

    Writes the new token's c_kv and k_rope into the cache in place (the
    reference returns an updated copy) and returns it."""
    with record_function("attn"):
        qk_rope = p["wq_b"].shape[-1] - p["wk_b"].shape[-1]
        kv_lora = p["wk_b"].shape[0]
        q = _mla_q(p, x)                                          # (B, 1, H, nope + rope)
        kv = x @ p["wkv_a"]                                       # (B, 1, lora + rope)
        positions = torch.full((1,), pos, device=x.device)       # no host copy
        cos, sin = rope_angles(positions, qk_rope, theta)
        q_rope = apply_rope(q[..., -qk_rope:], cos[None], sin[None])
        cache["c_kv"][:, pos:pos + 1] = _rms(kv[..., :kv_lora], p["kv_norm"])
        cache["k_rope"][:, pos:pos + 1] = apply_rope(
            kv[:, :, None, kv_lora:], cos[None], sin[None])[:, :, 0]
        ckv, krc = cache["c_kv"], cache["k_rope"]
        # q absorbed into the compressed space: (B, H, lora)
        q_abs = torch.einsum("bshk,lhk->bhl", q[..., :-qk_rope], p["wk_b"])
        scores = (torch.einsum("bhl,bsl->bhs", q_abs, ckv)
                  + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], krc)).float()
        valid = torch.arange(ckv.shape[1], device=x.device) < pos + 1
        scores = (scores * (1.0 / math.sqrt(p["wq_b"].shape[-1]))).masked_fill(
            ~valid, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(ckv.dtype)
        o_c = torch.einsum("bhs,bsl->bhl", w, ckv)                # (B, H, lora)
        o = torch.einsum("bhl,lhk->bhk", o_c, p["wv_b"])          # (B, H, v)
        return torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :], cache
