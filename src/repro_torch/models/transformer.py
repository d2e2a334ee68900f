"""Dense (GQA) transformer blocks and the layer loops (counterpart of the
dense family of ``repro/models/transformer.py``).

The reference stacks layers on a leading axis and drives them with
``lax.scan``; here ``blocks`` is a list of per-layer dicts and the loop is a
Python loop.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .attention import gqa_attend, gqa_decode, gqa_init
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init

Params = Dict[str, object]


def head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def dense_block_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {
        "ln1": rmsnorm_init(gen, cfg.d_model, dtype),
        "attn": gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         head_dim(cfg), dtype),
        "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp),
    }


def dense_block_apply(cfg, p: Params, x: torch.Tensor, cos, sin
                      ) -> torch.Tensor:
    """The training forward of one block (no cache)."""
    x = x + gqa_attend(p["attn"], rmsnorm(p["ln1"], x), cos, sin, causal=True)
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation)


def dense_block_prefill(cfg, p: Params, x: torch.Tensor, cos, sin
                        ) -> Tuple[torch.Tensor, Params]:
    a, cache = gqa_attend(p["attn"], rmsnorm(p["ln1"], x), cos, sin,
                          causal=True, return_cache=True)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation)
    return x, cache


def dense_block_decode(cfg, p: Params, x: torch.Tensor, cache: Params, pos: int
                       ) -> Tuple[torch.Tensor, Params]:
    a, cache = gqa_decode(p["attn"], rmsnorm(p["ln1"], x), cache, pos,
                          cfg.rope_theta)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation)
    return x, cache


def run_stack(cfg, blocks: List[Params], x: torch.Tensor, cos, sin
              ) -> torch.Tensor:
    """Run the layers in order (training forward).  The reference's ``remat``
    knob has no effect: autograd keeps every layer's activations."""
    for lp in blocks:
        x = dense_block_apply(cfg, lp, x, cos, sin)
    return x


def run_stack_prefill(cfg, blocks: List[Params], x: torch.Tensor, cos, sin
                      ) -> Tuple[torch.Tensor, List[Params]]:
    """Run the layers in order, collecting each layer's K/V cache."""
    caches = []
    for lp in blocks:
        x, cache = dense_block_prefill(cfg, lp, x, cos, sin)
        caches.append(cache)
    return x, caches


def run_stack_decode(cfg, blocks: List[Params], caches: List[Params],
                     x: torch.Tensor, pos: int
                     ) -> Tuple[torch.Tensor, List[Params]]:
    new_caches = []
    for lp, cache in zip(blocks, caches):
        x, cache = dense_block_decode(cfg, lp, x, cache, pos)
        new_caches.append(cache)
    return x, new_caches
