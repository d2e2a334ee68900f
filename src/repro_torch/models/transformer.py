"""Dense (GQA), MoE, MLA+MoE and SSM blocks, the hybrid family's groups and
the layer loops (counterpart of the dense, moe, mla_moe, ssm and hybrid
families of ``repro/models/transformer.py``).

Each family provides (init, train-apply, decode-apply, prefill, cache spec)
with a uniform signature, as in the reference; ``model.py`` picks them by
family.
The reference stacks layers on a leading axis and drives them with
``lax.scan``; here ``blocks`` is a list of per-layer dicts and the loop is a
Python loop.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

from .attention import (gqa_attend, gqa_decode, gqa_init, mla_attend,
                        mla_decode, mla_init)
from .layers import mlp, mlp_init, rmsnorm, rmsnorm_init
from .moe import moe_ffn, moe_init
from .rglru import rglru_cache_spec, rglru_decode, rglru_forward, rglru_init
from .ssm import mamba2_cache_spec, mamba2_decode, mamba2_forward, mamba2_init

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
                      ) -> Tuple[torch.Tensor, float]:
    """The training forward of one block (no cache): (x, aux loss), the aux
    loss 0.0, a number, so the dense step runs no operator for it."""
    x = x + gqa_attend(p["attn"], rmsnorm(p["ln1"], x), cos, sin, causal=True,
                       window=cfg.window or None)
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation), 0.0


def dense_block_prefill(cfg, p: Params, x: torch.Tensor, cos, sin
                        ) -> Tuple[torch.Tensor, Params]:
    a, cache = gqa_attend(p["attn"], rmsnorm(p["ln1"], x), cos, sin,
                          causal=True, window=cfg.window or None,
                          return_cache=True)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation)
    return x, cache


def dense_block_decode(cfg, p: Params, x: torch.Tensor, cache: Params, pos: int
                       ) -> Tuple[torch.Tensor, Params]:
    a, cache = gqa_decode(p["attn"], rmsnorm(p["ln1"], x), cache, pos,
                          cfg.rope_theta, window=cfg.window or None)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation)
    return x, cache


def dense_cache_spec(cfg, batch: int, seq: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's KV cache shapes (the dense and moe families'; with a
    local window, a ring of ``min(seq, window)`` positions)."""
    S = min(seq, cfg.window) if cfg.window else seq
    shape = (batch, S, cfg.n_kv_heads, head_dim(cfg))
    return {"k": shape, "v": shape}


# --------------------------------------------------------------------- MoE
def moe_block_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {
        "ln1": rmsnorm_init(gen, cfg.d_model, dtype),
        "attn": gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         head_dim(cfg), dtype),
        "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
        "moe": moe_init(gen, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                        cfg.top_k, cfg.n_shared_experts, dtype),
    }


def _moe(cfg, p: Params, x: torch.Tensor):
    return moe_ffn(p["moe"], rmsnorm(p["ln2"], x), top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor,
                   activation=cfg.activation)


def moe_block_apply(cfg, p: Params, x: torch.Tensor, cos, sin
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + gqa_attend(p["attn"], rmsnorm(p["ln1"], x), cos, sin, causal=True)
    h, aux = _moe(cfg, p, x)
    return x + h, aux


def moe_block_prefill(cfg, p: Params, x: torch.Tensor, cos, sin
                      ) -> Tuple[torch.Tensor, Params]:
    a, cache = gqa_attend(p["attn"], rmsnorm(p["ln1"], x), cos, sin,
                          causal=True, return_cache=True)
    x = x + a
    return x + _moe(cfg, p, x)[0], cache


def moe_block_decode(cfg, p: Params, x: torch.Tensor, cache: Params, pos: int
                     ) -> Tuple[torch.Tensor, Params]:
    a, cache = gqa_decode(p["attn"], rmsnorm(p["ln1"], x), cache, pos,
                          cfg.rope_theta)
    x = x + a
    return x + _moe(cfg, p, x)[0], cache


# ----------------------------------------------------------------- MLA+MoE
def mla_block_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {
        "ln1": rmsnorm_init(gen, cfg.d_model, dtype),
        "attn": mla_init(gen, cfg.d_model, cfg.n_heads, dtype,
                         q_lora=cfg.q_lora, kv_lora=cfg.kv_lora,
                         qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                         v_dim=cfg.v_head_dim),
        "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
        "moe": moe_init(gen, cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                        cfg.top_k, cfg.n_shared_experts, dtype),
    }


def _mla(cfg, p: Params, x: torch.Tensor, **kw):
    """MLA on the block's normed input; its RoPE angles are its own (rope
    columns only), as in the reference, which leaves the model's unused."""
    positions = torch.arange(x.shape[1], device=x.device)
    return mla_attend(p["attn"], rmsnorm(p["ln1"], x), positions,
                      cfg.rope_theta, **kw)


def mla_block_apply(cfg, p: Params, x: torch.Tensor, cos, sin
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + _mla(cfg, p, x)
    h, aux = _moe(cfg, p, x)
    return x + h, aux


def mla_block_prefill(cfg, p: Params, x: torch.Tensor, cos, sin
                      ) -> Tuple[torch.Tensor, Params]:
    a, cache = _mla(cfg, p, x, return_cache=True)
    x = x + a
    return x + _moe(cfg, p, x)[0], cache


def mla_block_decode(cfg, p: Params, x: torch.Tensor, cache: Params, pos: int
                     ) -> Tuple[torch.Tensor, Params]:
    a, cache = mla_decode(p["attn"], rmsnorm(p["ln1"], x), cache, pos,
                          cfg.rope_theta)
    x = x + a
    return x + _moe(cfg, p, x)[0], cache


def mla_cache_spec(cfg, batch: int, seq: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's MLA cache shapes: c_kv and k_rope."""
    return {"c_kv": (batch, seq, cfg.kv_lora), "k_rope": (batch, seq, cfg.qk_rope)}


# --------------------------------------------------------------------- SSM
def ssm_block_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {
        "ln": rmsnorm_init(gen, cfg.d_model, dtype),
        "ssm": mamba2_init(gen, cfg.d_model, cfg.ssm_state, dtype,
                           expand=cfg.ssm_expand),
    }


def ssm_block_apply(cfg, p: Params, x: torch.Tensor, cos, sin
                    ) -> Tuple[torch.Tensor, float]:
    """(x, aux loss 0.0), as the dense block; no RoPE (``cos``, ``sin``
    are None)."""
    return x + mamba2_forward(p["ssm"], rmsnorm(p["ln"], x),
                              chunk=cfg.ssm_chunk), 0.0


def ssm_block_prefill(cfg, p: Params, x: torch.Tensor, cos, sin
                      ) -> Tuple[torch.Tensor, Params]:
    h, cache = mamba2_forward(p["ssm"], rmsnorm(p["ln"], x),
                              chunk=cfg.ssm_chunk, return_state=True)
    return x + h, cache


def ssm_block_decode(cfg, p: Params, x: torch.Tensor, cache: Params, pos: int
                     ) -> Tuple[torch.Tensor, Params]:
    """One token; ``pos`` is not used (the state has no positions)."""
    h, cache = mamba2_decode(p["ssm"], rmsnorm(p["ln"], x), cache)
    return x + h, cache


def ssm_cache_spec(cfg, batch: int, seq: int) -> Dict[str, Tuple[int, ...]]:
    """One layer's conv window and SSM state: no sequence axis."""
    return mamba2_cache_spec(batch, cfg.d_model, cfg.ssm_state,
                             expand=cfg.ssm_expand)


# ------------------------------------------------------------ hybrid group
# RecurrentGemma's pattern: (recurrent, recurrent, local attention) groups,
# each sub-block with its own gated MLP; the model runs the layers past the
# last whole group as recurrent sub-blocks (``tail``).
def _rec_sub_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {"ln1": rmsnorm_init(gen, cfg.d_model, dtype),
            "rnn": rglru_init(gen, cfg.d_model, cfg.d_rnn, dtype),
            "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=True)}


def _attn_sub_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {"ln1": rmsnorm_init(gen, cfg.d_model, dtype),
            "attn": gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             head_dim(cfg), dtype),
            "ln2": rmsnorm_init(gen, cfg.d_model, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, gated=True)}


def hybrid_group_init(cfg, gen: torch.Generator, dtype) -> Params:
    return {"rec1": _rec_sub_init(cfg, gen, dtype),
            "rec2": _rec_sub_init(cfg, gen, dtype),
            "attn": _attn_sub_init(cfg, gen, dtype)}


def _mlp_sub(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x), activation=cfg.activation)


def _rec_sub_apply(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    return _mlp_sub(cfg, p, x + rglru_forward(p["rnn"], rmsnorm(p["ln1"], x)))


def _rec_sub_prefill(cfg, p: Params, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Params]:
    h, cache = rglru_forward(p["rnn"], rmsnorm(p["ln1"], x), return_state=True)
    return _mlp_sub(cfg, p, x + h), cache


def _rec_sub_decode(cfg, p: Params, x: torch.Tensor, cache: Params
                    ) -> Tuple[torch.Tensor, Params]:
    h, cache = rglru_decode(p["rnn"], rmsnorm(p["ln1"], x), cache)
    return _mlp_sub(cfg, p, x + h), cache


def hybrid_group_apply(cfg, p: Params, x: torch.Tensor, cos, sin
                       ) -> Tuple[torch.Tensor, float]:
    x = _rec_sub_apply(cfg, p["rec1"], x)
    x = _rec_sub_apply(cfg, p["rec2"], x)
    sp = p["attn"]
    x = x + gqa_attend(sp["attn"], rmsnorm(sp["ln1"], x), cos, sin, causal=True,
                       window=cfg.window)
    return _mlp_sub(cfg, sp, x), 0.0


def hybrid_group_prefill(cfg, p: Params, x: torch.Tensor, cos, sin
                         ) -> Tuple[torch.Tensor, Params]:
    cache = {}
    x, cache["rec1"] = _rec_sub_prefill(cfg, p["rec1"], x)
    x, cache["rec2"] = _rec_sub_prefill(cfg, p["rec2"], x)
    sp = p["attn"]
    a, cache["attn"] = gqa_attend(sp["attn"], rmsnorm(sp["ln1"], x), cos, sin,
                                  causal=True, window=cfg.window,
                                  return_cache=True)
    return _mlp_sub(cfg, sp, x + a), cache


def hybrid_group_decode(cfg, p: Params, x: torch.Tensor, cache: Params,
                        pos: int) -> Tuple[torch.Tensor, Params]:
    new = {}
    x, new["rec1"] = _rec_sub_decode(cfg, p["rec1"], x, cache["rec1"])
    x, new["rec2"] = _rec_sub_decode(cfg, p["rec2"], x, cache["rec2"])
    sp = p["attn"]
    a, new["attn"] = gqa_decode(sp["attn"], rmsnorm(sp["ln1"], x), cache["attn"],
                                pos, cfg.rope_theta, window=cfg.window)
    return _mlp_sub(cfg, sp, x + a), new


def rec_cache_spec(cfg, batch: int, seq: int) -> Dict[str, tuple]:
    """One recurrent sub-block's cache (a tail layer's): no sequence axis."""
    return rglru_cache_spec(batch, cfg.d_rnn)


def hybrid_cache_spec(cfg, batch: int, seq: int) -> Dict[str, Dict[str, tuple]]:
    """One group's cache: the two recurrent sub-blocks' and the local
    attention's K/V ring of ``min(seq, window)`` positions."""
    return {"rec1": rec_cache_spec(cfg, batch, seq),
            "rec2": rec_cache_spec(cfg, batch, seq),
            "attn": dense_cache_spec(cfg, batch, seq)}


# ------------------------------------------------------------ layer loops
def run_stack(cfg, blocks: List[Params], x: torch.Tensor, apply_fn, cos, sin
              ) -> Tuple[torch.Tensor, Union[torch.Tensor, float]]:
    """Run the layers in order (training forward): (x, summed aux loss).
    The sum is a tensor where the blocks return one, else 0.0.  The
    reference's ``remat`` knob has no effect: autograd keeps every layer's
    activations."""
    aux = 0.0
    for lp in blocks:
        x, a = apply_fn(cfg, lp, x, cos, sin)
        aux = a if isinstance(aux, float) else aux + a
    return x, aux


def run_stack_prefill(cfg, blocks: List[Params], x: torch.Tensor, prefill_fn,
                      cos, sin) -> Tuple[torch.Tensor, List[Params]]:
    """Run the layers in order, collecting each layer's cache."""
    caches = []
    for lp in blocks:
        x, cache = prefill_fn(cfg, lp, x, cos, sin)
        caches.append(cache)
    return x, caches


def run_stack_decode(cfg, blocks: List[Params], caches: List[Params],
                     x: torch.Tensor, decode_fn, pos: int
                     ) -> Tuple[torch.Tensor, List[Params]]:
    new_caches = []
    for lp, cache in zip(blocks, caches):
        x, cache = decode_fn(cfg, lp, x, cache, pos)
        new_caches.append(cache)
    return x, new_caches
