"""ModelConfig and the model API (counterpart of ``repro/models/model.py``),
for the dense, moe, mla_moe, ssm and hybrid families:

    init_params(cfg, seed, device)          -> params (meta: shapes only)
    loss_fn(cfg, params, batch)             -> scalar loss          (train)
    loss_and_grads(cfg, params, batch)      -> (loss, grads)
    make_train_step(cfg, optimizer)         -> (state, batch) -> (state, metrics)
    prefill_fn(cfg, params, batch)          -> (last-token logits, caches)
    decode_fn(cfg, params, caches, tok, pos)-> (logits, caches)   (one token)
    init_cache(cfg, batch, max_seq, device) -> zeroed per-block caches
    cache_seq_axes(cfg)                     -> each block cache leaf's sequence axis
    cache_axes(cfg)                         -> the same for every entry of init_cache
    count_params(cfg), active_params(cfg)   -> parameter counts (meta, no memory)

Params are the reference's tree with ``blocks`` (and the hybrid family's
``tail``) a list of per-block dicts (the reference stacks them on a leading
axis).  A block is one layer, or in the hybrid family a group of three
(``rec1``, ``rec2``, ``attn``: RecurrentGemma's two recurrent sub-blocks and
a local-attention one), and ``tail`` holds the ``n_layers % 3`` recurrent
sub-blocks past the last group.  Caches are a list of one entry per block,
then one per tail sub-block, as the family's cache spec gives it:
``{"k", "v"}`` of shape ``(B, S, K, hd)`` (dense, moe; with a local window
a ring of ``min(S, window)`` positions), ``{"c_kv" (B, S, kv_lora),
"k_rope" (B, S, qk_rope)}`` (mla_moe), ``{"conv" (B, 3, d_inner), "state"
(B, H, 64, ssm_state)}`` (ssm: constant in S), ``{"rec1", "rec2": {"conv"
(B, 3, d_rnn), "h" (B, d_rnn) float32}, "attn": {"k", "v"}}`` (hybrid; a
tail entry is one ``{"conv", "h"}``).  The ssm family has no RoPE, as in the
reference.  The other families, attention biases and LayerNorm raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch import resolve_device
from . import transformer as T
from .attention import rope_angles
from .layers import (embed, embedding_init, rmsnorm, rmsnorm_init,
                     softmax_cross_entropy_chunked)
from .paramdecl import normal_param

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    dtype: str = "bfloat16"
    rope_theta: float = 10000.0
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    attn_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # --- MLA (DeepSeek-V2)
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # --- hybrid (recurrentgemma)
    window: int = 0               # local-attention window (0 = full attention)
    d_rnn: int = 0
    # --- encdec (seamless)
    enc_layers: int = 0
    dec_layers: int = 0
    cross_len: int = 0            # encoder length for decode cache (0 = seq)
    # --- vlm (internvl)
    n_patches: int = 0
    # --- compilation / perf knobs of the reference (no effect in the port)
    layout: str = "v2"
    serve_layout: str = "v2"
    serve_fsdp: bool = True
    remat: str = "full"
    scan_layers: bool = True
    attn_chunk: int = 1024
    loss_chunk: int = 2048
    grad_accum: int = 1
    # --- applicability flags
    sub_quadratic: bool = False
    decode_supported: bool = True

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# family -> (block_init, block_apply, block_decode, block_prefill,
# cache_spec); the cache spec gives one layer's cache shapes (``init_cache``)
_FAMILY = {
    "dense": (T.dense_block_init, T.dense_block_apply, T.dense_block_decode,
              T.dense_block_prefill, T.dense_cache_spec),
    "moe": (T.moe_block_init, T.moe_block_apply, T.moe_block_decode,
            T.moe_block_prefill, T.dense_cache_spec),
    "mla_moe": (T.mla_block_init, T.mla_block_apply, T.mla_block_decode,
                T.mla_block_prefill, T.mla_cache_spec),
    "ssm": (T.ssm_block_init, T.ssm_block_apply, T.ssm_block_decode,
            T.ssm_block_prefill, T.ssm_cache_spec),
    "hybrid": (T.hybrid_group_init, T.hybrid_group_apply, T.hybrid_group_decode,
               T.hybrid_group_prefill, T.hybrid_cache_spec),
}


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(_FAMILY)})")
    for unported, name in ((cfg.attn_bias, "attn_bias"),
                           (cfg.norm != "rmsnorm", f"norm={cfg.norm!r}")):
        if unported:
            raise NotImplementedError(f"{name} is not ported yet")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_blocks(cfg: ModelConfig) -> int:
    """Blocks in the stack: one per layer, or one per group of three in the
    hybrid family (the reference's encoder-decoder comes with its family)."""
    return cfg.n_layers // 3 if cfg.family == "hybrid" else cfg.n_layers


def _n_tail(cfg: ModelConfig) -> int:
    """The hybrid family's recurrent sub-blocks past its last group."""
    return cfg.n_layers % 3 if cfg.family == "hybrid" else 0


# -------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``; on
    ``device="meta"`` no generator is made and the leaves are meta tensors
    of the real init's shapes and dtypes (the reference's
    ``init_params(cfg, None)``, spec mode)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = torch_dtype(cfg)
    p: Params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model, dt),
                 "final_norm": rmsnorm_init(gen, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": normal_param(gen, (cfg.vocab, cfg.d_model), dt,
                                              scale=0.02)}
    binit = _FAMILY[cfg.family][0]
    p["blocks"] = [binit(cfg, gen, dt) for _ in range(_n_blocks(cfg))]
    if _n_tail(cfg):
        p["tail"] = [T._rec_sub_init(cfg, gen, dt) for _ in range(_n_tail(cfg))]
    return p


# -------------------------------------------------------------- accounting
def count_params(cfg: ModelConfig) -> int:
    """Total parameters, counted from ``init_params(cfg, device="meta")``:
    shapes only, nothing allocated (llama3-405b has ~4e11)."""
    return sum(t.numel() for t in tree_flatten(init_params(cfg, device="meta"))[0])


def active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters (for MODEL_FLOPS = 6 * N_active * D)."""
    total = count_params(cfg)
    if cfg.n_experts and cfg.top_k:
        per_expert = 3 * cfg.d_model * cfg.d_ff_expert
        inactive = (cfg.n_experts - cfg.top_k) * per_expert * _n_blocks(cfg)
        total -= inactive
    return total


def _cache_specs(cfg: ModelConfig, batch: int, seq: int) -> List[Params]:
    """One cache spec per entry of the cache: each block's, then each tail
    sub-block's.  A spec is a dict whose leaves are shapes, in the config's
    dtype, or ``(shape, dtype)`` pairs (the hybrid family's float32 state);
    it may nest (a hybrid group's ``rec1``, ``rec2``, ``attn``)."""
    specs = [_FAMILY[cfg.family][4](cfg, batch, seq)] * _n_blocks(cfg)
    return specs + [T.rec_cache_spec(cfg, batch, seq)] * _n_tail(cfg)


def _leaf(spec, default_dtype=None) -> Tuple[Tuple[int, ...], Any]:
    """A cache spec leaf's (shape, dtype): a pair's own, or a shape's in
    ``default_dtype``."""
    if isinstance(spec[-1], torch.dtype):
        return tuple(spec[0]), spec[1]
    return tuple(spec), default_dtype


def _spec_map(fn, spec, default_dtype):
    """``fn(shape, dtype)`` over a cache spec's leaves, keeping its nesting."""
    if isinstance(spec, dict):
        return {k: _spec_map(fn, v, default_dtype) for k, v in spec.items()}
    return fn(*_leaf(spec, default_dtype))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device
               ) -> List[Params]:
    """Zeroed caches of ``max_seq`` positions, one entry per block and tail
    sub-block, each leaf of its spec's shape and dtype."""
    dev = resolve_device(device)
    return [_spec_map(lambda shape, dt: torch.zeros(shape, dtype=dt, device=dev),
                      spec, torch_dtype(cfg))
            for spec in _cache_specs(cfg, batch, max_seq)]


def _seq_axes(one, two):
    """The axes tree of two specs at seq 1 and 2: each leaf's first axis of
    differing length, None where none differs."""
    if isinstance(one, dict):
        return {k: _seq_axes(one[k], two[k]) for k in one}
    return next((i for i, (a, b) in enumerate(zip(_leaf(one)[0], _leaf(two)[0]))
                 if a != b), None)


def cache_seq_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """For each leaf of one block's cache, the axis that holds the sequence
    positions: the one whose length follows ``seq`` in the family's cache
    spec (a local window's ring included: its length is ``min(seq,
    window)``); ``None`` for a leaf of constant size (the ssm family's conv
    window and state, the hybrid family's ``conv`` and ``h``).  A hybrid
    group's axes nest as its cache does."""
    spec = _FAMILY[cfg.family][4]
    return _seq_axes(spec(cfg, 1, 1), spec(cfg, 1, 2))


def cache_axes(cfg: ModelConfig) -> List[Any]:
    """``cache_seq_axes`` for every entry of ``init_cache``'s list: each
    block's, then each tail sub-block's."""
    return [_seq_axes(one, two) for one, two in
            zip(_cache_specs(cfg, 1, 1), _cache_specs(cfg, 1, 2))]


# ----------------------------------------------------------------- forward
def _rope(cfg: ModelConfig, S: int, device):
    """RoPE's (cos, sin) for positions 0..S-1; (None, None) for the ssm
    family, which has no attention."""
    if cfg.family == "ssm":
        return None, None
    return rope_angles(torch.arange(S, device=device), T.head_dim(cfg),
                       cfg.rope_theta)


def _last_logits(cfg: ModelConfig, p: Params, h_last: torch.Tensor
                 ) -> torch.Tensor:
    """h_last: (B, d) -> (B, vocab)."""
    with record_function("unembed"):
        return h_last @ _unembed_params(cfg, p)["table"].T


def _unembed_params(cfg: ModelConfig, p: Params) -> Params:
    return p["embed"] if cfg.tie_embeddings else p["unembed"]


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """batch["tokens"], batch["labels"]: (B, S) [, "mask"] -> mean token CE
    (plus ``aux_loss_coef`` times the blocks' mean MoE aux loss)."""
    x = embed(p["embed"], batch["tokens"].long())
    cos, sin = _rope(cfg, x.shape[1], x.device)
    x, aux = T.run_stack(cfg, p["blocks"], x, _FAMILY[cfg.family][1], cos, sin)
    for lp in p.get("tail", []):
        x = T._rec_sub_apply(cfg, lp, x)
    h = rmsnorm(p["final_norm"], x)
    loss = softmax_cross_entropy_chunked(_unembed_params(cfg, p), h,
                                         batch["labels"], batch.get("mask"),
                                         chunk=cfg.loss_chunk)
    if cfg.n_experts:
        loss = loss + cfg.aux_loss_coef * aux / max(_n_blocks(cfg), 1)
    return loss


def loss_and_grads(cfg: ModelConfig, p: Params,
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
    """(loss, gradient tree like ``p``) by ``torch.autograd.grad`` over the
    param leaves; the loss is a detached 0-dim device tensor."""
    leaves, spec = tree_flatten(p)
    leaves = [t.detach().requires_grad_() for t in leaves]
    with torch.enable_grad():
        loss = loss_fn(cfg, tree_unflatten(leaves, spec), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(list(grads), spec)


def prefill_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, List[Params]]:
    """batch["tokens"]: (B, S) -> (logits of the last position, caches of S)."""
    x = embed(p["embed"], batch["tokens"])
    cos, sin = _rope(cfg, x.shape[1], x.device)
    x, caches = T.run_stack_prefill(cfg, p["blocks"], x, _FAMILY[cfg.family][3],
                                    cos, sin)
    for lp in p.get("tail", []):
        x, cache = T._rec_sub_prefill(cfg, lp, x)
        caches.append(cache)
    h = rmsnorm(p["final_norm"], x)
    return _last_logits(cfg, p, h[:, -1]), caches


def decode_fn(cfg: ModelConfig, p: Params, cache: List[Params],
              tokens: torch.Tensor, pos: int
              ) -> Tuple[torch.Tensor, List[Params]]:
    """tokens: (B, 1) at position ``pos``; writes the K/V caches in place
    (the recurrent states are new tensors in the returned caches)."""
    x = embed(p["embed"], tokens)
    n = len(p["blocks"])
    x, new_caches = T.run_stack_decode(cfg, p["blocks"], cache[:n], x,
                                       _FAMILY[cfg.family][2], pos)
    for lp, c in zip(p.get("tail", []), cache[n:]):
        x, c = T._rec_sub_decode(cfg, lp, x, c)
        new_caches.append(c)
    h = rmsnorm(p["final_norm"], x)
    return _last_logits(cfg, p, h[:, -1]), new_caches


# ------------------------------------------------------------------- Model
@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device="cuda") -> Params:
        return init_params(self.cfg, seed, device)

    def loss(self, params, batch):
        return loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch):
        return prefill_fn(self.cfg, params, batch)

    def decode(self, params, cache, tokens, pos):
        return decode_fn(self.cfg, params, cache, tokens, pos)


def build_model(cfg: ModelConfig) -> Model:
    _check_supported(cfg)
    return Model(cfg)


# ----------------------------------------------------------------- steps
def make_train_step(cfg: ModelConfig, optimizer) -> Callable:
    """(state, batch) -> (state, metrics).  state = {params, opt, step};
    metrics = {loss, grad_norm}, 0-dim device tensors (nothing here waits for
    the device).  ``cfg.grad_accum > 1`` splits the batch's leading dim into
    that many microbatches, sums their losses and gradients and divides by
    the count, as the reference's scan does."""
    build_model(cfg)

    def train_step(state, batch):
        params = state["params"]
        accum = cfg.grad_accum
        if accum > 1:
            mbs = {k: t.reshape((accum, t.shape[0] // accum) + t.shape[1:])
                   for k, t in batch.items()}
            loss, grads = None, None
            for i in range(accum):
                l, g = loss_and_grads(cfg, params, {k: t[i] for k, t in mbs.items()})
                loss = l if loss is None else loss + l
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)
        else:
            loss, grads = loss_and_grads(cfg, params, batch)
        with torch.no_grad(), record_function("update"):
            new_params, new_opt = optimizer.apply(grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss,
                           "grad_norm": optimizer.last_grad_norm(new_opt)}

    return train_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    model = build_model(cfg)

    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode(params, cache, tokens, pos)
        return logits.argmax(dim=-1, keepdim=True), cache

    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    model = build_model(cfg)

    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch)
        return logits.argmax(dim=-1, keepdim=True), cache

    return prefill_step
