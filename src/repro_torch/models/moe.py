"""Mixture-of-Experts FFN: top-k routing, capacity-bounded scatter dispatch
(counterpart of ``repro/models/moe.py``).

The reference's function, with every shape fixed by the input's: no boolean
indexing, ``nonzero``, ``.item()`` or sort of data-dependent length, so a
layer puts no device -> host sync in the step and runs on meta tensors (the
analytical route, ``core.trace_compiled``).

* The router stays float32 in a bf16 model; its logits are f32.
* Each batch row dispatches on its own: its ``S * top_k`` slots arrive in
  token-major order, and a slot whose arrival position in its expert is
  ``>= capacity`` is dropped (it adds zero to position ``capacity - 1``, as
  the reference's ``.at[].add`` does).
* Tokens are scattered (``index_put`` with ``accumulate=True``) into the
  reference's ``(B, E, C, d)`` buffer, stored expert-major as
  ``(E, B * C, d)`` so the expert products are plain ``bmm``s; kept slots
  have distinct targets, so the sum is exact in any order.
* The combine is a gather and a sum over each token's ``top_k`` slots,
  which lie next to each other: no atomics, the same result every run.

The expert products and everything else here are XLA in the reference, not
a Pallas kernel, so this plain PyTorch is the port of the layer.  Shared
experts (DeepSeek-V2 style) are the port's dense ``mlp``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .layers import ACTIVATIONS, mlp, mlp_init
from .paramdecl import normal_param

Params = Dict[str, torch.Tensor]


def moe_init(gen, d: int, d_ff_expert: int, n_experts: int, top_k: int,
             n_shared: int, dtype) -> Params:
    p: Params = {
        "router": normal_param(gen, (d, n_experts), torch.float32, scale=0.02),
        "w_gate": normal_param(gen, (n_experts, d, d_ff_expert), dtype),
        "w_up": normal_param(gen, (n_experts, d, d_ff_expert), dtype),
        "w_down": normal_param(gen, (n_experts, d_ff_expert, d), dtype),
    }
    if n_shared > 0:
        p["shared"] = mlp_init(gen, d, d_ff_expert * n_shared, dtype, gated=True)
    return p


def _route(router_w: torch.Tensor, x2: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2: (T, d) -> (gate_probs (T,k), expert_idx (T,k), aux_loss)."""
    logits = x2.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux loss (Switch-style): E * mean(frac_tokens * frac_prob)
    E = router_w.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    return gate, idx, E * (me * ce).sum()


def moe_ffn(p: Params, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25,
            activation: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss).  Per-row scatter-dispatch MoE."""
    with record_function("moe"):
        B, S, d = x.shape
        E = p["router"].shape[-1]
        k = top_k
        gate, idx, aux = _route(p["router"], x.reshape(B * S, d), k)
        gate = gate.reshape(B, S * k)
        flat_e = idx.reshape(B, S * k)

        cap = int(max(1, round(S * k / E * capacity_factor)))
        pos = F.one_hot(flat_e, E).cumsum(1) - 1               # arrival order
        pos_in_e = pos.gather(2, flat_e[..., None])[..., 0]    # (B, S*k)
        keep = pos_in_e < cap                                  # overflow drops
        safe_pos = torch.where(keep, pos_in_e, cap - 1)
        # the slot's row of the expert-major buffer: batch row b, position c
        row = torch.arange(B, device=x.device)[:, None] * cap + safe_pos

        # each token's k slots next to each other (the reference's tok_ids)
        x_slots = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
        contrib = torch.where(keep[..., None], x_slots, 0).to(x.dtype)
        buf = x.new_zeros((E, B * cap, d)).index_put(
            (flat_e, row), contrib, accumulate=True)           # (E, B*C, d)

        act = ACTIVATIONS[activation]
        h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        eo = torch.bmm(h, p["w_down"])                         # (E, B*C, d)

        # gather each (token, slot)'s expert output back, weight by its gate
        out_slots = eo[flat_e, row]                            # (B, S*k, d)
        w = (gate * keep).to(x.dtype)
        out = (out_slots * w[..., None]).view(B, S, k, d).sum(2)
        if "shared" in p:
            out = out + mlp(p["shared"], x, activation=activation)
        return out, aux


def moe_param_count(d: int, d_ff_expert: int, n_experts: int, n_shared: int
                    ) -> Tuple[int, int]:
    """(total, active-per-token-with-top_k=1-unit) FFN params — helpers for
    the 6*N*D MODEL_FLOPS accounting."""
    per_expert = 3 * d * d_ff_expert
    total = n_experts * per_expert + d * n_experts
    shared = 3 * d * d_ff_expert * n_shared if n_shared else 0
    return total + shared, per_expert
