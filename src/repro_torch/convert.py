"""Convert between the reference's trees and the port's params, optimizer
state and trainer state.

    params_from_jax(cfg, jax.device_get(jax_params), device="cpu")
    opt_state_from_jax(cfg, jax.device_get(jax_opt_state), device="cpu")
    params_to_jax(cfg, params), opt_state_to_jax(cfg, opt_state)   # numpy
    state_to_reference(cfg, state), state_from_reference(cfg, tree, device)

The reference's tree is ``embed.table``, ``final_norm.scale``,
``unembed.table`` and ``blocks.{ln1.scale, attn.{wq,wk,wv,wo}, ln2.scale,
mlp.{w_up,w_gate,w_down}}`` stacked on a leading layer axis (the hybrid
family's ``blocks`` are groups ``{rec1, rec2, attn}``, and its ``tail``
recurrent sub-blocks are stacked too), and its AdamW state ``{m, v, count,
gnorm}``; the port's trees keep ``blocks`` and ``tail`` as lists of
per-block dicts and its AdamW m and v flat-backed (``optim.opt_state``).
Inputs may be numpy trees (this module never imports JAX; bfloat16 leaves,
numpy's ``ml_dtypes`` type, are carried through float32, which is exact) or
tensors.  ``*_to_jax`` return numpy trees with bfloat16 carried as float32;
``state_to_reference`` returns the trainer state ``{params, opt, step}`` in
the reference's layout as tensors on the state's device, dtypes kept: what
the trainer checkpoints, so its files are the reference trainer's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import resolve_device
from repro_torch.models.model import (ModelConfig, _check_supported, _n_blocks,
                                      _n_tail, init_params)
from repro_torch.optim import opt_state


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` as ``dtype`` on ``device``: a copy of an array (JAX hands out
    read-only buffers); a tensor already so is returned as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _stacks(cfg: ModelConfig) -> Dict[str, int]:
    """The stacked subtrees of the config's params and their depths."""
    out = {"blocks": _n_blocks(cfg)}
    if _n_tail(cfg):
        out["tail"] = _n_tail(cfg)
    return out


def _depth(blocks: Dict[str, Any]) -> int:
    """The leading (layer) axis of a stacked blocks tree: any leaf's."""
    while isinstance(blocks, dict):
        blocks = next(iter(blocks.values()))
    return blocks.shape[0]


def _split_layers(cfg: ModelConfig, tree: Dict[str, Any], dtype, device
                  ) -> Dict[str, Any]:
    """A params-shaped tree (blocks and tail stacked) as tensors, blocks and
    tail unstacked: every leaf in ``dtype``, or, where ``dtype`` is a
    params-shaped tree of dtypes (blocks a list), each leaf in its own."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(sub, dt, layer=None):
        """``sub`` as tensors; ``layer`` picks one slice of a stacked leaf."""
        if isinstance(sub, dict):
            return {k: conv(v, dt[k] if isinstance(dt, dict) else dt, layer)
                    for k, v in sub.items()}
        a = sub if isinstance(sub, torch.Tensor) else np.asarray(sub)
        return _tensor(a if layer is None else a[layer], dt, dev)

    stacks = _stacks(cfg)
    out = conv({k: v for k, v in tree.items() if k not in stacks}, dtype)
    for key, want in stacks.items():
        n = _depth(tree[key])
        if n != want:
            raise ValueError(f"tree has {n} stacked {key}, config {want}")
        dt = dtype[key][0] if isinstance(dtype, dict) else dtype
        out[key] = [conv(tree[key], dt, i) for i in range(n)]
    return out


def _stack_layers(cfg: ModelConfig, tree: Dict[str, Any]) -> Dict[str, Any]:
    """A port params-shaped tree with ``blocks`` (and ``tail``) stacked on a
    leading layer axis (new tensors, on the leaves' device, dtypes kept)."""
    _check_supported(cfg)
    stacks = _stacks(cfg)

    def stack(subs):
        if isinstance(subs[0], dict):
            return {k: stack([s[k] for s in subs]) for k in subs[0]}
        return torch.stack([s.detach() for s in subs])

    out = {k: v for k, v in tree.items() if k not in stacks}
    for key, want in stacks.items():
        if len(tree[key]) != want:
            raise ValueError(f"tree has {len(tree[key])} {key}, config {want}")
        out[key] = stack(tree[key])
    return out


def _numpy(tree):
    """A tensor tree as numpy on the host, bfloat16 carried as float32."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device="cuda"
                    ) -> Dict[str, Any]:
    """A params tree (or a params-shaped one, such as gradients), each leaf
    in the dtype ``init_params`` gives it: the config's, but float32 for a
    MoE router, as in the reference."""
    dtypes = tree_map(lambda t: t.dtype, init_params(cfg, device="meta"))
    return _split_layers(cfg, tree, dtypes, device)


def opt_state_from_jax(cfg: ModelConfig, state: Dict[str, Any], device="cuda"
                       ) -> Dict[str, Any]:
    """The reference's AdamW state ``{m, v, count, gnorm}`` as the port's
    (``optim.opt_state``): m and v in f32 and flat-backed, count and gnorm
    carried over."""
    out = opt_state(_split_layers(cfg, state["m"], torch.float32, device),
                    _split_layers(cfg, state["v"], torch.float32, device),
                    int(state["count"]))
    if "gnorm" in state:
        out["gnorm"].fill_(float(state["gnorm"]))
    return out


def params_to_jax(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params as the reference's numpy tree (bf16 as f32)."""
    return _numpy(_stack_layers(cfg, params))


def _opt_to_reference(cfg: ModelConfig, state: Dict[str, Any]
                      ) -> Dict[str, Any]:
    return {"m": _stack_layers(cfg, state["m"]),
            "v": _stack_layers(cfg, state["v"]),
            "count": state["count"], "gnorm": state["gnorm"]}


def opt_state_to_jax(cfg: ModelConfig, state: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """The port's AdamW state as the reference's numpy ``{m, v, count,
    gnorm}``."""
    return _numpy(_opt_to_reference(cfg, state))


def state_to_reference(cfg: ModelConfig, state: Dict[str, Any]
                       ) -> Dict[str, Any]:
    """The trainer state ``{params, opt, step}`` in the reference's layout:
    tensors on the state's device, dtypes kept.  Stacked leaves are new
    tensors; the others are the state's own (m and v's are updated in place
    by the next step: copy before that, as ``CheckpointManager`` does)."""
    return {"params": _stack_layers(cfg, state["params"]),
            "opt": _opt_to_reference(cfg, state["opt"]),
            "step": state["step"]}


def state_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                         device="cuda") -> Dict[str, Any]:
    """The reference's trainer state (numpy or tensors) as the port's, on
    ``device``: params in their ``init_params`` dtypes, the AdamW state
    flat-backed (``AdamW.apply_fused`` updates those buffers in place)."""
    dev = resolve_device(device)
    step = tree["step"]
    step = (step.to(device=dev, dtype=torch.int32) if isinstance(step, torch.Tensor)
            else torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev))
    return {"params": params_from_jax(cfg, tree["params"], dev),
            "opt": opt_state_from_jax(cfg, tree["opt"], dev), "step": step}
