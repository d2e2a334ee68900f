"""Convert JAX trees (as numpy arrays) into the port's params and optimizer
state.

    params_from_jax(cfg, jax.device_get(jax_params), device="cpu")
    opt_state_from_jax(cfg, jax.device_get(jax_opt_state), device="cpu")

The input is the reference's tree — ``embed.table``, ``final_norm.scale``,
``unembed.table`` and ``blocks.{ln1.scale, attn.{wq,wk,wv,wo}, ln2.scale,
mlp.{w_up,w_gate,w_down}}`` stacked on a leading layer axis — with numpy
leaves, so this module never imports JAX.  bfloat16 leaves (numpy's
``ml_dtypes`` type) are carried through float32, which is exact.  The port's
trees keep ``blocks`` as a list of per-layer dicts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import ModelConfig, _check_supported, torch_dtype
from repro_torch.optim import opt_state


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` (JAX hands out read-only buffers) as ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _split_layers(cfg: ModelConfig, tree: Dict[str, Any], dtype: torch.dtype,
                  device) -> Dict[str, Any]:
    """A params-shaped numpy tree as tensors of ``dtype``, blocks unstacked."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def conv(sub, layer=None):
        """``sub`` as tensors; ``layer`` picks one slice of a stacked leaf."""
        if isinstance(sub, dict):
            return {k: conv(v, layer) for k, v in sub.items()}
        a = np.asarray(sub)
        return _tensor(a if layer is None else a[layer], dtype, dev)

    n = np.asarray(tree["blocks"]["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} stacked layers, config {cfg.n_layers}")
    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [conv(tree["blocks"], i) for i in range(n)]
    return out


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device="cuda"
                    ) -> Dict[str, Any]:
    """A params tree (or a params-shaped one, such as gradients) in the
    config's dtype."""
    return _split_layers(cfg, tree, torch_dtype(cfg), device)


def opt_state_from_jax(cfg: ModelConfig, state: Dict[str, Any], device="cuda"
                       ) -> Dict[str, Any]:
    """The reference's AdamW state ``{m, v, count, gnorm}`` as the port's
    (``optim.opt_state``): m and v in f32, count carried over."""
    return opt_state(_split_layers(cfg, state["m"], torch.float32, device),
                     _split_layers(cfg, state["v"], torch.float32, device),
                     np.asarray(state["count"]))
