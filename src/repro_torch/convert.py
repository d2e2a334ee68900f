"""Convert a JAX parameter tree (as numpy arrays) into the port's params.

    params_from_jax(cfg, jax.device_get(jax_params), device="cpu")

The input is the reference's tree — ``embed.table``, ``final_norm.scale``,
``unembed.table`` and ``blocks.{ln1.scale, attn.{wq,wk,wv,wo}, ln2.scale,
mlp.{w_up,w_gate,w_down}}`` stacked on a leading layer axis — with numpy
leaves, so this module never imports JAX.  bfloat16 leaves (numpy's
``ml_dtypes`` type) are carried through float32, which is exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import ModelConfig, _check_supported, torch_dtype


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` (JAX hands out read-only buffers) as ``dtype``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any], device="cuda"
                    ) -> Dict[str, Any]:
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def conv(sub, layer=None):
        """``sub`` as tensors; ``layer`` picks one slice of a stacked leaf."""
        if isinstance(sub, dict):
            return {k: conv(v, layer) for k, v in sub.items()}
        a = np.asarray(sub)
        return _tensor(a if layer is None else a[layer], dt, dev)

    n = np.asarray(tree["blocks"]["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} stacked layers, config {cfg.n_layers}")
    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [conv(tree["blocks"], i) for i in range(n)]
    return out
