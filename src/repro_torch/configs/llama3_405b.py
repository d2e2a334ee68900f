"""llama3-405b — Llama-3.1 405B dense.

[arXiv:2407.21783; unverified]  126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256.  Same numbers as ``repro/configs/llama3_405b.py``.
The port prices it (``serving_cost``, ``count_params`` on meta tensors); it
does not fit on one card.
"""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    layout="dp",
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512)
