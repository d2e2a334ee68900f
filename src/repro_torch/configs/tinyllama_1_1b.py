"""tinyllama-1.1b — TinyLlama (llama2-architecture small).

[arXiv:2401.02385; hf]  22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
Same numbers as ``repro/configs/tinyllama_1_1b.py``.
"""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    rope_theta=10000.0,
    layout="dp",
    serve_fsdp=False,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512)
