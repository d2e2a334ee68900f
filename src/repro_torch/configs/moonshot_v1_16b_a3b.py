"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (DeepSeek-V3-style MoE).

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64 experts top-6 (+2 shared).
Same numbers as ``repro/configs/moonshot_v1_16b_a3b.py``.
"""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    d_ff_expert=1408,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    vocab=163840,
    rope_theta=50000.0,
    activation="silu",
    serve_fsdp=False,   # weights fit replicated-over-data at serve time
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff_expert=32,
    n_experts=8, top_k=2, n_shared_experts=1, vocab=512)
