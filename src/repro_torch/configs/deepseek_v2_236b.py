"""deepseek-v2-236b — DeepSeek-V2 (MLA + fine-grained MoE).

[arXiv:2405.04434; hf]  60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536,
qk_nope=128, qk_rope=64, v=128), d_ff=1536 per routed expert, vocab=102400,
160 routed experts top-6 + 2 shared.
Same numbers as ``repro/configs/deepseek_v2_236b.py``.
"""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="mla_moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=0,
    d_ff_expert=1536,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    vocab=102400,
    q_lora=1536,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head_dim=128,
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff_expert=32,
    n_experts=8, top_k=2, n_shared_experts=1, vocab=512,
    q_lora=48, kv_lora=32, qk_nope=16, qk_rope=8, v_head_dim=16)
