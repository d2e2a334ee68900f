"""recurrentgemma-9b — Griffin (RG-LRU + local attention, 2:1 pattern).

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, window=2048, lru width 4096.  38 layers = 12 x (rec,rec,attn)
groups + 2 tail recurrent layers.  Sub-quadratic: runs ``long_500k``
(bounded window cache + O(1) recurrent state).
Same numbers as ``repro/configs/recurrentgemma_9b.py``.
"""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    window=2048,
    d_rnn=4096,
    activation="gelu",
    rope_theta=10000.0,
    sub_quadratic=True,
    layout="dp",        # no-TP DP+FSDP (small/linear arch)
    serve_fsdp=False,   # weights fit replicated-over-data at serve time
)

SMOKE = CONFIG.with_(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab=512, window=8, d_rnn=64)
