"""mamba2-2.7b — Mamba-2 SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 ssm_state=128 vocab=50280.
d_inner = 2*d_model = 5120 -> 80 SSD heads of dim 64.  Sub-quadratic: runs
the ``long_500k`` decode cell (O(1)-per-token recurrent state).
Same numbers as ``repro/configs/mamba2_2_7b.py``.
"""

from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,            # d_inner / 64 (accounting only; SSD derives it)
    n_kv_heads=80,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    sub_quadratic=True,
    layout="dp",        # no-TP DP+FSDP (small/linear arch)
    serve_fsdp=False,   # weights fit replicated-over-data at serve time
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab=512, ssm_state=16)
