"""xLSTM 1.3B — recurrent sLSTM + mLSTM blocks (no FFN).

[arXiv:2405.04517; unverified]  48L d_model=2048 4H vocab=50304, d_ff=0.
Blocks follow the xLSTM[7:1] recipe: 7 matrix-memory (mLSTM) blocks per
scalar-memory (sLSTM) block.  O(1) state per token -> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    mlp_kind="swiglu",          # unused (d_ff=0); blocks have internal proj
    norm_kind="layernorm",
    tie_embeddings=True,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    subquadratic=True,
)
