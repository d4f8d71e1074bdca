"""Yi 9B — dense llama-style GQA transformer.

[arXiv:2403.04652; hf]  48L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000, SwiGLU, RMSNorm, long-context rope base.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    layer_pattern=("attn",),
    subquadratic=False,
)
