"""Hymba 1.5B — hybrid-head transformer: parallel attention + Mamba heads.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.  Each layer runs attention heads and SSM heads in
parallel on the same input and fuses their (normalised) outputs.  Hymba uses
sliding-window attention on most layers, so the hybrid is subquadratic and
runs the long_500k decode shape.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    layer_pattern=("hybrid",),
    sliding_window=1024,
    ssm_state=16,
    subquadratic=True,
)
