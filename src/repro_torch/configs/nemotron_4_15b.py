"""Nemotron-4 15B — dense GQA transformer with squared-ReLU MLP.

[arXiv:2402.16819; unverified]  32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000.  Nemotron-4 uses squared-ReLU activations and untied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    mlp_kind="squared_relu",
    norm_kind="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    layer_pattern=("attn",),
    subquadratic=False,
)
