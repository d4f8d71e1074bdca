"""Llama-4 Maverick 400B (17B active) — interleaved dense/MoE, 128 experts top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1 with a shared
expert on alternating layers (Llama-4 style early-fusion backbone).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=False,
    layer_pattern=("attn", "moe"),
    n_experts=128,
    moe_top_k=1,
    expert_d_ff=8192,
    shared_expert=True,
    param_dtype="bfloat16",     # 400B params: fp32 master would not fit 256xv5e
    subquadratic=False,
)
