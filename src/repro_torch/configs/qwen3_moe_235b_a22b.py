"""Qwen3-MoE 235B (22B active) — all-MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, every layer MoE with 128 experts, top-8 routing,
no shared expert.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    layer_pattern=("moe",),
    n_experts=128,
    moe_top_k=8,
    expert_d_ff=1536,
    shared_expert=False,
    param_dtype="bfloat16",     # 235B params: fp32 master would not fit 256xv5e
    subquadratic=False,
)
