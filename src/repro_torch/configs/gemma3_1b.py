"""Gemma-3 1B — dense GQA transformer, 5:1 local:global attention, 128k ctx.

[hf:google/gemma-3-1b-pt; unverified]  26L d_model=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144, head_dim=256, sliding window 512 on local layers,
GeGLU MLP, tied embeddings.  Marked subquadratic: 5/6 of layers are
sliding-window and global layers are linear-per-token at decode, so the
long_500k decode shape runs (KV sequence-sharded; see DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=512,
    subquadratic=True,
)
