"""InternVL2 26B — VLM: InternViT frontend (STUB) + InternLM2 backbone.

[arXiv:2404.16821; hf]  Backbone only per assignment: 48L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=92553.  The vision frontend is a stub:
``input_specs()`` provides 256 precomputed patch embeddings per sequence
which are prepended to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    layer_pattern=("attn",),
    frontend="patch",
    n_frontend_tokens=256,
    subquadratic=False,
)
