"""Whisper medium — encoder-decoder; conv frontend is a STUB.

[arXiv:2212.04356; unverified]  24L (each side) d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865, GELU, LayerNorm, learned positions.  The conv/mel
frontend is a stub: ``input_specs()`` provides 1500 precomputed frame
embeddings (the encoder input).  Decoder shapes use the assigned seq_len.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    mlp_kind="gelu",
    norm_kind="layernorm",
    tie_embeddings=True,
    layer_pattern=("attn",),
    frontend="frame",
    n_frontend_tokens=1500,
    encdec=True,
    n_encoder_layers=24,
    positional="learned",
    max_position=65536,
    subquadratic=False,
)
