"""Architecture + shape config system: the port's copy of the JAX
package's ``configs/base.py``.

Every assigned architecture is a frozen :class:`ArchConfig`; ``reduced()``
produces the family-preserving smoke-test config (small widths, few layers,
tiny vocab) exercised by the per-arch tests.  ``torch_dtype`` maps the
configs' dtype names (``compute_dtype``, ``param_dtype``) to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config names ("float32" or "bfloat16")."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]

# Block kinds usable in ``layer_pattern`` (repeated cyclically over layers):
#   attn    - full causal attention + dense MLP
#   local   - sliding-window attention + dense MLP
#   hybrid  - parallel attention + Mamba-SSM heads + dense MLP
#   moe     - full causal attention + MoE MLP
#   mlstm   - xLSTM matrix-memory block (no separate MLP)
#   slstm   - xLSTM scalar-memory block (no separate MLP)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"        # swiglu | squared_relu | gelu
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    layer_pattern: tuple = ("attn",)
    sliding_window: int = 0         # used by 'local' blocks
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"    # global | local (per-data-shard capacity)
    # --- SSM (mamba-style, used by 'hybrid') ---
    ssm_state: int = 0
    ssm_conv: int = 4
    # --- modality frontend (stub: precomputed embeddings are model inputs) ---
    frontend: str = "none"          # none | patch | frame
    n_frontend_tokens: int = 0
    # --- encoder-decoder (whisper) ---
    encdec: bool = False
    n_encoder_layers: int = 0
    # --- positions ---
    positional: str = "rope"        # rope | learned
    max_position: int = 1 << 20     # table size for learned positions
    # --- numerics ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"    # bf16 for the 200B+ models (HBM capacity)
    norm_impl: str = "f32"          # f32 | bf16_apply (f32 stats, bf16 apply)
    # --- long-context capability: can this arch run long_500k decode? ---
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def has_mlp(self) -> bool:
        return self.d_ff > 0

    def block_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke config: tiny widths, one pattern period."""
        period = len(self.layer_pattern)
        return dataclasses.replace(
            self,
            n_layers=max(2, period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            expert_d_ff=64 if self.expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            n_frontend_tokens=4 if self.n_frontend_tokens else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs, reason-if-skipped) — skips recorded in EXPERIMENTS.md."""
    if shape.kind == "long_decode" and not arch.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
