"""Core layer primitives: norms, embeddings, MLPs, rotary embeddings — the
port of the JAX package's ``models/layers.py``.

All layers are (spec-builder, apply-fn) pairs over ParamSpec trees; compute
is carried out in ``cfg.compute_dtype`` (bf16 by default) with fp32 master
parameters.  ``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s
default is (plain ``F.gelu`` is the erf form, another function).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain
from repro_torch.models.module import ParamSpec


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, ("embed",), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6,
            impl: str = "f32") -> torch.Tensor:
    dtype = x.dtype
    if impl == "bf16_apply":
        # f32 statistics, application in x's type: the full-width tensors
        # never materialise in f32
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(dtype)
        return x * inv * params["scale"].to(dtype)
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dtype)


def layernorm_spec(d: int) -> dict:
    return {
        "scale": ParamSpec((d,), torch.float32, ("embed",), init="ones"),
        "bias": ParamSpec((d,), torch.float32, ("embed",), init="zeros"),
    }


def _mean_var(x: torch.Tensor) -> tuple:
    """fp32 mean and population variance over the last axis, as
    ``jnp.mean``/``jnp.var``."""
    mu = x.mean(dim=-1, keepdim=True)
    return mu, (x - mu).square().mean(dim=-1, keepdim=True)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5,
              impl: str = "f32") -> torch.Tensor:
    dtype = x.dtype
    if impl == "bf16_apply":
        mu, var = _mean_var(x.float())
        inv = torch.rsqrt(var + eps).to(dtype)
        return ((x - mu.to(dtype)) * inv * params["scale"].to(dtype)
                + params["bias"].to(dtype))
    x = x.float()
    mu, var = _mean_var(x)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dtype)


def norm_spec(kind: str, d: int) -> dict:
    return rmsnorm_spec(d) if kind == "rmsnorm" else layernorm_spec(d)


def apply_norm(kind: str, params: dict, x: torch.Tensor,
               impl: str = "f32") -> torch.Tensor:
    fn = rmsnorm if kind == "rmsnorm" else layernorm
    return fn(params, x, impl=impl)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embedding_spec(vocab: int, d: int) -> dict:
    # 1/sqrt(d): unit-variance logits under tied unembedding at init
    return {"table": ParamSpec((vocab, d), torch.float32, ("vocab", "embed"),
                               init="embed", init_scale=d ** -0.5)}


def embed(params: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # gather, then cast: the reference casts the whole table first, which
    # gives the same numbers
    out = params["table"][tokens.long()].to(compute_dtype)
    return constrain(out, "batch", "seq", "embed")


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss stability); table shared with embed when tied."""
    logits = torch.matmul(x.float(), params["table"].float().t())
    return constrain(logits, "batch", "seq", "vocab")


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_spec(kind: str, d: int, d_ff: int) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, d_ff), torch.float32, ("embed", "mlp")),
            "w_up": ParamSpec((d, d_ff), torch.float32, ("embed", "mlp")),
            "w_down": ParamSpec((d_ff, d), torch.float32, ("mlp", "embed")),
        }
    # squared_relu (nemotron) and gelu (whisper/vit) share a 2-matrix shape
    return {
        "w_up": ParamSpec((d, d_ff), torch.float32, ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d), torch.float32, ("mlp", "embed")),
    }


def mlp(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    if kind in ("swiglu", "geglu"):
        g = torch.matmul(x, params["w_gate"].to(dtype))
        u = torch.matmul(x, params["w_up"].to(dtype))
        h = (F.silu(g) if kind == "swiglu" else gelu(g)) * u
    else:
        h = torch.matmul(x, params["w_up"].to(dtype))
        if kind == "squared_relu":
            h = torch.relu(h).square()
        elif kind == "gelu":
            h = gelu(h)
        else:
            raise ValueError(f"unknown mlp kind {kind}")
    h = constrain(h, "batch", "seq", "mlp")
    out = torch.matmul(h, params["w_down"].to(dtype))
    return constrain(out, "batch", "seq", "embed")


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    # log(theta) in fp32 as the reference takes it, as a Python number: a
    # tensor made on the host and copied to the card would wait for the
    # card at every call
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32,
                                                device=x.device) / half)
    angles = positions[..., :, None].float() * freqs   # [..., seq, half]
    cos = torch.cos(angles)[..., :, None, :]            # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)
