"""Serving steps: prefill and single-token decode (greedy / temperature),
the port of ``repro.serve.decode``.

``make_serve_step`` is one new token per sequence against a KV cache of
``seq_len`` positions; ``make_prefill_step`` fills that cache from a whole
prompt.  ``generate`` runs the two eagerly (the reference jits them): its
prefill goes through the hand flash-attention kernel, one launch a layer,
when the prompt lies on the card.

Sampling with a temperature draws from ``softmax(logits / T)`` through
``torch.multinomial`` with an explicit ``torch.Generator``: the reference's
``jax.random.categorical`` draws from the same distribution, but not the
same tokens for a seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.registry import Model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0       # 0 => greedy
    k_chunk: int = 1024


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float) -> torch.Tensor:
    """logits [B,1,V] -> tokens [B,1] int32.  Greedy without a temperature
    or a generator; else one draw per row from softmax(logits / T)."""
    if temperature <= 0.0 or generator is None:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1]).to(torch.int32)


def make_serve_step(model: Model, cfg: ServeConfig = ServeConfig()):
    """(params, cache, tokens [B,1], cache_index) -> (next_tokens, logits,
    cache)."""

    def serve_step(params, cache, tokens, cache_index):
        logits, cache = model.decode_step(params, cache, tokens, cache_index)
        next_tokens = sample(logits, None, cfg.temperature)
        return next_tokens, logits, cache

    return serve_step


def make_prefill_step(model: Model, max_seq: int,
                      cfg: ServeConfig = ServeConfig()):
    """(params, batch) -> (first sampled token, cache filled to
    len(tokens))."""

    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch, max_seq,
                                      k_chunk=cfg.k_chunk)
        next_tokens = sample(logits[:, -1:], None, cfg.temperature)
        return next_tokens, cache

    return prefill_step


@torch.inference_mode()
def generate(model: Model, params, prompt: torch.Tensor, max_new: int,
             max_seq: int, cfg: ServeConfig = ServeConfig(),
             extras: Optional[dict] = None) -> torch.Tensor:
    """Simple generation loop (prefill + greedy decode) for the examples:
    tokens [B, max_new] int32 on the prompt's device."""
    batch = {"tokens": prompt}
    if extras:
        batch.update(extras)
    prefill = make_prefill_step(model, max_seq, cfg)
    step = make_serve_step(model, cfg)
    tok, cache = prefill(params, batch)
    out = [tok]
    idx = prompt.shape[1]
    for i in range(max_new - 1):
        tok, _, cache = step(params, cache, tok, idx + i)
        out.append(tok)
    return torch.cat(out, dim=1)
