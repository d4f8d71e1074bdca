"""Serving steps: prefill and single-token decode (greedy / temperature),
the port of ``repro.serve.decode``.

``make_serve_step`` is one new token per sequence against a KV cache of
``seq_len`` positions; ``make_prefill_step`` fills that cache from a whole
prompt.  ``generate`` runs the two eagerly (the reference jits them): its
prefill goes through the hand flash-attention kernel, one launch a layer,
when the prompt lies on the card.

Under an active mesh whose rules put the batch on mesh axes, both steps
run as a data-parallel region, as ``train.step``'s does: each rank takes
its block of the tokens (``dist.sharding.local_batch``) and of the cache
along the batch, runs the model under the rest of the mesh (the batch
axes made known to the layers, ``dist.sharding.data_region``: the MoE's
global dispatch routes the whole batch, as the reference's does), and the
sampled tokens (and the decode logits) are gathered whole on every rank.
A blocked cache (``dist.sharding.Block``s, ``cache_shardings``) is written
in place and stays blocked, and a prefill of blocked tokens returns a
blocked cache; with whole tokens the prefill returns the whole cache, and
a decode step writes every rank's rows into a whole cache (the global
view: its rows are all-gathered each step).  The model's decode step
takes the blocks as they are held: under ``serve_rules(long_context=
True)`` the KV leaves are each rank's block of the sequence, decoded
there (``models.attention.attention_decode_step``).  The prefill stays
whole along the sequence, as the reference's ``prefill_32k`` (no long
context) is: a prefill of blocked tokens under those rules cuts its cache
into sequence blocks once, and a caller that holds a whole cache moves
into the layout with ``shard_tree`` and ``cache_shardings``.

Where the active rules split the vocabulary, the heads or the recurrent
channels (``dist.sharding`` module docstring), the model returns this
rank's vocabulary block of the logits and writes this rank's KV heads,
SSM channels and mLSTM heads (``Model.state_axes``): both steps gather
the [B, 1, V] rows whole before sampling (the returned logits are whole,
as the reference's), and the prefill returns that state whole, or, for
blocked tokens, the cache blocked over its batch and, where
``cache_shardings`` splits them, its KV heads, SSM channels and mLSTM
heads.

Sampling with a temperature draws from ``softmax(logits / T)`` through
``torch.multinomial`` with an explicit ``torch.Generator``: the reference's
``jax.random.categorical`` draws from the same distribution, but not the
same tokens for a seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.dist import collectives, compat
from repro_torch.dist.sharding import (Block, active_mesh, active_rules,
                                       batch_shardings, cache_logical,
                                       cache_shardings, data_region,
                                       local_batch, use_mesh)
from repro_torch.models.module import leaves, tree_map
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


def _region(tokens):
    """(mesh, rules, the batch dimension's spec entry) when the active
    mesh's rules split the batch of ``tokens`` (whole or a Block); None
    otherwise."""
    mesh, rules = active_mesh(), active_rules()
    if mesh is None or rules is None:
        return None
    if isinstance(tokens, Block):
        entry = tokens.spec[0]
    else:
        entry = batch_shardings({"tokens": tokens}, mesh,
                                rules)["tokens"].spec[0]
    return (mesh, rules, entry) if collectives.names_of(entry) else None


def _rest(mesh, entry):
    """The mesh without the batch's axes (None when nothing is left)."""
    names = collectives.names_of(entry)
    return compat.submesh(mesh, [n for n in mesh.mesh_dim_names
                                 if n not in names])


def _whole(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    return collectives._gather_whole(t, mesh, spec)


def _entry(axes: tuple):
    """A spec entry for ``axes``: None, one name, or a tuple of names."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _whole_vocab(model: Model, logits: torch.Tensor, s: int) -> torch.Tensor:
    """[B, S', V] logits whole from this rank's vocabulary block of a step
    over ``s`` positions, under the frame the model ran in."""
    axes = model.vocab_axes(logits.shape[0], s) \
        if active_mesh() is not None else ()
    if not axes:
        return logits
    return _whole(logits, active_mesh(), (None, None, _entry(axes)))


def _cache_specs(model: Model, cache, rows, axes=None):
    """Per cache leaf, the spec that splits its batch dimension over
    ``rows`` and each dimension ``axes`` names (a dict from the logical
    axes of ``Model.state_axes`` to spec entries: the KV heads, hymba's
    SSM channels, the mLSTM's heads or C's value rows) over its entry."""
    axes = axes or {}

    def one(leaf, spec):
        return tuple(rows if ax == "batch" else axes.get(ax)
                     for ax in cache_logical(spec.logical_axes))
    return tree_map(one, cache, model.cache_specs(1, 1))


def _prefill_cache(model: Model, cache, mesh, held, specs, rules, shape):
    """The prefill's cache (this rank's block under ``specs``) as the
    caller holds it: whole, or (``held``: blocked tokens) blocked as
    ``cache_shardings`` puts it over a cache of ``shape`` (batch,
    max_seq)."""
    if not held:
        return tree_map(lambda c, spec: _whole(c, mesh, spec), cache, specs)
    target = tree_map(lambda sh: sh.spec, cache_shardings(
        model.cache_specs(*shape), mesh, rules))

    def one(c, spec, want):
        if spec != want:
            c = collectives.block(_whole(c, mesh, spec), mesh, want).clone(
                memory_format=torch.contiguous_format)
        return Block(c, want, mesh)
    return tree_map(one, cache, specs, target)


def make_serve_step(model: Model, cfg: ServeConfig = ServeConfig()):
    """(params, cache, tokens [B,1], cache_index) -> (next_tokens, logits,
    cache).  Under a mesh that splits the batch, a data-parallel region
    (module docstring)."""

    def serve_step(params, cache, tokens, cache_index):
        region = _region(tokens)
        if region is None:
            logits, _ = model.decode_step(params, cache, tokens, cache_index)
            logits = _whole_vocab(model, logits, 1)
            next_tokens = sample(logits, None, cfg.temperature)
            return next_tokens, logits, cache
        mesh, rules, entry = region
        rows = (entry,)
        part = (tokens.local if isinstance(tokens, Block)
                else collectives.block(tokens, mesh, rows))
        specs = _cache_specs(model, tree_map(
            lambda c: c.local if isinstance(c, Block) else c, cache), entry)
        views = tree_map(lambda c, spec: c if isinstance(c, Block)
                         else collectives.block(c, mesh, spec), cache, specs)
        rest = _rest(mesh, entry)
        with data_region(mesh, collectives.names_of(entry)), \
                use_mesh(rest, rules if rest is not None else None):
            logits, _ = model.decode_step(params, views, part, cache_index)
            logits = _whole_vocab(model, logits, 1)
            next_tokens = sample(logits, None, cfg.temperature)
        for c, v, spec in zip(leaves(cache), leaves(views), leaves(specs)):
            if not isinstance(c, Block):       # the global view's rows
                c.copy_(_whole(v, mesh, spec))
        return (_whole(next_tokens, mesh, rows), _whole(logits, mesh, rows),
                cache)

    return serve_step


def make_prefill_step(model: Model, max_seq: int,
                      cfg: ServeConfig = ServeConfig()):
    """(params, batch) -> (first sampled token, cache filled to
    len(tokens)).  Under a mesh that splits the batch, a data-parallel
    region (module docstring)."""

    def run(params, batch):
        """(the first tokens, the cache, the spec entries of the state the
        layers computed on blocks of, ``Model.state_axes``) under
        the active frame."""
        b, s = batch["tokens"].shape
        logits, cache = model.prefill(params, batch, max_seq,
                                      k_chunk=cfg.k_chunk)
        last = _whole_vocab(model, logits[:, -1:], s)
        del logits
        blocks = ({k: _entry(v) for k, v in model.state_axes(b, s).items()
                   if v} if active_mesh() is not None else {})
        return sample(last, None, cfg.temperature), cache, blocks

    def prefill_step(params, batch):
        region = _region(batch["tokens"])
        if region is None:
            next_tokens, cache, blocks = run(params, batch)
            if blocks:
                cache = _prefill_cache(model, cache, active_mesh(), False,
                                       _cache_specs(model, cache, None,
                                                    blocks), None, None)
            return next_tokens, cache
        mesh, rules, entry = region
        part, _ = local_batch(batch, mesh, rules)
        rest = _rest(mesh, entry)
        with data_region(mesh, collectives.names_of(entry)), \
                use_mesh(rest, rules if rest is not None else None):
            next_tokens, cache, blocks = run(params, part)
        tokens = batch["tokens"]
        held = isinstance(tokens, Block)
        shape = ((tokens.whole_shape() if held else tokens.shape)[0],
                 max_seq)
        cache = _prefill_cache(model, cache, mesh, held,
                               _cache_specs(model, cache, entry, blocks),
                               rules, shape)
        return _whole(next_tokens, mesh, (entry,)), cache

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
