"""Model API: param/cache/input specs + forward/decode for every arch — the
port of the JAX package's ``models/registry.py``.

``Model`` is a thin, stateless facade over the functional blocks: plain
functions over param trees (nested dicts of tensors), the trees the serve
and train layers pass around.  ``init_params`` and ``init_cache`` create
tensors on the card unless the caller asks for the CPU
(``device="cpu"``); with no card and no device given they raise.

``decode_step`` writes into the cache it is given and returns that same
tree (the reference returns a new one; its scan carry aliases, so the
bytes it moves are the same).  ``forward``/``prefill`` run the attention
layers' chunked branch through the hand flash-attention kernel on a CUDA
tensor (``use_kernel=False``: the plain ``attend_chunked``).

Params may be held as blocks (``dist.sharding.Block``, a mesh's blocked
layout): the learned positions and the final norms are gathered where
they are used, the layers by the stack.  The embedding and the
unembedding take their table's vocabulary block where the active rules
split the vocabulary (``models.layers``): ``forward``, ``prefill`` and
``decode_step`` then return this rank's block of the logits
(:meth:`Model.vocab_axes` names the axes), and ``unembed_table`` this
rank's rows of the table.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, torch_dtype
from repro_torch.dist.sharding import constrain, gather_tree, take
from repro_torch.models import module
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, embed, embedding_spec,
                                       norm_spec, unembed, vocab_axes)
from repro_torch.models.module import ParamSpec


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- parameter declaration -------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        spec: dict[str, Any] = {
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
            "final_norm": norm_spec(cfg.norm_kind, cfg.d_model),
            "stack": tfm.stack_spec(cfg, cfg.n_layers, cross=cfg.encdec),
        }
        if not cfg.tie_embeddings:
            spec["unembed"] = embedding_spec(cfg.vocab_size, cfg.d_model)
        if cfg.positional == "learned":
            spec["pos_embed"] = {
                "table": ParamSpec((cfg.max_position, cfg.d_model), torch.float32,
                                   (None, "embed"), init="embed", init_scale=0.02)}
        if cfg.encdec:
            spec["encoder"] = {
                "stack": tfm.stack_spec(cfg, cfg.n_encoder_layers, cross=False),
                "final_norm": norm_spec(cfg.norm_kind, cfg.d_model),
                "pos_embed": {
                    "table": ParamSpec((cfg.n_frontend_tokens, cfg.d_model),
                                       torch.float32, (None, "embed"),
                                       init="embed", init_scale=0.02)},
            }
        if cfg.param_dtype != "float32":
            dt = torch_dtype(cfg.param_dtype)
            spec = module.tree_map(
                lambda s: dataclasses.replace(s, dtype=dt), spec)
        return spec

    # -- inputs ------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta tensors standing in for every model input."""
        cfg = self.cfg
        b = shape.global_batch
        compute = torch_dtype(cfg.compute_dtype)
        if shape.is_decode:
            specs = {"tokens": _meta((b, 1), torch.int32)}
        else:
            s_tok = shape.seq_len - (cfg.n_frontend_tokens
                                     if cfg.frontend == "patch" else 0)
            specs = {"tokens": _meta((b, s_tok), torch.int32),
                     "labels": _meta((b, s_tok), torch.int32)}
            if cfg.frontend == "patch":
                specs["patches"] = _meta((b, cfg.n_frontend_tokens,
                                          cfg.d_model), compute)
        if cfg.frontend == "frame":
            specs["frames"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                    compute)
        return specs

    def cache_specs(self, batch: int, max_seq: int,
                    cache_dtype=torch.bfloat16) -> dict:
        cfg = self.cfg
        cross_len = cfg.n_frontend_tokens if cfg.encdec else 0
        return tfm.stack_cache_spec(cfg, cfg.n_layers, batch, max_seq,
                                    cache_dtype, cross_len)

    # -- encoder (whisper) --------------------------------------------------
    def encode(self, params: dict, frames: torch.Tensor, *,
               remat: bool = True, k_chunk: int = 1024,
               use_kernel: bool = True) -> torch.Tensor:
        cfg = self.cfg
        enc = params["encoder"]
        t = frames.shape[1]
        x = frames + gather_tree(enc["pos_embed"])["table"][:t].to(
            frames.dtype)
        x, _ = tfm.stack_forward(cfg, enc["stack"], x, causal=False,
                                 remat=remat, k_chunk=k_chunk,
                                 use_kernel=use_kernel)
        return apply_norm(cfg.norm_kind, gather_tree(enc["final_norm"]), x,
                          impl=cfg.norm_impl)

    def _inputs(self, params: dict, batch: dict, dtype) -> torch.Tensor:
        """Token embeddings, the patches prepended, learned positions
        added."""
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"], dtype)
        if cfg.frontend == "patch" and "patches" in batch:
            x = torch.cat([batch["patches"].to(dtype), x], dim=1)
            x = constrain(x, "batch", "seq", "embed")
        if cfg.positional == "learned":
            table = gather_tree(params["pos_embed"])["table"]
            x = x + table[:x.shape[1]].to(dtype)
        return x

    # -- full-sequence forward (train / prefill) ----------------------------
    def forward(self, params: dict, batch: dict, *, remat: bool = True,
                k_chunk: int = 1024, local_block: bool = False,
                ring: bool = False, remat_policy: str = "full",
                return_hidden: bool = False, use_kernel: bool = True) -> tuple:
        """Returns (logits [B,S,V] — this rank's vocabulary block under a
        split, module docstring —, aux_loss), or the final hidden states
        [B,S,d] with ``return_hidden``."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        x = self._inputs(params, batch, dtype)
        memory = None
        if cfg.encdec:
            memory = self.encode(params, batch["frames"].to(dtype),
                                 remat=remat, k_chunk=k_chunk,
                                 use_kernel=use_kernel)
        x, aux = tfm.stack_forward(cfg, params["stack"], x, causal=True,
                                   memory=memory, remat=remat, k_chunk=k_chunk,
                                   local_block=local_block, ring=ring,
                                   remat_policy=remat_policy,
                                   use_kernel=use_kernel)
        x = self._final(params, x)
        if return_hidden:
            return x, aux
        return self._logits(params, x), aux

    def _final(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return apply_norm(cfg.norm_kind, gather_tree(params["final_norm"]), x,
                          impl=cfg.norm_impl)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return unembed(params.get("unembed", params["embed"]), x)

    def vocab_axes(self, b: int, s: int) -> tuple:
        """The mesh axes the active rules split the vocabulary of [b, s]
        logits over (this rank's block is the ``index``-th of their
        ranks' product, ``collectives.block_index``); () for whole
        logits."""
        return vocab_axes(b, s, self.cfg.vocab_size)

    def state_axes(self, b: int, s: int) -> dict:
        """{the logical axis of a cache leaf: the mesh axes its layer
        computes on a block of} for a step over [b, s] tokens under the
        active rules: the KV heads (attention), the SSM's channels
        ("mlp", hymba's ``h_ssm``) and the mLSTM's heads ("heads", its
        C, n, m); () for each that stays whole."""
        return tfm.state_axes(self.cfg, b, s)

    def unembed_table(self, params: dict, axes: tuple = ()) -> torch.Tensor:
        """The unembedding table: whole, or this rank's vocabulary rows
        over ``axes`` (:meth:`vocab_axes`)."""
        return take(params.get("unembed", params["embed"])["table"], 0, axes)

    # -- prefill: forward + populate decode cache ----------------------------
    def prefill(self, params: dict, batch: dict, max_seq: int, *,
                cache_dtype=torch.bfloat16, k_chunk: int = 1024,
                use_kernel: bool = True) -> tuple:
        """Returns (logits [B,S,V], cache filled for positions [0, S))."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        x = self._inputs(params, batch, dtype)
        memory = None
        if cfg.encdec:
            memory = self.encode(params, batch["frames"].to(dtype),
                                 k_chunk=k_chunk, use_kernel=use_kernel)
        x, cache = tfm.stack_prefill(cfg, params["stack"], x,
                                     max_seq=max_seq, cache_dtype=cache_dtype,
                                     memory=memory, k_chunk=k_chunk,
                                     use_kernel=use_kernel)
        x = self._final(params, x)      # the stack's output dies here
        return self._logits(params, x), cache

    # -- single-token decode -------------------------------------------------
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor,
                    cache_index, start=None, stream_kv: bool = False) -> tuple:
        """tokens: [B,1] -> (logits [B,1,V], cache).  Writes the step into
        ``cache`` in place and returns it.  ``start`` [B] gives each slot's
        admission index (continuous batching)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        index = int(cache_index)
        x = embed(params["embed"], tokens, dtype)
        if cfg.positional == "learned":
            table = gather_tree(params["pos_embed"])["table"]
            x = x + table[index:index + 1].to(dtype)[None]
        x, cache = tfm.stack_decode(cfg, params["stack"], x, cache, index,
                                    start=start, stream_kv=stream_kv)
        x = self._final(params, x)      # the stack's output dies here
        return self._logits(params, x), cache

    # -- convenience ---------------------------------------------------------
    def init_params(self, generator: torch.Generator, device="cuda") -> dict:
        return module.init(generator, self.param_specs(), device)

    def init_cache(self, batch: int, max_seq: int, cache_dtype=torch.bfloat16,
                   device="cuda") -> dict:
        return module.init(torch.Generator().manual_seed(0),
                           self.cache_specs(batch, max_seq, cache_dtype),
                           device)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
