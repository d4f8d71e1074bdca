"""Model assembly: pattern-stacked layer stacks for all 10 architectures —
the port of the JAX package's ``models/transformer.py``.

Layers are grouped into *periods* (one repetition of ``cfg.layer_pattern``);
full periods keep stacked params under ``scan`` (a leading layer axis per
leaf, as the reference's ``lax.scan`` needs them, so weights carry across
key for key), and the remainder (e.g. gemma3's 26 = 4*6 + 2) runs as the
``tail``.  Where the reference scans, the port loops in Python and indexes
each stacked leaf per period.  The same structure drives ``forward``
(train/prefill) and ``decode_step`` (KV-cache/state decode).

``remat`` (and ``remat_policy``) wrap each period in
``torch.utils.checkpoint`` under autograd, the recompute under the mesh
frame of the forward (``dist.sharding.bind_frame``); without a gradient
they change no number.  A layer's params may be held as blocks
(``dist.sharding.Block``): each layer gathers its own just before it runs
(inside the checkpointed period, so the recompute gathers them again and
no whole weight outlives its layer).  The attention, MLP, SSM-branch,
xLSTM, shared-expert and expert weights are gathered only along the axes
the layer does not compute on: under a mesh that splits their heads,
``mlp`` or ``expert`` dimension they compute on this rank's block
(``models.attention``, ``models.layers``, ``models.ssm`` through
:func:`_fuse_ssm`, ``models.xlstm``, ``models.moe``; :func:`_held`).
In a data-parallel region that takes gradients, the period's fsdp
leaves pass ``region_period`` (:func:`_in_region`), but the global MoE
dispatch's expert weights, which it computes on as they are held
(``moe.region_held``).  Inside a layer the sequential loops remat each step
(``layers.scan_step``): the period's recompute keeps one step's
intermediates at a time.  ``stack_decode`` updates the cache it is given
in place and returns it: each layer writes one token slice of its KV
cache and its recurrent state (whole, or this rank's SSM channels, mLSTM
heads or C's value rows, as the cache holds it) into the stacked
tensors, never a copy of the cache.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (active_mesh, bind_frame, gather_tree,
                                       local, region_period, split_axes,
                                       take)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import apply_norm, mlp, mlp_spec, norm_spec
from repro_torch.models.module import ParamSpec, stack_tree, tree_map

# ---------------------------------------------------------------------------
# Per-block param specs
# ---------------------------------------------------------------------------

def block_spec(cfg: ArchConfig, kind: str, cross: bool = False) -> dict:
    d = cfg.d_model
    if kind == "mlstm":
        return xlstm_mod.mlstm_spec(cfg)
    if kind == "slstm":
        return xlstm_mod.slstm_spec(cfg)
    spec: dict[str, Any] = {
        "norm1": norm_spec(cfg.norm_kind, d),
        "attn": attn.attention_spec(cfg),
    }
    if cross:
        spec["norm_x"] = norm_spec(cfg.norm_kind, d)
        spec["cross"] = attn.attention_spec(cfg, cross=True)
    if kind == "hybrid":
        di = d
        spec["ssm_in"] = ParamSpec((d, di), torch.float32, ("embed", "mlp"))
        spec["ssm"] = ssm_mod.ssm_spec(cfg, di)
        spec["ssm_out"] = ParamSpec((di, d), torch.float32, ("mlp", "embed"))
        spec["fuse_attn_norm"] = norm_spec("rmsnorm", d)
        spec["fuse_ssm_norm"] = norm_spec("rmsnorm", d)
    if kind == "moe":
        spec["norm2"] = norm_spec(cfg.norm_kind, d)
        spec["moe"] = moe_mod.moe_spec(cfg)
    elif cfg.has_mlp:
        spec["norm2"] = norm_spec(cfg.norm_kind, d)
        spec["mlp"] = mlp_spec(cfg.mlp_kind, d, cfg.d_ff)
    return spec


def block_cache_spec(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                     cache_dtype=torch.bfloat16, cross_len: int = 0) -> dict:
    """Decode-state declaration for one block (ParamSpec tree)."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    d = cfg.d_model
    f32 = torch.float32
    if kind == "mlstm":
        di = 2 * d
        dh = di // cfg.n_heads
        return {"C": ParamSpec((batch, cfg.n_heads, dh, dh), f32,
                               ("batch", "heads", "head_dim", "head_dim"), init="zeros"),
                "n": ParamSpec((batch, cfg.n_heads, dh), f32,
                               ("batch", "heads", "head_dim"), init="zeros"),
                "m": ParamSpec((batch, cfg.n_heads), f32,
                               ("batch", "heads"), init="zeros")}
    if kind == "slstm":
        leaf = ParamSpec((batch, d), f32, ("batch", "embed"), init="zeros")
        return {"c": leaf, "n": leaf, "m": leaf, "h": leaf}
    # attention KV cache
    seq = max_seq
    cache = {"k": ParamSpec((batch, seq, kv, hd), cache_dtype,
                            ("batch", "cache_seq", "kv_heads", "head_dim"), init="zeros"),
             "v": ParamSpec((batch, seq, kv, hd), cache_dtype,
                            ("batch", "cache_seq", "kv_heads", "head_dim"), init="zeros")}
    if kind == "hybrid":
        cache["h_ssm"] = ParamSpec((batch, d, cfg.ssm_state), f32,
                                   ("batch", "mlp", None), init="zeros")
    if cross_len:
        cache["xk"] = ParamSpec((batch, cross_len, kv, hd), cache_dtype,
                                ("batch", None, "kv_heads", "head_dim"), init="zeros")
        cache["xv"] = ParamSpec((batch, cross_len, kv, hd), cache_dtype,
                                ("batch", None, "kv_heads", "head_dim"), init="zeros")
    return cache


# ---------------------------------------------------------------------------
# Per-block forward / decode
# ---------------------------------------------------------------------------

def ssm_axes(cfg: ArchConfig, b: int, s: int) -> tuple:
    """The mesh axes the active rules split hymba's SSM channels (its
    ``d_inner`` = d_model, the "mlp" dimension of ``ssm_in``'s output)
    over for activations of ``b`` x ``s`` positions; () where they stay
    whole."""
    return split_axes(("batch", "seq", "mlp"), (b, s, cfg.d_model), 2)


def state_axes(cfg: ArchConfig, b: int, s: int) -> dict:
    """``Model.state_axes``: per logical axis of a cache leaf (the mLSTM
    C's value rows named ``"value_rows"``, ``dist.sharding.cache_logical``),
    the mesh axes its layer computes on this rank's block of."""
    _, heads, rows = xlstm_mod.mlstm_axes(cfg, b, s, 2 * cfg.d_model)
    return {"kv_heads": attn.head_axes(cfg, b, s)[1],
            "mlp": ssm_axes(cfg, b, s), "heads": heads, "value_rows": rows}


def _fuse_ssm(cfg, params, h, a, x_dtype, ssm_fn):
    """Hymba's parallel heads: the SSM branch beside attention output
    ``a``, the two normalised and averaged; returns (mix, ssm state).
    Under a mesh that splits the channels (:func:`ssm_axes`) ``ssm_in`` is
    column-parallel, the SSM runs on this rank's channels (``ssm_fn``
    takes them and the axes) and ``ssm_out`` is row-parallel."""
    axes = ssm_axes(cfg, h.shape[0], h.shape[1])
    mesh = active_mesh()
    if axes:
        h = collectives.copy_to(h, mesh, axes)
    u = torch.matmul(h, take(params["ssm_in"], 1, axes).to(x_dtype))
    s_out, state = ssm_fn(params["ssm"], u, axes=axes)
    s_out = torch.matmul(s_out, take(params["ssm_out"], 0, axes).to(x_dtype))
    if axes:
        s_out = collectives.reduce_from(s_out, mesh, axes)
    mix = 0.5 * (apply_norm("rmsnorm", params["fuse_attn_norm"], a, impl=cfg.norm_impl)
                 + apply_norm("rmsnorm", params["fuse_ssm_norm"], s_out, impl=cfg.norm_impl))
    return mix, state


def _ffn(cfg, kind, params, x):
    """The block's MLP or MoE residual branch: (x_out, aux)."""
    if kind == "moe":
        h2 = apply_norm(cfg.norm_kind, params["norm2"], x, impl=cfg.norm_impl)
        y, aux = moe_mod.moe_apply(cfg, params["moe"], h2)
        return x + y, aux
    if cfg.has_mlp:
        h2 = apply_norm(cfg.norm_kind, params["norm2"], x, impl=cfg.norm_impl)
        x = x + mlp(cfg.mlp_kind, params["mlp"], h2)
    return x, None


# the sub-trees and leaves whose layers take their own weight blocks: the
# attention's, the MLP's, hymba's SSM projections and the xLSTM cores'
_TAKEN = ("attn", "cross", "mlp", "ssm_in", "ssm_out",
          "w_up", "wq", "wk", "wv", "w_if", "w_down", "w_gates")


# the MoE's leaves its dispatches take as held: the shared expert and the
# experts' weights (``models.moe``); the router is used whole
_MOE_TAKEN = ("shared", "w_gate", "w_up", "w_down")


def _held(params: dict) -> dict:
    """One block's params as its layers use them: the leaves of
    ``_TAKEN``, the MoE's shared expert and its experts' weights as they
    are held (each layer takes the block it computes on,
    ``dist.sharding.take``), every other leaf whole (``gather_tree``)."""
    out = {}
    for k, v in params.items():
        if k == "moe":
            v = {kk: vv if kk in _MOE_TAKEN else gather_tree(vv)
                 for kk, vv in v.items()}
        elif k not in _TAKEN:
            v = gather_tree(v)
        out[k] = v
    return out


def _in_region(cfg: ArchConfig, tree: dict, path: tuple = ()) -> dict:
    """One period's params as a data-parallel region uses them
    (``region_period``), but the leaves the MoE's global dispatch takes as
    they are held (``moe.region_held``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _in_region(cfg, v, path + (k,))
        else:
            out[k] = (v if moe_mod.region_held(cfg, path + (k,))
                      else region_period(v))
    return out


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_forward(cfg: ArchConfig, kind: str, params: dict, x: torch.Tensor, *,
                  causal: bool = True, memory: Optional[torch.Tensor] = None,
                  k_chunk: int = 1024, local_block: bool = False,
                  ring: bool = False, use_kernel: bool = True) -> tuple:
    """Returns (x_out, aux_loss)."""
    use_rope = cfg.positional == "rope"
    if kind == "mlstm":
        y, _ = xlstm_mod.mlstm_apply(cfg, params, x)
        return x + y, _zero(x)
    if kind == "slstm":
        y, _ = xlstm_mod.slstm_apply(cfg, params, x)
        return x + y, _zero(x)

    window = cfg.sliding_window if kind in ("local", "hybrid") else 0
    h = apply_norm(cfg.norm_kind, params["norm1"], x, impl=cfg.norm_impl)
    a = attn.attention(cfg, params["attn"], h, causal=causal, window=window,
                       use_rope=use_rope, k_chunk=k_chunk,
                       local_block=local_block, ring=ring,
                       use_kernel=use_kernel)
    if kind == "hybrid":
        a, _ = _fuse_ssm(cfg, params, h, a, x.dtype, ssm_mod.ssm_apply)
    x = x + a
    del h, a          # dead: no local holds them through the FFN
    if memory is not None and "cross" in params:
        hx = apply_norm(cfg.norm_kind, params["norm_x"], x, impl=cfg.norm_impl)
        cx = attn.attention(cfg, params["cross"], hx, causal=False,
                            use_rope=False, kv_src=memory, k_chunk=k_chunk,
                            use_kernel=use_kernel)
        x = x + cx
        del hx, cx
    x, aux = _ffn(cfg, kind, params, x)
    return x, _zero(x) if aux is None else aux


def block_prefill(cfg: ArchConfig, kind: str, params: dict, x: torch.Tensor, *,
                  max_seq: int, cache_dtype=torch.bfloat16,
                  memory: Optional[torch.Tensor] = None,
                  k_chunk: int = 1024, use_kernel: bool = True) -> tuple:
    """Forward pass that also builds this block's decode cache."""
    s = x.shape[1]
    use_rope = cfg.positional == "rope"

    def pad_seq(a):
        out = a.new_zeros((a.shape[0], max_seq) + a.shape[2:],
                          dtype=cache_dtype)
        out[:, :s] = a
        return out

    if kind == "mlstm":
        y, (C, n, m) = xlstm_mod.mlstm_apply(cfg, params, x)
        return x + y, {"C": C, "n": n, "m": m}
    if kind == "slstm":
        y, (c, n, m, hh) = xlstm_mod.slstm_apply(cfg, params, x)
        return x + y, {"c": c, "n": n, "m": m, "h": hh}

    window = cfg.sliding_window if kind in ("local", "hybrid") else 0
    h = apply_norm(cfg.norm_kind, params["norm1"], x, impl=cfg.norm_impl)
    a, (k, v) = attn.attention(cfg, params["attn"], h, causal=True,
                               window=window, use_rope=use_rope,
                               k_chunk=k_chunk, return_kv=True,
                               use_kernel=use_kernel)
    cache = {"k": pad_seq(k), "v": pad_seq(v)}
    del k, v
    if kind == "hybrid":
        a, cache["h_ssm"] = _fuse_ssm(cfg, params, h, a, x.dtype,
                                      ssm_mod.ssm_apply)
    x = x + a
    del h, a          # dead: no local holds them through the FFN
    if memory is not None and "cross" in params:
        hx = apply_norm(cfg.norm_kind, params["norm_x"], x, impl=cfg.norm_impl)
        cx, (xk, xv) = attn.attention(cfg, params["cross"], hx, causal=False,
                                      use_rope=False, kv_src=memory,
                                      k_chunk=k_chunk, return_kv=True,
                                      use_kernel=use_kernel)
        x = x + cx
        del hx, cx
        cache["xk"] = xk.to(cache_dtype)
        cache["xv"] = xv.to(cache_dtype)
    x, _ = _ffn(cfg, kind, params, x)
    return x, cache


def block_decode(cfg: ArchConfig, kind: str, params: dict, x: torch.Tensor,
                 cache: dict, cache_index, start=None,
                 stream_kv: bool = False) -> tuple:
    """One token through one block: (x_out, the block's new cache).  The
    KV tensors of ``cache`` are written in place and come back as they
    are; recurrent state comes back as new tensors.  Leaves may be held
    as ``dist.sharding.Block``s: the KV leaves go to the attention as they
    are (a block of the sequence is decoded there), the others are read
    as this rank's tensors."""
    use_rope = cfg.positional == "rope"
    cache = {k: v if k in ("k", "v") else local(v) for k, v in cache.items()}
    if kind == "mlstm":
        st = (cache["C"], cache["n"], cache["m"])
        y, (C, n, m) = xlstm_mod.mlstm_decode_step(cfg, params, x, st)
        return x + y, {"C": C, "n": n, "m": m}
    if kind == "slstm":
        st = (cache["c"], cache["n"], cache["m"], cache["h"])
        y, (c, n, m, hh) = xlstm_mod.slstm_decode_step(cfg, params, x, st)
        return x + y, {"c": c, "n": n, "m": m, "h": hh}

    window = cfg.sliding_window if kind in ("local", "hybrid") else 0
    h = apply_norm(cfg.norm_kind, params["norm1"], x, impl=cfg.norm_impl)
    kv_cache = {"k": cache["k"], "v": cache["v"]}
    a, kv_cache = attn.attention_decode_step(
        cfg, params["attn"], h, kv_cache, cache_index,
        window=window, use_rope=use_rope, start=start, stream_kv=stream_kv)
    new_cache = dict(cache)
    new_cache.update(kv_cache)
    if kind == "hybrid":
        a, new_cache["h_ssm"] = _fuse_ssm(
            cfg, params, h, a, x.dtype,
            lambda p, u, axes: ssm_mod.ssm_decode_step(p, u, cache["h_ssm"],
                                                       axes))
    x = x + a
    if "xk" in cache and "cross" in params:
        hx = apply_norm(cfg.norm_kind, params["norm_x"], x, impl=cfg.norm_impl)
        xc = {"k": cache["xk"], "v": cache["xv"]}
        enc_len = cache["xk"].shape[1]
        cx, _ = attn.attention_decode_step(
            cfg, params["cross"], hx, xc, enc_len - 1,
            use_rope=False, update_cache=False)
        x = x + cx
    x, _ = _ffn(cfg, kind, params, x)
    return x, new_cache


# ---------------------------------------------------------------------------
# Stack assembly
# ---------------------------------------------------------------------------

def _segments(cfg: ArchConfig, n_layers: int) -> tuple[int, tuple[str, ...]]:
    """(full_periods, tail_kinds)."""
    period = len(cfg.layer_pattern)
    full = n_layers // period
    tail = tuple(cfg.layer_pattern[i % period] for i in range(full * period, n_layers))
    return full, tail


def stack_spec(cfg: ArchConfig, n_layers: int, cross: bool = False) -> dict:
    full, tail = _segments(cfg, n_layers)
    spec: dict[str, Any] = {}
    if full:
        spec["scan"] = {
            f"p{i}": stack_tree(block_spec(cfg, kind, cross), full)
            for i, kind in enumerate(cfg.layer_pattern)
        }
    spec["tail"] = {f"t{i}": block_spec(cfg, kind, cross)
                    for i, kind in enumerate(tail)}
    return spec


def stack_cache_spec(cfg: ArchConfig, n_layers: int, batch: int, max_seq: int,
                     cache_dtype=torch.bfloat16, cross_len: int = 0) -> dict:
    full, tail = _segments(cfg, n_layers)
    spec: dict[str, Any] = {}
    if full:
        spec["scan"] = {
            f"p{i}": stack_tree(
                block_cache_spec(cfg, kind, batch, max_seq, cache_dtype, cross_len),
                full)
            for i, kind in enumerate(cfg.layer_pattern)
        }
    spec["tail"] = {
        f"t{i}": block_cache_spec(cfg, kind, batch, max_seq, cache_dtype, cross_len)
        for i, kind in enumerate(tail)}
    return spec


def _periods(scan_params: Optional[dict]) -> int:
    """Number of stacked periods (the leading axis of every scan leaf)."""
    if not scan_params:
        return 0
    first = next(iter(scan_params.values()))
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return first.shape[0]


def _period(tree: dict, li: int) -> dict:
    """Period ``li`` of stacked leaves: views, no copy."""
    return tree_map(lambda a: a[li], tree)


def _tail_kind(cfg: ArchConfig, tail_idx: int) -> str:
    period = len(cfg.layer_pattern)
    return cfg.layer_pattern[tail_idx % period]


def _checkpointed(body, remat_policy: str):
    """``body`` recomputed in the backward pass (``remat``); the "dots"
    policy keeps the matrix products' outputs, as the reference's
    ``dots_saveable``."""
    context_fn = checkpoint.noop_context_fn
    if remat_policy == "dots":
        ops = torch.ops.aten
        saved = {ops.mm.default, ops.bmm.default, ops.addmm.default}

        def policy(ctx, op, *args, **kwargs):
            return (checkpoint.CheckpointPolicy.MUST_SAVE if op in saved
                    else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, policy)

    def run(x, period_params):
        return checkpoint.checkpoint(bind_frame(body), x, period_params,
                                     use_reentrant=False,
                                     context_fn=context_fn)
    return run


def stack_forward(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
                  causal: bool = True, memory: Optional[torch.Tensor] = None,
                  remat: bool = True, k_chunk: int = 1024,
                  local_block: bool = False, ring: bool = False,
                  remat_policy: str = "full",
                  use_kernel: bool = True) -> tuple:
    scan_params = params.get("scan")
    aux_total = _zero(x)
    kw = {"causal": causal, "memory": memory, "k_chunk": k_chunk,
          "local_block": local_block, "ring": ring, "use_kernel": use_kernel}

    def period_body(x, period_params):
        aux_p = _zero(x)
        period_params = _in_region(cfg, period_params)
        for i, kind in enumerate(cfg.layer_pattern):
            if f"p{i}" not in period_params:
                continue
            x, aux = block_forward(cfg, kind,
                                   _held(period_params[f"p{i}"]), x,
                                   **kw)
            aux_p = aux_p + aux
        return x, aux_p

    body = period_body
    if remat and torch.is_grad_enabled():
        body = _checkpointed(period_body, remat_policy)
    auxes = []
    for li in range(_periods(scan_params)):
        x, aux_p = body(x, _period(scan_params, li))
        auxes.append(aux_p)
    if auxes:
        aux_total = aux_total + torch.stack(auxes).sum()
    # tail layers continue the pattern: layer full*period + i has pattern
    # position i (full*period % period == 0)
    for i, (key, p) in enumerate(sorted(params.get("tail", {}).items())):
        x, aux = block_forward(cfg, _tail_kind(cfg, i), _held(p), x,
                               **kw)
        aux_total = aux_total + aux
    return x, aux_total


def stack_prefill(cfg: ArchConfig, params: dict, x: torch.Tensor, *,
                  max_seq: int, cache_dtype=torch.bfloat16,
                  memory: Optional[torch.Tensor] = None,
                  k_chunk: int = 1024, use_kernel: bool = True) -> tuple:
    scan_params = params.get("scan")
    cache: dict[str, Any] = {"tail": {}}
    kw = {"max_seq": max_seq, "cache_dtype": cache_dtype, "memory": memory,
          "k_chunk": k_chunk, "use_kernel": use_kernel}

    periods = []
    for li in range(_periods(scan_params)):
        period_params = _period(scan_params, li)
        period_cache = {}
        for i, kind in enumerate(cfg.layer_pattern):
            key = f"p{i}"
            if key not in period_params:
                continue
            x, period_cache[key] = block_prefill(
                cfg, kind, _held(period_params[key]), x, **kw)
        periods.append(period_cache)
    if periods:
        cache["scan"] = tree_map(lambda *leaves: torch.stack(leaves),
                                 *periods)
    for i, (key, p) in enumerate(sorted(params.get("tail", {}).items())):
        x, cache["tail"][key] = block_prefill(cfg, _tail_kind(cfg, i),
                                              _held(p), x, **kw)
    return x, cache


def _write_back(layer_cache: dict, new: dict) -> None:
    """Each leaf of a block's new cache into the cache it was given, in
    place; leaves that are those tensors already (the KV caches, written by
    ``attention_decode_step``) are skipped."""
    for name, value in new.items():
        held = layer_cache[name]
        if value is not held and value is not local(held):
            local(held).copy_(value)


def stack_decode(cfg: ArchConfig, params: dict, x: torch.Tensor, cache: dict,
                 cache_index, start=None, stream_kv: bool = False) -> tuple:
    """Decode one token through the layer stack, updating ``cache`` in
    place; returns (x, cache) with the same cache tree it was given.  Per
    step each layer writes one token slice of its KV cache and its
    recurrent state, as the reference's aliased scan carry does."""
    scan_params = params.get("scan")
    kw = {"start": start, "stream_kv": stream_kv}
    for li in range(_periods(scan_params)):
        period_params = _period(scan_params, li)
        for i, kind in enumerate(cfg.layer_pattern):
            key = f"p{i}"
            if key not in period_params:
                continue
            layer_cache = _period(cache["scan"][key], li)
            x, c_new = block_decode(cfg, kind,
                                    _held(period_params[key]), x,
                                    layer_cache, cache_index, **kw)
            _write_back(layer_cache, c_new)
    for i, (key, p) in enumerate(sorted(params.get("tail", {}).items())):
        layer_cache = cache["tail"][key]
        x, c_new = block_decode(cfg, _tail_kind(cfg, i), _held(p), x,
                                layer_cache, cache_index, **kw)
        _write_back(layer_cache, c_new)
    return x, cache
