"""Core layer primitives: norms, embeddings, MLPs, rotary embeddings — the
port of the JAX package's ``models/layers.py``.

All layers are (spec-builder, apply-fn) pairs over ParamSpec trees; compute
is carried out in ``cfg.compute_dtype`` (bf16 by default) with fp32 master
parameters.  ``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s
default is (plain ``F.gelu`` is the erf form, another function).

Under an active mesh whose rules split the ``mlp`` or ``vocab`` dimension
(``dist.sharding.split_axes``) the MLP, the embedding and the unembedding
compute on this rank's block, as the reference's SPMD program does: the
MLP's up products column-parallel and its down product row-parallel with
the partial sums added over the axes; the embedding looks up the tokens in
this rank's vocabulary rows, zeroes the others and sums over the axes; the
unembedding returns this rank's vocabulary block of the logits.  Params may
be blocks (``dist.sharding.Block``); ``take`` gives the block a layer uses.

:func:`scan_step` is the counterpart of the reference's ``jax.checkpoint``
on a ``lax.scan`` body: the layers' sequential loops (attention's KV
chunks, the SSM's and the mLSTM's chunks, the sLSTM's steps) run each step
through it.  Its recompute in the backward is marked (:func:`recomputing`):
a product there whose value no gradient reads (attention's p·v) is not
computed, as XLA drops it from the reference's recompute as dead code.

Where a layer stays whole on every rank of the active mesh (attention
heads or a vocabulary that do not divide its axes), its weights'
gradients are computed on this rank's block of d over those idle axes
and all-gathered (:func:`whole_matmul`), as the reference's partitioner
spends the idle axes on them.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.dist import collectives
from repro_torch.dist.sharding import (_axis_sizes, active_mesh, bind_frame,
                                       constrain, split_axes, take,
                                       whole_shape)
from repro_torch.models.module import ParamSpec


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_STATE = threading.local()


def recomputing() -> bool:
    """Whether this thread runs a step's recompute in :class:`_Remat`'s
    backward, where only the gradients of the step's outputs are read,
    never their values."""
    return getattr(_STATE, "recompute", False)


class _Remat(torch.autograd.Function):
    """One remat'ed step (:func:`scan_step`): the forward runs the step
    without recording and saves its tensor arguments with
    ``save_for_backward``; the backward runs the step again with a
    gradient, marked as a recompute (:func:`recomputing`), and
    differentiates it.  Saved through the saved-tensor
    hooks, the arguments are discarded by an enclosing checkpoint's
    forward (the transformer's period) and made again by its recompute,
    where ``torch.utils.checkpoint``'s non-reentrant form would hold a
    nested step's arguments for every layer of the forward."""

    @staticmethod
    def forward(ctx, fn, spec, out_spec, *flat):
        out, tree = pytree.tree_flatten(fn(*pytree.tree_unflatten(
            list(flat), spec)))
        out_spec.append(tree)
        ctx.fn, ctx.spec = fn, spec
        ctx.slots = [isinstance(a, torch.Tensor) for a in flat]
        ctx.flat = [None if slot else a for a, slot in zip(flat, ctx.slots)]
        ctx.needs = [slot and a.requires_grad
                     for a, slot in zip(flat, ctx.slots)]
        ctx.save_for_backward(*(a for a in flat
                                if isinstance(a, torch.Tensor)))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        flat = [next(saved).detach().requires_grad_(need) if slot else a
                for a, slot, need in zip(ctx.flat, ctx.slots, ctx.needs)]
        was = recomputing()
        _STATE.recompute = True
        try:
            with torch.enable_grad():
                out = pytree.tree_leaves(ctx.fn(*pytree.tree_unflatten(
                    flat, ctx.spec)))
        finally:
            _STATE.recompute = was
        pairs = [(o, g) for o, g in zip(out, grads)
                 if g is not None and o.requires_grad]
        wanted = [a for a, need in zip(flat, ctx.needs) if need]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        return (None, None, None) + tuple(
            next(got, None) if need else None for need in ctx.needs)


def scan_step(fn):
    """``fn``, one step of a layer's sequential loop, as the reference's
    ``jax.checkpoint`` runs a scan body: under autograd only the step's
    arguments (the carry and the step's slices) are kept and the step is
    recomputed in the backward (:class:`_Remat`), under the mesh frame
    active now (``dist.sharding.bind_frame``); without a gradient ``fn``
    itself.  The values are ``fn``'s.  A step returns a tree of fresh
    tensors (a view would keep its base alive with the next step's
    arguments) and takes slices of what is alive anyway."""
    if not torch.is_grad_enabled():
        return fn
    bound = bind_frame(fn)

    def run(*args):
        flat, spec = pytree.tree_flatten(args)
        out_spec = []
        out = _Remat.apply(bound, spec, out_spec, *flat)
        return pytree.tree_unflatten(list(out), out_spec[0])
    return run


def idle_axes() -> tuple:
    """The active mesh's axes of more than one rank: those that a layer
    computed whole on every rank leaves idle; () with no mesh."""
    mesh = active_mesh()
    if mesh is None:
        return ()
    return tuple(n for n, size in _axis_sizes(mesh).items() if size > 1)


def whole_matmul(x: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.matmul(x, w)`` (``w`` 2-D, dimension ``dim`` of it d) of a
    layer that every rank computes whole: under autograd on a mesh whose
    idle axes divide d, w's gradient on this rank's block of d over them,
    all-gathered (``collectives.whole_product``)."""
    axes = idle_axes()
    if axes and torch.is_grad_enabled():
        _, blocks = collectives.block_index(active_mesh(), axes)
        if w.shape[dim] % blocks == 0:
            return collectives.whole_product(x, w, active_mesh(), axes, dim)
    return torch.matmul(x, w)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), torch.float32, ("embed",), init="ones")}


def layernorm_spec(d: int) -> dict:
    return {
        "scale": ParamSpec((d,), torch.float32, ("embed",), init="ones"),
        "bias": ParamSpec((d,), torch.float32, ("embed",), init="zeros"),
    }


# The bytes of fp32 a row-chunked loop (the norms, the MoE's combine)
# holds per buffer: no fp32 [rows, d] buffer larger than this is live,
# where the reference's XLA fuses the whole computation into one pass.
ROW_CHUNK_BYTES = 64 << 20


def row_chunks(rows: int, width: int) -> list:
    """[lo, hi) bounds of ``rows`` rows of ``width`` fp32 elements, each
    chunk at most :data:`ROW_CHUNK_BYTES` (one row at least); one empty
    chunk for no rows."""
    step = max(1, ROW_CHUNK_BYTES // (4 * width))
    return [(lo, min(lo + step, rows))
            for lo in range(0, max(rows, 1), step)]


def _norm_chunk(kind, impl, eps, xc, scale, bias) -> tuple:
    """One chunk of rows of the norm, in the reference's order of ops:
    (the result in x's type, the fp32 per-row mean (layernorm) or None,
    the fp32 per-row rstd)."""
    dtype = xc.dtype
    xf = xc.float()
    m = None
    if kind == "layernorm":
        m = xf.mean(dim=-1, keepdim=True)
        c = xf - m                        # (x - mu), as jnp.var takes it
        var = c.square().mean(dim=-1, keepdim=True)
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    if impl == "bf16_apply":
        # f32 statistics, application in x's type: the full-width tensors
        # never materialise in f32
        inv = r.to(dtype)
        if kind == "layernorm":
            y = (xc - m.to(dtype)).mul_(inv).mul_(scale.to(dtype))
            return y.add_(bias.to(dtype)), m, r
        return (xc * inv).mul_(scale.to(dtype)), m, r
    if kind == "layernorm":
        y = c.mul_(r).mul_(scale).add_(bias)
    else:
        y = (xf * r).mul_(scale)          # xf may be xc itself
    return y.to(dtype), m, r


def _norm_rows(kind, impl, eps, x, scale, bias) -> tuple:
    """(the norm of ``x`` in x's type, the fp32 per-row mean or None, the
    fp32 per-row rstd [rows, 1]), chunk by chunk of rows; one chunk's
    result as it comes, several written into one result."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    chunks = row_chunks(x2.shape[0], d)
    if len(chunks) == 1:
        y, mu, rstd = _norm_chunk(kind, impl, eps, x2, scale, bias)
        return y.view(x.shape), mu, rstd
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    stat = (x2.shape[0], 1)
    rstd = torch.empty(stat, dtype=torch.float32, device=x.device)
    mu = (torch.empty(stat, dtype=torch.float32, device=x.device)
          if kind == "layernorm" else None)
    for lo, hi in chunks:
        y, m, r = _norm_chunk(kind, impl, eps, x2[lo:hi], scale, bias)
        out[lo:hi], rstd[lo:hi] = y, r
        if mu is not None:
            mu[lo:hi] = m
    return out.view(x.shape), mu, rstd


def _norm_grads(kind, xc, dyc, scale, mu, r, want) -> tuple:
    """One chunk's (dx in fp32 or None, its dscale and dbias terms or
    None): x̂ recomputed from x, the mean and rstd."""
    want_x, want_scale, want_bias = want
    xhat = xc.float()
    if kind == "layernorm":
        xhat = xhat - mu
    xhat = xhat * r
    g = dyc.to(torch.float32, copy=True)
    dscale = (g * xhat).sum(dim=0) if want_scale else None
    dbias = g.sum(dim=0) if want_bias else None
    if not want_x:
        return None, dscale, dbias
    g = g.mul_(scale)                                   # dL/dx̂
    corr = (g * xhat).mean(dim=-1, keepdim=True)
    if kind == "layernorm":
        g = g.sub_(g.mean(dim=-1, keepdim=True))
    return g.sub_(xhat.mul_(corr)).mul_(r), dscale, dbias


class _Norm(torch.autograd.Function):
    """RMSNorm or LayerNorm (both ``impl``s) as one node: the forward
    writes the result chunk by chunk of rows (:func:`_norm_rows`) and
    saves x as given (alive anyway as the residual) with the fp32 per-row
    mean (layernorm) and rstd; the backward recomputes x̂ chunk by chunk
    and sums the scale's and bias's gradients in fp32.  No fp32 buffer of
    the rows' full size is made either way."""

    @staticmethod
    def forward(ctx, kind, impl, eps, x, scale, bias):
        out, mu, rstd = _norm_rows(kind, impl, eps, x, scale, bias)
        ctx.kind = kind
        ctx.save_for_backward(x, scale, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, mu, rstd = ctx.saved_tensors
        d = x.shape[-1]
        x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
        want = ctx.needs_input_grad[3:]
        chunks = row_chunks(x2.shape[0], d)
        dx = (torch.empty(x2.shape, dtype=x.dtype, device=x.device)
              if want[0] and len(chunks) > 1 else None)
        dscale = dbias = None
        for lo, hi in chunks:
            dxc, ds, db = _norm_grads(
                ctx.kind, x2[lo:hi], dy2[lo:hi], scale,
                None if mu is None else mu[lo:hi], rstd[lo:hi], want)
            dscale = ds if dscale is None else dscale.add_(ds)
            dbias = db if dbias is None else dbias.add_(db)
            if dx is not None:
                dx[lo:hi] = dxc
            elif dxc is not None:
                dx = dxc.to(x.dtype)
        return (None, None, None, None if dx is None else dx.view(x.shape),
                None if dscale is None else dscale.to(scale.dtype),
                None if dbias is None else dbias.to(scale.dtype))


def _norm(kind, params, x, eps, impl) -> torch.Tensor:
    scale, bias = params["scale"], params.get("bias")
    parts = (x, scale) if bias is None else (x, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in parts):
        return _Norm.apply(kind, impl, eps, x, scale, bias)
    return _norm_rows(kind, impl, eps, x, scale, bias)[0]


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6,
            impl: str = "f32") -> torch.Tensor:
    """The reference's RMSNorm (``impl`` "f32": normalised and scaled in
    fp32; "bf16_apply": fp32 statistics applied in x's type), as one
    autograd node over chunks of rows (:class:`_Norm`)."""
    return _norm("rmsnorm", params, x, eps, impl)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5,
              impl: str = "f32") -> torch.Tensor:
    """The reference's LayerNorm (population variance, as ``jnp.var``),
    as :func:`rmsnorm` runs it."""
    return _norm("layernorm", params, x, eps, impl)


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


def vocab_axes(b: int, s: int, vocab: int) -> tuple:
    """The mesh axes the active rules split the vocabulary of [b, s]
    logits over; () where it stays whole."""
    return split_axes(("batch", "seq", "vocab"), (b, s, vocab), 2)


def embed(params: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # gather, then cast: the reference casts the whole table first, which
    # gives the same numbers
    table = params["table"]
    axes = vocab_axes(*tokens.shape, whole_shape(table)[0])
    if not axes:
        out = take(table)[tokens.long()].to(compute_dtype)
        return constrain(out, "batch", "seq", "embed")
    mesh = active_mesh()
    rows = take(table, 0, axes)
    index, _ = collectives.block_index(mesh, axes)
    local = tokens.long() - index * rows.shape[0]
    mine = (local >= 0) & (local < rows.shape[0])
    # one rank holds each token's row, the others add exact zeros
    part = torch.where(mine[..., None], rows[torch.where(mine, local, 0)], 0)
    out = collectives.reduce_from(part, mesh, axes).to(compute_dtype)
    return constrain(out, "batch", "seq", "embed")


def _fp32_rows_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x.float(), w)`` (w fp32 [d, v]) outside autograd,
    chunk by chunk of x's rows (:func:`row_chunks`) into one fp32 result:
    no fp32 copy of all of x, where XLA fuses the reference's convert into
    its dot."""
    x2 = x.reshape(-1, x.shape[-1])
    out = torch.empty((x2.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for lo, hi in row_chunks(*x2.shape):
        torch.matmul(x2[lo:hi].float(), w, out=out[lo:hi])
    return out.view(*x.shape[:-1], w.shape[1])


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss stability); table shared with embed when tied.
    Under a split vocabulary, this rank's block of them.  Where no
    gradient is taken x is converted to fp32 a chunk of rows at a time."""
    table = params["table"]
    axes = vocab_axes(*x.shape[:-1], whole_shape(table)[0])
    w = take(table, 0, axes).float().t()
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return constrain(_fp32_rows_product(x, w), "batch", "seq", "vocab")
    if not axes:
        logits = whole_matmul(x.float(), w, 0)
        return constrain(logits, "batch", "seq", "vocab")
    x32 = collectives.copy_to(x.float(), active_mesh(), axes)
    return constrain(torch.matmul(x32, w), "batch", "seq", "vocab")


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
    d_ff = whole_shape(params["w_up"])[1]
    axes = split_axes(("batch", "seq", "mlp"), (*x.shape[:-1], d_ff),
                      x.ndim - 1)
    mesh = active_mesh()
    if axes:
        x = collectives.copy_to(x, mesh, axes)
    if kind in ("swiglu", "geglu"):
        g = torch.matmul(x, take(params["w_gate"], 1, axes).to(dtype))
        u = torch.matmul(x, take(params["w_up"], 1, axes).to(dtype))
        h = (F.silu(g) if kind == "swiglu" else gelu(g)) * u
    else:
        h = torch.matmul(x, take(params["w_up"], 1, axes).to(dtype))
        if kind == "squared_relu":
            h = torch.relu(h).square()
        elif kind == "gelu":
            h = gelu(h)
        else:
            raise ValueError(f"unknown mlp kind {kind}")
    h = constrain(h, "batch", "seq", "mlp")
    out = torch.matmul(h, take(params["w_down"], 0, axes).to(dtype))
    if axes:
        out = collectives.reduce_from(out, mesh, axes)
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
