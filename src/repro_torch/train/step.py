"""Training step factory: loss, grads, optimizer, metrics — the port of
``repro.train.step``.

``make_train_step`` builds the step function: gradient-accumulation
microbatching, optional int8 error-feedback gradient compression, and a
z-loss regulariser on the logits.  The reference's JAX constructs map so:

- ``jax.value_and_grad`` — autograd over leaf tensors that share the
  params' storage (``torch.autograd.grad``);
- ``lax.scan`` over microbatches — a loop summing fp32 grads;
- ``jax.checkpoint`` of each chunked-CE segment — an autograd Function
  (``_CESegment``) that saves the segment's inputs and logsumexp and
  recomputes its logits in the backward into one fp32 buffer, turned in
  place into their cotangent, so one segment's [B, chunk, V] fp32 buffer
  lives at a time, in the backward as in the forward (autograd's
  ``logsumexp`` and ``gather`` backward kept five).

The model's ``remat`` wraps each layer period in ``torch.utils.checkpoint``,
and on the card every attention layer runs the hand flash-attention
kernels: the lse-writing forward (again in the recompute of a checkpointed
period) and the dq and dk/dv backward kernels.  ``use_kernel=False`` (a
keyword the reference lacks; its default is the reference's path) takes
the plain ``attend_chunked`` instead.

The step updates ``params`` and the optimizer state in place (the
counterpart of the reference launcher's donation, ``optim.adamw``) and
returns them with the metrics as 0-dim tensors.

**Data parallelism.**  Under an active mesh whose rules put ``batch`` on
mesh axes (the launcher's ``--data-parallel``: a 1-D ``("data",)`` mesh
with ``train_rules()``), each gradient evaluation is an SPMD region, the
counterpart of what the reference's SPMD partitioner does with the batch
sharded over ``data``.  Every rank holds the whole batch and takes its
block (``dist.batch_shardings``); it computes its loss and gradients on it
with the rest of the mesh active (no frame when nothing is left); and the
gradients, loss and metrics are summed over the batch axes, each rank's
weighted by its share of the global batch's counted tokens.  The loss is
``sum / mask.sum()`` over the *global* batch, so a plain mean of the
ranks' means would be wrong whenever the masks differ.  The region is
made known to the layers (``dist.sharding.data_region``): the MoE's global
dispatch routes and takes its aux loss over the whole batch there, as the
reference does, so the aux loss is the same on every rank; its gradient
reaches each rank's share of the batch divided by the rank's weight (the
share, or 1 for a rank with no counted token), so the weighted sum gives
the whole gradient.

**Tensor parallelism.**  Under a mesh whose rules split the heads, the
MLP or the vocabulary over ``model`` (``dist.sharding`` module
docstring), the forward computes on this rank's blocks, and the
cross-entropy reads this rank's vocabulary block of the logits: a max
all-reduced outside autograd, the sums of exponentials and the gold logit
psum'd, so the loss is the same on every rank, and the z-loss is taken
from the whole logsumexp.  The fp32 logits stay, as in the reference.
Where the vocabulary stays whole on every rank, the table's gradient is
computed on this rank's block of d and all-gathered
(``models.layers.whole_matmul``).

**Blocked state.**  Params and AdamW's moments may be held as blocks
(``dist.sharding.Block``), and the batch too (the launcher under
``--data-parallel``, the dry-run).  Each layer gathers its params where it
uses them (``models``), so a rank's gradients are the blocks of the whole
gradients it computed, and the step returns the blocked tree it was
given.  A blocked batch is the rank's block already; the global batch's
token count is then the sum of the ranks' counts.  A leaf whose spec
splits it over a batch axis (``train_rules(fsdp=True)``) is gathered
over that axis where the loss uses it, and its gradient weighted, summed
over the batch axes and blocked again in the backward
(``dist.sharding.region_period``): a stacked layer period's leaves one
period at a time inside the period's checkpoint, the others as the loss
begins.  Every other leaf's gradient is weighted and summed after the
region.  Either way each rank sums whole gradients over the batch axes,
as the global view does.  Microbatching
gathers a blocked batch whole first: its microbatches are the global
batch's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives, compat
from repro_torch.dist.sharding import (Block, active_mesh, active_rules,
                                       bind_frame, data_region, gather_tree,
                                       local, local_batch, region_params,
                                       split_over, use_mesh)
from repro_torch.models.layers import whole_matmul
from repro_torch.models.module import leaves, tree_map
from repro_torch.models.registry import Model
from repro_torch.optim import compression as comp_mod
from repro_torch.optim.adamw import AdamW, AdamWState

IGNORE_LABEL = -100


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor,
              axes: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, the label's logit) of fp32 logits [..., V] at labels
    [...] (each a valid index).  With ``axes`` the logits are this rank's
    vocabulary block over the active mesh's ``axes``: the max is
    all-reduced (no gradient), the exponentials' sums and the owning
    rank's gold logit are psum'd together (``collectives.reduce_from``),
    so every rank gets the whole values; only the summation order departs
    from the whole logits'."""
    if not axes:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    mesh = active_mesh()
    index, _ = collectives.block_index(mesh, axes)
    v = logits.shape[-1]
    m = collectives.pmax(logits.amax(dim=-1), mesh, axes)
    local = labels - index * v
    mine = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    sums = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                        torch.where(mine, gold[..., 0], 0.0)])
    sums = collectives.reduce_from(sums, mesh, axes)
    return torch.log(sums[0]) + m, sums[1]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4, vocab_axes: tuple = ()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions (+ z-loss). logits fp32 [B,S,V],
    or this rank's vocabulary block over ``vocab_axes``."""
    mask = labels != IGNORE_LABEL
    safe_labels = torch.where(mask, labels, 0).long()
    lse, gold = _lse_gold(logits, safe_labels, vocab_axes)
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return (nll.sum() + zl.sum()) / denom, nll.sum() / denom


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    aux_loss_weight: float = 0.01      # MoE load-balance
    z_loss: float = 1e-4
    remat: bool = True
    k_chunk: int = 1024                # flash-attention KV chunk
    local_block: bool = False          # banded sliding-window attention
    remat_policy: str = "full"         # full | dots (save dot outputs)
    ring: bool = False                 # explicit ring attention (with sp)
    ce_seq_chunk: int = 512            # chunked-CE segment (0 => full logits)
    grad_compression: bool = False


def _segment_logits(h, t32, axes=()):
    """One segment's fp32 logits (with ``axes`` this rank's vocabulary
    block): whole, the table's gradient on a block of d where the
    vocabulary stays whole (``layers.whole_matmul``); split, the hidden
    states' cotangent summed over ``axes`` (``copy_to``)."""
    h32 = h.to(torch.float32)
    if axes:
        h32 = collectives.copy_to(h32, active_mesh(), axes)
        return torch.einsum("bsd,vd->bsv", h32, t32)
    return whole_matmul(h32, t32.t(), 0)


class _CESegment(torch.autograd.Function):
    """One chunked-CE segment: (nll sum, z sum, count) of hidden states h
    [B, chunk, d] against the table t32 [V, d] fp32 (or this rank's
    vocabulary rows over ``axes``, :func:`_lse_gold` reducing over them),
    the counterpart of the reference's ``jax.checkpoint`` of the segment.

    The forward keeps no logits: it saves h, the table, the logsumexp,
    the safe labels and the mask.  The backward recomputes the logits
    under autograd (:func:`_segment_logits`, in the frame of the forward)
    into one fp32 buffer and turns it in place into their cotangent,
    exp(logits - lse) * mask * (g_nll + 2 lse g_z), minus mask * g_nll at
    the gold column on the rank whose block holds it; the product's
    backward then gives dh = p·t and dt = pᵀ·h.  The products are those of
    a checkpointed autograd segment (the forward, one recompute, dh and
    dt), but one [B, chunk, V] fp32 buffer is live where autograd's
    ``logsumexp`` and ``gather`` backward kept five."""

    @staticmethod
    def forward(ctx, h, lab, t32, axes):
        logits = _segment_logits(h, t32, axes)
        mask = lab != IGNORE_LABEL
        safe = torch.where(mask, lab, 0).long()
        lse, gold = _lse_gold(logits, safe, axes)
        del logits
        ctx.save_for_backward(h, t32, lse, safe, mask)
        ctx.axes, ctx.mesh = axes, active_mesh()
        ctx.logits = bind_frame(_segment_logits)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - gold) * mask).sum(), (torch.square(lse) * mask).sum(), \
            count

    @staticmethod
    def backward(ctx, g_nll, g_z, _):
        h, t32, lse, safe, mask = ctx.saved_tensors
        inputs = [h.detach().requires_grad_(ctx.needs_input_grad[0]),
                  t32.detach().requires_grad_(ctx.needs_input_grad[2])]
        with torch.enable_grad():
            logits = ctx.logits(*inputs, ctx.axes)
        p = logits.detach()                 # the buffer, made the cotangent
        p.sub_(lse[..., None]).exp_()
        p.mul_((mask * (g_nll + 2.0 * lse * g_z))[..., None])
        col, gold = safe, -(mask * g_nll)
        if ctx.axes:
            index, _ = collectives.block_index(ctx.mesh, ctx.axes)
            v = p.shape[-1]
            col = safe - index * v
            mine = (col >= 0) & (col < v)
            col, gold = torch.where(mine, col, 0), torch.where(mine, gold, 0.0)
        p.scatter_add_(-1, col[..., None], gold[..., None].to(p.dtype))
        wanted = [x for x in inputs if x.requires_grad]
        got = iter(torch.autograd.grad(logits, wanted, p) if wanted else ())
        dh, dt = (next(got) if x.requires_grad else None for x in inputs)
        return dh, None, dt, None


def _ce_segment(h, lab, t32, axes=()):
    """One chunked-CE segment's (nll sum, z sum, count)
    (:class:`_CESegment`)."""
    return _CESegment.apply(h, lab, t32, axes)


def chunked_cross_entropy(hidden: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int,
                          z_loss: float = 1e-4, vocab_axes: tuple = ()
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """CE over [B,S,d] hidden states without materialising [B,S,V] logits.

    Loops over sequence segments; each computes its logits, LSE and gold
    logit and recomputes its logits in the backward pass
    (:class:`_CESegment`, one fp32 buffer turned into their cotangent in
    place), so peak logits memory is one O(B * chunk * V) buffer instead
    of O(B * S * V).  With ``vocab_axes`` ``table`` is this rank's
    vocabulary rows (``Model.unembed_table``) and each segment's logits
    its block, whose logsumexp and gold logit are reduced over the axes
    (:func:`_lse_gold`)."""
    b, s, d = hidden.shape
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE_LABEL)
    t32 = table.to(torch.float32)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zl = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c in range(n_chunks):
        h = hidden[:, c * chunk:(c + 1) * chunk]
        lab = labels[:, c * chunk:(c + 1) * chunk]
        seg = _ce_segment(h, lab, t32, vocab_axes)
        nll, zl, count = nll + seg[0], zl + seg[1], count + seg[2]
    denom = torch.clamp(count, min=1).to(torch.float32)
    return (nll + z_loss * zl) / denom, nll / denom


def _pad_vision_labels(model: Model, batch: dict) -> torch.Tensor:
    labels = batch["labels"]
    cfg = model.cfg
    if cfg.frontend == "patch" and "patches" in batch:
        n_vis = batch["patches"].shape[1]
        pad = torch.full((labels.shape[0], n_vis), IGNORE_LABEL,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return labels


def make_loss_fn(model: Model, cfg: TrainStepConfig, *,
                 use_kernel: bool = True):
    def loss_fn(params, batch):
        params = region_params(params)
        labels = _pad_vision_labels(model, batch)
        if cfg.ce_seq_chunk:
            hidden, aux = model.forward(params, batch, remat=cfg.remat,
                                        k_chunk=cfg.k_chunk,
                                        local_block=cfg.local_block,
                                        ring=cfg.ring,
                                        remat_policy=cfg.remat_policy,
                                        return_hidden=True,
                                        use_kernel=use_kernel)
            axes = model.vocab_axes(*labels.shape)
            loss, ce = chunked_cross_entropy(
                hidden, model.unembed_table(params, axes), labels,
                chunk=cfg.ce_seq_chunk, z_loss=cfg.z_loss, vocab_axes=axes)
        else:
            logits, aux = model.forward(params, batch, remat=cfg.remat,
                                        k_chunk=cfg.k_chunk,
                                        local_block=cfg.local_block,
                                        use_kernel=use_kernel)
            loss, ce = cross_entropy(logits, labels, cfg.z_loss,
                                     model.vocab_axes(*labels.shape))
        total = loss + cfg.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux}
    return loss_fn


def _value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, aux metrics),
    grads) with the grads a tree of ``params``' layout and types (zeros for
    a leaf the loss does not reach), the metrics detached."""
    def leaf(p):
        if isinstance(p, Block):
            return p.with_local(p.local.detach().requires_grad_())
        return p.detach().requires_grad_()

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(leaf, params)
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, [local(p) for p in leaves(live)],
                                        allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_map(lambda _: next(it), live))
    return grad_fn


def _data_parallel(grad_fn, model: Model):
    """``grad_fn`` as the data-parallel region under an active mesh that
    shards the batch (module docstring); ``grad_fn`` itself otherwise."""
    def run(params, batch):
        mesh, rules = active_mesh(), active_rules()
        if mesh is None or rules is None:
            return grad_fn(params, batch)
        part, axes = local_batch(batch, mesh, rules)
        if not axes:
            return grad_fn(params, batch)
        rest = compat.submesh(mesh, [n for n in mesh.mesh_dim_names
                                     if n not in axes])
        count = (_pad_vision_labels(model, part) != IGNORE_LABEL).sum()
        total = count.clone()
        collectives.reduce_sum_([total], mesh, axes)
        share = count.float() / torch.clamp(total, min=1).float()
        # the gradients' factor: the share, or 1 where it is 0 (no counted
        # token: the CE's gradient is 0 there, and the terms the region's
        # layers take over the whole batch keep their part)
        weight = torch.where(share > 0, share, torch.ones_like(share))
        with data_region(mesh, axes, weight), \
                use_mesh(rest, rules if rest is not None else None):
            (loss, metrics), grads = grad_fn(params, part)
        out = [loss * share] + [v * share for v in metrics.values()]
        # a leaf held split over a batch axis had its gradient summed where
        # it was used (dist.sharding.region_period)
        grad_leaves = [g for g, p in zip(leaves(grads), leaves(params))
                       if not split_over(p, axes)]
        for g in grad_leaves:
            g.mul_(weight.to(g.dtype))
        collectives.reduce_sum_(out + grad_leaves, mesh, axes)
        return (out[0], dict(zip(metrics, out[1:]))), grads
    return run


def make_train_step(model: Model, optimizer: AdamW,
                    cfg: TrainStepConfig = TrainStepConfig(), *,
                    use_kernel: bool = True):
    grad_fn = _data_parallel(
        _value_and_grad(make_loss_fn(model, cfg, use_kernel=use_kernel)),
        model)

    def train_step(params, opt_state: AdamWState, batch: dict,
                   comp_state=None):
        if cfg.microbatches > 1:
            batch = gather_tree(batch)

            def micro(i):
                return {k: v.reshape((cfg.microbatches, -1) + v.shape[1:])[i]
                        for k, v in batch.items()}
            grads, msum = None, None
            for i in range(cfg.microbatches):
                (l, m), g = grad_fn(params, micro(i))
                step_m = {"loss": l, "ce": m["ce"], "aux": m["aux"]}
                if grads is None:
                    grads = tree_map(lambda x: x.to(torch.float32), g)
                    msum = step_m
                else:
                    grads = tree_map(torch.add, grads, g)
                    msum = {k: msum[k] + v for k, v in step_m.items()}
            inv = 1.0 / cfg.microbatches
            grads = tree_map(lambda g: g * inv, grads)
            metrics = {k: v * inv for k, v in msum.items()}
            loss = metrics.pop("loss")
        else:
            (loss, metrics), grads = grad_fn(params, batch)

        if cfg.grad_compression and comp_state is not None:
            grads, comp_state = comp_mod.compress_grads(grads, comp_state)

        new_params, new_opt_state, gnorm = optimizer.update(grads, opt_state,
                                                            params)
        out_metrics = {"loss": loss, "grad_norm": gnorm, **metrics}
        if cfg.grad_compression:
            return new_params, new_opt_state, comp_state, out_metrics
        return new_params, new_opt_state, out_metrics

    return train_step
