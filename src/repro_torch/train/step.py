"""Training step factory: loss, grads, optimizer, metrics — the port of
``repro.train.step``.

``make_train_step`` builds the step function: gradient-accumulation
microbatching, optional int8 error-feedback gradient compression, and a
z-loss regulariser on the logits.  The reference's JAX constructs map so:

- ``jax.value_and_grad`` — autograd over leaf tensors that share the
  params' storage (``torch.autograd.grad``);
- ``lax.scan`` over microbatches — a loop summing fp32 grads;
- ``jax.checkpoint`` of each chunked-CE segment —
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so only
  one segment's [B, chunk, V] fp32 logits live at a time, in the backward
  as in the forward.

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
ranks' means would be wrong whenever the masks differ.  The aux loss is
weighted alike (it is zero for a dense model).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

from repro_torch.dist import collectives, compat
from repro_torch.dist.sharding import (active_mesh, active_rules,
                                       batch_shardings, use_mesh)
from repro_torch.models.module import leaves, tree_map
from repro_torch.models.registry import Model
from repro_torch.optim import compression as comp_mod
from repro_torch.optim.adamw import AdamW, AdamWState

IGNORE_LABEL = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions (+ z-loss). logits fp32 [B,S,V]."""
    mask = labels != IGNORE_LABEL
    safe_labels = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
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


def _ce_segment(h, lab, t32):
    """One chunked-CE segment's (nll sum, z sum, count)."""
    logits = torch.einsum("bsd,vd->bsv", h.to(torch.float32), t32)
    mask = lab != IGNORE_LABEL
    safe = torch.where(mask, lab, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return (((lse - gold) * mask).sum(), (torch.square(lse) * mask).sum(),
            mask.sum())


def chunked_cross_entropy(hidden: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int,
                          z_loss: float = 1e-4
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """CE over [B,S,d] hidden states without materialising [B,S,V] logits.

    Loops over sequence segments; each computes its logits, LSE and gold
    logit and is recomputed in the backward pass (a checkpoint per segment
    under autograd), so peak logits memory is O(B * chunk * V) instead of
    O(B * S * V)."""
    b, s, d = hidden.shape
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=IGNORE_LABEL)
    t32 = table.to(torch.float32)
    grad = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zl = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int32, device=hidden.device)
    for c in range(n_chunks):
        h = hidden[:, c * chunk:(c + 1) * chunk]
        lab = labels[:, c * chunk:(c + 1) * chunk]
        if grad:
            seg = checkpoint.checkpoint(_ce_segment, h, lab, t32,
                                        use_reentrant=False)
        else:
            seg = _ce_segment(h, lab, t32)
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
        labels = _pad_vision_labels(model, batch)
        if cfg.ce_seq_chunk:
            hidden, aux = model.forward(params, batch, remat=cfg.remat,
                                        k_chunk=cfg.k_chunk,
                                        local_block=cfg.local_block,
                                        ring=cfg.ring,
                                        remat_policy=cfg.remat_policy,
                                        return_hidden=True,
                                        use_kernel=use_kernel)
            loss, ce = chunked_cross_entropy(
                hidden, model.unembed_table(params), labels,
                chunk=cfg.ce_seq_chunk, z_loss=cfg.z_loss)
        else:
            logits, aux = model.forward(params, batch, remat=cfg.remat,
                                        k_chunk=cfg.k_chunk,
                                        local_block=cfg.local_block,
                                        use_kernel=use_kernel)
            loss, ce = cross_entropy(logits, labels, cfg.z_loss)
        total = loss + cfg.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux}
    return loss_fn


def _value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, aux metrics),
    grads) with the grads a tree of ``params``' layout and types (zeros for
    a leaf the loss does not reach), the metrics detached."""
    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves(live),
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
        specs = batch_shardings(batch, mesh, rules)
        axes = tuple(dict.fromkeys(n for sh in specs.values()
                                   for n in collectives.names_of(sh.spec[0])))
        if not axes:
            return grad_fn(params, batch)
        total = (_pad_vision_labels(model, batch) != IGNORE_LABEL).sum()
        local = {k: collectives.block(v, mesh, specs[k].spec)
                 for k, v in batch.items()}
        rest = compat.submesh(mesh, [n for n in mesh.mesh_dim_names
                                     if n not in axes])
        with use_mesh(rest, rules if rest is not None else None):
            (loss, metrics), grads = grad_fn(params, local)
        count = (_pad_vision_labels(model, local) != IGNORE_LABEL).sum()
        share = count.float() / torch.clamp(total, min=1).float()
        out = [loss * share] + [v * share for v in metrics.values()]
        grad_leaves = leaves(grads)
        for g in grad_leaves:
            g.mul_(share.to(g.dtype))
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
