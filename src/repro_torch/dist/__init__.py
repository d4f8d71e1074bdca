"""Distributed execution layer on ``torch.distributed``: logical-axis
sharding and ring attention.

  * :mod:`repro_torch.dist.sharding` — :class:`ShardingRules` (logical ->
    physical axis mapping with dedup + divisibility resolution), the
    ``use_mesh``/``active_mesh`` context, ``constrain`` and the per-leaf
    ``tree_shardings``/``batch_shardings``.
  * :mod:`repro_torch.dist.ring_attention` — blockwise ring attention and
    the decode ring, with ``ppermute`` rotation and an online-softmax
    accumulator.
  * :mod:`repro_torch.dist.compat` — process-group set-up and
    ``make_mesh`` (a ``DeviceMesh`` that records its transport).
  * :mod:`repro_torch.dist.collectives` — ``axis_index``, ``ppermute``,
    ``psum``/``pmean`` and the region's ``shard``/``unshard``, the
    counterparts of ``shard_map`` and ``jax.lax``'s collectives (no module
    of the JAX package corresponds).

The ``constrain`` contract
--------------------------

``constrain(x, *logical_axes)`` returns ``x`` unchanged while no
``use_mesh(mesh, rules)`` frame is active for the current thread, or inside
an explicit ``use_mesh(None, None)`` frame, so the same model code runs
annotated on one device.  Under an active mesh it checks the rank and
resolves the spec, and returns ``x`` as well: the port keeps every tensor
whole on every rank outside its SPMD regions (the global view,
``dist.collectives``).  Axis names unknown to the active rules, axes
missing from the mesh, and non-divisible dimension sizes all resolve to
"replicated" rather than erroring.
"""
from repro_torch.dist.sharding import (ShardingRules, active_mesh,
                                       active_rules, batch_shardings,
                                       constrain, serve_rules, train_rules,
                                       tree_shardings, use_mesh)
from repro_torch.dist.ring_attention import ring_attention

__all__ = [
    "ShardingRules", "active_mesh", "active_rules", "batch_shardings",
    "constrain", "ring_attention", "serve_rules", "train_rules",
    "tree_shardings", "use_mesh",
]
