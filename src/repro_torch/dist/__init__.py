"""Distributed execution layer, one device so far: logical-axis sharding
rules and the ``constrain`` no-op contract (``dist.sharding``), and the
attention masks the dense paths share (``dist.masking``).

``constrain(x, *logical_axes)`` returns ``x`` unchanged while no
``use_mesh(mesh, rules)`` frame is active for the current thread, or inside
an explicit ``use_mesh(None, None)`` frame, so the same model code runs
annotated on one device.  Ring attention, ``compat`` and the mesh that
actually shards come with the port's dist slice on ``torch.distributed``.
"""
from repro_torch.dist.sharding import (ShardingRules, active_mesh,
                                       active_rules, constrain, serve_rules,
                                       train_rules, use_mesh)

__all__ = [
    "ShardingRules", "active_mesh", "active_rules", "constrain",
    "serve_rules", "train_rules", "use_mesh",
]
