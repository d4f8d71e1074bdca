"""Production mesh construction: the port of the JAX package's
``launch/mesh.py``.

Functions, not module-level constants, so importing this module touches no
process group.  Both build a ``DeviceMesh`` through ``dist.compat.make_mesh``
over the default process group, which the caller owns: neither creates
one.  The reference forces 512 host devices before importing jax; the
port's dry-run (``launch.dryrun``) joins a fake process group of 256 or 512
ranks in one process instead.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist import compat


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks), over
    the first ranks of the default group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; have {have} — the dry-run "
            "joins a fake process group of that many ranks first "
            "(launch.dryrun.fake_group)")
    return compat.make_mesh(shape, axes)


def make_host_mesh():
    """1x1 mesh over a world of one (integration tests)."""
    return compat.make_mesh((1, 1), ("data", "model"))
