"""Process-group set-up and the device mesh: the port's counterpart of the
JAX package's ``dist/compat.py``.

The reference is single-controller: ``jax.make_mesh`` lays the devices of
one process out on named axes.  The port is multi-process SPMD on
``torch.distributed``: every rank runs the same program, and
:func:`make_mesh` builds a ``DeviceMesh`` over the default process group,
which :func:`init_process_group` creates first.  That set-up is shared by
the tests, ``chip_smoke.py`` and the training launcher:

  * rendezvous from ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), from an ``init_method`` given
    explicitly (``file://...`` in the tests; the rank and world size as
    arguments or from ``RANK``/``WORLD_SIZE``), or — with neither — a
    world of one in process (a ``HashStore``), as ``jax.device_count()``
    is one on one card;
  * a ``timeout`` on the group, so that a lost rank fails the run;
  * one explicit device per rank (``torch.cuda.set_device`` on a card).

**Transport.**  It is chosen once, by the group's backend, and recorded on
the mesh (``mesh.transport``): with NCCL (one card per rank) device tensors
go straight into the collectives; with gloo (the CPU, or several ranks
sharing one card, which NCCL refuses) ``dist.collectives`` copies CUDA
tensors to host memory and back explicitly and counts the bytes and
seconds.  Nothing retries on another backend or device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class Transport:
    """How a mesh's collectives move tensors, and what they moved through
    the host.  ``backend`` is the group's (``nccl`` or ``gloo``);
    ``device`` is this rank's compute device."""

    backend: str
    device: torch.device
    host_bytes: int = 0         # bytes staged through host memory
    host_s: float = 0.0         # seconds spent staging them (copies)

    @property
    def staged(self) -> bool:
        """True when CUDA tensors travel through host memory (gloo)."""
        return self.backend == "gloo"

    def describe(self) -> str:
        where = "host-staged" if self.staged else "device-direct"
        return f"{self.backend} ({where}, {self.device})"


def init_process_group(device, *, backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group on ``device`` (this rank's one
    device) and return it.  ``backend`` defaults to NCCL on a card and
    gloo on the CPU; rendezvous as the module docstring says."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is not None:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return device


@contextlib.contextmanager
def process_group(device, **kw):
    """:func:`init_process_group` for the enclosed block, destroyed at its
    end; an existing default group is used as it is and left alone."""
    if dist.is_initialized():
        yield torch.device(device)
        return
    device = init_process_group(device, **kw)
    try:
        yield device
    finally:
        dist.destroy_process_group()


def make_mesh(axis_shapes, axis_names, *, device=None):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    default group (the counterpart of ``jax.make_mesh``), with
    ``mesh.transport`` recording the backend, the staging and this rank's
    ``device`` (default: the current card under NCCL, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call dist.compat.init_process_group first")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))
    mesh.transport = Transport(backend, torch.device(device))
    return mesh


def submesh(mesh, names):
    """The mesh over the axes ``names`` through this rank, with its
    parent's transport; None for no axes."""
    names = tuple(names)
    if not names:
        return None
    sub = mesh[names]
    sub.transport = mesh.transport
    return sub
