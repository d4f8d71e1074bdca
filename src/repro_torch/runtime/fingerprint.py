"""Hardware fingerprint — the model-zoo key of the tuning cache.

The paper's premise is that a predictor is only valid for the (kernel,
hardware) pair it was trained on (§4.1: every platform gets its own
<=75-weight model).  The runtime cache therefore namespaces everything it
persists by a fingerprint of the *executing* hardware: backend, device
kind, device/core counts, and which dtypes actually materialise.  A cache
directory produced on one host is never silently reused on another — a
mismatched fingerprint simply resolves to a different (empty) directory,
which is the cold-cache path, not an error.

The port reads the device from torch.  Its backends are ``torch-cuda`` and
``torch-cpu``, names the JAX package's fingerprints (``cpu``, ``gpu``,
``tpu``) never take, so the two packages' caches can share a root without
one ever loading — and, on a stale layout, overwriting — the other's
entries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re

import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    backend: str               # torch-cuda | torch-cpu
    device_kind: str           # torch.cuda.get_device_name() or "cpu"
    device_count: int
    host_cores: int
    dtypes: tuple              # supported compute dtypes, sorted

    def to_json(self) -> dict:
        return {"backend": self.backend, "device_kind": self.device_kind,
                "device_count": self.device_count,
                "host_cores": self.host_cores,
                "dtypes": list(self.dtypes)}

    @classmethod
    def from_json(cls, d: dict) -> "Fingerprint":
        return cls(backend=d["backend"], device_kind=d["device_kind"],
                   device_count=int(d["device_count"]),
                   host_cores=int(d["host_cores"]),
                   dtypes=tuple(d["dtypes"]))

    @property
    def key(self) -> str:
        """Stable directory slug: human-readable prefix + content hash.

        The hash covers every field, so any change (the runtime exposes a new
        dtype, different device count) keys a fresh cache directory."""
        canon = json.dumps(self.to_json(), sort_keys=True)
        digest = hashlib.sha1(canon.encode()).hexdigest()[:10]
        slug = re.sub(r"[^a-z0-9]+", "-",
                      f"{self.backend}-{self.device_kind}".lower()).strip("-")
        return f"{slug}-{self.device_count}x-{digest}"


def _dtype_support(device: torch.device) -> tuple:
    """Dtypes a tensor on ``device`` actually materialises in."""
    out = []
    for name in ("bfloat16", "float16", "float32", "float64"):
        dtype = getattr(torch, name)
        try:
            if torch.zeros((), dtype=dtype, device=device).dtype == dtype:
                out.append(name)
        except (TypeError, RuntimeError):
            pass
    return tuple(out)


def current_fingerprint(device="cuda") -> Fingerprint:
    """Fingerprint of ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        kind, count = "cpu", 1
    return Fingerprint(
        backend=f"torch-{device.type}",
        device_kind=kind,
        device_count=count,
        host_cores=os.cpu_count() or 1,
        dtypes=_dtype_support(device),
    )
