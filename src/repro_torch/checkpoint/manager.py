"""Atomic checkpoint manager (fault-tolerance substrate): the port of
``repro.checkpoint.manager``, on the same files.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, written to a temp dir
and atomically renamed — a crash mid-write can never corrupt the latest
checkpoint.  Arrays are saved as host numpy under the keys the reference
gives its leaves (``"a/b/0"``: dict keys in sorted order, list and tuple
indices; ``"opt/.mu/a"``: a NamedTuple's fields by name) and restored
onto the devices of the ``like`` tree's leaves.  A content checksum in
the manifest guards torn reads.

bfloat16 leaves are written as the reference writes them: 2-byte raw
records (``|V2`` in the npz, numpy having no bfloat16) under the dtype name
``bfloat16`` in the checksum.  Reading, a 2-byte raw record is taken for a
bfloat16 leaf, so the port restores bf16 checkpoints of either package;
the reference itself reads the name ``|V2`` back and fails its checksum on
any checkpoint with a bf16 leaf.

``restore`` takes a ``shardings`` tree of devices (one per leaf) on one
host; under an active mesh it places every leaf, whole, on this rank's
device (the port's global view, ``dist.collectives``), where the reference
reshards each leaf with ``device_put``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import active_mesh

_BF16_RECORD = np.dtype("V2")     # how numpy stores a bfloat16 leaf


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _items(tree, prefix: str = ""):
    """(key, leaf) pairs in the reference's flattening order and under its
    key names (``tree_flatten_with_path``): dict keys sorted, a
    NamedTuple's fields in order as ``.<field>`` (an optimizer state's
    ``opt/.mu/...``), list and tuple entries by index, None an empty
    subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for field, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}.{field}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` in ``_items`` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(_BF16_RECORD)
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_RECORD else str(a.dtype)


def _checksum(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for key in sorted(arrays):
        h.update(key.encode())
        h.update(str(arrays[key].shape).encode())
        h.update(_dtype_name(arrays[key]).encode())
        a = arrays[key]
        h.update(a.tobytes()[:4096])          # prefix hash: cheap tear-guard
    return h.hexdigest()


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == _BF16_RECORD:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._writer: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        arrays = _flatten(tree)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "checksum": _checksum(arrays),
            "extra": extra or {},
        }
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)             # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        """Non-blocking save: the device->host snapshot happens now (so the
        caller can write its tensors in place right after), serialization
        + atomic publish run on a background thread.  At most one writer is
        in flight; a new save waits for the previous one (bounded staleness,
        no unbounded queue)."""
        self.wait()
        # copies: a tensor on the host shares its memory with .numpy()
        arrays = {key: np.array(a) for key, a in _flatten(tree).items()}
        self._writer = threading.Thread(
            target=self.save, args=(step, arrays, extra), daemon=True)
        self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- discovery ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore --------------------------------------------------------------
    def restore(self, step: int, like: Any,
                shardings: Any = None) -> tuple[Any, dict]:
        """``like``: tree giving the structure and, for tensor leaves, the
        device each leaf goes to (values ignored; other leaves come back
        as CPU tensors).  ``shardings``: optional matching tree that
        overrides those placements — of devices with no mesh active; under
        an active mesh (``dist.tree_shardings``' records, or any matching
        tree) every leaf goes to this rank's device (``mesh.transport``),
        whole: the global view's counterpart of the reference's reshard
        onto another mesh."""
        mesh = active_mesh()
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if _checksum(arrays) != manifest["checksum"]:
            raise IOError(f"checkpoint {path} failed checksum (torn write?)")
        on_mesh = shardings is not None and mesh is not None
        places = [dev for _, dev in _items(shardings)] \
            if shardings is not None and not on_mesh else None
        leaves = []
        for idx, (key, leaf) in enumerate(_items(like)):
            if key not in arrays:
                raise KeyError(f"checkpoint missing key {key}")
            if on_mesh:
                device = mesh.transport.device
            elif places is not None:
                device = places[idx]
            elif isinstance(leaf, torch.Tensor):
                device = leaf.device
            else:
                device = "cpu"
            leaves.append(_to_tensor(arrays[key], device))
        return _unflatten(like, iter(leaves)), manifest["extra"]

    def restore_latest(self, like: Any, shardings: Any = None
                       ) -> Optional[tuple[int, Any, dict]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, shardings)
        return step, tree, extra
