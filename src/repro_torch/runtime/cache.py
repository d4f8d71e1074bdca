"""Persistent tuning cache: measured rows + fitted NN+C state on disk.

Layout (``results/tunecache/<fingerprint.key>/``):

- ``fingerprint.json`` — the full fingerprint of the host that produced
  this directory (the key is a hash; this file is the readable record).
- ``<kernel>.json`` — cache-entry metadata: feature/variant names, shape
  buckets with measurement coverage, and the fitted model's hyperparams
  (``nnc.to_state`` meta) when one exists.
- ``<kernel>.npz`` — the measured ``(features, time)`` rows (c last, the
  repo-wide layout) plus the model's weights/scalers under ``model_*``.

Invalidation rules: a fingerprint mismatch selects a different directory
(cold start, never an error); a stored entry whose variant or feature
names no longer match the live registry is discarded on load (the rows
were measured against a different candidate set); an unknown
``CACHE_VERSION`` is likewise discarded.  Lookup is shape-bucketed
(``shape_bucket``): dims collapse to log2 buckets, so coverage is tracked
per shape *class* and dispatch can distinguish "this shape class was
measured here" from a genuine cold miss.

The files are those of the JAX package, byte for byte in layout and with
the same ``CACHE_VERSION``, so a directory either package wrote loads in
the other; the fingerprint keys keep the two packages' directories apart.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import zipfile
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.nnc import (MLPModel, lightweight_dims, mape,
                                  model_from_state)
from repro_torch.runtime.fingerprint import Fingerprint, current_fingerprint

CACHE_VERSION = 1
DEFAULT_ROOT = os.path.join("results", "tunecache")
# the paper's lightweight training budget (<250 instances, §4.2) bounds
# every (re)fit: only the newest rows inside the budget are used
TRAIN_BUDGET_ROWS = 250


def bucket_dim(v) -> float:
    """The single-dimension collapse rule behind every shape bucket in the
    repo: small values (ranks, strides, windows) stay exact, larger ones
    collapse to their log2 bucket."""
    v = float(v)
    return v if v <= 16 else 16.0 + round(math.log2(v))


def shape_bucket(params: dict) -> tuple:
    """Canonical shape bucket: ``bucket_dim`` per param.  Coverage of a
    bucket means "we measured a shape like this here"."""
    return tuple((k, bucket_dim(params[k])) for k in sorted(params))


def shape_class(shape) -> tuple:
    """Whole-shape bucket — ``bucket_dim`` per axis.  This is the rule
    ``repro_torch.api.CompiledProgram`` uses to reuse a compiled schedule
    across minor shape jitter; it lives here, next to ``shape_bucket``, so the
    compile-time class and the cache's measured-coverage buckets can never
    drift apart."""
    return tuple(bucket_dim(d) for d in shape)


@dataclasses.dataclass
class CacheEntry:
    kernel: str
    feature_names: list
    variant_names: list
    X: np.ndarray                   # [N, F+1], c last
    y: np.ndarray                   # [N] seconds
    buckets: set                    # shape buckets with measured coverage
    model: Optional[object] = None  # fitted MLPModel/LinearModel
    dirty: bool = False
    version: int = 0                # bumped on every (re)fit; in-process
                                    # invalidation token for decision memos
    fit_mape: Optional[float] = None  # training-set MAPE (%) of the last
                                      # fit — the dispatcher's error band
                                      # before any online observations

    @property
    def n_rows(self) -> int:
        return int(len(self.y))

    def clear_rows(self) -> None:
        """Drop measured rows, bucket coverage, and the fitted model — a
        fresh tuning pass re-measures its grid; keeping rows from an
        earlier pass would mix two noise regimes into one fit."""
        self.X = np.zeros((0, len(self.feature_names) + 1))
        self.y = np.zeros((0,))
        self.buckets = set()
        self.model = None
        self.fit_mape = None
        self.dirty = True
        self.version += 1

    def add_rows(self, X: np.ndarray, y: Sequence[float],
                 bucket: tuple) -> None:
        X = np.atleast_2d(np.asarray(X, np.float64))
        if X.shape[1] != len(self.feature_names) + 1:
            raise ValueError(
                f"{self.kernel}: row width {X.shape[1]} != "
                f"{len(self.feature_names)} features + c")
        self.X = np.concatenate([self.X, X], axis=0)
        self.y = np.concatenate([self.y, np.asarray(y, np.float64)])
        self.buckets.add(bucket)
        self.dirty = True

    def fit(self, *, epochs: int = 6000, warm_start: bool = False,
            budget_rows: int = TRAIN_BUDGET_ROWS,
            model: Optional[object] = None) -> object:
        """(Re)fit the lightweight model on the newest ``budget_rows``."""
        if self.n_rows < 2:
            raise ValueError(f"{self.kernel}: {self.n_rows} rows is not "
                             "enough to fit")
        X, y = self.X[-budget_rows:], self.y[-budget_rows:]
        if model is not None:
            model.fit(X, y)
        elif warm_start and isinstance(self.model, MLPModel):
            model = copy.deepcopy(self.model)
            model.fit(X, y, warm_start=True)
        else:
            nf = X.shape[1]
            model = MLPModel(lightweight_dims(nf, 75, 1), epochs=epochs)
            model.fit(X, y)
        # swapped in whole: a reader on another thread (the adaptive
        # executor prices steals while a worker refits) sees the old model
        # or the new one, never one in the middle of its fit
        self.model = model
        self.fit_mape = float(mape(y, self.model.predict_np(X)))
        self.dirty = True
        self.version += 1
        return self.model

    def predict(self, rows: np.ndarray) -> np.ndarray:
        if self.model is None:
            raise ValueError(f"{self.kernel}: no fitted model in cache")
        return self.model.predict_np(np.atleast_2d(rows))


def _bucket_to_json(b: tuple) -> list:
    return [[k, v] for k, v in b]


def _bucket_from_json(b: list) -> tuple:
    return tuple((k, float(v)) for k, v in b)


class TuningCache:
    """Per-(kernel, hardware-fingerprint) store of rows + fitted models."""

    def __init__(self, root: str = DEFAULT_ROOT,
                 fingerprint: Optional[Fingerprint] = None):
        self.root = root
        self.fingerprint = fingerprint or current_fingerprint()
        self.dir = os.path.join(root, self.fingerprint.key)
        self._entries: dict[str, CacheEntry] = {}

    # -- entry lifecycle -----------------------------------------------------
    def entry(self, kernel: str, feature_names: Optional[Sequence[str]] = None,
              variant_names: Optional[Sequence[str]] = None) -> CacheEntry:
        """Get the in-memory entry, loading from disk on first touch.  When
        the caller states its live layout (feature/variant names) a stale
        on-disk entry is discarded instead of reused."""
        if kernel not in self._entries:
            loaded = self._load(kernel)
            if loaded is not None and not self._stale(loaded, feature_names,
                                                      variant_names):
                self._entries[kernel] = loaded
            else:
                if feature_names is None:
                    raise KeyError(
                        f"no cached entry for {kernel!r} under {self.dir} "
                        "and no feature_names given to create one")
                nf = len(feature_names)
                self._entries[kernel] = CacheEntry(
                    kernel=kernel, feature_names=list(feature_names),
                    variant_names=list(variant_names or []),
                    X=np.zeros((0, nf + 1)), y=np.zeros((0,)), buckets=set())
        return self._entries[kernel]

    @staticmethod
    def _stale(entry: CacheEntry, feature_names, variant_names) -> bool:
        if feature_names is not None and \
                list(feature_names) != entry.feature_names:
            return True
        if variant_names is not None and \
                list(variant_names) != entry.variant_names:
            return True
        return False

    def has(self, kernel: str) -> bool:
        return kernel in self._entries or \
            os.path.exists(self._json_path(kernel))

    def kernels(self) -> list[str]:
        on_disk = []
        if os.path.isdir(self.dir):
            on_disk = [f[:-5] for f in os.listdir(self.dir)
                       if f.endswith(".json") and f != "fingerprint.json"]
        return sorted(set(on_disk) | set(self._entries))

    # -- persistence ---------------------------------------------------------
    def _json_path(self, kernel: str) -> str:
        return os.path.join(self.dir, f"{kernel}.json")

    def _npz_path(self, kernel: str) -> str:
        return os.path.join(self.dir, f"{kernel}.npz")

    def save(self, kernel: Optional[str] = None) -> None:
        """Write dirty entries (or the named one) to disk."""
        names = [kernel] if kernel else list(self._entries)
        os.makedirs(self.dir, exist_ok=True)
        fp_path = os.path.join(self.dir, "fingerprint.json")
        if not os.path.exists(fp_path):
            with open(fp_path, "w") as f:
                json.dump(self.fingerprint.to_json(), f, indent=1)
        for name in names:
            e = self._entries.get(name)
            if e is None or (kernel is None and not e.dirty):
                continue
            meta = {"version": CACHE_VERSION, "kernel": e.kernel,
                    "feature_names": e.feature_names,
                    "variant_names": e.variant_names,
                    "n_rows": e.n_rows,
                    "buckets": [_bucket_to_json(b)
                                for b in sorted(e.buckets)],
                    "fit_mape": e.fit_mape,
                    "model": None}
            arrays = {"X": e.X, "y": e.y}
            if e.model is not None:
                mmeta, marrays = e.model.to_state()
                meta["model"] = mmeta
                arrays.update({f"model_{k}": v for k, v in marrays.items()})
            # npz first, json last: the json is the commit marker (_load
            # requires both files), so a crash mid-save leaves either the
            # old pair or a dangling npz — never a valid json over a
            # truncated npz.  Both writes go through tmp + atomic replace.
            tmp_npz = self._npz_path(name) + ".tmp.npz"
            np.savez(tmp_npz, **arrays)
            os.replace(tmp_npz, self._npz_path(name))
            tmp = self._json_path(name) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)
            os.replace(tmp, self._json_path(name))
            e.dirty = False

    def _load(self, kernel: str) -> Optional[CacheEntry]:
        path = self._json_path(kernel)
        if not os.path.exists(path) or not os.path.exists(
                self._npz_path(kernel)):
            return None
        # a corrupt/torn entry (crash mid-write, disk issues) is discarded —
        # the contract is cold start, never an error
        try:
            with open(path) as f:
                meta = json.load(f)
            if meta.get("version") != CACHE_VERSION:
                return None
            with np.load(self._npz_path(kernel)) as z:
                arrays = {k: z[k] for k in z.files}
            model = None
            if meta.get("model") is not None:
                marrays = {k[len("model_"):]: v for k, v in arrays.items()
                           if k.startswith("model_")}
                model = model_from_state(meta["model"], marrays)
            return CacheEntry(
                kernel=kernel, feature_names=list(meta["feature_names"]),
                variant_names=list(meta["variant_names"]),
                X=arrays["X"], y=arrays["y"],
                buckets={_bucket_from_json(b) for b in meta["buckets"]},
                model=model, fit_mape=meta.get("fit_mape"))
        except (json.JSONDecodeError, KeyError, ValueError, OSError,
                zipfile.BadZipFile):
            return None
