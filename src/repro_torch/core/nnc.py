"""NN+C and the paper's baselines, fitted with PyTorch on the host CPU.

The lightweight NN+C (Table 3) keeps <= 75 weights: one or two ReLU hidden
layers, one linear output, full-batch MSE training.  ``lightweight_dims``
picks the widest hidden sizes that respect the budget for a given input
width.  Features and targets are z-scored inside the model wrapper (scalers
are part of the fitted state) so raw-seconds MAE/MAPE are reported against
the paper's protocol.

The fit runs on the host CPU by design, not as a fallback: a <=75-weight
model is bound by launch overhead on any accelerator, and its predictions
are consumed as host numpy by the dispatcher.  The restarts train together
along a leading batch dimension, with the gradient written out by hand and
Adam applied to one flat parameter buffer, so an epoch is a couple of dozen
tensor operations for all restarts at once.

``to_state``/``from_state`` keep the JAX package's meta keys and array
names exactly, so either package loads the other's fitted models.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch


def n_params(layers: Sequence[int]) -> int:
    return sum(layers[i] * layers[i + 1] + layers[i + 1]
               for i in range(len(layers) - 1))


def wide_columns(X: np.ndarray) -> list[int]:
    """Columns that should be log-scaled: wide-range (c-like) or densities."""
    cols = []
    for j in range(X.shape[1]):
        col = X[:, j]
        wide = col.max() > 2048                    # c-like column
        density = col.max() <= 1.0 and col.min() > 0 and col.min() < 1 / 64
        if wide or density:                        # multiplicative features
            cols.append(j)
    return cols


def log_size_features(X: np.ndarray,
                      cols: Optional[Sequence[int]] = None) -> np.ndarray:
    """Log-scale only the *wide-range* columns (c and other >2048-range
    features); dims/densities/threads stay raw.

    Execution time is multiplicative in problem size: with a log target the
    operation count enters as log c, which is exactly what a z-scored
    log-scaled c column provides.  Raw dims stay raw: a 75-weight ReLU net
    cannot synthesise log(m*n*k) from {m,n,k} (that inability is precisely
    why feeding c helps, the paper's central claim).

    ``cols`` pins the column set (fitted models store the set chosen at fit
    time so a single-row predict — the runtime-dispatch hot path — scales
    identically to the training batch); ``None`` infers it from ``X``."""
    if cols is None:
        cols = wide_columns(X)
    Xl = X.astype(np.float64).copy()
    for j in cols:
        Xl[:, j] = np.log(np.maximum(X[:, j], 1e-12))
    return Xl


def lightweight_dims(n_features: int, budget: int = 75,
                     n_hidden: int = 1) -> list[int]:
    """Widest hidden sizes with n_params <= budget and no width-<3 bottleneck.

    The paper's "2 dense layers" is 1 hidden + linear output (Table 3's 61
    params for MV-GPU is [4, 10, 1], 73 for MM-GPU is [7, 8, 1]); MM-on-CPU
    uses "3 dense layers" (2 hidden)."""
    best = None
    rng = range(3, 33)
    if n_hidden == 1:
        candidates = [[h] for h in rng]
    else:
        candidates = [[h1, h2] for h1 in rng for h2 in rng if h2 <= h1]
    for hs in candidates:
        layers = [n_features] + hs + [1]
        p = n_params(layers)
        if p <= budget and (best is None or p > best[0]):
            best = (p, layers)
    if best is None:
        raise ValueError(f"no architecture fits {budget} params "
                         f"for {n_features} features")
    return best[1]


@dataclasses.dataclass
class MLPModel:
    """Tiny MLP regressor (ReLU or tanh), full-batch Adam training."""

    layers: list[int]
    activation: str = "relu"
    # paper §4.3 uses lr=1e-4; at this epoch budget that underfits, so
    # Adam's 1e-3 default is used (the JAX package's choice)
    learning_rate: float = 1e-3
    epochs: int = 30000
    seed: int = 0
    log_inputs: bool = True
    log_target: bool = True
    # fitted state
    params: Optional[list] = None
    x_mean: Optional[np.ndarray] = None
    x_std: Optional[np.ndarray] = None
    y_mean: float = 0.0
    y_std: float = 1.0
    y_lo: float = -1e30
    y_hi: float = 1e30
    log_cols: Optional[list] = None
    train_seconds: float = 0.0
    n_restarts: int = 3

    @property
    def n_params(self) -> int:
        return n_params(self.layers)

    def _init(self, gen: torch.Generator) -> list:
        params = []
        for i in range(len(self.layers) - 1):
            fan_in, fan_out = self.layers[i], self.layers[i + 1]
            w = torch.randn(fan_in, fan_out, generator=gen) / math.sqrt(fan_in)
            params.append((w, torch.zeros(fan_out)))
        return params

    def _act(self, z: torch.Tensor) -> torch.Tensor:
        return torch.relu(z) if self.activation == "relu" else torch.tanh(z)

    def _forward(self, ws: list, bs: list, x: torch.Tensor) -> list:
        """Activations of every layer for all restarts: x is [R, N, F],
        ws[i] is [R, in, out], bs[i] is [R, 1, out]."""
        hs = [x]
        for i, (w, b) in enumerate(zip(ws, bs)):
            z = torch.baddbmm(b, hs[-1], w)
            hs.append(self._act(z) if i < len(ws) - 1 else z)
        return hs

    def _train(self, starts: list, Xs: torch.Tensor, ys: torch.Tensor):
        """Full-batch Adam for every start at once; returns the per-start
        weights, biases and final training loss."""
        r_, (n, _) = len(starts), Xs.shape
        shapes = [(self.layers[i], self.layers[i + 1])
                  for i in range(len(self.layers) - 1)]
        # one flat buffer [R, P] holds every restart's parameters in the
        # JAX package's (w0, b0, w1, b1, ...) order; the per-layer tensors
        # are views into it, so Adam updates them in place
        p = torch.stack([torch.cat([t.reshape(-1) for wb in s for t in wb])
                         for s in starts])
        sizes = [sz for fi, fo in shapes for sz in (fi * fo, fo)]
        views = torch.split(p, sizes, dim=1)
        ws = [views[2 * i].unflatten(1, shape) for i, shape in enumerate(shapes)]
        bs = [views[2 * i + 1].unsqueeze(1) for i in range(len(shapes))]
        m = torch.zeros_like(p)
        v = torch.zeros_like(p)
        x = Xs.expand(r_, n, Xs.shape[1]).contiguous()
        y2 = ys.unsqueeze(-1)
        lr = self.learning_rate
        loss = None
        for t in range(1, self.epochs + 1):
            hs = self._forward(ws, bs, x)
            err = hs[-1] - y2                               # [R, N, 1]
            if t == self.epochs:
                loss = err.square().mean((1, 2))
            # backward of mean((out - y)^2), layer by layer
            g = err.mul_(2.0 / n)
            grads = []
            for i in range(len(ws) - 1, -1, -1):
                grads.append(g.sum(1))
                grads.append(torch.bmm(hs[i].transpose(1, 2), g).flatten(1))
                if i > 0:
                    g = torch.bmm(g, ws[i].transpose(1, 2))
                    if self.activation == "relu":
                        g.masked_fill_(hs[i] <= 0, 0.0)
                    else:
                        g.mul_(1.0 - hs[i].square())
            grad = torch.cat(grads[::-1], dim=1)
            m.lerp_(grad, 0.1)                              # b1 = 0.9
            v.mul_(0.999).addcmul_(grad, grad, value=0.001)  # b2 = 0.999
            denom = (v / (1.0 - 0.999 ** t)).sqrt_().add_(1e-8)
            p.addcdiv_(m, denom, value=-lr / (1.0 - 0.9 ** t))
        return ws, bs, loss

    def fit(self, X: np.ndarray, y: np.ndarray, *,
            warm_start: bool = False) -> "MLPModel":
        """Full-batch fit.  ``warm_start=True`` resumes from the current
        fitted weights (one run, no restarts) — the online-refinement path,
        where a handful of new rows should nudge, not re-randomise, the
        model."""
        t0 = time.time()
        if warm_start and self.params is not None:
            starts = [[(torch.as_tensor(np.asarray(w, np.float32)),
                        torch.as_tensor(np.asarray(b, np.float32)))
                       for w, b in self.params]]
        else:                                   # dead-ReLU insurance
            starts = [self._init(torch.Generator().manual_seed(
                self.seed + 1000 * r)) for r in range(self.n_restarts)]
        if self.log_inputs:
            self.log_cols = wide_columns(X)
            X = log_size_features(X, self.log_cols)
        if self.log_target:
            y = np.log(np.maximum(y, 1e-12))
        self.x_mean = X.mean(axis=0)
        self.x_std = X.std(axis=0) + 1e-12
        self.y_mean = float(y.mean())
        self.y_std = float(y.std() + 1e-12)
        # extrapolation guard: a log-target regressor that wanders one unit
        # outside the observed range turns into an e^1 multiplicative error
        self.y_lo = float(y.min()) - 2.0
        self.y_hi = float(y.max()) + 2.0
        Xs = torch.as_tensor((X - self.x_mean) / self.x_std,
                             dtype=torch.float32)
        ys = torch.as_tensor((y - self.y_mean) / self.y_std,
                             dtype=torch.float32)
        # the fit keeps the intra-op thread count it finds: the count is
        # the process default that threads take at their first parallel
        # operation, so setting it here, even on a thread of the fit's
        # own, could leave another lane's thread on one (PERF.md, fault 1)
        with torch.inference_mode():
            ws, bs, loss = self._train(starts, Xs, ys)
            # restart selection by a held-out validation slice of the TRAIN
            # set: tiny nets land in minima with equal train loss but very
            # different generalisation
            n_val = max(1, Xs.shape[0] // 5)
            xv = Xs[:n_val].expand(len(starts), n_val, Xs.shape[1])
            vloss = (self._forward(ws, bs, xv)[-1][..., 0]
                     - ys[:n_val]).square().mean(1)
            best = int(torch.argmin(vloss))     # first of equals, as JAX's
            self.params = [(w[best].numpy().copy(), b[best, 0].numpy().copy())
                           for w, b in zip(ws, bs)]
            self.final_loss = float(loss[best])
        self.train_seconds = time.time() - t0
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.log_inputs:
            X = log_size_features(X, self.log_cols)
        h = torch.as_tensor((X - self.x_mean) / self.x_std,
                            dtype=torch.float32)
        with torch.inference_mode():
            for i, (w, b) in enumerate(self.params):
                h = h @ torch.as_tensor(w) + torch.as_tensor(b)
                if i < len(self.params) - 1:
                    h = self._act(h)
        pred = h[..., 0].numpy() * self.y_std + self.y_mean
        pred = np.clip(pred, self.y_lo, self.y_hi)
        return np.exp(pred) if self.log_target else pred

    def predict_np(self, X: np.ndarray) -> np.ndarray:
        """Pure-numpy forward (same float32 math as ``predict``) — the
        runtime-dispatch hot path: a <=75-weight forward on a handful of rows
        costs microseconds here vs. far more for per-call tensor dispatch."""
        if self.log_inputs:
            X = log_size_features(X, self.log_cols)
        h = ((X - self.x_mean) / self.x_std).astype(np.float32)
        for i, (w, b) in enumerate(self.params):
            h = h @ np.asarray(w) + np.asarray(b)
            if i < len(self.params) - 1:
                h = np.maximum(h, 0.0) if self.activation == "relu" \
                    else np.tanh(h)
        pred = h[..., 0].astype(np.float64) * self.y_std + self.y_mean
        pred = np.clip(pred, self.y_lo, self.y_hi)
        return np.exp(pred) if self.log_target else pred

    # -- persistence (npz/JSON round-trip, see save_model/load_model) --------
    def to_state(self) -> tuple[dict, dict]:
        if self.params is None:
            raise ValueError("cannot persist an unfitted MLPModel")
        meta = {"kind": "mlp", "layers": list(self.layers),
                "activation": self.activation,
                "learning_rate": self.learning_rate, "epochs": self.epochs,
                "seed": self.seed, "log_inputs": self.log_inputs,
                "log_target": self.log_target, "y_mean": self.y_mean,
                "y_std": self.y_std, "y_lo": self.y_lo, "y_hi": self.y_hi,
                "log_cols": self.log_cols, "n_restarts": self.n_restarts,
                "train_seconds": self.train_seconds}
        arrays = {"x_mean": np.asarray(self.x_mean),
                  "x_std": np.asarray(self.x_std)}
        for i, (w, b) in enumerate(self.params):
            arrays[f"w{i}"] = np.asarray(w)
            arrays[f"b{i}"] = np.asarray(b)
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict) -> "MLPModel":
        m = cls(layers=list(meta["layers"]), activation=meta["activation"],
                learning_rate=meta["learning_rate"], epochs=meta["epochs"],
                seed=meta["seed"], log_inputs=meta["log_inputs"],
                log_target=meta["log_target"])
        m.n_restarts = meta["n_restarts"]
        m.y_mean, m.y_std = meta["y_mean"], meta["y_std"]
        m.y_lo, m.y_hi = meta["y_lo"], meta["y_hi"]
        m.log_cols = meta.get("log_cols")
        m.train_seconds = meta.get("train_seconds", 0.0)
        m.x_mean = np.asarray(arrays["x_mean"])
        m.x_std = np.asarray(arrays["x_std"])
        m.params = [(np.asarray(arrays[f"w{i}"]), np.asarray(arrays[f"b{i}"]))
                    for i in range(len(m.layers) - 1)]
        return m


@dataclasses.dataclass
class LinearModel:
    """Closed-form ridge regression (the paper's LR / Cons baselines)."""

    ridge: float = 1e-8
    log_inputs: bool = True
    log_target: bool = True
    coef: Optional[np.ndarray] = None
    x_mean: Optional[np.ndarray] = None
    x_std: Optional[np.ndarray] = None
    y_lo: float = -1e30
    y_hi: float = 1e30
    log_cols: Optional[list] = None
    train_seconds: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearModel":
        t0 = time.time()
        if self.log_inputs:
            self.log_cols = wide_columns(X)
            X = log_size_features(X, self.log_cols)
        if self.log_target:
            y = np.log(np.maximum(y, 1e-12))
        self.y_lo = float(y.min()) - 2.0
        self.y_hi = float(y.max()) + 2.0
        self.x_mean = X.mean(axis=0)
        self.x_std = X.std(axis=0) + 1e-12
        Xs = (X - self.x_mean) / self.x_std
        A = np.concatenate([Xs, np.ones((len(Xs), 1))], axis=1)
        self.coef = np.linalg.solve(A.T @ A + self.ridge * np.eye(A.shape[1]),
                                    A.T @ y)
        self.train_seconds = time.time() - t0
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.log_inputs:
            X = log_size_features(X, self.log_cols)
        Xs = (X - self.x_mean) / self.x_std
        A = np.concatenate([Xs, np.ones((len(Xs), 1))], axis=1)
        pred = np.clip(A @ self.coef, self.y_lo, self.y_hi)
        return np.exp(pred) if self.log_target else pred

    predict_np = predict                     # already pure numpy

    def to_state(self) -> tuple[dict, dict]:
        if self.coef is None:
            raise ValueError("cannot persist an unfitted LinearModel")
        meta = {"kind": "linear", "ridge": self.ridge,
                "log_inputs": self.log_inputs, "log_target": self.log_target,
                "y_lo": self.y_lo, "y_hi": self.y_hi,
                "log_cols": self.log_cols,
                "train_seconds": self.train_seconds}
        arrays = {"coef": np.asarray(self.coef),
                  "x_mean": np.asarray(self.x_mean),
                  "x_std": np.asarray(self.x_std)}
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict) -> "LinearModel":
        m = cls(ridge=meta["ridge"], log_inputs=meta["log_inputs"],
                log_target=meta["log_target"])
        m.y_lo, m.y_hi = meta["y_lo"], meta["y_hi"]
        m.log_cols = meta.get("log_cols")
        m.train_seconds = meta.get("train_seconds", 0.0)
        m.coef = np.asarray(arrays["coef"])
        m.x_mean = np.asarray(arrays["x_mean"])
        m.x_std = np.asarray(arrays["x_std"])
        return m


# --------------------------------------------------------------------------
# Fitted-model persistence: meta -> JSON, weights/scalers -> npz.  The
# runtime tuning cache embeds these states in its own files.
# --------------------------------------------------------------------------

def model_from_state(meta: dict, arrays: dict):
    """Rebuild a fitted model from ``to_state`` output — of either package:
    a predictor the JAX package fitted (numpy arrays) becomes the port's."""
    if meta.get("kind") == "mlp":
        return MLPModel.from_state(meta, arrays)
    if meta.get("kind") == "linear":
        return LinearModel.from_state(meta, arrays)
    raise ValueError(f"unknown model kind {meta.get('kind')!r}")


def save_model(model, path: str) -> None:
    """Writes ``path.json`` (hyperparams + scalars) and ``path.npz``
    (weights + z-score scalers)."""
    meta, arrays = model.to_state()
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(path + ".npz", **arrays)


def load_model(path: str):
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    return model_from_state(meta, arrays)


# --------------------------------------------------------------------------
# Model factory for the five methods of the paper
# --------------------------------------------------------------------------

def make_model(method: str, n_features_with_c: int, *,
               mm_cpu: bool = False, budget: int = 75,
               unconstrained: bool = False, epochs: int = 30000,
               seed: int = 0):
    """method in {nnc, nn, cons, lr, nlr}.  ``n_features_with_c`` counts c.

    Returns (model, uses_c): slice the feature matrix accordingly.
    """
    nf = n_features_with_c
    n_hidden = 3 if mm_cpu else 2
    if method == "nnc":
        layers = ([nf, 64, 32, 1] if unconstrained
                  else lightweight_dims(nf, budget, n_hidden))
        return MLPModel(layers, "relu", epochs=epochs, seed=seed), True
    if method == "nn":
        layers = ([nf - 1, 64, 32, 1] if unconstrained
                  else lightweight_dims(nf - 1, budget, n_hidden))
        return MLPModel(layers, "relu", epochs=epochs, seed=seed), False
    if method == "nlr":
        layers = ([nf - 1, 64, 32, 1] if unconstrained
                  else lightweight_dims(nf - 1, budget, n_hidden))
        return MLPModel(layers, "tanh", epochs=epochs, seed=seed), False
    if method == "lr":
        return LinearModel(), False
    if method == "cons":
        return LinearModel(), "c_only"
    raise ValueError(f"unknown method {method}")


def slice_features(X: np.ndarray, uses_c) -> np.ndarray:
    """X has c as its LAST column."""
    if uses_c is True:
        return X
    if uses_c == "c_only":
        return X[:, -1:]
    return X[:, :-1]


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.abs(y_true - y_pred)))


def mape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    denom = np.maximum(np.abs(y_true), 1e-12)
    return float(100.0 * np.mean(np.abs(y_true - y_pred) / denom))
