"""Measured kernel variants (the real-timing combos) and the black-box
timing protocol shared by every measured row.

``HOST_VARIANTS`` are the JAX package's host anchor variants, as numpy:
two genuinely different implementations per kernel (analogous to the
paper's Eigen vs Boost), a BLAS/vectorised variant and a slower
non-BLAS/naive-path variant.  ``card_variants`` are the port's registry
variants of the paper's four kernels (``runtime.registry``: the library
path ``ref`` and the hand CUDA kernels ``pallas_*``), the callables
dispatch picks between, called on ``make_inputs``' operands cast to fp32 on
a device.  Timings are wall-clock with adaptive repetition (target window
~5 ms) — the paper's black-box protocol; a card variant's call ends in a
synchronise, as the dispatcher's does.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from repro_torch.kernels import resolve_device


def time_callable(fn: Callable[[], object], min_window: float = 5e-3,
                  max_reps: int = 200) -> float:
    """Wall-clock seconds per call of ``fn`` — the repo-wide black-box
    timing protocol: one warmup call, then adaptive repetition until the
    measured window reaches ``min_window`` (amortizes timer resolution for
    microsecond kernels without penalizing millisecond ones).

    ``fn`` must return only when its work is done: a callable that
    launches CUDA work synchronises the device before returning (the
    runtime dispatcher wraps every variant so), or the window measures
    launches, not kernels.
    """
    fn()                                    # warmup
    reps = 1
    while True:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        if dt >= min_window or reps >= max_reps:
            return dt / reps
        reps = min(max_reps, max(reps * 2, int(reps * min_window / max(dt, 1e-9))))


# --- host variants (numpy) --------------------------------------------------

def mm_blas(p, a, b, v):
    return a @ b


def mm_naive(p, a, b, v):
    # einsum without optimize: numpy's internal loop, no BLAS dispatch
    return np.einsum("ij,jk->ik", a, b, optimize=False)


def mv_blas(p, a, b, v):
    return a @ v


def mv_naive(p, a, b, v):
    return np.einsum("ij,j->i", a, v, optimize=False)


def mc_window(p, a, b, v):
    # stride-tricks windows + tensordot (BLAS path)
    w = sliding_window_view(a, (p["r"], p["r"]))
    return np.tensordot(w, b, axes=([2, 3], [0, 1]))


def mc_fft(p, a, b, v):
    # FFT-based valid convolution — different perf profile entirely
    m, n, r = p["m"], p["n"], p["r"]
    fa = np.fft.rfft2(a)
    fb = np.fft.rfft2(b, s=a.shape)
    out = np.fft.irfft2(fa * fb, s=a.shape)
    return out[r - 1:, r - 1:]


def mp_window(p, a, b, v):
    w = sliding_window_view(a, (p["r"], p["r"]))[::p["s"], ::p["s"]]
    return w.max(axis=(2, 3))


def mp_offsets(p, a, b, v):
    r, s = p["r"], p["s"]
    m, n = a.shape
    om, on = (m - r) // s + 1, (n - r) // s + 1
    out = np.full((om, on), -np.inf, a.dtype)
    for i in range(r):
        for j in range(r):
            np.maximum(out, a[i:i + om * s:s, j:j + on * s:s], out=out)
    return out


def chol_lapack(p, a, b, v):
    return np.linalg.cholesky(a)


def chol_blocked(p, a, b, v, blk=64):
    # right-looking blocked Cholesky: unblocked LAPACK on the diagonal,
    # BLAS triangular-solve + syrk-style updates on the trailing matrix
    a = a.copy()
    n = a.shape[0]
    for k0 in range(0, n, blk):
        k1 = min(k0 + blk, n)
        a[k0:k1, k0:k1] = np.linalg.cholesky(a[k0:k1, k0:k1])
        if k1 < n:
            ltri = a[k0:k1, k0:k1]
            panel = np.linalg.solve(ltri, a[k1:, k0:k1].T).T
            a[k1:, k0:k1] = panel
            a[k1:, k1:] -= panel @ panel.T
    return np.tril(a)


def qr_lapack(p, a, b, v):
    return np.linalg.qr(a)


def qr_mgs(p, a, b, v):
    # modified Gram-Schmidt (vectorised inner loop) — genuinely different
    # perf profile from Householder LAPACK
    m, n = a.shape
    q = a.copy()
    r = np.zeros((n, n))
    for j in range(n):
        r[j, j] = np.linalg.norm(q[:, j])
        q[:, j] = q[:, j] / max(r[j, j], 1e-30)
        if j + 1 < n:
            r[j, j + 1:] = q[:, j] @ q[:, j + 1:]
            q[:, j + 1:] -= np.outer(q[:, j], r[j, j + 1:])
    return q, r


HOST_VARIANTS = {
    "mm": {"blas": mm_blas, "einsum": mm_naive},
    "mv": {"blas": mv_blas, "einsum": mv_naive},
    "mc": {"window": mc_window, "fft": mc_fft},
    "mp": {"window": mp_window, "offsets": mp_offsets},
    "chol": {"lapack": chol_lapack, "blocked": chol_blocked},
    "qr": {"lapack": qr_lapack, "mgs": qr_mgs},
}


# --- card variants: the registry's variants of the paper's four kernels ----

# the registry kernel behind each paper kernel, and its call's operands
# among make_inputs' (a, b, v)
CARD_KERNELS = {"mm": ("matmul", lambda a, b, v: (a, b)),
                "mv": ("matvec", lambda a, b, v: (a, v)),
                "mc": ("conv2d", lambda a, b, v: (a, b)),
                "mp": ("maxpool", lambda a, b, v: (a,))}


@functools.lru_cache(maxsize=None)
def card_variants(kernel: str) -> dict:
    """Variant name -> the ``runtime.registry`` Variant of a paper kernel:
    the callables dispatch picks between (on a CPU tensor a hand variant
    runs its kernel's plain version)."""
    # imported here: the runtime package imports this module
    from repro_torch.runtime.registry import default_registry

    name = CARD_KERNELS[kernel][0]
    return {v.name: v for v in default_registry(include=[name]).variants(name)}


def card_call(kernel: str, variant: str, p: dict, a, b, v):
    """One call of a card variant on make_inputs' operands as tensors."""
    operands = CARD_KERNELS[kernel][1](a, b, v)
    return card_variants(kernel)[variant].call(operands, p)


def make_inputs(kernel: str, p: dict, rng: np.random.RandomState):
    if kernel == "mm":
        a = rng.rand(p["m"], p["n"])
        b = rng.rand(p["n"], p["k"])
        return a, b, None
    if kernel == "mv":
        a = rng.rand(p["m"], p["n"])
        v = rng.rand(p["n"])
        return a, None, v
    if kernel in ("mc", "mp"):
        a = rng.rand(p["m"], p["n"])
        b = rng.rand(p["r"], p["r"]) if kernel == "mc" else None
        return a, b, None
    if kernel == "chol":
        g = rng.rand(p["n"], p["n"])
        a = g @ g.T + p["n"] * np.eye(p["n"])      # SPD
        return a, None, None
    if kernel == "qr":
        return rng.rand(p["m"], p["n"]), None, None
    raise ValueError(kernel)


def to_device(a, b, v, device) -> tuple:
    """``make_inputs``' operands as fp32 tensors on ``device`` (None stays
    None)."""
    return tuple(None if x is None else
                 torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (a, b, v))


def measure_instance(kernel: str, variant: str, p: dict,
                     rng: np.random.RandomState,
                     device: Optional[str] = None) -> float:
    """Seconds per call of one instance.  ``device=None`` times a host
    variant on make_inputs' float64 arrays; otherwise a card variant on
    them cast to fp32 on ``device``, each call synchronised."""
    a, b, v = make_inputs(kernel, p, rng)
    if device is not None:
        from repro_torch.runtime.dispatch import synchronize

        card_variants(kernel)[variant]          # an unknown name raises
        a, b, v = to_device(a, b, v, resolve_device(device))
        return time_callable(
            lambda: synchronize(card_call(kernel, variant, p, a, b, v)))
    fn = HOST_VARIANTS[kernel][variant]
    # cap the slow naive MM path: subsample huge einsum problems by timing a
    # row-slice and scaling (documented black-box shortcut; keeps the 500-
    # instance protocol tractable on a shared CI box)
    if kernel == "mm" and variant == "einsum" and p["m"] * p["n"] * p["k"] > 2e8:
        rows = max(1, int(2e8 / (p["n"] * p["k"])))
        a_sub = a[:rows]
        t = time_callable(lambda: fn(p, a_sub, b, v))
        return t * (p["m"] / rows)
    return time_callable(lambda: fn(p, a, b, v))
