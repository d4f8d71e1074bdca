"""Kernel parameter spaces, complexity functions f(K,H), and feature vectors:
the port's copy of the JAX package's ``core.features``.

This is the paper's §3.2: for each kernel the inputs are its dimensional
parameters, densities, the hardware knob (thread count on CPU), and — the
paper's key contribution — the analytic operation count ``c = f(K, H)``
appended as an extra feature (NN+C).  Table 2 parameter ranges are sampled
exactly as published.  Every sampler draws from ``np.random.RandomState``
in the JAX package's order, so one seed gives the same parameters in both
packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    param_names: tuple            # kernel parameters K (feature order)
    complexity: Callable          # f(K) -> operation count c
    sample: Callable              # rng -> dict of kernel params


def _sample_density(rng: np.random.RandomState, size_log2: float,
                    include_one: bool = True) -> float:
    """d in {1, 1/2, 1/4, ..., 1/2^log2(size)} (Table 2)."""
    lo = 0 if include_one else 1
    hi = max(int(size_log2), lo + 1)
    return 2.0 ** (-rng.randint(lo, hi + 1))


# --- Matrix-Matrix multiplication: A[m,n] @ B[n,k] --------------------------

def mm_complexity(p: dict) -> float:
    return float(p["m"] * p["n"] * p["k"])


def mm_sample(rng: np.random.RandomState) -> dict:
    m, n, k = rng.randint(1, 1025, size=3)
    d1 = _sample_density(rng, math.log2(max(m * n, 2)))
    d2 = _sample_density(rng, math.log2(max(n * k, 2)))
    return {"m": int(m), "n": int(n), "k": int(k), "d1": d1, "d2": d2}


# --- Matrix-Vector multiplication: A[m,n] @ b[n] ----------------------------

def mv_complexity(p: dict) -> float:
    return float(p["m"] * p["n"])


def mv_sample(rng: np.random.RandomState) -> dict:
    m, n = rng.randint(1, 1025, size=2)
    d = _sample_density(rng, math.log2(max(m * n, 2)), include_one=False)
    return {"m": int(m), "n": int(n), "d": d}


# --- Matrix Convolution: A[m,n] * B[r,r] (valid) ----------------------------

def mc_complexity(p: dict) -> float:
    return float((p["m"] - p["r"] + 1) * (p["n"] - p["r"] + 1) * p["r"] ** 2)


def mc_sample(rng: np.random.RandomState) -> dict:
    r = int(rng.choice([3, 5, 7]))
    m, n = rng.randint(r, 1025, size=2)
    d = _sample_density(rng, math.log2(max(m * n, 2)))
    return {"m": int(m), "n": int(n), "r": r, "d": d}


# --- Max-Pooling: A[m,n], window r, stride s --------------------------------

def mp_complexity(p: dict) -> float:
    return float(math.ceil(p["m"] / p["s"]) * math.ceil(p["n"] / p["s"])
                 * p["r"] ** 2)


def mp_sample(rng: np.random.RandomState) -> dict:
    r = int(rng.choice([2, 3, 4, 5]))
    s = int(rng.choice([1, 2]))
    m, n = rng.randint(r, 1025, size=2)
    d = _sample_density(rng, math.log2(max(m * n, 2)))
    return {"m": int(m), "n": int(n), "r": r, "s": s, "d": d}


# --- Dense factorizations (the paper's §4.2 "omitted kernels" family: it
# --- evaluated LU; we add Cholesky and QR, whose complexity functions play
# --- the same role and whose reference implementations are BLAS-backed) ----

def chol_complexity(p: dict) -> float:
    return float(p["n"] ** 3) / 3.0


def chol_sample(rng: np.random.RandomState) -> dict:
    return {"n": int(rng.randint(16, 1025))}


def qr_complexity(p: dict) -> float:
    m, n = p["m"], p["n"]
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3


def qr_sample(rng: np.random.RandomState) -> dict:
    m = int(rng.randint(16, 1025))
    n = int(rng.randint(16, m + 1))
    return {"m": m, "n": n}


# --- Blur (Halide demo, §6): 3x3 box blur with schedule knobs ---------------

def blur_complexity(p: dict) -> float:
    """3x3 box blur: nine additions per pixel of the [m, n] plane."""
    return float(p["m"] * p["n"] * 9)


def blur_sample(rng: np.random.RandomState) -> dict:
    m = int(rng.choice([256, 512, 768, 1024, 1536, 2048]))
    n = int(rng.choice([256, 512, 768, 1024, 1536, 2048]))
    return {"m": m, "n": n}


KERNELS: dict[str, KernelSpec] = {
    "mm": KernelSpec("mm", ("m", "n", "k", "d1", "d2"), mm_complexity, mm_sample),
    "mv": KernelSpec("mv", ("m", "n", "d"), mv_complexity, mv_sample),
    "mc": KernelSpec("mc", ("m", "n", "r", "d"), mc_complexity, mc_sample),
    "mp": KernelSpec("mp", ("m", "n", "r", "s", "d"), mp_complexity, mp_sample),
    "blur": KernelSpec("blur", ("m", "n"), blur_complexity, blur_sample),
    "chol": KernelSpec("chol", ("n",), chol_complexity, chol_sample),
    "qr": KernelSpec("qr", ("m", "n"), qr_complexity, qr_sample),
}


def feature_vector(kernel: str, params: dict, *,
                   n_threads: Optional[int] = None,
                   extra: Optional[dict] = None,
                   with_c: bool = True) -> np.ndarray:
    """K_i (+ H_i) (+ c) in a fixed order — the NN+C input layout (Fig 1)."""
    spec = KERNELS[kernel]
    feats = [float(params[k]) for k in spec.param_names]
    if n_threads is not None:
        feats.append(float(n_threads))
    if extra:
        feats.extend(float(v) for _, v in sorted(extra.items()))
    if with_c:
        feats.append(spec.complexity(params))
    return np.asarray(feats, dtype=np.float64)


def feature_names(kernel: str, *, cpu: bool = False,
                  extra: tuple = (), with_c: bool = True) -> list[str]:
    names = list(KERNELS[kernel].param_names)
    if cpu:
        names.append("n_threads")
    names.extend(extra)
    if with_c:
        names.append("c")
    return names
