"""Calibrated simulated devices for the 40-combo portability matrix.

The paper's five platforms are stood in by roofline-style timing models
with per-device peaks/bandwidths matching the published hardware, Amdahl
thread scaling, kernel-launch overhead on GPUs, sparse/dense path
switching (the nonlinearity that makes MM-on-CPU the hardest table in the
paper), and multiplicative lognormal noise.  Deterministic per (combo,
instance, seed) — the *learning problem* NN+C faces is faithful even
though the seconds are synthetic.

The port's copy of the JAX package's ``perfdata.simulate``: the same
float64 numpy arithmetic in the same order, so the seconds are equal bit
for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.features import KERNELS


@dataclasses.dataclass(frozen=True)
class SimDevice:
    name: str
    kind: str                  # cpu | gpu
    peak_flops: float          # single-thread (cpu) or device (gpu) flop/s
    mem_bw: float              # bytes/s
    max_threads: int = 1
    parallel_frac: float = 0.9
    launch_overhead: float = 0.0
    noise_sigma: float = 0.05


# the paper's platforms (§4.1), public spec-sheet numbers
DEVICES = {
    "xeon": SimDevice("xeon", "cpu", 20.8e9, 59.7e9, max_threads=64,
                      parallel_frac=0.95, launch_overhead=2e-7),
    "i7": SimDevice("i7", "cpu", 35.2e9, 41.8e9, max_threads=24,
                    parallel_frac=0.92, launch_overhead=2e-7),
    "i5": SimDevice("i5", "cpu", 18.4e9, 34.1e9, max_threads=4,
                    parallel_frac=0.85, launch_overhead=2e-7),
    "tesla": SimDevice("tesla", "gpu", 4.29e12, 288e9,
                       launch_overhead=8e-6, noise_sigma=0.04),
    "quadro": SimDevice("quadro", "gpu", 300e9, 29e9,
                        launch_overhead=1.2e-5, noise_sigma=0.04),
}


@dataclasses.dataclass(frozen=True)
class SimVariant:
    name: str
    efficiency: float          # fraction of device peak achieved
    bw_factor: float           # effective bandwidth fraction
    threaded: bool             # honours N_thd
    sparse_aware: bool         # work scales with density below a threshold


VARIANTS = {
    "cpu": {
        "eigen": SimVariant("eigen", 0.60, 0.80, threaded=True,
                            sparse_aware=True),
        "boost": SimVariant("boost", 0.08, 0.35, threaded=False,
                            sparse_aware=True),
    },
    "gpu": {
        "cuda_global": SimVariant("cuda_global", 0.22, 0.55, threaded=False,
                                  sparse_aware=False),
        "cuda_shared": SimVariant("cuda_shared", 0.45, 0.95, threaded=False,
                                  sparse_aware=False),
    },
}


def _bytes(kernel: str, p: dict) -> float:
    if kernel == "mm":
        return 8.0 * (p["m"] * p["n"] + p["n"] * p["k"] + p["m"] * p["k"])
    if kernel == "mv":
        return 8.0 * (p["m"] * p["n"] + p["n"] + p["m"])
    if kernel in ("mc", "mp", "blur"):
        return 8.0 * 2 * p["m"] * p["n"]
    if kernel == "chol":
        return 8.0 * 2 * p["n"] * p["n"]
    if kernel == "qr":
        return 8.0 * (2 * p["m"] * p["n"] + p["n"] * p["n"])
    raise ValueError(kernel)


def _density_work(kernel: str, p: dict) -> float:
    """Eigen/Boost pick sparse paths below ~25% density; sparse ops cost ~3x
    per nonzero (index chasing) — the 4-codepath nonsmoothness of §5."""
    if kernel == "mm":
        d = p["d1"] * p["d2"]
    else:
        d = p.get("d", 1.0)
    if d >= 0.25:
        return 1.0
    return min(1.0, 3.0 * d + 1e-3)


def simulate_time(kernel: str, device: SimDevice, variant: SimVariant,
                  p: dict, n_threads: int, rng: np.random.RandomState) -> float:
    c = KERNELS[kernel].complexity(p)
    work = c * (_density_work(kernel, p) if variant.sparse_aware else 1.0)
    if device.kind == "cpu":
        thd = n_threads if variant.threaded else 1
        speedup = 1.0 / ((1 - device.parallel_frac)
                         + device.parallel_frac / max(thd, 1))
        flops_rate = device.peak_flops * variant.efficiency * speedup
    else:
        flops_rate = device.peak_flops * variant.efficiency
    t_compute = work / flops_rate
    t_mem = _bytes(kernel, p) / (device.mem_bw * variant.bw_factor)
    t = device.launch_overhead + max(t_compute, t_mem)
    t *= float(np.exp(rng.randn() * device.noise_sigma))
    return t
