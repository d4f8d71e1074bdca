"""Dataset assembly: 500 instances per kernel-variant-hardware combo.

The paper's protocol (§4.2): sample Table 2 parameter ranges, measure (or
simulate) the execution time, split 250 train / 250 test.  Features carry
``c`` as the LAST column (``nnc.slice_features`` peels it for baselines).
Generated datasets are cached under results/perfdata/, in the JAX
package's file format and names, so a cache file written by either package
loads in the other.

The port's copy of the JAX package's ``perfdata.datasets``, plus the card
combos (``card_combos``): the reference only simulates its GPUs, the port
measures the registry's variants of the paper's four kernels on a CUDA
card.  Their keys end in ``|cuda``, a device name no reference combo uses,
and their cache files also carry the card's fingerprint and the kernel
library's build hash (``card_stamp``).
An instance's seed is the reference's, ``hash(combo.key)`` included: the
draws match the JAX package's within one process, and across processes
``PYTHONHASHSEED`` decides them, in both packages alike.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from repro_torch.core.features import KERNELS, feature_names, feature_vector
from repro_torch.kernels import resolve_device
from repro_torch.kernels.build import library_path
from repro_torch.perfdata import measure as measure_mod
from repro_torch.perfdata import simulate as sim_mod
from repro_torch.runtime.fingerprint import current_fingerprint

PAPER_KERNELS = ("mm", "mv", "mc", "mp")
# the paper's §4.2 "other kernels evaluated, omitted for brevity" family:
# dense factorizations with known complexity functions
EXTRA_KERNELS = ("chol", "qr")
CARD = "cuda"                  # the device name of the card combos


@dataclasses.dataclass(frozen=True)
class Combo:
    kernel: str
    variant: str
    device: str                # simulated device name, "host" or "cuda"
    simulated: bool

    @property
    def key(self) -> str:
        return f"{self.kernel}|{self.variant}|{self.device}"

    @property
    def is_cpu(self) -> bool:
        return self.device in ("host", "xeon", "i7", "i5")


def paper_combos() -> list[Combo]:
    """The 40 simulated combos of the paper: 4 kernels x (2 variants x 3
    CPUs + 2 variants x 2 GPUs)."""
    combos = []
    for kernel in PAPER_KERNELS:
        for dev in ("xeon", "i7", "i5"):
            for var in ("eigen", "boost"):
                combos.append(Combo(kernel, var, dev, simulated=True))
        for dev in ("tesla", "quadro"):
            for var in ("cuda_global", "cuda_shared"):
                combos.append(Combo(kernel, var, dev, simulated=True))
    return combos


def host_combos() -> list[Combo]:
    """The 8 measured anchor combos (real wall-clock on the host)."""
    out = []
    for kernel in PAPER_KERNELS:
        for var in measure_mod.HOST_VARIANTS[kernel]:
            out.append(Combo(kernel, var, "host", simulated=False))
    return out


def card_combos(device="cuda") -> list[Combo]:
    """The 9 measured card combos: every registry variant of the paper's
    four kernels (``measure.card_variants``), timed on the current CUDA
    device.  Raises for a device that is not a card."""
    if resolve_device(device).type != "cuda":
        raise ValueError(f"card combos are measured on a CUDA device, not "
                         f"{device!r}")
    return [Combo(kernel, var, CARD, simulated=False)
            for kernel in PAPER_KERNELS
            for var in measure_mod.card_variants(kernel)]


def extra_combos() -> list[Combo]:
    """Omitted-kernels appendix: Cholesky/QR, measured + one sim device each."""
    out = []
    for kernel in EXTRA_KERNELS:
        for var in measure_mod.HOST_VARIANTS[kernel]:
            out.append(Combo(kernel, var, "host", simulated=False))
        for dev, var in (("xeon", "eigen"), ("tesla", "cuda_shared")):
            out.append(Combo(kernel, var, dev, simulated=True))
    return out


def card_stamp(combo: Combo) -> Optional[str]:
    """What a card combo's timings hang on besides its key: the card's
    fingerprint and the build of its kernel's library.  None for the
    reference's combos, whose timings hang on the key alone."""
    if combo.device != CARD:
        return None
    lib = library_path(measure_mod.CARD_KERNELS[combo.kernel][0]).stem
    return f"{current_fingerprint(CARD).key}-{lib.rsplit('-', 1)[1]}"


def instance_rng(combo: Combo, seed: int = 0) -> np.random.RandomState:
    """The generator of a combo's instances, seeded as the reference's."""
    return np.random.RandomState(seed * 7919 + hash(combo.key) % 100003)


def generate(combo: Combo, n: int = 500, seed: int = 0,
             cache_dir: Optional[str] = "results/perfdata"
             ) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Returns (X [n, F] with c last, y [n] seconds, feature names).  A
    card combo's cache file is named by its ``card_stamp`` too, so another
    card or another build of its kernel measures anew."""
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        stamp = card_stamp(combo)
        name = combo.key.replace('|', '_') + (f"_{stamp}" if stamp else "")
        cache = os.path.join(cache_dir, f"{name}_{n}_{seed}.npz")
        if os.path.exists(cache):
            z = np.load(cache, allow_pickle=True)
            return z["X"], z["y"], list(z["names"])

    rng = instance_rng(combo, seed)
    spec = KERNELS[combo.kernel]
    threaded = combo.is_cpu
    if combo.simulated:
        device = sim_mod.DEVICES[combo.device]
        variant = sim_mod.VARIANTS[device.kind][combo.variant]
        max_thd = device.max_threads if variant.threaded else 1
    else:
        max_thd = 1                      # host measurements are single-proc
    on = None if combo.device == "host" else combo.device
    X, y = [], []
    for _ in range(n):
        p = spec.sample(rng)
        nthd = int(rng.randint(1, max_thd + 1)) if threaded else None
        X.append(feature_vector(combo.kernel, p, n_threads=nthd))
        if combo.simulated:
            y.append(sim_mod.simulate_time(combo.kernel, device, variant, p,
                                           nthd or 1, rng))
        else:
            y.append(measure_mod.measure_instance(combo.kernel, combo.variant,
                                                  p, rng, device=on))
    X = np.asarray(X)
    y = np.asarray(y)
    names = feature_names(combo.kernel, cpu=threaded)
    if cache:
        np.savez(cache, X=X, y=y, names=np.asarray(names, dtype=object))
    return X, y, names


def train_test_split(X: np.ndarray, y: np.ndarray, n_train: int = 250):
    return (X[:n_train], y[:n_train]), (X[n_train:], y[n_train:])
