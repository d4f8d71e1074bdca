"""Variant registry for predictor-driven dispatch: the port's kernels.

A ``Variant`` is (name, call, features, flops): ``features(params)`` is the
NN+C input row *without* c — the variant axis (block size, hand kernel or
library) is encoded as trailing feature columns so one per-kernel model
ranks all variants — and ``flops(params)`` is the analytic operation count,
the paper's ``c`` augmentation, appended as the last column by
``KernelRegistry.feature_rows``.

Variant and feature names are persisted data: they are the JAX package's,
so fitted cache entries move between the two packages.  In the port,
``pallas_<blk>`` names the hand-written CUDA kernel at that output tile
(on a CPU tensor, its plain version), and ``ref`` is the library path,
``torch.matmul``/``torch.mv``/``F.conv2d``/``F.max_pool2d`` in fp32 — the
counterpart of the jnp path XLA compiled.  The blur variants are the host
schedules of ``kernels.blur.ops``, torch-op schedules as the JAX ones are
jnp.  The ``flash_attention`` variants are, as in the JAX package,
``models.attention``'s ``attend_full`` and ``attend_chunked`` over the
(q_chunk, k_chunk) schedule axis, plain torch ops; the hand flash-attention
kernels run through ``kernels.flash_attention.ops.attention``, the
differentiable op, not through dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.features import blur_complexity
from repro_torch.kernels import Aval


def attention_flops(b: int, h: int, s: int, d: int) -> float:
    """Analytic c for one causal attention call (qk^T + pv)."""
    return 4.0 * b * h * s * s * d


# The chunked-attention (q_chunk, k_chunk) schedule axis, the JAX package's:
# ATTENTION_SCHEDULE_GRID is the full measurement sweep of its autotuner;
# ATTENTION_SCHEDULES is the curated subset the dispatcher ranks at run time.
ATTENTION_SCHEDULE_GRID = tuple((q, k) for q in (64, 128, 256, 512)
                                for k in (128, 256, 512, 1024))
ATTENTION_SCHEDULES = ((128, 256), (256, 512), (512, 1024))


@dataclasses.dataclass(frozen=True)
class Variant:
    kernel: str
    name: str
    call: Callable          # call(args: tuple, params: dict) -> tensor
    features: Callable      # features(params) -> list[float]  (no c)
    flops: Callable         # flops(params) -> float  (the c augmentation)


@dataclasses.dataclass(frozen=True)
class RegisteredKernel:
    name: str
    params_of: Callable     # params_of(*args, **kwargs) -> dict
    feature_names: tuple    # column names, c excluded (it is always last)
    variants: tuple
    # the uniform abstract hooks: shape-only derivations so the tracer can
    # build predictor features and output avals without executing
    abstract_params: Optional[Callable] = None  # (*avals, **kw) -> params
    out_aval: Optional[Callable] = None         # (*avals, **kw) -> Aval


class KernelRegistry:
    def __init__(self):
        self._kernels: dict[str, RegisteredKernel] = {}

    def register(self, rk: RegisteredKernel) -> None:
        if rk.name in self._kernels:
            raise ValueError(f"kernel {rk.name!r} already registered")
        if not rk.variants:
            raise ValueError(f"kernel {rk.name!r} has no variants")
        self._kernels[rk.name] = rk

    def get(self, kernel: str) -> RegisteredKernel:
        if kernel not in self._kernels:
            raise KeyError(f"unknown kernel {kernel!r}; registered: "
                           f"{sorted(self._kernels)}")
        return self._kernels[kernel]

    def kernels(self) -> list[str]:
        return sorted(self._kernels)

    def variants(self, kernel: str) -> tuple:
        return self.get(kernel).variants

    def variant_names(self, kernel: str) -> list[str]:
        return [v.name for v in self.get(kernel).variants]

    def params_of(self, kernel: str, *args, **kwargs) -> dict:
        return self.get(kernel).params_of(*args, **kwargs)

    def abstract_params(self, kernel: str, *avals, **kwargs) -> dict:
        """Predictor params from abstract values (anything with .shape)."""
        rk = self.get(kernel)
        if rk.abstract_params is None:
            raise NotImplementedError(
                f"kernel {kernel!r} registered without an abstract_params "
                "hook; it cannot be traced")
        return rk.abstract_params(*avals, **kwargs)

    def out_aval(self, kernel: str, *avals, **kwargs) -> Aval:
        """Output shape/dtype from abstract values, without executing."""
        rk = self.get(kernel)
        if rk.out_aval is None:
            raise NotImplementedError(
                f"kernel {kernel!r} registered without an out_aval hook; "
                "it cannot be traced")
        return rk.out_aval(*avals, **kwargs)

    def feature_rows(self, kernel: str, params: dict) -> np.ndarray:
        """[n_variants, F+1] candidate matrix, c as the LAST column."""
        rk = self.get(kernel)
        rows = [list(v.features(params)) + [v.flops(params)]
                for v in rk.variants]
        return np.asarray(rows, dtype=np.float64)


# --------------------------------------------------------------------------
# Default registry: the port's kernels
# --------------------------------------------------------------------------

def _matmul() -> RegisteredKernel:
    from repro_torch.kernels.matmul import ops

    flops = lambda p: 2.0 * p["m"] * p["n"] * p["k"]

    def feat(block, pallas):
        return lambda p: [p["m"], p["n"], p["k"], block, pallas]

    variants = [Variant("matmul", "ref",
                        lambda args, p: ops.matmul(*args, use_kernel=False),
                        feat(0.0, 0.0), flops)]
    for blk in (32, 128):
        # the hand kernel's output tile is blk x blk; bk=32 names the
        # schedule (matmul.SCHEDULES)
        variants.append(Variant(
            "matmul", f"pallas_{blk}",
            lambda args, p, _b=blk: ops.matmul(*args, bm=_b, bn=_b, bk=32),
            feat(float(blk), 1.0), flops))
    return RegisteredKernel("matmul", ops.abstract_params,
                            ("m", "n", "k", "block", "pallas"),
                            tuple(variants),
                            abstract_params=ops.abstract_params,
                            out_aval=ops.out_aval)


def _matvec() -> RegisteredKernel:
    from repro_torch.kernels.matvec import ops

    flops = lambda p: 2.0 * p["m"] * p["k"]

    def feat(block, pallas):
        return lambda p: [p["m"], p["k"], block, pallas]

    # the port has one hand matvec schedule (1 or 2 warps a row, chosen by
    # the kernel from the shape); it keeps the
    # JAX package's variant name and its block feature of 128, the Pallas
    # variant's bm=bk=128, so fitted states carry over
    return RegisteredKernel(
        "matvec", ops.abstract_params, ("m", "k", "block", "pallas"),
        (Variant("matvec", "ref",
                 lambda args, p: ops.matvec(*args, use_kernel=False),
                 feat(0.0, 0.0), flops),
         Variant("matvec", "pallas_128", lambda args, p: ops.matvec(*args),
                 feat(128.0, 1.0), flops)),
        abstract_params=ops.abstract_params, out_aval=ops.out_aval)


def _conv2d() -> RegisteredKernel:
    from repro_torch.kernels.conv2d import ops

    flops = lambda p: 2.0 * (p["m"] - p["r"] + 1) * (p["n"] - p["r"] + 1) \
        * p["r"] ** 2

    def feat(block, pallas):
        return lambda p: [p["m"], p["n"], p["r"], block, pallas]

    return RegisteredKernel(
        "conv2d", ops.abstract_params, ("m", "n", "r", "block", "pallas"),
        (Variant("conv2d", "ref",
                 lambda args, p: ops.conv2d(*args, use_kernel=False),
                 feat(0.0, 0.0), flops),
         Variant("conv2d", "pallas_32",
                 lambda args, p: ops.conv2d(*args, bm=32, bn=32),
                 feat(32.0, 1.0), flops)),
        abstract_params=ops.abstract_params, out_aval=ops.out_aval)


def _maxpool() -> RegisteredKernel:
    from repro_torch.kernels.maxpool import ops

    # the JAX registry's form, not core.features' mp_complexity
    flops = lambda p: float((p["m"] // p["s"]) * (p["n"] // p["s"])
                            * p["r"] ** 2)

    def feat(block, pallas):
        return lambda p: [p["m"], p["n"], p["r"], p["s"], block, pallas]

    return RegisteredKernel(
        "maxpool", ops.abstract_params, ("m", "n", "r", "s", "block", "pallas"),
        (Variant("maxpool", "ref",
                 lambda args, p: ops.maxpool(args[0], r=p["r"], s=p["s"],
                                             use_kernel=False),
                 feat(0.0, 0.0), flops),
         Variant("maxpool", "pallas_32",
                 lambda args, p: ops.maxpool(args[0], r=p["r"], s=p["s"],
                                             bm=32, bn=32),
                 feat(32.0, 1.0), flops)),
        abstract_params=ops.abstract_params, out_aval=ops.out_aval)


def _blur() -> RegisteredKernel:
    from repro_torch.kernels.blur import ops

    variants = []
    for sched, fn in ops.HOST_SCHEDULES.items():
        variants.append(Variant(
            "blur", sched, lambda args, p, _f=fn: _f(args[0]),
            lambda p, _x=ops.SCHEDULE_FEATURES[sched]: [p["m"], p["n"], *_x],
            blur_complexity))
    return RegisteredKernel("blur", ops.abstract_params,
                            ("m", "n", "separable", "conv", "n_blocks"),
                            tuple(variants),
                            abstract_params=ops.abstract_params,
                            out_aval=ops.out_aval)


def _flash_attention() -> RegisteredKernel:
    from repro_torch.models.attention import attend_chunked, attend_full

    # this variant set is built over models.attention ([B, S, H, D] layout),
    # so its abstract hooks live here, not in kernels/flash_attention/ops.py
    # (whose entry point is [B, H, S, D])
    def abstract_params(q, k, v):
        b, s, h, d = q.shape
        return {"b": int(b), "h": int(h), "s": int(s), "d": int(d)}

    def out_aval(q, k, v):
        return Aval(tuple(q.shape), q.dtype)

    flops = lambda p: attention_flops(p["b"], p["h"], p["s"], p["d"])

    def feat(qc, kc):
        # qc/kc == 0 encodes "no tiling" (the full reference path)
        return lambda p: [p["b"], p["h"], p["s"], p["d"],
                          qc or p["s"], kc or p["s"]]

    variants = [Variant("flash_attention", "full",
                        lambda args, p: attend_full(*args, causal=True),
                        feat(0, 0), flops)]
    for qc, kc in ATTENTION_SCHEDULES:
        variants.append(Variant(
            "flash_attention", f"chunked_q{qc}_k{kc}",
            lambda args, p, _qc=qc, _kc=kc: attend_chunked(
                *args, causal=True, q_chunk=_qc, k_chunk=_kc),
            feat(qc, kc), flops))
    return RegisteredKernel("flash_attention", abstract_params,
                            ("b", "h", "s", "d", "q_chunk", "k_chunk"),
                            tuple(variants),
                            abstract_params=abstract_params,
                            out_aval=out_aval)


# in the JAX package's order
_BUILDERS = {
    "matmul": _matmul,
    "matvec": _matvec,
    "conv2d": _conv2d,
    "maxpool": _maxpool,
    "blur": _blur,
    "flash_attention": _flash_attention,
}


def default_registry(include: Sequence[str] = ()) -> KernelRegistry:
    """Registry over the port's kernels; ``include`` restricts the set."""
    reg = KernelRegistry()
    for name, build in _BUILDERS.items():
        if include and name not in include:
            continue
        reg.register(build())
    return reg
