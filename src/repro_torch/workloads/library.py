"""The workload definitions of this slice: ``mlp_block`` and
``decode_microbatch``, the programs the matmul and matvec kernels carry.

Every factory returns ``(make, reference)`` over one shared set of input
tensors: ``make()`` records the program through ``repro_torch.api.ops``
under an active trace; ``reference()`` computes the identical outputs with
the kernels' plain versions — no registry, no dispatch, no variants.
Inputs are drawn exactly as the JAX package draws them (same numpy calls,
float32 arithmetic), so with the same seed they are bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import ops
from repro_torch.kernels.matmul import ref as matmul_ref
from repro_torch.kernels.matvec import ref as matvec_ref


def _np_arr(rng, *shape) -> np.ndarray:
    return (rng.rand(*shape) - 0.5).astype(np.float32)


def _arr(rng, device, *shape) -> torch.Tensor:
    return torch.from_numpy(_np_arr(rng, *shape)).to(device)


def _weight(rng, device, *shape) -> torch.Tensor:
    """Contraction operand scaled by 1/sqrt(fan_in): chained products keep
    O(1) magnitudes, so float32 accumulation error stays inside the suite's
    1e-5 parity budget instead of compounding with value growth."""
    w = _np_arr(rng, *shape) / np.sqrt(np.float32(shape[0]))
    return torch.from_numpy(w).to(device)


# --------------------------------------------------------------------------
# mlp_block: a chain of matmuls (d -> h -> d -> h -> ...)
# --------------------------------------------------------------------------

def _mlp_block(p, rng, device):
    b, d, h = p["b"], p["d"], p["h"]
    dims = [d if i % 2 == 0 else h for i in range(p["depth"] + 1)]
    x = _arr(rng, device, b, dims[0])
    ws = [_weight(rng, device, dims[i], dims[i + 1])
          for i in range(p["depth"])]

    def make():
        y = x
        for w in ws:
            y = ops.matmul(y, w)
        return (y,)

    def reference():
        y = x
        for w in ws:
            y = matmul_ref.matmul(y, w)
        return (y,)

    return make, reference


# --------------------------------------------------------------------------
# decode_microbatch: matvec-heavy — independent per-request layer chains
# --------------------------------------------------------------------------

def _decode_microbatch(p, rng, device):
    h, depth, chains = p["h"], p["depth"], p["chains"]
    xs = [_arr(rng, device, h) for _ in range(chains)]
    ws = [[_weight(rng, device, h, h) for _ in range(depth)]
          for _ in range(chains)]

    def make():
        outs = []
        for x, chain in zip(xs, ws):
            y = x
            for w in chain:
                y = ops.matvec(w, y)
            outs.append(y)
        return tuple(outs)

    def reference():
        outs = []
        for x, chain in zip(xs, ws):
            y = x
            for w in chain:
                y = matvec_ref.matvec(w, y)
            outs.append(y)
        return tuple(outs)

    return make, reference


# name -> (kernels used, size presets, factory); the presets are the JAX
# package's
WORKLOAD_BUILDERS = {
    "mlp_block": (
        ("matmul",),
        {"small": {"b": 48, "d": 64, "h": 96, "depth": 3},
         "medium": {"b": 128, "d": 256, "h": 512, "depth": 4},
         "large": {"b": 256, "d": 1024, "h": 2048, "depth": 4}},
        _mlp_block),
    "decode_microbatch": (
        ("matvec",),
        {"small": {"h": 192, "depth": 3, "chains": 2},
         "medium": {"h": 512, "depth": 4, "chains": 3},
         "large": {"h": 1024, "depth": 6, "chains": 4}},
        _decode_microbatch),
}
