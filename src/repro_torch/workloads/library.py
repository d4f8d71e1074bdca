"""The workload definitions: the JAX package's five multi-kernel program
families.

Every factory returns ``(make, reference)`` over one shared set of input
tensors: ``make()`` records the program through ``repro_torch.api.ops``
under an active trace; ``reference()`` computes the identical outputs with
the kernels' plain versions and ``models.attention.attend_full`` — no
registry, no dispatch, no variants.
Inputs are drawn exactly as the JAX package draws them (same numpy calls,
float32 arithmetic), so with the same seed they are bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import ops
from repro_torch.kernels.blur import ref as blur_ref
from repro_torch.kernels.conv2d import ref as conv2d_ref
from repro_torch.kernels.matmul import ref as matmul_ref
from repro_torch.kernels.matvec import ref as matvec_ref
from repro_torch.kernels.maxpool import ref as maxpool_ref
from repro_torch.models.attention import attend_full


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
# image_pipeline: blur -> conv2d -> maxpool (the classic Halide pipeline)
# --------------------------------------------------------------------------

def _image_pipeline(p, rng, device):
    a = _arr(rng, device, p["m"], p["n"])
    w = _arr(rng, device, 3, 3)          # taps drawn as _arr, not _weight

    def make():
        x = ops.blur(a)
        y = ops.conv2d(x, w)
        return (ops.maxpool(y, r=2, s=2),)

    def reference():
        x = blur_ref.blur(a)
        y = conv2d_ref.conv2d(x, w)
        return (maxpool_ref.maxpool(y, r=2, s=2),)

    return make, reference


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
# attention_block: flash_attention + a parallel 2-matmul MLP branch
# --------------------------------------------------------------------------

def _attention_block(p, rng, device):
    b, s, h, dh = p["b"], p["s"], p["h"], p["dh"]
    q, k, v = (_arr(rng, device, b, s, h, dh) for _ in range(3))
    x = _arr(rng, device, s, p["e"])
    w1 = _weight(rng, device, p["e"], p["f"])
    w2 = _weight(rng, device, p["f"], p["e"])

    def make():
        attn = ops.attention(q, k, v)
        mlp = ops.matmul(ops.matmul(x, w1), w2)
        return (attn, mlp)

    def reference():
        attn = attend_full(q, k, v, causal=True)
        mlp = matmul_ref.matmul(matmul_ref.matmul(x, w1), w2)
        return (attn, mlp)

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


# --------------------------------------------------------------------------
# mixed_dag: a wide diamond of mixed kernels (multi-device overlap stress)
# --------------------------------------------------------------------------

def _mixed_dag(p, rng, device):
    n, width = p["n"], p["width"]
    a, b = _arr(rng, device, n, n), _arr(rng, device, n, n)
    ws = [_weight(rng, device, n, n) for _ in range(width)]

    def make():
        root = ops.matmul(a, b)
        branches = [ops.matmul(root, w) for w in ws]
        blurred = ops.blur(root)
        pooled = ops.maxpool(root, r=2, s=2)
        join = branches[0]
        for br in branches[1:]:
            join = ops.matmul(join, br)
        # root is an *interior* output — only reachable via mark_output
        return (join, blurred, pooled, root)

    def reference():
        root = matmul_ref.matmul(a, b)
        branches = [matmul_ref.matmul(root, w) for w in ws]
        blurred = blur_ref.blur(root)
        pooled = maxpool_ref.maxpool(root, r=2, s=2)
        join = branches[0]
        for br in branches[1:]:
            join = matmul_ref.matmul(join, br)
        return (join, blurred, pooled, root)

    return make, reference


# name -> (kernels used, size presets, factory); the presets and the order
# are the JAX package's
WORKLOAD_BUILDERS = {
    "image_pipeline": (
        ("blur", "conv2d", "maxpool"),
        {"small": {"m": 96, "n": 96},
         "medium": {"m": 384, "n": 384},
         "large": {"m": 1024, "n": 1024}},
        _image_pipeline),
    "mlp_block": (
        ("matmul",),
        {"small": {"b": 48, "d": 64, "h": 96, "depth": 3},
         "medium": {"b": 128, "d": 256, "h": 512, "depth": 4},
         "large": {"b": 256, "d": 1024, "h": 2048, "depth": 4}},
        _mlp_block),
    "attention_block": (
        ("flash_attention", "matmul"),
        {"small": {"b": 1, "s": 64, "h": 2, "dh": 8, "e": 64, "f": 96},
         "medium": {"b": 2, "s": 256, "h": 4, "dh": 16, "e": 256, "f": 512},
         "large": {"b": 4, "s": 512, "h": 8, "dh": 32, "e": 512,
                   "f": 1024}},
        _attention_block),
    "decode_microbatch": (
        ("matvec",),
        {"small": {"h": 192, "depth": 3, "chains": 2},
         "medium": {"h": 512, "depth": 4, "chains": 3},
         "large": {"h": 1024, "depth": 6, "chains": 4}},
        _decode_microbatch),
    "mixed_dag": (
        ("matmul", "blur", "maxpool"),
        {"small": {"n": 64, "width": 3},
         "medium": {"n": 192, "width": 4},
         "large": {"n": 384, "width": 6}},
        _mixed_dag),
}
