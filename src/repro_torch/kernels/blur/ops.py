"""Public blur op and the host schedule variants the registry dispatches.

``HOST_SCHEDULES`` are the JAX package's five jnp blur schedules written
as PyTorch ops: each computes the same 3x3 box mean by another route
(fused, separable, one library convolution, row blocks), so they differ
only in time, which is what the NN+C selector learns.  On a card they run
as PyTorch's own CUDA kernels, as the jnp schedules ran as XLA's.

``blur(use_kernel=True)`` runs the hand-written blur kernels
(``csrc/blur.cu``, the port of the Pallas ``blur`` kernels) at tile (bm, bn),
fused or separable, on a CUDA tensor, and their plain version on a CPU
tensor; ``use_kernel=False`` is the plain blur.  No dispatch path reaches
the kernels: the registry's blur variants are the host schedules, as in the
JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import Aval, cudnn_fp32
from repro_torch.kernels.blur import blur as _kernel
from repro_torch.kernels.blur import ref as _ref


def abstract_params(a) -> dict:
    """Predictor params from avals (shape-only; see kernels/matmul/ops.py)."""
    m, n = a.shape
    return {"m": int(m), "n": int(n)}


def out_aval(a) -> Aval:
    return Aval((a.shape[0] - 2, a.shape[1] - 2), a.dtype)


def blur(a: torch.Tensor, *, bm: int = 128, bn: int = 128,
         separable: bool = False, use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel=False`` is the plain blur; otherwise the hand kernels at
    tile (bm, bn), fused or separable.  The kernels mask their ragged edge,
    so unlike the JAX op nothing is padded."""
    if not use_kernel:
        return _ref.blur(a)
    return _kernel.blur(a, bm=bm, bn=bn, separable=separable)


# --- host schedule variants --------------------------------------------------

def _host_direct(a):
    return _ref.blur(a)


def _host_separable(a):
    m, n = a.shape
    h = (a[:, 0:n - 2] + a[:, 1:n - 1] + a[:, 2:n]).float() / 3.0
    v = (h[0:m - 2] + h[1:m - 1] + h[2:m]) / 3.0
    return v.to(a.dtype)


def _host_conv(a):
    k = torch.ones((3, 3), dtype=a.dtype, device=a.device) / 9.0
    with cudnn_fp32():
        return F.conv2d(a[None, None], k[None, None])[0, 0]


def _host_blocked(a, tile):
    m, n = a.shape
    om, on = m - 2, n - 2
    nb = max(1, om // tile)
    rows = []
    for i in range(nb):
        r0 = i * (om // nb)
        r1 = om if i == nb - 1 else (i + 1) * (om // nb)
        rows.append(_ref.blur(a[r0:r1 + 2]))
    return torch.cat(rows, dim=0)


HOST_SCHEDULES = {
    "direct": _host_direct,
    "separable": _host_separable,
    "conv": _host_conv,
    "blocked64": lambda a: _host_blocked(a, 64),
    "blocked256": lambda a: _host_blocked(a, 256),
}

# schedule feature encoding for the NN+C selector: (sep, conv, n_blocks)
SCHEDULE_FEATURES = {
    "direct": (0.0, 0.0, 1.0),
    "separable": (1.0, 0.0, 1.0),
    "conv": (0.0, 1.0, 1.0),
    "blocked64": (0.0, 0.0, 64.0),
    "blocked256": (0.0, 0.0, 256.0),
}
