"""Shared kernel pieces: the abstract-value contract and the backend rule.

The rule replaces the JAX package's ``default_interpret``: there a Pallas
kernel ran compiled on an accelerator and interpreted on the CPU.  Here a
wrapper launches its hand-written CUDA kernel for tensors on a CUDA device
and takes its plain PyTorch version for tensors on the CPU.  There is no
third path: any other device raises, and a failed build or launch raises
rather than dropping to the plain version.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build


class Aval(NamedTuple):
    """Shape/dtype abstract value for the ``abstract_params``/``out_aval``
    hooks every ``ops.py`` entry point exposes.  The hooks only ever read
    ``.shape`` and ``.dtype``, so tensors, lazy traced values and these
    Avals are interchangeable inputs."""
    shape: tuple
    dtype: object


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on one CUDA device (launch the kernel),
    False when they lie on the CPU (take the plain version)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {device}: operands must lie on "
                     "a CUDA device or on the CPU")


def cuda_index(a: torch.Tensor, b: torch.Tensor) -> int:
    """``on_cuda`` for a pair of operands, as the lean launch path needs
    it: the index of the CUDA device both lie on, or -1 when both lie on
    the CPU; anything else raises as ``on_cuda`` does.  The common case
    reads two flags and two indices and builds no set."""
    if a.is_cuda and b.is_cuda:
        index = a.get_device()
        if b.get_device() == index:
            return index
    return a.get_device() if on_cuda(a, b) else -1


class Entry:
    """One C entry point of a kernel library, bound at its first call and
    kept: a launch pays no library lookup and no signature set-up.  The
    entry takes the device index and does its own device guard (one
    ``cudaGetDevice`` when the device is current already), so the caller
    enters no context manager.  A caller calls ``fn`` itself (``entry.fn
    or entry.bind()``: no Python call of its own on a launch) and passes a
    non-zero return to ``fail``, which raises."""

    def __init__(self, library: str, name: str, argtypes: list,
                 what: str) -> None:
        self.library, self.name, self.what = library, name, what
        self.argtypes = argtypes
        self.fn = None

    def bind(self):
        # set here too: a library loaded for another entry point has not
        # had this one's signature set
        fn = getattr(self._lib(), self.name)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        self.fn = fn
        return fn

    def fail(self, code: int) -> None:
        build.check(self._lib(), code, self.what)

    def _lib(self):
        return build.load(self.library, {self.name: self.argtypes})


class Window(NamedTuple):
    """Launch geometry of a window kernel (blur, maxpool, conv2d;
    ``csrc/window.cuh``).  ``load_bytes`` 16 or 8 takes the vector path,
    where a thread owns one load packet of columns and walks ``rows`` output
    rows, and blocks are one row of ``threads`` threads; 0 takes the staged
    path, one block per output tile (``threads``, ``rows`` and
    ``store_bytes`` 0)."""
    load_bytes: int
    store_bytes: int
    threads: int
    rows: int
    blocks: int

    def config(self, dtype: int, tile: int) -> int:
        """The packed launch configuration the C entries decode
        (``repro::Config``), less the device index, which the caller ors in
        at bit 48."""
        return (dtype | self.load_bytes << 8 | self.store_bytes << 16
                | self.rows << 24 | (self.threads // 32) << 32 | tile << 40)


# blocks a window kernel's vector path launches at least, where the plane
# allows: several for each of an H100's 132 SMs
FILL_BLOCKS = 4 * 132


def packet_bytes(ptr: int, row_bytes: int) -> int:
    """The widest load packet, 16 or 8 bytes, on which a plane at address
    ``ptr`` with rows of ``row_bytes`` starts every row; 0 when neither
    fits."""
    for size in (16, 8):
        if not (ptr | row_bytes) & (size - 1):
            return size
    return 0


def store_bytes(ptr: int, row_bytes: int, most: int) -> int:
    """The widest power-of-two store packet, at most ``most`` bytes, on
    which every output row at ``ptr`` starts; 4-byte words at least, else 1
    (one element at a time)."""
    size = most
    while size >= 4:
        if not (ptr | row_bytes) & (size - 1):
            return size
        size //= 2
    return 1


def strips(out_rows: int, groups: int, threads: int, rows: int) -> tuple:
    """(threads, rows, blocks) of a vector-path launch whose thread groups
    (one packet each) span ``groups`` a row over ``out_rows`` output rows:
    blocks at most ``threads`` wide, a thread walking at most ``rows`` rows,
    halved (down to 1) until the grid reaches FILL_BLOCKS."""
    threads = min(threads, -(-groups // 32) * 32)
    across = -(-groups // threads)
    while rows > 1 and across * -(-out_rows // rows) < FILL_BLOCKS:
        rows //= 2
    return threads, rows, across * -(-out_rows // rows)


def device_guard(tensor: torch.Tensor):
    """Context that makes ``tensor``'s card the current device for a
    launch; a no-op when it already is (the common case, kept cheap)."""
    index = tensor.get_device()
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def launch_stream(tensor: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream on ``tensor``'s device — the
    stream a kernel launches on.  ``torch.cuda.current_stream()`` builds a
    Python stream object per call, a host cost of the same order as a
    small kernel's whole device time."""
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


_CUDNN_FLAGS = threading.RLock()


@contextlib.contextmanager
def cudnn_fp32():
    """Run cuDNN convolutions in full fp32 inside the block.  PyTorch lets
    cuDNN round fp32 convolution inputs to TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), about 1e-3 relative,
    far outside the workloads' 1e-5 budget; the port's library paths pin
    it off here, locally, and restore the caller's setting after.  The
    flag is process-wide, so one thread at a time holds the block: a
    second thread's exit cannot restore TF32 under the first's call."""
    with _CUDNN_FLAGS:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point creates tensors on.  Entry points default
    to ``cuda``; without a card they raise instead of running on the CPU,
    which a caller must ask for with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the host")
    return device
