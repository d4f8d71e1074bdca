"""Plain PyTorch version of the matmul kernel: fp32 accumulation, cast to
the operands' type at the end (what ``_mm_kernel`` computes)."""
import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)
