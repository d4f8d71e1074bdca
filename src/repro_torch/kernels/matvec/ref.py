"""Plain PyTorch version of the matvec kernel: x cast to a's type, fp32
accumulation, the result cast to a's type (what ``_mv_kernel`` computes)."""
import torch


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.mv(a.float(), x.to(a.dtype).float()).to(a.dtype)
