"""Plain PyTorch version of the maxpool kernel: the strided running max over
the r x r window from -inf in fp32 (``torch.maximum`` propagates NaN, as
``jnp.maximum`` does), cast to a's type at the end."""
import torch


def maxpool(a: torch.Tensor, *, r: int, s: int) -> torch.Tensor:
    m, n = a.shape
    om, on = (m - r) // s + 1, (n - r) // s + 1
    a32 = a.float()
    acc = torch.full((om, on), -torch.inf, dtype=torch.float32,
                     device=a.device)
    for di in range(r):
        for dj in range(r):
            sub = a32[di:di + (om - 1) * s + 1:s, dj:dj + (on - 1) * s + 1:s]
            acc = torch.maximum(acc, sub)
    return acc.to(a.dtype)
