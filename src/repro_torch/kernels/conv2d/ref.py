"""Plain PyTorch version of the conv2d kernel: valid cross-correlation with
the taps in ``_conv_kernel``'s order (di outer, dj inner), fp32
accumulation, cast to a's type at the end."""
import torch


def conv2d(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m, n = a.shape
    r = w.shape[0]
    om, on = m - r + 1, n - r + 1
    a32, w32 = a.float(), w.float()
    acc = torch.zeros((om, on), dtype=torch.float32, device=a.device)
    for di in range(r):
        for dj in range(r):
            acc = acc + a32[di:di + om, dj:dj + on] * w32[di, dj]
    return acc.to(a.dtype)
