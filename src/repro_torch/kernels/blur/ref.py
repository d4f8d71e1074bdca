"""Plain PyTorch 3x3 box blur (valid region): the nine shifted planes summed
in fp32, divided by 9, cast to a's type at the end."""
import torch


def blur(a: torch.Tensor) -> torch.Tensor:
    m, n = a.shape
    om, on = m - 2, n - 2
    a32 = a.float()
    acc = torch.zeros((om, on), dtype=torch.float32, device=a.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + a32[di:di + om, dj:dj + on]
    return (acc / 9.0).to(a.dtype)
