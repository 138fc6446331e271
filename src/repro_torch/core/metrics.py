"""Image quality metrics."""
from __future__ import annotations

import torch


def psnr(img: torch.Tensor, ref: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))
