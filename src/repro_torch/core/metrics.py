"""Image quality metrics (PSNR / SSIM)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(img: torch.Tensor, ref: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img - ref) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def ssim(img: torch.Tensor, ref: torch.Tensor, data_range: float = 1.0,
         win: int = 7) -> torch.Tensor:
    """Mean SSIM with a uniform window (channels averaged)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def filt(x):  # (H, W, C) -> uniform window means, valid positions only
        y = F.avg_pool2d(x.movedim(-1, 0)[:, None], win, stride=1)
        return y[:, 0].movedim(0, -1)

    mu_x, mu_y = filt(img), filt(ref)
    sxx = filt(img * img) - mu_x ** 2
    syy = filt(ref * ref) - mu_y ** 2
    sxy = filt(img * ref) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return torch.mean(num / den)
