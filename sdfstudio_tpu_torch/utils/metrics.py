"""Image quality metrics (counterpart of ``sdfstudio_tpu/utils/metrics.py:14-53``):
PSNR and SSIM on ``[H, W, C]`` images in [0, 1].

SSIM is the standard formulation with an 11-tap gaussian window of sigma
1.5 and VALID padding, as a depthwise ``conv2d``; C1 and C2 follow from
``data_range``. LPIPS is not ported: it needs pretrained weights the
repository does not hold.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """metrics.py:14-16."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """metrics.py:19-22: built in float64, stored in f32."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred: torch.Tensor, target: torch.Tensor, kernel_size: int = 11, sigma: float = 1.5,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM with a gaussian window (metrics.py:25-53)."""
    C = pred.shape[-1]
    x = pred.permute(2, 0, 1)[None]  # [1, C, H, W]
    y = target.permute(2, 0, 1)[None]
    k = torch.from_numpy(_gaussian_window(kernel_size, sigma)).to(pred.device)
    kernel = k[None, None].expand(C, 1, kernel_size, kernel_size)

    def conv(v):
        return F.conv2d(v, kernel, groups=C)

    mu_x, mu_y = conv(x), conv(y)
    sigma_x = conv(x * x) - mu_x**2
    sigma_y = conv(y * y) - mu_y**2
    sigma_xy = conv(x * y) - mu_x * mu_y
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x**2 + mu_y**2 + C1) * (sigma_x + sigma_y + C2)
    return torch.mean(num / den)
