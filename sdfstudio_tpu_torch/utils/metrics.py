"""Image quality metrics (counterpart of ``sdfstudio_tpu/utils/metrics.py``):
PSNR, SSIM and LPIPS on ``[H, W, C]`` images in [0, 1].

SSIM is the standard formulation with an 11-tap gaussian window of sigma
1.5 and VALID padding, as a depthwise ``conv2d``; C1 and C2 follow from
``data_range``. LPIPS (metrics.py:56-149) is JAX's VGG16 network over the
weights of an ``.npz`` (``SST_LPIPS_WEIGHTS``), as ``F.conv2d`` and
``max_pool2d``; without a weights file there is no LPIPS. The canonical
trained weights cannot be downloaded here: ``scripts/make_lpips_weights.py``
writes a seeded random-feature file, reported as ``lpips_rand``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

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


# VGG16's convolutions: (out channels, stage); the features are tapped after
# the relu that closes each stage (metrics.py:62-73)
_VGG16_PLAN = [
    (64, 0), (64, 0),
    (128, 1), (128, 1),
    (256, 2), (256, 2), (256, 2),
    (512, 3), (512, 3), (512, 3),
    (512, 4), (512, 4), (512, 4),
]
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

LpipsWeights = Tuple[List[Tuple[torch.Tensor, torch.Tensor]], List[torch.Tensor]]


def load_lpips_weights(path, device=None) -> LpipsWeights:
    """``conv{i}_w`` [kh, kw, cin, cout] and ``conv{i}_b`` [cout] for the 13
    convolutions, ``lin{s}`` [c_s] for the 5 heads (metrics.py:78-88); the
    kernels come back in ``conv2d``'s [cout, cin, kh, kw] layout."""
    data = np.load(path)
    convs = [(torch.from_numpy(np.ascontiguousarray(data[f"conv{i}_w"].transpose(3, 2, 0, 1))).to(device),
              torch.from_numpy(data[f"conv{i}_b"]).to(device)) for i in range(len(_VGG16_PLAN))]
    lins = [torch.from_numpy(data[f"lin{s}"]).to(device) for s in range(5)]
    return convs, lins


def lpips_metric_name(path) -> str:
    """"lpips" for trained weights, "lpips_rand" for a file stamped
    ``canonical=0`` (metrics.py:91-101)."""
    data = np.load(path)
    if "canonical" in data.files and int(np.asarray(data["canonical"])) == 0:
        return "lpips_rand"
    return "lpips"


def _vgg_taps(img: torch.Tensor, convs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    shift = torch.from_numpy(_LPIPS_SHIFT).to(img.device)
    scale = torch.from_numpy(_LPIPS_SCALE).to(img.device)
    x = ((img * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None]  # [1, C, H, W]
    taps, stage = [], 0
    for (w, b), (_, s) in zip(convs, _VGG16_PLAN):
        if s != stage:  # a stage boundary: tap, then a 2x2 max pool (VALID)
            taps.append(x)
            x = F.max_pool2d(x, 2)
            stage = s
        x = torch.relu(F.conv2d(x, w, b, padding=1))
    taps.append(x)
    return taps


@torch.no_grad()
def lpips(pred: torch.Tensor, target: torch.Tensor, weights: Optional[LpipsWeights] = None,
          weights_path: Optional[str] = None) -> Optional[torch.Tensor]:
    """LPIPS(VGG) between two [H, W, 3] images in [0, 1] (metrics.py:104-149);
    None when there are no weights (``weights``, ``weights_path``, or the
    file ``SST_LPIPS_WEIGHTS`` names)."""
    if weights is None:
        path = weights_path or os.environ.get("SST_LPIPS_WEIGHTS")
        if not path:
            return None
        weights = load_lpips_weights(path, pred.device)
    convs, lins = weights
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for a, b, lin in zip(_vgg_taps(pred.float(), convs), _vgg_taps(target.float(), convs), lins):
        # unit-normalise along the channels, squared difference, the 1x1 head
        an = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        bn = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((an - bn) ** 2 * lin[None, :, None, None], dim=1))
    return total
