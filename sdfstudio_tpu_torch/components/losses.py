"""Training losses of the ported methods (counterpart of
``sdfstudio_tpu/components/losses.py``): rgb L1, eikonal, the zip-NeRF
interlevel loss with its step-function blur, the foreground-mask BCE and
Neuralangelo's curvature loss.
Weights are [R, S] (no trailing channel), as in the JAX package."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from sdfstudio_tpu_torch.core.math import searchsorted_right


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """losses.py:23-24."""
    return torch.mean(torch.abs(pred - target))


def eikonal_loss(gradients: torch.Tensor) -> torch.Tensor:
    """((|grad| - 1)^2).mean() over all sample gradients (losses.py:31-34)."""
    return torch.mean((torch.linalg.vector_norm(gradients, dim=-1) - 1.0) ** 2)


def ray_samples_to_sdist(ray_samples) -> torch.Tensor:
    """[R, S+1] bin edges in normalised s-space (losses.py:42-46)."""
    return torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], -1)


def blur_stepfun(x: torch.Tensor, y: torch.Tensor, r: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step function (edges x [R, N+1], values y [R, N]) convolved with a
    box of radius r (losses.py:86-103)."""
    x_c = torch.cat([x - r, x + r], -1)
    x_idx = torch.argsort(x_c, dim=-1, stable=True)
    x_r = torch.gather(x_c, -1, x_idx)
    zeros = torch.zeros_like(y[..., :1])
    y_1 = (torch.cat([y, zeros], -1) - torch.cat([zeros, y], -1)) / (2 * r)
    y_2 = torch.gather(torch.cat([y_1, -y_1], -1), -1, x_idx[..., :-1])
    y_r = torch.cumsum((x_r[..., 1:] - x_r[..., :-1]) * torch.cumsum(y_2, -1), -1)
    return x_r, torch.cat([zeros, y_r], -1)


def interlevel_loss_zip(
    weights_list: Sequence[torch.Tensor], ray_samples_list,
    blur_radii: Sequence[float] = (0.03, 0.003),
) -> torch.Tensor:
    """Zip-NeRF anti-aliased proposal loss (losses.py:106-136): the final
    weights, blurred and integrated, bound each proposal level's weights;
    only the proposal weights carry a gradient."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1].detach()
    w_normalize = w / (c[..., 1:] - c[..., :-1])
    loss = 0.0
    for ray_samples, weights, r in zip(ray_samples_list[:-1], weights_list[:-1], blur_radii):
        x_r, y_r = blur_stepfun(c, w_normalize, r)
        y_r = torch.clamp(y_r, min=0.0)
        y_cum = torch.cumsum((y_r[..., 1:] + y_r[..., :-1]) * 0.5 * (x_r[..., 1:] - x_r[..., :-1]), -1)
        y_cum = torch.cat([torch.zeros_like(y_cum[..., :1]), y_cum], -1)
        cp = ray_samples_to_sdist(ray_samples)
        inds = searchsorted_right(x_r, cp)
        below = torch.clamp(inds - 1, 0, x_r.shape[-1] - 1)
        above = torch.clamp(inds, 0, x_r.shape[-1] - 1)
        x_g0, y_g0 = torch.gather(x_r, -1, below), torch.gather(y_cum, -1, below)
        x_g1, y_g1 = torch.gather(x_r, -1, above), torch.gather(y_cum, -1, above)
        t = torch.clamp(torch.nan_to_num((cp - x_g0) / (x_g1 - x_g0), nan=0.0), 0.0, 1.0)
        bins = y_g0 + t * (y_g1 - y_g0)
        w_gt = bins[..., 1:] - bins[..., :-1]
        loss = loss + torch.mean(torch.clamp(w_gt - weights, min=0.0) ** 2 / (weights + 1e-5))
    return loss


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Foreground-mask BCE with clip(eps, 1 - eps) (losses.py:406-409)."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def curvature_loss(sampled_sdf: torch.Tensor, sdf: torch.Tensor, delta) -> torch.Tensor:
    """Neuralangelo's discrete-Laplacian curvature from the six numerical
    gradient taps (losses.py:412-419): per axis ``(a + b - 2 sdf) /
    (delta^2 + 1e-12)``, the mean of the absolute values. ``sampled_sdf``
    [..., 6] in the taps' order (+x, -x, +y, -y, +z, -z), ``sdf`` [...]."""
    pairs = sampled_sdf.reshape(*sampled_sdf.shape[:-1], 3, 2)
    curvature = (torch.sum(pairs, dim=-1) - 2.0 * sdf[..., None]) / (delta * delta + 1e-12)
    return torch.mean(torch.abs(curvature))
