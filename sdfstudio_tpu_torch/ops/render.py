"""Volume-rendering math (counterpart of ``sdfstudio_tpu/ops/render.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from sdfstudio_tpu_torch.utils import checks

BACKGROUND_COLORS = {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}


def alphas_from_densities(deltas: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    """alpha = 1 - exp(-delta sigma) (render.py:19-21)."""
    return 1.0 - torch.exp(-deltas * densities)


def weights_and_transmittance_from_densities(
    deltas: torch.Tensor, densities: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NeRF quadrature (render.py:24-38)."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    shifted = torch.cat([torch.zeros_like(delta_density[..., :1]), delta_density[..., :-1]], -1)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alphas * transmittance, transmittance


def weights_from_densities(deltas: torch.Tensor, densities: torch.Tensor) -> torch.Tensor:
    return weights_and_transmittance_from_densities(deltas, densities)[0]


def weights_and_transmittance_from_alphas(alphas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NeuS compositing (render.py:45-59): T = cumprod of (1 - alpha + 1e-7)
    with a leading 1, length S+1; weights use T[..., :-1]."""
    ones = torch.ones_like(alphas[..., :1])
    transmittance = torch.cumprod(torch.cat([ones, 1.0 - alphas + 1e-7], -1), dim=-1)
    return alphas * transmittance[..., :-1], transmittance


def weights_from_alphas(alphas: torch.Tensor) -> torch.Tensor:
    return weights_and_transmittance_from_alphas(alphas)[0]


def render_rgb(rgb: torch.Tensor, weights: torch.Tensor, background_color: str = "black",
               background_rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Composite per-sample colours (render.py:73-98) over
    ``background_rgb [..., 3]`` where given, else over the named
    background: ``"white"``, ``"black"``, ``"last_sample"`` (each ray's last
    sample colour), ``"none"`` (no background); ``"random"`` without a
    ``background_rgb`` is black, as in JAX."""
    checks.check_weights_values(weights, rgb, "render_rgb")
    comp = torch.sum(weights[..., None] * rgb, dim=-2)
    if background_rgb is None:
        if background_color == "none":
            return comp
        if background_color == "last_sample":
            background_rgb = rgb[..., -1, :]
        elif background_color == "random":
            background_rgb = torch.zeros(3, dtype=rgb.dtype, device=rgb.device)
        elif background_color in BACKGROUND_COLORS:
            background_rgb = torch.tensor(BACKGROUND_COLORS[background_color], dtype=rgb.dtype,
                                          device=rgb.device)
        else:
            raise ValueError(f"unknown background_color {background_color!r}")
    accumulation = torch.sum(weights, dim=-1, keepdim=True)
    return comp + background_rgb * (1.0 - accumulation)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """[..., S] -> [..., 1] (render.py:103-105)."""
    return torch.sum(weights, dim=-1, keepdim=True)


def render_depth_expected(
    weights: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor, eps: float = 1e-10
) -> torch.Tensor:
    """Accumulation-normalised expected depth (render.py:108-116)."""
    checks.check_sample_axis("render_depth_expected", weights=weights, starts=starts, ends=ends)
    steps = (starts + ends) * 0.5
    depth = torch.sum(weights * steps, dim=-1, keepdim=True)
    depth = depth / (torch.sum(weights, dim=-1, keepdim=True) + eps)
    return torch.minimum(
        torch.maximum(depth, steps.amin(dim=-1, keepdim=True)), steps.amax(dim=-1, keepdim=True)
    )


def render_depth_median(weights: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """The first bin centre where the cumulative weight reaches 0.5 (the
    last bin's where it never does), [..., 1] (render.py:117-126)."""
    checks.check_sample_axis("render_depth_median", weights=weights, starts=starts, ends=ends)
    steps = (starts + ends) * 0.5
    cumulative = torch.cumsum(weights, dim=-1)
    idx = torch.sum((cumulative < 0.5).to(torch.int64), dim=-1, keepdim=True)
    return torch.gather(steps, -1, torch.clamp(idx, 0, steps.shape[-1] - 1))


def render_normals(normals: torch.Tensor, weights: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Weighted sum of per-sample normals, divided by its norm + 1e-10 with
    ``normalize`` (render.py:136-141)."""
    checks.check_weights_values(weights, normals, "render_normals")
    out = torch.sum(weights[..., None] * normals, dim=-2)
    if normalize:
        out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-10)
    return out


def render_semantics(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of per-sample vectors (render.py:131-135); normals use it."""
    checks.check_weights_values(weights, values, "render_semantics")
    return torch.sum(weights[..., None] * values, dim=-2)


def render_uncertainty(betas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """NeRF-W's weighted sum of per-sample betas, [..., S] -> [..., 1] (render.py:144-147)."""
    checks.check_sample_axis("render_uncertainty", weights=weights, betas=betas)
    return torch.sum(weights * betas, dim=-1, keepdim=True)
