"""SDF -> density / alpha (counterpart of ``sdfstudio_tpu/ops/density.py``)."""
from __future__ import annotations

import torch

BETA_MIN = 1e-4


def effective_beta(beta_param: torch.Tensor, beta_min: float = BETA_MIN) -> torch.Tensor:
    """beta = |beta_param| + beta_min (density.py:18-20)."""
    return torch.abs(beta_param) + beta_min


def laplace_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """VolSDF density (density.py:23-27)."""
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def variance_inv_s(variance_param: torch.Tensor) -> torch.Tensor:
    """inv_s = exp(10 * var), clipped (density.py:36-39)."""
    return torch.clamp(torch.exp(variance_param * 10.0), 1e-6, 1e6)


def neus_alpha(
    sdf: torch.Tensor,  # [..., S]
    gradients: torch.Tensor,  # [..., S, 3]
    directions: torch.Tensor,  # [..., 3] or [..., S, 3]
    deltas: torch.Tensor,  # [..., S]
    inv_s: torch.Tensor,
    cos_anneal_ratio: float,
) -> torch.Tensor:
    """NeuS opacity with cosine annealing (density.py:42-68)."""
    if directions.ndim < gradients.ndim:
        directions = directions[..., None, :]
    true_cos = torch.sum(directions * gradients, dim=-1)
    iter_cos = -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + torch.relu(-true_cos) * cos_anneal_ratio
    )
    estimated_next_sdf = sdf + iter_cos * deltas * 0.5
    estimated_prev_sdf = sdf - iter_cos * deltas * 0.5
    prev_cdf = torch.sigmoid(estimated_prev_sdf * inv_s)
    next_cdf = torch.sigmoid(estimated_next_sdf * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    return torch.clamp(alpha, 0.0, 1.0)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) whose derivative is taken from clip(x, -15, 15), against
    exploding gradients (density.py:101-113, the instant-ngp activation)."""
    return _TruncExp.apply(x)


def sigmoid_density(sdf: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The sigmoid density variant (density.py:30-33)."""
    alpha = 1.0 / beta
    return alpha * torch.sigmoid(-sdf * alpha)


def neus_alpha_fixed_inv_s(sdf: torch.Tensor, deltas: torch.Tensor, inv_s: float) -> torch.Tensor:
    """NeuS upsampling alpha (density.py:72-92): ``inv_s`` fixed, the cosine
    from finite differences of ``sdf [R, S]`` over ``deltas [R, S-1]``,
    robustified by min(previous cos, cos) and clipped to [-1e3, 0]. Returns [R, S-1]."""
    prev_sdf, next_sdf = sdf[..., :-1], sdf[..., 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (deltas + 1e-5)
    prev_cos = torch.cat([torch.zeros_like(cos_val[..., :1]), cos_val[..., :-1]], -1)
    cos_val = torch.clamp(torch.minimum(prev_cos, cos_val), -1e3, 0.0)
    prev_cdf = torch.sigmoid((mid_sdf - cos_val * deltas * 0.5) * inv_s)
    next_cdf = torch.sigmoid((mid_sdf + cos_val * deltas * 0.5) * inv_s)
    return (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)


def unisurf_occupancy(sdf: torch.Tensor) -> torch.Tensor:
    """UniSurf occupancy sigmoid(-10 sdf) (density.py:95-97)."""
    return torch.sigmoid(-10.0 * sdf)
