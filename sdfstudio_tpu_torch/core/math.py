"""Math helpers (counterpart of ``sdfstudio_tpu/core/math.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """L2-normalize along the last axis (core/math.py:117-119)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``searchsorted(a, v, side="right")`` (core/math.py:122-150).

    The JAX package counts ``a <= v`` because a vmapped binary search is a
    serial loop on the TPU; ``torch.searchsorted(right=True)`` is a batched
    binary search on either device and returns the same tie-inclusive
    indices. Returns int64 [..., M] in [0, N].
    """
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=True)


def components_from_spherical_harmonics(levels: int, directions: torch.Tensor) -> torch.Tensor:
    """Real SH basis values of every band up to ``levels`` (core/math.py:13-57),
    [..., levels**2], with JAX's constants and products in its order."""
    if not 1 <= levels <= 5:
        raise ValueError(f"SH levels must be in [1, 5], got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if levels > 4:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.4425326924449826 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


class Gaussians(NamedTuple):
    """A multivariate Gaussian (core/math.py:60-64)."""

    mean: torch.Tensor  # [..., dim]
    cov: torch.Tensor  # [..., dim, dim]


def compute_3d_gaussian(directions: torch.Tensor, means: torch.Tensor, dir_variance: torch.Tensor,
                        radius_variance: torch.Tensor) -> Gaussians:
    """A Gaussian oriented along the ray (core/math.py:67-78): the variance
    along the direction and across it."""
    dir_outer = directions[..., :, None] * directions[..., None, :]
    eye = torch.eye(directions.shape[-1], dtype=directions.dtype, device=directions.device)
    dir_mag_sq = torch.clamp(torch.sum(directions**2, dim=-1, keepdim=True), min=1e-10)
    null_outer = eye - directions[..., :, None] * (directions / dir_mag_sq)[..., None, :]
    cov = dir_variance[..., None] * dir_outer + radius_variance[..., None] * null_outer
    return Gaussians(mean=means, cov=cov)


def conical_frustum_to_gaussian(origins: torch.Tensor, directions: torch.Tensor,
                                starts: torch.Tensor, ends: torch.Tensor,
                                radius: torch.Tensor) -> Gaussians:
    """mip-NeRF's stable Gaussian of a conical frustum (core/math.py:96-109)."""
    mu = (starts + ends) / 2.0
    hw = (ends - starts) / 2.0
    means = origins + directions * (mu + (2.0 * mu * hw**2.0) / (3.0 * mu**2.0 + hw**2.0))
    dir_variance = (hw**2) / 3 - (4 / 15) * ((hw**4 * (12 * mu**2 - hw**2)) / (3 * mu**2 + hw**2) ** 2)
    radius_variance = radius**2 * ((mu**2) / 4 + (5 / 12) * hw**2 - 4 / 15 * (hw**4) / (3 * mu**2 + hw**2))
    return compute_3d_gaussian(directions, means, dir_variance, radius_variance)


def expected_sin(x_means: torch.Tensor, x_vars: torch.Tensor) -> torch.Tensor:
    """E[sin(y)] for y ~ N(mean, var) (core/math.py:112-114)."""
    return torch.exp(-0.5 * x_vars) * torch.sin(x_means)
