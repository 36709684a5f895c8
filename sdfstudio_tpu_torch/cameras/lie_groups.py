"""Lie-group exponential maps for pose deltas (counterpart of
``sdfstudio_tpu/cameras/lie_groups.py``).

Rodrigues' formula with JAX's branch-free Taylor fallback below ``eps =
1e-2``: both branches are computed and one is selected, with ``theta``
clamped at ``eps`` so that the branch not taken stays finite, and its
gradient too, at the identity where the camera optimizer starts.
"""
from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` -> ``[..., 3, 3]`` cross-product matrix (lie_groups.py:13-24)."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)


def _so3_exp(omega: torch.Tensor, eps: float = 1e-2):
    """(R [..., 3, 3], theta, A, B, C) with ``A = sin t / t``, ``B = (1 -
    cos t) / t^2``, ``C = (t - sin t) / t^3``, and their Taylor expansions
    where ``t^2 < eps^2`` (lie_groups.py:27-48)."""
    theta_sq = torch.sum(omega**2, dim=-1)
    safe_sq = torch.clamp(theta_sq, min=eps**2)
    theta = torch.sqrt(safe_sq)
    small = theta_sq < eps**2
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (safe_sq * theta))
    K = _skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    R = eye + A[..., None, None] * K + B[..., None, None] * (K @ K)
    return R, theta, A, B, C


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` (translation, rotation) -> ``[..., 3, 4]``: the rotation
    by Rodrigues, the translation as it is (lie_groups.py:51-57)."""
    R, *_ = _so3_exp(tangent[..., 3:])
    return torch.cat([R, tangent[..., :3, None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` se(3) tangent -> ``[..., 3, 4]``, the translation through
    the left jacobian ``V`` (lie_groups.py:60-68)."""
    t, omega = tangent[..., :3], tangent[..., 3:]
    R, _, _, B, C = _so3_exp(omega)
    K = _skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    V = eye + B[..., None, None] * K + C[..., None, None] * (K @ K)
    return torch.cat([R, (V @ t[..., None])], dim=-1)
