"""Pose and lens helpers (counterpart of ``sdfstudio_tpu/cameras/camera_utils.py``):
the composition of two poses on tensors (``multiply_poses``, :22-27), which
the camera optimizer's correction takes; OpenCV's radial and tangential
distortion inverted by Newton's method (``radial_and_tangential_undistort``,
:146-197), which ray generation runs on the card for distorted cameras
(plain PyTorch, as it is XLA code in JAX; profiler range
``sst/undistort``); and the orientation and centring on the host, in numpy
(:200-248): the parsers' ``auto_orient`` rotates and centres the poses with
these before any tensor reaches the card."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def multiply_poses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two ``[..., 3, 4]`` poses composed: ``a @ [b; 0 0 0 1]``."""
    R = a[..., :3, :3] @ b[..., :3, :3]
    t = a[..., :3, 3:] + a[..., :3, :3] @ b[..., :3, 3:]
    return torch.cat([R, t], dim=-1)


def get_distortion_params(k1: float = 0.0, k2: float = 0.0, k3: float = 0.0, k4: float = 0.0,
                          p1: float = 0.0, p2: float = 0.0) -> np.ndarray:
    """``[k1, k2, k3, k4, p1, p2]`` in float32 (camera_utils.py:146-148)."""
    return np.array([k1, k2, k3, k4, p1, p2], dtype=np.float32)


def _residual_and_jacobian(x, y, xd, yd, params):
    """The distortion's residual at (x, y) against (xd, yd) and its 2 x 2
    jacobian (camera_utils.py:157-172)."""
    k1, k2, k3, k4 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    p1, p2 = params[..., 4], params[..., 5]
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(coords: torch.Tensor, distortion_params: torch.Tensor,
                                    eps: float = 1e-3, max_iterations: int = 10) -> torch.Tensor:
    """The undistorted normalised coordinates ``[..., 2]`` of ``coords``
    under ``distortion_params [..., 6]``: ``max_iterations`` Newton steps
    from the distorted point, each step taken only where the jacobian's
    determinant exceeds ``eps`` in magnitude, as a select
    (camera_utils.py:175-197). A fixed count, with no test of convergence,
    so that the card never waits on the host."""
    xd, yd = coords[..., 0], coords[..., 1]
    x, y = xd, yd
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(x, y, xd, yd, distortion_params)
        denom = fy_x * fx_y - fx_x * fy_y
        x_num = fx * fy_y - fy * fx_y
        y_num = fy * fx_x - fx * fy_x
        safe = torch.abs(denom) > eps
        x = x + torch.where(safe, x_num / denom, torch.zeros_like(x))
        y = y + torch.where(safe, y_num / denom, torch.zeros_like(y))
    return torch.stack([x, y], dim=-1)


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The rotation taking direction ``a`` to direction ``b`` (Rodrigues'
    form, camera_utils.py:200-211); for opposite directions ``a`` is nudged
    at random first, as in the reference."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        eps = (np.random.rand(3) - 0.5) * 0.01
        return rotation_matrix_between(a + eps, b)
    s = np.linalg.norm(v)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s**2 + 1e-8))


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_poses: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient (``pca``, ``up`` or ``none``) and optionally centre poses
    [N, 4, 4] in float64 (camera_utils.py:214-248). Returns (oriented [N, 3,
    4], transform [3, 4]), both float32."""
    poses = np.asarray(poses, dtype=np.float64)
    translation = poses[..., :3, 3]
    mean_translation = translation.mean(axis=0)
    translation_diff = translation - mean_translation
    translation = mean_translation if center_poses else np.zeros(3)

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = np.flip(eigvec, axis=-1).copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate([eigvec, eigvec @ -translation[:, None]], axis=-1)
        oriented = transform @ poses
        if oriented.mean(axis=0)[2, 1] < 0:
            oriented[:, 1:3] = -oriented[:, 1:3]
    elif method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        rotation = rotation_matrix_between(up, np.array([0, 0, 1.0]))
        transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=-1)
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4)
        transform[:3, 3] = -translation
        transform = transform[:3, :]
        oriented = transform @ poses
    else:
        raise ValueError(f"unknown orientation method {method}")
    return oriented.astype(np.float32), transform.astype(np.float32)
