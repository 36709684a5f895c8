"""Pose helpers (counterpart of ``sdfstudio_tpu/cameras/camera_utils.py``):
the composition of two poses on tensors (``multiply_poses``, :22-27), which
the camera optimizer's correction takes, and the orientation and centring
on the host, in numpy (:200-248): the SDFStudio parser's ``auto_orient``
rotates and centres the poses with these before any tensor reaches the
card."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def multiply_poses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two ``[..., 3, 4]`` poses composed: ``a @ [b; 0 0 0 1]``."""
    R = a[..., :3, :3] @ b[..., :3, :3]
    t = a[..., :3, 3:] + a[..., :3, :3] @ b[..., :3, 3:]
    return torch.cat([R, t], dim=-1)


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
