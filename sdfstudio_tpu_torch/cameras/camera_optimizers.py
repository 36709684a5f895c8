"""Per-camera pose refinement (counterpart of
``sdfstudio_tpu/cameras/camera_optimizers.py``).

``CameraOptimizer`` holds the ``pose_adjustment [num_cameras, 6]`` table,
zeros at first, and maps camera indices to ``[R, 3, 4]`` corrections:
the identity with ``mode="off"``, ``exp_map_SO3xR3`` or ``exp_map_SE3`` of
the cameras' rows otherwise. With a position or orientation noise it
composes a constant ``pose_noise [num_cameras, 3, 4]`` before the
correction (camera_optimizers.py:57-68). JAX draws that table from
``PRNGKey(0)``, which torch cannot reproduce: the port draws it from a
seeded ``torch.Generator`` with the same distribution, and a JAX table is
carried across with ``load_pose_noise`` as the weights are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from sdfstudio_tpu_torch.cameras.camera_utils import multiply_poses
from sdfstudio_tpu_torch.cameras.lie_groups import exp_map_SE3, exp_map_SO3xR3

MODES = ("off", "SO3xR3", "SE3")


@dataclasses.dataclass(frozen=True)
class CameraOptimizerConfig:
    """camera_optimizers.py:21-25."""

    mode: str = "off"  # off | SO3xR3 | SE3
    position_noise_std: float = 0.0
    orientation_noise_std: float = 0.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown camera optimizer mode {self.mode!r}: one of {MODES}")


def pose_noise(num_cameras: int, pos_std: float, orient_std: float,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``exp_map_SE3`` of normal tangents scaled by the stds, ``[num_cameras,
    3, 4]`` (``_pose_noise``, camera_optimizers.py:70-73)."""
    std = torch.tensor([pos_std] * 3 + [orient_std] * 3)
    return exp_map_SE3(torch.randn((num_cameras, 6), generator=generator) * std)


class CameraOptimizer(nn.Module):
    """camera_optimizers.py:28-67: the parameter ``pose_adjustment`` (absent
    with ``mode="off"``) and, with noise, the buffer ``pose_noise``."""

    def __init__(self, num_cameras: int, config: CameraOptimizerConfig = CameraOptimizerConfig()):
        super().__init__()
        self.num_cameras = num_cameras
        self.config = config
        if config.mode != "off":
            self.pose_adjustment = nn.Parameter(torch.zeros(num_cameras, 6))
        self.has_noise = config.position_noise_std > 0 or config.orientation_noise_std > 0
        if self.has_noise:
            self.register_buffer("pose_noise", pose_noise(
                num_cameras, config.position_noise_std, config.orientation_noise_std,
                torch.Generator().manual_seed(0)))

    @torch.no_grad()
    def load_pose_noise(self, noise) -> None:
        """Take JAX's ``constants.pose_noise`` table [num_cameras, 3, 4]."""
        noise = torch.as_tensor(np.array(noise), dtype=self.pose_noise.dtype)
        if noise.shape != self.pose_noise.shape:
            raise ValueError(f"pose_noise of shape {tuple(noise.shape)}, expected "
                             f"{tuple(self.pose_noise.shape)}")
        self.pose_noise.copy_(noise)

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """Camera indices [R] -> corrections [R, 3, 4]."""
        if self.config.mode == "off":
            eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], dim=-1).to(indices.device)
            return eye.expand(indices.shape[0], 3, 4)
        tangent = self.pose_adjustment[indices]
        out = exp_map_SO3xR3(tangent) if self.config.mode == "SO3xR3" else exp_map_SE3(tangent)
        if self.has_noise:
            out = multiply_poses(self.pose_noise[indices], out)
        return out
