"""Batched perspective cameras and ray generation.

Counterpart of ``sdfstudio_tpu/cameras/cameras.py`` for the perspective model
without distortion, which is what the DTU-like scenes use. Fisheye,
equirectangular and distortion parameters raise instead of being ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.utils.device import resolve_device

PERSPECTIVE = 1  # CameraType.PERSPECTIVE (cameras.py:22-27)


@dataclasses.dataclass
class Cameras:
    """Intrinsics and extrinsics, leading shape [N] (cameras.py:46-110)."""

    camera_to_worlds: torch.Tensor  # [N, 3, 4], OpenGL convention (camera looks down -z)
    fx: torch.Tensor  # [N]
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: torch.Tensor  # [N] int
    height: torch.Tensor  # [N] int

    @classmethod
    def create(
        cls,
        camera_to_worlds,
        fx,
        fy,
        cx,
        cy,
        width,
        height,
        camera_type: int = PERSPECTIVE,
        distortion_params=None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "Cameras":
        """Build from broadcastable host values (cameras.py:60-99)."""
        if camera_type != PERSPECTIVE:
            raise NotImplementedError("only perspective cameras are ported")
        if distortion_params is not None:
            raise NotImplementedError("camera distortion is not ported")
        dev = resolve_device(device)
        c2w = torch.as_tensor(camera_to_worlds, dtype=torch.float32).to(dev)
        if c2w.ndim == 2:
            c2w = c2w[None]
        n = c2w.shape[0]

        def vec(v, dtype=torch.float32):
            return torch.as_tensor(v, dtype=dtype).reshape(-1).expand(n).contiguous().to(dev)

        return cls(
            camera_to_worlds=c2w[:, :3, :4].contiguous(),
            fx=vec(fx),
            fy=vec(fy),
            cx=vec(cx),
            cy=vec(cy),
            width=vec(width, torch.int64),
            height=vec(height, torch.int64),
        )

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]

    @property
    def device(self) -> torch.device:
        return self.camera_to_worlds.device

    def to(self, device: Union[str, torch.device]) -> "Cameras":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )

    def generate_rays(self, camera_indices: torch.Tensor, coords: torch.Tensor) -> RayBundle:
        """Pixel coords (y, x) -> world rays (cameras.py:134-230, perspective
        branch), each ray from its own camera ``camera_indices[i]``. Pixel
        centres at +0.5 are the caller's business, as in the JAX package."""
        idx = camera_indices
        y, x = coords[..., 0], coords[..., 1]
        fx, fy, cx, cy = self.fx[idx], self.fy[idx], self.cx[idx], self.cy[idx]
        # base direction + one-pixel offsets for the pixel area
        c0 = torch.stack([(x - cx) / fx, -(y - cy) / fy], -1)
        c1 = torch.stack([(x - cx + 1) / fx, -(y - cy) / fy], -1)
        c2 = torch.stack([(x - cx) / fx, -(y - cy + 1) / fy], -1)
        cs = torch.stack([c0, c1, c2], 0)  # [3, R, 2]
        d_cam = torch.stack([cs[..., 0], cs[..., 1], -torch.ones_like(cs[..., 0])], -1)
        c2w = self.camera_to_worlds[idx]  # [R, 3, 4]
        rotation = c2w[..., :3, :3]
        d = torch.sum(d_cam[..., None, :] * rotation[None], dim=-1)  # [3, R, 3]
        directions_norm = torch.linalg.vector_norm(d[0], dim=-1, keepdim=True)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        directions = d[0]
        dx = torch.sqrt(torch.sum((directions - d[1]) ** 2, dim=-1))
        dy = torch.sqrt(torch.sum((directions - d[2]) ** 2, dim=-1))
        return RayBundle(
            origins=c2w[..., :3, 3],
            directions=directions,
            pixel_area=(dx * dy)[..., None],
            camera_indices=idx,
            directions_norm=directions_norm,
        )

    def generate_image_rays(self, camera_index: int) -> RayBundle:
        """Full-image bundle for one camera, row-major (cameras.py:232-255)."""
        h = int(self.height[camera_index])
        w = int(self.width[camera_index])
        ys, xs = torch.meshgrid(
            torch.arange(h, device=self.device), torch.arange(w, device=self.device), indexing="ij"
        )
        coords = torch.stack([ys, xs], -1).reshape(-1, 2).to(torch.float32) + 0.5
        idx = torch.full((h * w,), camera_index, dtype=torch.int64, device=self.device)
        return self.generate_rays(idx, coords)
