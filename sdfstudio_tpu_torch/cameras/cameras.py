"""Batched cameras and ray generation (counterpart of
``sdfstudio_tpu/cameras/cameras.py``): perspective, fisheye and
equirectangular cameras, each with OpenCV's radial and tangential
distortion where its ``distortion_params`` are given. As in JAX, all three
camera models' directions are computed for every ray and each ray takes its
camera's (cameras.py:136-232); the base direction and its two one-pixel
offsets (the pixel area) are undistorted, except for equirectangular
cameras, by ``camera_utils.radial_and_tangential_undistort`` (10 fixed
Newton steps, profiler range ``sst/undistort``). A camera may carry a time
(D-NeRF's frames, cameras.py:58, 98), which its rays carry as
``RayBundle.times`` (:223).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.cameras.camera_utils import multiply_poses, radial_and_tangential_undistort
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.utils.device import resolve_device


class CameraType(enum.IntEnum):
    """The camera models (cameras.py:25-30)."""

    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3


# COLMAP / OpenCV model names (cameras.py:33-42)
CAMERA_MODEL_TO_TYPE = {
    "SIMPLE_PINHOLE": CameraType.PERSPECTIVE,
    "PINHOLE": CameraType.PERSPECTIVE,
    "SIMPLE_RADIAL": CameraType.PERSPECTIVE,
    "RADIAL": CameraType.PERSPECTIVE,
    "OPENCV": CameraType.PERSPECTIVE,
    "OPENCV_FISHEYE": CameraType.FISHEYE,
    "EQUIRECTANGULAR": CameraType.EQUIRECTANGULAR,
}


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
    camera_type: Optional[torch.Tensor] = None  # [N] int, a CameraType; perspective when None
    distortion_params: Optional[torch.Tensor] = None  # [N, 6]: k1, k2, k3, k4, p1, p2
    times: Optional[torch.Tensor] = None  # [N]
    # read on the host so that ray generation never waits on the card: some
    # camera is not perspective; some distortion parameter is not 0 (with all
    # of them 0 the Newton steps leave every coordinate as it is, bit for bit)
    non_perspective: bool = False
    distorted: bool = False

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
        camera_type: int = CameraType.PERSPECTIVE,
        distortion_params=None,
        device: Optional[Union[str, torch.device]] = None,
        times=None,
    ) -> "Cameras":
        """Build from broadcastable host values (cameras.py:60-99):
        ``camera_type`` one type or one a camera, ``distortion_params``
        [N, 6] or None."""
        dev = resolve_device(device)
        c2w = torch.as_tensor(camera_to_worlds, dtype=torch.float32).to(dev)
        if c2w.ndim == 2:
            c2w = c2w[None]
        n = c2w.shape[0]

        def vec(v, dtype=torch.float32):
            return torch.as_tensor(v, dtype=dtype).reshape(-1).expand(n).contiguous().to(dev)

        ctype = torch.as_tensor(np.asarray(camera_type, dtype=np.int64)).reshape(-1).expand(n)
        dist = None if distortion_params is None else torch.as_tensor(
            np.asarray(distortion_params, dtype=np.float32)).reshape(-1, 6).expand(n, 6)
        return cls(
            camera_to_worlds=c2w[:, :3, :4].contiguous(),
            fx=vec(fx),
            fy=vec(fy),
            cx=vec(cx),
            cy=vec(cy),
            width=vec(width, torch.int64),
            height=vec(height, torch.int64),
            camera_type=ctype.contiguous().to(dev),
            distortion_params=None if dist is None else dist.to(dev),
            non_perspective=bool((ctype != CameraType.PERSPECTIVE).any()),
            distorted=dist is not None and bool((dist != 0).any()),
            times=None if times is None else torch.as_tensor(times, dtype=torch.float32)
            .reshape(n).to(dev),
        )

    @property
    def num_cameras(self) -> int:
        return self.camera_to_worlds.shape[0]

    @property
    def device(self) -> torch.device:
        return self.camera_to_worlds.device

    def _map(self, fn) -> "Cameras":
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def to(self, device: Union[str, torch.device]) -> "Cameras":
        return self._map(lambda t: t.to(device))

    def __getitem__(self, indices: torch.Tensor) -> "Cameras":
        """The cameras at ``indices`` [M] (``gather_cameras``, datamanager.py:279-284)."""
        return self._map(lambda t: t[indices])

    def rescale_output_resolution(self, scaling_factor: float) -> "Cameras":
        """Intrinsics and image size scaled by ``scaling_factor``, the size
        truncated to an integer as JAX's ``astype`` does (cameras.py:124-133)."""
        def size(v):
            return (v.to(torch.float32) * scaling_factor).to(v.dtype)

        return dataclasses.replace(self, fx=self.fx * scaling_factor, fy=self.fy * scaling_factor,
                                   cx=self.cx * scaling_factor, cy=self.cy * scaling_factor,
                                   width=size(self.width), height=size(self.height))

    def get_intrinsics_matrices(self) -> torch.Tensor:
        """[N, 3, 3] pinhole intrinsics in the focal lengths' type (cameras.py:113-122)."""
        K = torch.zeros((self.num_cameras, 3, 3), dtype=self.fx.dtype, device=self.device)
        K[:, 0, 0] = self.fx
        K[:, 1, 1] = self.fy
        K[:, 0, 2] = self.cx
        K[:, 1, 2] = self.cy
        K[:, 2, 2] = 1.0
        return K

    def generate_rays(self, camera_indices: torch.Tensor, coords: torch.Tensor,
                      camera_opt_to_camera: Optional[torch.Tensor] = None,
                      disable_distortion: bool = False) -> RayBundle:
        """Pixel coords (y, x) -> world rays (cameras.py:136-232), each ray
        from its own camera ``camera_indices[i]``, its pose composed with
        ``camera_opt_to_camera [R, 3, 4]`` where given (the camera
        optimizer's correction, cameras.py:205-206). Pixel centres at +0.5
        are the caller's business, as in the JAX package."""
        idx = camera_indices
        y, x = coords[..., 0], coords[..., 1]
        fx, fy, cx, cy = self.fx[idx], self.fy[idx], self.cx[idx], self.cy[idx]
        # base direction + one-pixel offsets for the pixel area
        c0 = torch.stack([(x - cx) / fx, -(y - cy) / fy], -1)
        c1 = torch.stack([(x - cx + 1) / fx, -(y - cy) / fy], -1)
        c2 = torch.stack([(x - cx) / fx, -(y - cy + 1) / fy], -1)
        cs = torch.stack([c0, c1, c2], 0)  # [3, R, 2]
        ctype = self.camera_type[idx] if self.camera_type is not None else None
        if not disable_distortion and self.distorted:
            with record_function("sst/undistort"):
                und = radial_and_tangential_undistort(cs, self.distortion_params[idx][None])
                cs = (torch.where((ctype != CameraType.EQUIRECTANGULAR)[None, :, None], und, cs)
                      if self.non_perspective else und)
        u, v = cs[..., 0], cs[..., 1]
        d_cam = torch.stack([u, v, -torch.ones_like(u)], -1)  # perspective (cameras.py:183-184)
        if self.non_perspective:
            # fisheye (:185-190) and equirectangular (:191-200), chosen per ray
            theta = torch.clamp(torch.sqrt(u ** 2 + v ** 2), 1e-9, math.pi)
            ratio = torch.sin(theta) / theta
            fisheye = torch.stack([u * ratio, v * ratio, -torch.cos(theta)], -1)
            theta_e, phi = -math.pi * u, math.pi * (0.5 - v)
            equirect = torch.stack([-torch.sin(theta_e) * torch.sin(phi), torch.cos(phi),
                                    -torch.cos(theta_e) * torch.sin(phi)], -1)
            ct = ctype[None, :, None]
            d_cam = torch.where(ct == CameraType.PERSPECTIVE, d_cam,
                                torch.where(ct == CameraType.FISHEYE, fisheye, equirect))
        c2w = self.camera_to_worlds[idx]  # [R, 3, 4]
        if camera_opt_to_camera is not None:
            c2w = multiply_poses(c2w, camera_opt_to_camera)
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
            times=None if self.times is None else self.times[idx][..., None],
        )

    def generate_image_rays(self, camera_index: int, height: Optional[int] = None,
                            width: Optional[int] = None) -> RayBundle:
        """Full-image bundle for one camera, row-major, at its own size or at
        ``height`` x ``width`` (cameras.py:234-255)."""
        h = int(self.height[camera_index] if height is None else height)
        w = int(self.width[camera_index] if width is None else width)
        ys, xs = torch.meshgrid(
            torch.arange(h, device=self.device), torch.arange(w, device=self.device), indexing="ij"
        )
        coords = torch.stack([ys, xs], -1).reshape(-1, 2).to(torch.float32) + 0.5
        idx = torch.full((h * w,), camera_index, dtype=torch.int64, device=self.device)
        return self.generate_rays(idx, coords)
