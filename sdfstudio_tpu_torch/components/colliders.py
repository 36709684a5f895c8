"""Scene colliders: per-ray near/far (``sdfstudio_tpu/components/colliders.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox


def near_far_collider(ray_bundle: RayBundle, near_plane: float, far_plane: float) -> RayBundle:
    """Constant near/far (colliders.py:16-19)."""
    ones = torch.ones_like(ray_bundle.origins[..., 0:1])
    return ray_bundle.replace(nears=ones * near_plane, fars=ones * far_plane)


def aabb_box_collider(
    ray_bundle: RayBundle, aabb: torch.Tensor, near_plane: float = 0.0, training: bool = True
) -> RayBundle:
    """Slab-test ray/AABB intersection (colliders.py:22-37)."""
    rays_o, rays_d = ray_bundle.origins, ray_bundle.directions
    dir_fraction = 1.0 / (rays_d + 1e-6)
    t_lo = (aabb[0] - rays_o) * dir_fraction
    t_hi = (aabb[1] - rays_o) * dir_fraction
    nears = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    fars = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    nears = torch.clamp(nears, min=near_plane if training else 0.0)
    fars = torch.maximum(fars, nears + 1e-6)
    return ray_bundle.replace(nears=nears[..., None], fars=fars[..., None])


def sphere_collider(
    ray_bundle: RayBundle, radius: float = 1.0, soft_intersection: bool = False
) -> RayBundle:
    """Ray/sphere intersection with a clamped fallback (colliders.py:40-56)."""
    rays_o, rays_d = ray_bundle.origins, ray_bundle.directions
    ray_cam_dot = torch.sum(rays_d * rays_o, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot**2 - (torch.sum(rays_o**2, dim=-1, keepdim=True) - radius**2)
    under_sqrt = torch.clamp(under_sqrt, min=0.01)
    if soft_intersection:
        under_sqrt = torch.ones_like(under_sqrt) * radius
    sqrt_val = torch.sqrt(under_sqrt)
    nears = torch.clamp(-sqrt_val - ray_cam_dot, min=0.01)
    fars = torch.clamp(sqrt_val - ray_cam_dot, min=0.01)
    return ray_bundle.replace(nears=nears, fars=fars)


def apply_collider(
    ray_bundle: RayBundle,
    scene_box: Optional[SceneBox],
    collider_type: str,
    near_plane: float = 0.0,
    far_plane: float = 6.0,
    radius: float = 1.0,
    soft_intersection: bool = False,
    training: bool = True,
) -> RayBundle:
    """Dispatch on ``collider_type`` (colliders.py:59-80)."""
    if ray_bundle.nears is not None and ray_bundle.fars is not None:
        return ray_bundle
    if collider_type == "near_far":
        return near_far_collider(ray_bundle, near_plane, far_plane)
    if collider_type == "box":
        aabb = torch.as_tensor(scene_box.aabb, dtype=ray_bundle.origins.dtype,
                               device=ray_bundle.origins.device)
        return aabb_box_collider(ray_bundle, aabb, near_plane=near_plane, training=training)
    if collider_type == "sphere":
        return sphere_collider(ray_bundle, radius=radius, soft_intersection=soft_intersection)
    raise ValueError(f"unknown collider type {collider_type}")
