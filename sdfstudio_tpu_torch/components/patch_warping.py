"""Geo-NeuS patch warping through per-point plane homographies (counterpart
of ``sdfstudio_tpu/components/patch_warping.py``), in plain PyTorch as JAX
computes it in XLA code: no ray is compacted away, each keeps its place
with a validity mask, and an invalid ray warps to zero patches.

The source views are sampled with JAX's explicit bilinear gather (four
corner reads, each masked where it lies outside the image), not
``F.grid_sample``: the gradient through the sample coordinates is then
JAX's, the bilinear weights' (``floor`` and the integer clip carry none).

A ray without a crossing gets a zero normal from
``get_intersection_points`` (its low and high sample are the same one), so
its plane distance ``d`` is 0 and its homography 0 / 0 = NaN. In JAX's
jitted step XLA turns the product with the validity mask into a select, so
that ray's patches and gradients come out 0; PyTorch multiplies, and the
NaN would reach every parameter's gradient. ``patch_warping`` therefore
gives a ray outside the mask the plane facing its camera (normal
``-direction``, ``d = -z``): a finite homography, patches masked to 0 and
gradients of 0 there, as JAX's jitted step gives them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from sdfstudio_tpu_torch.cameras.cameras import Cameras
from sdfstudio_tpu_torch.core.rays import RaySamples


def get_intersection_points(
    ray_samples: RaySamples, sdf: torch.Tensor, normal: torch.Tensor, in_image_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each ray's first + to - crossing of the SDF between its samples and
    the normal interpolated there (patch_warping.py:20-57): (points [R, 3],
    unit normals [R, 3], mask [R]). ``sdf`` [R, S], ``normal`` [R, S, 3]; a
    ray counts where it has a crossing, the SDF before it is positive, it
    lies inside the image and its normal is not edge-on (|n . d| > 0.1)."""
    n_samples = sdf.shape[-1]
    starts = ray_samples.starts
    sign_matrix = torch.cat([torch.sign(sdf[:, :-1] * sdf[:, 1:]), torch.ones_like(sdf[:, :1])], -1)
    cost_matrix = sign_matrix * torch.arange(n_samples, 0, -1, dtype=sdf.dtype, device=sdf.device)
    values = torch.amin(cost_matrix, dim=-1)
    indices = torch.argmin(cost_matrix, dim=-1)  # the first of equal values, as jnp.argmin

    def take(arr, idx):
        return torch.gather(arr, -1, idx[:, None])[:, 0]

    mask = (values < 0) & (take(sdf, indices) > 0) & in_image_mask
    idx_hi = torch.clamp(indices + 1, max=n_samples - 1)
    d_low, v_low = take(starts, indices), take(sdf, indices)
    d_high, v_high = take(starts, idx_hi), take(sdf, idx_hi)
    n_low = torch.gather(normal, 1, indices[:, None, None].expand(-1, 1, 3))[:, 0]
    n_high = torch.gather(normal, 1, idx_hi[:, None, None].expand(-1, 1, 3))[:, 0]

    tiny = torch.full_like(v_low, 1e-12)
    denom = torch.where(torch.abs(v_low - v_high) > 1e-12, v_low - v_high, tiny)
    z = (v_low * d_high - v_high * d_low) / denom
    z = torch.clamp(z, starts[:, 0], starts[:, -1])
    points = ray_samples.origins + ray_samples.directions * z[:, None]
    pn = (v_low[:, None] * n_high - v_high[:, None] * n_low) / denom[:, None]
    pn = pn / torch.sqrt(torch.sum(pn**2, dim=-1, keepdim=True) + 1e-12)
    valid_normal = torch.abs(torch.sum(pn * ray_samples.directions, dim=-1)) > 0.1
    return points, pn, mask & valid_normal


def get_homography(
    points: torch.Tensor, normal: torch.Tensor, cameras: Cameras, valid_angle_thres: float = 0.3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The homography ``K_i (R_rel + t_rel n^T / d) K_0^-1`` of each point's
    tangent plane from the reference view (camera 0) into each view, in the
    OpenCV convention (patch_warping.py:60-102): (H [N, P, 3, 3], valid [N,
    P]). A view counts where it sees the plane's front (the point's normal
    within ``acos(valid_angle_thres)`` of the direction to the camera) and
    the point lies in front of it (z > 0.01)."""
    c2w = cameras.camera_to_worlds
    c2w = torch.cat([c2w[:, :3, :1], -c2w[:, :3, 1:3], c2w[:, :3, 3:]], -1)  # nerfstudio -> OpenCV
    K = cameras.get_intrinsics_matrices()
    K_inv = torch.linalg.inv_ex(K).inverse  # inv_ex: no singularity check, no wait for the device
    w2c_r = c2w[:, :3, :3].transpose(1, 2)
    w2c_t = -w2c_r @ c2w[:, :3, 3:]
    R_rel = w2c_r @ c2w[:1, :3, :3]  # [N, 3, 3]
    t_rel = w2c_r @ c2w[:1, :3, 3:] + w2c_t[:1]  # [N, 3, 1]
    p_ref = w2c_r[0] @ points.T + w2c_t[0]  # [3, P]
    n_ref = w2c_r[0] @ normal.T  # [3, P]
    d = torch.sum(n_ref * p_ref, dim=0, keepdim=True)  # [1, P]
    H = R_rel[:, None] + t_rel[:, None] @ n_ref.T[None, :, None, :] / d.T[None, :, :, None]
    H = K[:, None] @ H @ K_inv[None, :1]  # [N, P, 3, 3]
    dir_src = c2w[:, None, :, 3] - points[None]
    dir_src = dir_src / torch.sqrt(torch.sum(dir_src**2, dim=-1, keepdim=True) + 1e-12)
    valid = torch.sum(dir_src * normal[None], dim=-1) > valid_angle_thres
    p_src = w2c_r @ points.T + w2c_t  # [N, 3, P]
    return H, valid & (p_src[:, 2, :] > 0.01)


def bilinear_sample(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample(align_corners=True)`` with zero padding, as JAX's
    explicit gather (patch_warping.py:105-131): ``images`` [N, H, W, C],
    ``coords`` [N, ..., 2] as (x, y) in [-1, 1] -> [N, ..., C]."""
    N, H, W, _ = images.shape
    x = (coords[..., 0] + 1) * 0.5 * (W - 1)
    y = (coords[..., 1] + 1) * 0.5 * (H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    n = torch.arange(N, device=images.device).reshape((N,) + (1,) * (x.dim() - 1))

    def gather(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        # NaN to 0 first: a NaN index would read out of the image (it is masked by inb)
        xi_c = torch.clamp(torch.nan_to_num(xi), 0, W - 1).long()
        yi_c = torch.clamp(torch.nan_to_num(yi), 0, H - 1).long()
        return images[n, yi_c, xi_c] * inb[..., None]

    top = gather(x0, y0) * (1 - wx) + gather(x0 + 1, y0) * wx
    bot = gather(x0, y0 + 1) * (1 - wx) + gather(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def patch_warping(
    ray_samples: RaySamples,
    sdf: torch.Tensor,
    normal: torch.Tensor,
    cameras: Cameras,
    images: torch.Tensor,
    pix_indices: torch.Tensor,
    patch_size: int = 31,
    pixel_offset: float = 0.5,
    valid_angle_thres: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp each ray's ``patch_size``^2 patch around its pixel in the
    reference view (camera 0; ``pix_indices`` [R, 2] as (y, x)) into every
    view through its crossing's tangent-plane homography
    (patch_warping.py:134-177). Returns (patches [N, R, P^2, 3], valid [N,
    R, P^2, 1]); an invalid pixel's colour is 0."""
    half = patch_size // 2
    H_img, W_img = cameras.height[0], cameras.width[0]
    in_image = ((pix_indices[:, 0] > half) & (pix_indices[:, 1] > half)
                & (pix_indices[:, 0] < H_img - half - 1) & (pix_indices[:, 1] < W_img - half - 1))
    points, pnormal, mask = get_intersection_points(ray_samples, sdf, normal, in_image)
    # a masked ray's plane faces its camera: a finite homography (see the module's docstring)
    pnormal = torch.where(mask[:, None], pnormal, -ray_samples.directions)
    Hmat, H_valid = get_homography(points, pnormal, cameras, valid_angle_thres)

    dev, dt = sdf.device, Hmat.dtype
    offs = torch.arange(-half, half + 1, device=dev)
    yy, xx = torch.meshgrid(offs, offs, indexing="ij")
    patch = torch.stack([xx, yy], dim=-1).reshape(-1, 2).to(dt)  # [p^2, 2] as (x, y)
    base = torch.flip(pix_indices, dims=[-1]).to(dt) + pixel_offset
    coords = base[:, None, :] + patch[None]  # [R, p^2, 2]
    hom = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)
    warped = torch.einsum("nrij,rpj->nrpi", Hmat, hom)  # [N, R, p^2, 3]
    positive_depth = warped[..., 2] >= 0.2
    denom = warped[..., 2:] * positive_depth[..., None] + 1e-6
    uv = warped[..., :2] / denom  # pixel (x, y)
    gx = uv[..., 0] / (W_img - 1) * 2 - 1
    gy = uv[..., 1] / (H_img - 1) * 2 - 1
    in_bounds = (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
    valid = in_bounds & H_valid[..., None] & positive_depth & mask[None, :, None]
    rgb = bilinear_sample(images, torch.stack([gx, gy], dim=-1)) * valid[..., None]
    return rgb, valid[..., None]
