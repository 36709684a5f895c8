"""Training losses of the ported methods (counterpart of
``sdfstudio_tpu/components/losses.py``): rgb L1, eikonal, the mip-NeRF
360 interlevel loss (BakedSDF's and nerfacto's) and the zip-NeRF one with
its step-function blur, mip-NeRF 360's distortion loss, ref-NeRF's
orientation and predicted-normal losses (nerfacto's), the foreground-mask
BCE,
Neuralangelo's curvature loss, MonoSDF's monocular normal and
scale-and-shift-invariant depth losses, Geo-NeuS's top-k NCC over warped
patches, the sensor-depth losses and S3IM.
Weights are [R, S] (no trailing channel), as in the JAX package."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sdfstudio_tpu_torch.core.math import searchsorted_right


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """losses.py:23-24."""
    return torch.mean(torch.abs(pred - target))


def eikonal_loss(gradients: torch.Tensor) -> torch.Tensor:
    """((|grad| - 1)^2).mean() over all sample gradients (losses.py:31-34)."""
    return torch.mean((torch.linalg.vector_norm(gradients, dim=-1) - 1.0) ** 2)


def ray_samples_to_sdist(ray_samples) -> torch.Tensor:
    """[R, S+1] bin edges in normalised s-space (losses.py:42-46)."""
    return torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], -1)


def outer(t0_starts, t0_ends, t1_starts, t1_ends, y1) -> torch.Tensor:
    """The mass of the histogram ``y1`` on bins ``t1`` inside each bin of
    ``t0`` (losses.py:49-61)."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], -1)
    idx_lo = torch.clamp(searchsorted_right(t1_starts, t0_starts) - 1, 0, y1.shape[-1] - 1)
    idx_hi = torch.clamp(searchsorted_right(t1_ends, t0_ends), 0, y1.shape[-1] - 1)
    return torch.gather(cy1[..., 1:], -1, idx_hi) - torch.gather(cy1[..., :-1], -1, idx_lo)


def interlevel_loss(weights_list: Sequence[torch.Tensor], ray_samples_list) -> torch.Tensor:
    """mip-NeRF 360's proposal loss (losses.py:64-78): the final weights
    ``w`` on their bins ``c`` (no gradient) against each proposal level's
    mass inside them, ``mean(max(w - outer, 0)^2 / (w + 1e-7))``; only the
    proposal weights carry a gradient."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1].detach()
    loss = 0.0
    for ray_samples, weights in zip(ray_samples_list[:-1], weights_list[:-1]):
        cp = ray_samples_to_sdist(ray_samples)
        w_outer = outer(c[..., :-1], c[..., 1:], cp[..., :-1], cp[..., 1:], weights)
        loss = loss + torch.mean(torch.clamp(w - w_outer, min=0.0) ** 2 / (w + 1e-7))
    return loss


def blur_stepfun(x: torch.Tensor, y: torch.Tensor, r: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step function (edges x [R, N+1], values y [R, N]) convolved with a
    box of radius r (losses.py:86-103)."""
    x_c = torch.cat([x - r, x + r], -1)
    x_idx = torch.argsort(x_c, dim=-1, stable=True)
    x_r = torch.gather(x_c, -1, x_idx)
    zeros = torch.zeros_like(y[..., :1])
    y_1 = (torch.cat([y, zeros], -1) - torch.cat([zeros, y], -1)) / (2 * r)
    y_2 = torch.gather(torch.cat([y_1, -y_1], -1), -1, x_idx[..., :-1])
    y_r = torch.cumsum((x_r[..., 1:] - x_r[..., :-1]) * torch.cumsum(y_2, -1), -1)
    return x_r, torch.cat([zeros, y_r], -1)


def interlevel_loss_zip(
    weights_list: Sequence[torch.Tensor], ray_samples_list,
    blur_radii: Sequence[float] = (0.03, 0.003),
) -> torch.Tensor:
    """Zip-NeRF anti-aliased proposal loss (losses.py:106-136): the final
    weights, blurred and integrated, bound each proposal level's weights;
    only the proposal weights carry a gradient."""
    c = ray_samples_to_sdist(ray_samples_list[-1]).detach()
    w = weights_list[-1].detach()
    w_normalize = w / (c[..., 1:] - c[..., :-1])
    loss = 0.0
    for ray_samples, weights, r in zip(ray_samples_list[:-1], weights_list[:-1], blur_radii):
        x_r, y_r = blur_stepfun(c, w_normalize, r)
        y_r = torch.clamp(y_r, min=0.0)
        y_cum = torch.cumsum((y_r[..., 1:] + y_r[..., :-1]) * 0.5 * (x_r[..., 1:] - x_r[..., :-1]), -1)
        y_cum = torch.cat([torch.zeros_like(y_cum[..., :1]), y_cum], -1)
        cp = ray_samples_to_sdist(ray_samples)
        inds = searchsorted_right(x_r, cp)
        below = torch.clamp(inds - 1, 0, x_r.shape[-1] - 1)
        above = torch.clamp(inds, 0, x_r.shape[-1] - 1)
        x_g0, y_g0 = torch.gather(x_r, -1, below), torch.gather(y_cum, -1, below)
        x_g1, y_g1 = torch.gather(x_r, -1, above), torch.gather(y_cum, -1, above)
        t = torch.clamp(torch.nan_to_num((cp - x_g0) / (x_g1 - x_g0), nan=0.0), 0.0, 1.0)
        bins = y_g0 + t * (y_g1 - y_g0)
        w_gt = bins[..., 1:] - bins[..., :-1]
        loss = loss + torch.mean(torch.clamp(w_gt - weights, min=0.0) ** 2 / (weights + 1e-5))
    return loss


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-ray mip-NeRF 360 distortion of weights ``w [R, S]`` on bin edges
    ``t [R, S+1]`` (losses.py:144-150): the pairwise term over bin midpoints
    and the bins' own ``w^2 dt / 3``."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return loss_inter + loss_intra


def distortion_loss(weights_list: Sequence[torch.Tensor], ray_samples_list) -> torch.Tensor:
    """The mean distortion of the final level, on its s-space bins (losses.py:153-156)."""
    return torch.mean(lossfun_distortion(ray_samples_to_sdist(ray_samples_list[-1]),
                                         weights_list[-1]))


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor,
                     viewdirs: torch.Tensor) -> torch.Tensor:
    """Per ray, the weighted squared part of each normal that faces along
    the ray, ``sum w min(0, n.v)^2`` (losses.py:164-167)."""
    n_dot_v = torch.sum(normals * viewdirs[..., None, :], dim=-1)
    return torch.sum(weights * torch.clamp(n_dot_v, max=0.0) ** 2, dim=-1)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor,
                     pred_normals: torch.Tensor) -> torch.Tensor:
    """Per ray, ``sum w (1 - n . n_pred)`` (losses.py:170-172)."""
    return torch.sum(weights * (1.0 - torch.sum(normals * pred_normals, dim=-1)), dim=-1)


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Foreground-mask BCE with clip(eps, 1 - eps) (losses.py:406-409)."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def curvature_loss(sampled_sdf: torch.Tensor, sdf: torch.Tensor, delta) -> torch.Tensor:
    """Neuralangelo's discrete-Laplacian curvature from the six numerical
    gradient taps (losses.py:412-419): per axis ``(a + b - 2 sdf) /
    (delta^2 + 1e-12)``, the mean of the absolute values. ``sampled_sdf``
    [..., 6] in the taps' order (+x, -x, +y, -y, +z, -z), ``sdf`` [...]."""
    pairs = sampled_sdf.reshape(*sampled_sdf.shape[:-1], 3, 2)
    curvature = (torch.sum(pairs, dim=-1) - 2.0 * sdf[..., None]) / (delta * delta + 1e-12)
    return torch.mean(torch.abs(curvature))


# --- MonoSDF's monocular cues (losses.py:180-250) --------------------------


def monosdf_normal_loss(normal_pred: torch.Tensor, normal_gt: torch.Tensor) -> torch.Tensor:
    """L1 plus cosine distance between unit normals (losses.py:180-189)."""
    def normalize(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)

    normal_gt, normal_pred = normalize(normal_gt), normalize(normal_pred)
    l1 = torch.mean(torch.sum(torch.abs(normal_pred - normal_gt), dim=-1))
    cos = torch.mean(1.0 - torch.sum(normal_pred * normal_gt, dim=-1))
    return l1 + cos


def compute_scale_and_shift(prediction: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed-form 2x2 least-squares scale and shift of ``prediction``
    onto ``target`` under ``mask``, [B, H, W] -> ([B], [B]); 0 where the
    system is singular (losses.py:192-205)."""
    a_00 = torch.sum(mask * prediction * prediction, dim=(1, 2))
    a_01 = torch.sum(mask * prediction, dim=(1, 2))
    a_11 = torch.sum(mask, dim=(1, 2))
    b_0 = torch.sum(mask * prediction * target, dim=(1, 2))
    b_1 = torch.sum(mask * target, dim=(1, 2))
    det = a_00 * a_11 - a_01 * a_01
    valid = det != 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    x_0 = torch.where(valid, (a_11 * b_0 - a_01 * b_1) / safe_det, zero)
    x_1 = torch.where(valid, (-a_01 * b_0 + a_00 * b_1) / safe_det, zero)
    return x_0, x_1


def _midas_mse(prediction, target, mask):
    """losses.py:208-213."""
    M = torch.sum(mask, dim=(1, 2))
    res = prediction - target
    image_loss = torch.sum(mask * res * res, dim=(1, 2))
    divisor = torch.sum(2 * M)
    return torch.where(divisor == 0, torch.zeros_like(divisor),
                       torch.sum(image_loss) / torch.clamp(divisor, min=1.0))


def _gradient_loss(prediction, target, mask):
    """Neighbour differences of the masked residual along x and y (losses.py:216-224)."""
    M = torch.sum(mask, dim=(1, 2))
    diff = mask * (prediction - target)
    grad_x = torch.abs(diff[:, :, 1:] - diff[:, :, :-1]) * (mask[:, :, 1:] * mask[:, :, :-1])
    grad_y = torch.abs(diff[:, 1:, :] - diff[:, :-1, :]) * (mask[:, 1:, :] * mask[:, :-1, :])
    image_loss = torch.sum(grad_x, dim=(1, 2)) + torch.sum(grad_y, dim=(1, 2))
    divisor = torch.sum(M)
    return torch.where(divisor == 0, torch.zeros_like(divisor),
                       torch.sum(image_loss) / torch.clamp(divisor, min=1.0))


def scale_and_shift_invariant_loss(prediction: torch.Tensor, target: torch.Tensor,
                                   mask: torch.Tensor, alpha: float = 0.5,
                                   scales: int = 4) -> torch.Tensor:
    """MiDaS's scale-and-shift-invariant depth loss with multi-scale
    gradient matching, [B, H, W] inputs (losses.py:226-244)."""
    scale, shift = compute_scale_and_shift(prediction, target, mask)
    pred_ssi = scale[:, None, None] * prediction + shift[:, None, None]
    total = _midas_mse(pred_ssi, target, mask)
    if alpha > 0:
        for s in range(scales):
            step = 2**s
            total = total + alpha * _gradient_loss(pred_ssi[:, ::step, ::step],
                                                   target[:, ::step, ::step], mask[:, ::step, ::step])
    return total


# --- Geo-NeuS's multi-view photometric consistency (losses.py:252-300) -----


def ncc_score(x: torch.Tensor, y: torch.Tensor, min_patch_variance: float = 0.01) -> torch.Tensor:
    """1 - NCC of grey patches [N, P, P, C], in [0, 2]; 0 where either
    patch's variance is below ``min_patch_variance`` (losses.py:252-270)."""
    xg, yg = torch.mean(x, dim=-1), torch.mean(y, dim=-1)
    x_c = xg - torch.mean(xg, dim=(1, 2), keepdim=True)
    y_c = yg - torch.mean(yg, dim=(1, 2), keepdim=True)
    norm = torch.sum(x_c * y_c, dim=(1, 2))
    x_var = torch.sum(x_c**2, dim=(1, 2))
    y_var = torch.sum(y_c**2, dim=(1, 2))
    denom = torch.sqrt(x_var * y_var + 1e-6)
    ncc = norm / (denom + 1e-6)
    not_valid = (x_var < min_patch_variance) | (y_var < min_patch_variance)
    ncc = torch.where(not_valid, torch.ones_like(ncc), torch.clamp(ncc, -1.0, 1.0))
    return 1.0 - ncc


def smallest_k(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row and their indices, ties to the lower
    index first, as ``jax.lax.top_k(-score, k)`` orders them (a stable
    ascending sort)."""
    idx = torch.sort(score, dim=-1, stable=True).indices[..., :k]
    return torch.gather(score, -1, idx), idx


def multi_view_loss(patches: torch.Tensor, valid: torch.Tensor, patch_size: int = 11,
                    topk: int = 4, min_patch_variance: float = 0.01) -> torch.Tensor:
    """Geo-NeuS's loss (losses.py:273-300): each source patch's NCC score
    against the reference's (``patches[0]``, no gradient), the ``topk``
    smallest per ray over the sources, the ones whose every pixel warped
    validly averaged. ``patches`` [1 + S, R, P^2, C], ``valid`` [1 + S, R,
    P^2, 1]."""
    num_imgs, num_rays = patches.shape[0], patches.shape[1]
    C, P = patches.shape[-1], patch_size
    ref = patches[:1].reshape(1, num_rays, P, P, C).expand(num_imgs - 1, num_rays, P, P, C)
    ref = ref.reshape(-1, P, P, C)
    src = patches[1:].reshape(-1, P, P, C)
    src_valid = valid[1:].reshape(-1, P * P)
    score = ncc_score(ref.detach(), src, min_patch_variance).reshape(num_imgs - 1, num_rays)
    score_valid = torch.all(src_valid, dim=-1).reshape(num_imgs - 1, num_rays)
    min_score, idx = smallest_k(score.T, min(topk, num_imgs - 1))
    min_valid = torch.gather(score_valid.T, -1, idx)
    min_score = torch.where(min_valid, min_score, torch.zeros_like(min_score))
    return torch.sum(min_score) / (torch.sum(min_valid.to(min_score.dtype)) + 1e-6)


# --- sensor depth (losses.py:308-333) --------------------------------------


def sensor_depth_loss(depth_pred: torch.Tensor, depth_gt: torch.Tensor, starts: torch.Tensor,
                      pred_sdf: torch.Tensor, directions_norm: torch.Tensor, truncation: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L1 on the rays with a sensor depth, free-space, truncated SDF)
    (losses.py:308-333): ``depth_pred`` / ``depth_gt`` / ``directions_norm``
    [R, 1], ``starts`` and ``pred_sdf`` [R, S]."""
    valid_gt = depth_gt > 0.0
    l1 = torch.sum(valid_gt * torch.abs(depth_gt - depth_pred)) / (torch.sum(valid_gt) + 1e-6)
    z_vals = starts / directions_norm
    front = valid_gt & (z_vals < (depth_gt - truncation))
    back = valid_gt & (z_vals > (depth_gt + truncation))
    sdf_mask = valid_gt & (~front) & (~back)
    num_fs = torch.sum(front)
    num_sdf = torch.sum(sdf_mask)
    num = num_fs + num_sdf + 1e-6
    fs_weight = 1.0 - num_fs / num
    sdf_weight = 1.0 - num_sdf / num
    free_space = torch.mean((torch.relu(truncation - pred_sdf) * front) ** 2) * fs_weight
    sdf_l = torch.mean(((z_vals + pred_sdf) - depth_gt) ** 2 * sdf_mask) * sdf_weight
    return l1, free_space, sdf_l


# --- S3IM (losses.py:341-398) ----------------------------------------------


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _ssim_mean(img1: torch.Tensor, img2: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """Mean SSIM under a Gaussian window, a grouped convolution a channel
    (losses.py:348-374); images [1, C, H, W]."""
    C = img1.shape[1]
    k = torch.as_tensor(_gaussian_kernel(kernel_size, 1.5), dtype=img1.dtype, device=img1.device)
    kernel = k[None, None].repeat(C, 1, 1, 1)
    pad = (kernel_size - 1) // 2

    def conv(x):
        return F.conv2d(x, kernel, stride=stride, padding=pad, groups=C)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def s3im_loss(src_vec: torch.Tensor, tar_vec: torch.Tensor, rng=None,
              kernel_size: int = 4, stride: int = 4, repeat_time: int = 10,
              patch_height: int = 64, perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic structural similarity (losses.py:377-398): the ray batch
    (colours [N, 3]) in its order and in ``repeat_time - 1`` shuffles, laid
    out as virtual patches of ``patch_height`` rows, 1 - their SSIM. The
    shuffles are ``perms`` [repeat_time - 1, N] when given (a test hands in
    JAX's), else drawn from ``rng``, a ``torch.Generator`` on the rays' device."""
    n = tar_vec.shape[0]
    if perms is None:
        perms = torch.stack([torch.randperm(n, generator=rng, device=tar_vec.device)
                             for _ in range(repeat_time - 1)])
    idx = torch.cat([torch.arange(n, device=tar_vec.device), perms.reshape(-1).to(tar_vec.device)])
    tar_patch = tar_vec[idx].T.reshape(1, 3, patch_height, -1)
    src_patch = src_vec[idx].T.reshape(1, 3, patch_height, -1)
    return 1.0 - _ssim_mean(src_patch, tar_patch, kernel_size, stride)
