"""VolSDF's error-bounded sampler, Algorithm 1 (counterpart of
``sdfstudio_tpu/samplers/error_bounded.py``).

As in JAX (error_bounded.py:1-9), the data-dependent convergence loop is a
fixed ``max_total_iters`` rounds of upsampling, and the per-round
bisection on beta is ``beta_iters`` masked updates: every loop count is
static, so the card never waits on the host."""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.ops.render import weights_and_transmittance_from_densities
from sdfstudio_tpu_torch.samplers.pdf import merge_ray_samples, pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform, uniform_sampler
from sdfstudio_tpu_torch.utils import checks


def _get_dstar(sdf: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Theorem 1's distance bound d* from the triangle of consecutive |sdf|
    (error_bounded.py:25-44). sdf, deltas [R, S] -> [R, S]."""
    a = deltas[..., :-1]
    b = torch.abs(sdf[..., :-1])
    c = torch.abs(sdf[..., 1:])
    first_cond = a**2 + b**2 <= c**2
    second_cond = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    area_sq = torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)
    heron = 2.0 * torch.sqrt(area_sq) / torch.clamp(a, min=1e-12)
    d_star = torch.zeros_like(a)
    d_star = torch.where(first_cond, b, d_star)
    d_star = torch.where(second_cond, c, d_star)
    d_star = torch.where(~first_cond & ~second_cond & (b + c - a > 0), heron, d_star)
    # intervals whose ends straddle the surface get 0
    same_sign = torch.sign(sdf[..., 1:]) * torch.sign(sdf[..., :-1]) == 1
    d_star = torch.where(same_sign, d_star, torch.zeros_like(d_star))
    return torch.cat([d_star, d_star[..., -1:]], -1)


def _error_per_section(beta: torch.Tensor, d_star: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    return torch.exp(-d_star / beta) * (deltas**2) / (4 * beta**2)


def _error_bound(beta: torch.Tensor, density_fn: Callable, sdf: torch.Tensor, d_star: torch.Tensor,
                 deltas: torch.Tensor) -> torch.Tensor:
    """Each ray's largest opacity error bound (error_bounded.py:47-62); beta [R, 1] -> [R]."""
    delta_density = deltas * density_fn(sdf, beta)
    integral = torch.cumsum(delta_density[..., :-1], -1)
    integral = torch.cat([torch.zeros_like(integral[..., :1]), integral], -1)
    error_integral = torch.cumsum(_error_per_section(beta, d_star, deltas), -1)
    bound_opacity = (torch.clamp(torch.exp(error_integral), max=1e6) - 1.0) * torch.exp(-integral)
    return bound_opacity.amax(-1)


def _updated_beta(beta0: torch.Tensor, beta: torch.Tensor, density_fn: Callable, sdf: torch.Tensor,
                  d_star: torch.Tensor, deltas: torch.Tensor, eps: float, beta_iters: int) -> torch.Tensor:
    """Bisection for the smallest beta that meets the error bound
    (error_bounded.py:65-87), ``beta_iters`` masked halvings; beta [R]."""
    curr_error = _error_bound(beta[:, None], density_fn, sdf, d_star, deltas)
    beta0 = beta0.expand_as(beta)
    beta = torch.where(curr_error <= eps, beta0, beta)
    beta_min, beta_max = beta0, beta
    for _ in range(beta_iters):
        beta_mid = (beta_min + beta_max) / 2.0
        ok = _error_bound(beta_mid[:, None], density_fn, sdf, d_star, deltas) <= eps
        beta_max = torch.where(ok, beta_mid, beta_max)
        beta_min = torch.where(ok, beta_min, beta_mid)
    return beta_max


@torch.no_grad()
def error_bounded_sampler(
    ray_bundle: RayBundle,
    density_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # (sdf, beta) -> density
    sdf_fn: Callable[[RaySamples], torch.Tensor],  # samples -> [R, S] sdf
    beta0: torch.Tensor,  # the field's current beta
    rng: Rng = None,
    num_samples: int = 64,
    num_samples_eval: int = 128,
    num_samples_extra: int = 32,
    eps: float = 0.1,
    beta_iters: int = 10,
    max_total_iters: int = 5,
    single_jitter: bool = False,
    return_eikonal_points: bool = True,
) -> Tuple[RaySamples, Optional[torch.Tensor]]:
    """VolSDF sampling (error_bounded.py:90-202): (samples, eikonal points
    [R * 10, 3] or None). Nothing here carries a gradient."""
    checks.check_ray_bundle(ray_bundle)
    beta0 = beta0.detach().reshape(())
    ray_samples = uniform_sampler(ray_bundle, num_samples_eval, rng=rng, single_jitter=single_jitter)
    # Lemma 2's upper bound as the first beta
    bound = (1.0 / (4.0 * math.log(eps + 1.0))) * torch.sum(ray_samples.deltas**2, -1)
    beta = torch.sqrt(bound)  # [R]
    sdf = sorted_index = weights = None
    new_samples = ray_samples
    for it in range(max_total_iters):
        new_sdf = sdf_fn(new_samples)
        sdf = new_sdf if sorted_index is None else torch.gather(
            torch.cat([sdf, new_sdf], -1), -1, sorted_index)
        deltas = ray_samples.deltas
        d_star = _get_dstar(sdf, deltas)
        beta = _updated_beta(beta0, beta, density_fn, sdf, d_star, deltas, eps, beta_iters)
        weights, transmittance = weights_and_transmittance_from_densities(
            deltas, density_fn(sdf, beta[:, None]))
        if it < max_total_iters - 1:
            # upsample in proportion to the current error bound
            error_integral = torch.cumsum(_error_per_section(beta[:, None], d_star, deltas), -1)
            up_weights = (torch.clamp(torch.exp(error_integral), max=1e6) - 1.0) * transmittance
            new_samples = pdf_sampler(
                ray_bundle, ray_samples, up_weights, num_samples=num_samples_eval, rng=rng,
                single_jitter=single_jitter, histogram_padding=1e-5, include_original=False,
            )
            ray_samples, sorted_index = merge_ray_samples(ray_bundle, ray_samples, new_samples)
    # the final samples of the rendering integral
    ray_samples = pdf_sampler(
        ray_bundle, ray_samples, weights, num_samples=num_samples, rng=rng,
        single_jitter=single_jitter, histogram_padding=1e-5, include_original=False,
    )
    eik_points = None
    if return_eikonal_points:
        pts = ray_samples.get_positions().reshape(-1, 3)
        num = ray_samples.num_rays * 10
        if rng is not None:
            idx = torch.clamp((uniform(rng, (num,), pts.device) * pts.shape[0]).long(),
                              max=pts.shape[0] - 1)
        else:
            idx = torch.arange(num, device=pts.device) % pts.shape[0]
        eik_points = pts[idx]
    if num_samples_extra > 0:
        extra = uniform_sampler(ray_bundle, num_samples_extra, rng=rng, single_jitter=single_jitter)
        ray_samples, _ = merge_ray_samples(ray_bundle, ray_samples, extra)
    return ray_samples, eik_points
