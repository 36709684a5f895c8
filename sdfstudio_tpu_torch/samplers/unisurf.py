"""UniSurf's surface-guided sampler (counterpart of ``sdfstudio_tpu/samplers/unisurf.py``).

As in JAX (unisurf.py:1-7), every ray keeps its place: the surface points
are [R] arrays with a validity mask instead of the reference's compacted
subset, so shapes never depend on the data."""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.ops.render import weights_from_alphas
from sdfstudio_tpu_torch.samplers.pdf import merge_ray_samples_in_euclidean, pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform_sampler
from sdfstudio_tpu_torch.utils import checks


class SurfacePoints(NamedTuple):
    points: torch.Tensor  # [R, 3]
    mask: torch.Tensor  # [R] bool: a + to - sign change was found
    depth: torch.Tensor  # [R] the root's distance along the ray


def unisurf_interval_delta(step: float, interval_start: float = 0.25, interval_end: float = 0.0125,
                           interval_decay: float = 5e-5) -> float:
    """The interval half-width's exponential decay (unisurf.py:29-37), a function of the step."""
    return max(interval_start * math.exp(-interval_decay * float(step)), interval_end)


def find_surface_points(ray_samples: RaySamples, sdf: torch.Tensor) -> SurfacePoints:
    """Each ray's first + to - sign change, its root by linear interpolation
    (unisurf.py:40-71): the first sign change is the argmin of sign * (S..1)."""
    n_samples = sdf.shape[-1]
    starts = ray_samples.starts  # [R, S]
    sign_matrix = torch.cat([torch.sign(sdf[..., :-1] * sdf[..., 1:]), torch.ones_like(sdf[..., :1])], -1)
    cost_matrix = sign_matrix * torch.arange(n_samples, 0, -1, dtype=sdf.dtype, device=sdf.device)
    values, indices = torch.min(cost_matrix, -1)
    sdf_at = torch.gather(sdf, -1, indices[:, None])[:, 0]
    mask = (values < 0) & (sdf_at > 0)
    ind_hi = torch.clamp(indices + 1, max=n_samples - 1)
    d_low = torch.gather(starts, -1, indices[:, None])[:, 0]
    d_high = torch.gather(starts, -1, ind_hi[:, None])[:, 0]
    v_low, v_high = sdf_at, torch.gather(sdf, -1, ind_hi[:, None])[:, 0]
    den = torch.where(torch.abs(v_low - v_high) > 1e-12, v_low - v_high,
                      torch.full_like(v_low, 1e-12))
    # invalid rays' roots stay in range: they are masked later, but a runaway
    # value would reach the field as a huge position
    z = torch.clamp((v_low * d_high - v_high * d_low) / den, starts[..., 0], starts[..., -1])
    points = ray_samples.origins + ray_samples.directions * z[:, None]
    return SurfacePoints(points=points, mask=mask, depth=z)


@torch.no_grad()
def unisurf_sampler(
    ray_bundle: RayBundle,
    occupancy_fn: Callable[[torch.Tensor], torch.Tensor],
    sdf_fn: Callable[[RaySamples], torch.Tensor],
    delta: float,  # the interval half-width (a schedule of the step)
    rng: Rng = None,
    num_samples_interval: int = 64,
    num_samples_outside: int = 32,
    num_samples_importance: int = 32,
    num_marching_steps: int = 256,
    single_jitter: bool = False,
) -> Tuple[RaySamples, SurfacePoints]:
    """UniSurf sampling (unisurf.py:74-142): the merged samples, and the
    surface points with their mask for the smoothness loss."""
    checks.check_ray_bundle(ray_bundle)
    ray_samples = uniform_sampler(ray_bundle, num_marching_steps, rng=rng, single_jitter=single_jitter)
    sdf = sdf_fn(ray_samples)
    # importance samples weighted by occupancy
    weights = weights_from_alphas(occupancy_fn(sdf))
    importance_samples = pdf_sampler(
        ray_bundle, ray_samples, weights, num_samples=num_samples_importance, rng=rng,
        single_jitter=single_jitter, histogram_padding=1e-5, include_original=False,
    )
    outside_samples = uniform_sampler(ray_bundle, num_samples_outside, rng=rng,
                                      single_jitter=single_jitter)
    uniform_importance = merge_ray_samples_in_euclidean(ray_bundle, importance_samples, outside_samples)
    surface = find_surface_points(ray_samples, sdf)
    # [near, far] shrunk around the root on the rays that have one
    nears, fars = ray_bundle.nears, ray_bundle.fars
    dists = fars - nears
    z, m = surface.depth[:, None], surface.mask[:, None]
    shrunk = ray_bundle.replace(
        nears=torch.where(m, torch.maximum(z - dists * delta, nears), nears),
        fars=torch.where(m, torch.minimum(z + dists * delta, fars), fars),
    )
    interval_samples = uniform_sampler(shrunk, num_samples_interval, rng=rng, single_jitter=single_jitter)
    return merge_ray_samples_in_euclidean(ray_bundle, interval_samples, uniform_importance), surface
