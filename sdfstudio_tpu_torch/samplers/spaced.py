"""Spacing-function samplers (counterpart of ``sdfstudio_tpu/samplers/spaced.py``).

Randomness comes from an explicit ``rng``: ``None`` is eval mode (no
jitter), a ``torch.Generator`` draws the jitter on the rays' device, and a
callable ``shape -> tensor`` hands in given uniforms (the tests feed both
packages the same numbers this way)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from sdfstudio_tpu_torch.core.rays import (
    SPACING_LINDISP,
    SPACING_PIECEWISE,
    SPACING_UNIFORM,
    RayBundle,
    RaySamples,
    spacing_fn,
    spacing_fn_inv,
)
from sdfstudio_tpu_torch.utils import checks

Rng = Optional[Union[torch.Generator, Callable[[Sequence[int]], torch.Tensor]]]


def uniform(rng: Rng, shape: Sequence[int], device: torch.device) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``rng`` (a generator or a callable)."""
    if isinstance(rng, torch.Generator):
        return torch.rand(tuple(shape), generator=rng, device=device)
    return rng(tuple(shape)).to(device)


def spaced_sampler(
    ray_bundle: RayBundle, num_samples: int, kind: str, rng: Rng = None,
    single_jitter: bool = False,
) -> RaySamples:
    """Stratified samples under a spacing warp (spaced.py:27-64): with an
    ``rng`` each bin edge moves uniformly within its half-bins, by one draw
    per ray under ``single_jitter``."""
    checks.check_ray_bundle(ray_bundle)
    dev = ray_bundle.origins.device
    num_rays = ray_bundle.num_rays
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=dev, dtype=ray_bundle.nears.dtype)[None, :]
    if rng is not None:
        t_rand = uniform(rng, (num_rays, 1) if single_jitter else (num_rays, num_samples + 1), dev)
        centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        upper = torch.cat([centers, bins[..., -1:]], -1)
        lower = torch.cat([bins[..., :1], centers], -1)
        bins = lower + (upper - lower) * t_rand
    else:
        bins = bins.expand(num_rays, num_samples + 1)
    s_near = spacing_fn(kind, ray_bundle.nears)
    s_far = spacing_fn(kind, ray_bundle.fars)
    euclidean_bins = spacing_fn_inv(kind, bins * s_far + (1.0 - bins) * s_near)
    return ray_bundle.get_ray_samples(
        euclidean_bins=euclidean_bins, spacing_bins=bins, spacing_kind=kind,
        s_near=s_near, s_far=s_far,
    )


def uniform_lindisp_piecewise_sampler(
    ray_bundle: RayBundle, num_samples: int, rng: Rng = None, single_jitter: bool = False
) -> RaySamples:
    """spaced.py:93-94: uniform up to distance 1, linear in disparity beyond."""
    return spaced_sampler(ray_bundle, num_samples, SPACING_PIECEWISE, rng, single_jitter)


def uniform_sampler(
    ray_bundle: RayBundle, num_samples: int, rng: Rng = None, single_jitter: bool = False
) -> RaySamples:
    """spaced.py:71-72: evenly spaced in distance."""
    return spaced_sampler(ray_bundle, num_samples, SPACING_UNIFORM, rng, single_jitter)


def linear_disparity_sampler(
    ray_bundle: RayBundle, num_samples: int, rng: Rng = None, single_jitter: bool = False
) -> RaySamples:
    """spaced.py:75-76: evenly spaced in disparity (the background's samples)."""
    return spaced_sampler(ray_bundle, num_samples, SPACING_LINDISP, rng, single_jitter)
