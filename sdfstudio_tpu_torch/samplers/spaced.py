"""Spacing-function samplers (counterpart of ``sdfstudio_tpu/samplers/spaced.py``)."""
from __future__ import annotations

import torch

from sdfstudio_tpu_torch.core.rays import (
    SPACING_PIECEWISE,
    RayBundle,
    RaySamples,
    spacing_fn,
    spacing_fn_inv,
)
from sdfstudio_tpu_torch.utils import checks


def spaced_sampler(ray_bundle: RayBundle, num_samples: int, kind: str) -> RaySamples:
    """Evenly spaced samples under a spacing warp, without jitter (spaced.py:27-64
    with ``rng=None``; jittered sampling is training's)."""
    checks.check_ray_bundle(ray_bundle)
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=ray_bundle.origins.device)
    bins = bins[None, :].expand(ray_bundle.num_rays, num_samples + 1)
    s_near = spacing_fn(kind, ray_bundle.nears)
    s_far = spacing_fn(kind, ray_bundle.fars)
    euclidean_bins = spacing_fn_inv(kind, bins * s_far + (1.0 - bins) * s_near)
    return ray_bundle.get_ray_samples(
        euclidean_bins=euclidean_bins, spacing_bins=bins, spacing_kind=kind,
        s_near=s_near, s_far=s_far,
    )


def uniform_lindisp_piecewise_sampler(ray_bundle: RayBundle, num_samples: int) -> RaySamples:
    """spaced.py:93-94: uniform up to distance 1, linear in disparity beyond."""
    return spaced_sampler(ray_bundle, num_samples, SPACING_PIECEWISE)
