"""Voxel- and surface-guided sampling of ``neusW`` and ``dto`` (counterpart of
``sdfstudio_tpu/samplers/surface_guided.py``; the reference's
NeuralReconWSampler, which its DtoO model inlines):

1. each ray's [near, far] tightened against the COARSE binary grid (the
   parser's sparse-cloud occupancy);
2. ``num_voxel_samples`` uniform samples over those bounds;
3. once the FINE grid is armed (any cell set), the NeuS bounds collapse to
   +-``fine_shell_margin`` around the first fine hit; a disarmed grid hits
   nothing and the rays keep the coarse bounds;
4. the NeuS sampler (8 + 16 samples, 2 rounds, base variance 512) on the
   ray's own bounds or that shell;
5. the two sets merged by their euclidean starts.

Static shapes throughout (``samplers/grid.py``); plain PyTorch under the
profiler range ``sst/surface_guided_sampler``.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.samplers.grid import OccupancyGrid, grid_near_far
from sdfstudio_tpu_torch.samplers.neus import neus_sampler
from sdfstudio_tpu_torch.samplers.pdf import merge_ray_samples_in_euclidean
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform_sampler


def voxel_surface_guided_samples(
    ray_bundle: RayBundle,
    coarse_grid: OccupancyGrid,
    fine_grid: OccupancyGrid,
    sdf_fn: Callable[[RaySamples], torch.Tensor],
    rng: Rng,
    num_voxel_samples: int = 10,
    num_samples: int = 8,
    num_samples_importance: int = 16,
    num_upsample_steps: int = 2,
    base_variance: float = 512.0,
    coarse_probe_steps: int = 64,
    fine_shell_margin: float = 0.03,
) -> RaySamples:
    """The merged [R, num_voxel_samples + num_samples +
    num_samples_importance] samples (surface_guided.py:33-81). JAX splits
    its key between the voxel and the NeuS draws; the port's generator
    draws them one after the other."""
    with record_function("sst/surface_guided_sampler"):
        nears, fars, _ = grid_near_far(ray_bundle, coarse_grid, num_probes=coarse_probe_steps)
        coarse_bundle = ray_bundle.replace(nears=nears, fars=fars)
        voxel_samples = uniform_sampler(coarse_bundle, num_voxel_samples, rng=rng)
        f_nears, f_fars, _ = grid_near_far(coarse_bundle, fine_grid, num_probes=coarse_probe_steps,
                                           first_hit_shell=fine_shell_margin)
        neus_bundle = ray_bundle.replace(nears=f_nears, fars=f_fars)
        neus_samples = neus_sampler(
            neus_bundle, sdf_fn, rng=rng, num_samples=num_samples,
            num_samples_importance=num_samples_importance, num_upsample_steps=num_upsample_steps,
            base_variance=base_variance,
        )
        return merge_ray_samples_in_euclidean(coarse_bundle, neus_samples, voxel_samples)
