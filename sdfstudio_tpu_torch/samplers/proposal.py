"""Proposal-network sampler, eval branch (counterpart of
``sdfstudio_tpu/samplers/proposal.py``): N rounds of density evaluation and
PDF resampling. At eval no gradient flows, so the JAX ``train_proposal``
gate (proposal.py:75-99) has nothing to select."""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.ops.render import weights_from_densities
from sdfstudio_tpu_torch.samplers.pdf import pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import uniform_lindisp_piecewise_sampler
from sdfstudio_tpu_torch.utils import checks


def proposal_network_sampler(
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    num_proposal_samples_per_ray: Tuple[int, ...] = (64,),
    num_nerf_samples_per_ray: int = 32,
    num_proposal_network_iterations: int = 2,
    anneal: float = 1.0,
) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Returns (final samples, weights_list, ray_samples_list) (proposal.py:27-100)."""
    checks.check_ray_bundle(ray_bundle)
    n = num_proposal_network_iterations
    if len(density_fns) < n:
        raise ValueError(f"{n} proposal iterations need {n} density functions")
    weights_list: List[torch.Tensor] = []
    ray_samples_list: List[RaySamples] = []
    weights = ray_samples = None
    for i_level in range(n + 1):
        is_prop = i_level < n
        num_samples = num_proposal_samples_per_ray[i_level] if is_prop else num_nerf_samples_per_ray
        if i_level == 0:
            ray_samples = uniform_lindisp_piecewise_sampler(ray_bundle, num_samples)
        else:
            ray_samples = pdf_sampler(
                ray_bundle, ray_samples, torch.pow(weights, anneal),
                num_samples=num_samples, include_original=False,
            )
        if is_prop:
            density = density_fns[i_level](ray_samples.get_positions())
            weights = weights_from_densities(ray_samples.deltas, density)
            weights_list.append(weights)
            ray_samples_list.append(ray_samples)
    return ray_samples, weights_list, ray_samples_list
