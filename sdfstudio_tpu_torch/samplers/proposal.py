"""Proposal-network sampler (counterpart of ``sdfstudio_tpu/samplers/proposal.py``):
N rounds of density evaluation and PDF resampling, with the
``train_proposal`` gradient gate."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.ops.render import weights_from_densities
from sdfstudio_tpu_torch.samplers.pdf import pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform_lindisp_piecewise_sampler
from sdfstudio_tpu_torch.utils import checks


def proposal_network_sampler(
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    rng: Rng = None,
    num_proposal_samples_per_ray: Tuple[int, ...] = (64,),
    num_nerf_samples_per_ray: int = 32,
    num_proposal_network_iterations: int = 2,
    single_jitter: bool = False,
    anneal: float = 1.0,
    train_proposal: bool = True,
) -> Tuple[RaySamples, List[torch.Tensor], List[RaySamples]]:
    """Returns (final samples, weights_list, ray_samples_list) (proposal.py:27-100).

    The gate is the ``"where"`` form p8's MLP proposal fields run
    (neus_facto.py:197-202): on a frozen step (``train_proposal`` False)
    the proposal densities carry no gradient. Here they are evaluated under
    ``no_grad`` then, which gives the same values and the same zero
    gradient without building the graph."""
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
            ray_samples = uniform_lindisp_piecewise_sampler(
                ray_bundle, num_samples, rng=rng, single_jitter=single_jitter
            )
        else:
            ray_samples = pdf_sampler(
                ray_bundle, ray_samples, torch.pow(weights.detach(), anneal),
                num_samples=num_samples, rng=rng, single_jitter=single_jitter,
                include_original=False,
            )
        if is_prop:
            positions = ray_samples.get_positions()
            with torch.set_grad_enabled(torch.is_grad_enabled() and bool(train_proposal)):
                density = density_fns[i_level](positions)
            weights = weights_from_densities(ray_samples.deltas, density)
            weights_list.append(weights)
            ray_samples_list.append(ray_samples)
    return ray_samples, weights_list, ray_samples_list
