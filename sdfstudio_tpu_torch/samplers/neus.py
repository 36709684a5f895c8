"""NeuS hierarchical sampler (counterpart of ``sdfstudio_tpu/samplers/neus.py``).

Uniform samples, then ``num_upsample_steps`` rounds of importance sampling
with a doubling fixed inv_s. Each round evaluates the SDF only at the new
samples and merges the cached values through the sort permutation
(neus.py:1-9). The round count is static and no value returns to the host
between rounds."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.ops.density import neus_alpha_fixed_inv_s
from sdfstudio_tpu_torch.ops.render import weights_from_alphas
from sdfstudio_tpu_torch.samplers.pdf import merge_ray_samples, pdf_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform_sampler
from sdfstudio_tpu_torch.utils import checks


def neus_sampler(
    ray_bundle: RayBundle,
    sdf_fn: Callable[[RaySamples], torch.Tensor],  # samples -> [R, S] sdf at the bin starts
    rng: Rng = None,
    num_samples: int = 64,
    num_samples_importance: int = 64,
    num_upsample_steps: int = 4,
    base_variance: float = 64.0,
    single_jitter: bool = True,
    initial_samples: Optional[RaySamples] = None,
) -> RaySamples:
    """The NeuS samples of every ray (neus.py:25-81). ``sdf_fn`` is
    evaluated without a gradient."""
    checks.check_ray_bundle(ray_bundle)
    ray_samples = (initial_samples if initial_samples is not None
                   else uniform_sampler(ray_bundle, num_samples, rng=rng, single_jitter=single_jitter))
    sdf = sorted_index = None
    new_samples = ray_samples
    for it in range(num_upsample_steps):
        with torch.no_grad():
            new_sdf = sdf_fn(new_samples)
        sdf = new_sdf if sorted_index is None else torch.gather(
            torch.cat([sdf, new_sdf], -1), -1, sorted_index)
        alphas = neus_alpha_fixed_inv_s(sdf, ray_samples.deltas[..., :-1],
                                        inv_s=base_variance * 2**it)  # [R, S-1]
        weights = weights_from_alphas(alphas)
        weights = torch.cat([weights, torch.zeros_like(weights[..., :1])], -1)
        new_samples = pdf_sampler(
            ray_bundle, ray_samples, weights, num_samples=num_samples_importance // num_upsample_steps,
            rng=rng, single_jitter=single_jitter, histogram_padding=1e-5, include_original=False,
        )
        ray_samples, sorted_index = merge_ray_samples(ray_bundle, ray_samples, new_samples)
    return ray_samples
