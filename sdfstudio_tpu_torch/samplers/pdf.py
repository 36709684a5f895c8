"""Inverse-CDF resampling (counterpart of ``sdfstudio_tpu/samplers/pdf.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from sdfstudio_tpu_torch.core.math import searchsorted_right
from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform
from sdfstudio_tpu_torch.utils import checks


def sample_pdf_bins(
    existing_bins: torch.Tensor,  # [R, N+1] spacing coords
    weights: torch.Tensor,  # [R, N]
    num_samples: int,
    rng: Rng = None,
    single_jitter: bool = False,
    histogram_padding: float = 0.01,
    include_original: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``num_samples + 1`` new bin edges from the weight histogram
    (pdf.py:21-78): the inverse CDF at the bin midpoints, or, with an
    ``rng``, at jittered positions (one draw per ray under ``single_jitter``)."""
    checks.check_bins_weights(existing_bins, weights, "sample_pdf_bins")
    num_bins = num_samples + 1
    weights = weights + histogram_padding
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.relu(eps - weights_sum)
    weights = weights + padding / weights.shape[-1]
    weights_sum = weights_sum + padding
    pdf = weights / weights_sum
    cdf = torch.clamp(torch.cumsum(pdf, dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [R, N+1]

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=cdf.device)
    if rng is not None:
        shape = (*cdf.shape[:-1], 1 if single_jitter else num_bins)
        u = u + uniform(rng, shape, cdf.device) / num_bins
    else:
        u = (u + 1.0 / (2 * num_bins)).expand(*cdf.shape[:-1], num_bins)

    inds = searchsorted_right(cdf, u)
    n = existing_bins.shape[-1]
    below = torch.clamp(inds - 1, 0, n - 1)
    above = torch.clamp(inds, 0, n - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    bins_g0 = torch.gather(existing_bins, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g1 = torch.gather(existing_bins, -1, above)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0), 0.0, 1.0)
    bins = bins_g0 + t * (bins_g1 - bins_g0)
    if include_original:
        bins = torch.sort(torch.cat([existing_bins, bins], -1), dim=-1).values
    return bins.detach()


def pdf_sampler(
    ray_bundle: RayBundle,
    ray_samples: RaySamples,
    weights: torch.Tensor,
    num_samples: int,
    rng: Rng = None,
    single_jitter: bool = False,
    histogram_padding: float = 0.01,
    include_original: bool = True,
) -> RaySamples:
    """PDF resampling over the existing bins (pdf.py:81-109)."""
    existing_bins = torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], -1)
    bins = sample_pdf_bins(
        existing_bins, weights, num_samples, rng=rng, single_jitter=single_jitter,
        histogram_padding=histogram_padding, include_original=include_original,
    )
    return ray_bundle.get_ray_samples(
        euclidean_bins=ray_samples.spacing_to_euclidean(bins),
        spacing_bins=bins,
        spacing_kind=ray_samples.spacing_kind,
        s_near=ray_samples.s_near,
        s_far=ray_samples.s_far,
    )


def merge_ray_samples(
    ray_bundle: RayBundle, samples_1: RaySamples, samples_2: RaySamples
) -> Tuple[RaySamples, torch.Tensor]:
    """Merge two sample sets by their spacing starts (pdf.py:112-138); the
    index reorders concat([values_1, values_2]) into the merged order."""
    concat = torch.cat([samples_1.spacing_starts, samples_2.spacing_starts], -1)
    ends = torch.maximum(samples_1.spacing_ends[..., -1:], samples_2.spacing_ends[..., -1:])
    sorted_index = torch.argsort(concat, dim=-1, stable=True)
    bins = torch.cat([torch.gather(concat, -1, sorted_index), ends], -1).detach()
    merged = ray_bundle.get_ray_samples(
        euclidean_bins=samples_1.spacing_to_euclidean(bins),
        spacing_bins=bins,
        spacing_kind=samples_1.spacing_kind,
        s_near=samples_1.s_near,
        s_far=samples_1.s_far,
    )
    return merged, sorted_index
