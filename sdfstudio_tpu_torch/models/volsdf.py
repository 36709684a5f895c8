"""VolSDF (counterpart of ``sdfstudio_tpu/models/volsdf.py``): the
error-bounded sampler, Laplace density and density compositing, the
eikonal loss of the base model, and the beta / alpha metrics."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModel, SurfaceModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.density import laplace_density
from sdfstudio_tpu_torch.samplers.error_bounded import error_bounded_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class VolSDFModelConfig(SurfaceModelConfig):
    """volsdf.py:20-24."""

    num_samples: int = 64
    num_samples_eval: int = 128
    num_samples_extra: int = 32
    max_total_iters: int = 5


class VolSDFModel(SurfaceModel):
    """volsdf.py:27-75."""

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        """volsdf.py:30-68: the sampler jitters in training."""
        cfg = self.config
        with record_function("sst/error_bounded_sampler"):
            ray_samples, eik_points = error_bounded_sampler(
                ray_bundle, laplace_density, self.sdf_at_starts, beta0=self.field.get_beta()[0],
                rng=rng if train else None, num_samples=cfg.num_samples,
                num_samples_eval=cfg.num_samples_eval, num_samples_extra=cfg.num_samples_extra,
                max_total_iters=cfg.max_total_iters,
            )
        field_outputs = self.field.get_outputs(ray_samples, train=train)
        weights, transmittance = R.weights_and_transmittance_from_densities(
            ray_samples.deltas, field_outputs["density"])
        return {
            "ray_samples": ray_samples,
            "eik_points": eik_points,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1:],
        }

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        m = super().get_metrics_dict(outputs, batch)
        beta = self.field.get_beta()[0]
        m["beta"] = beta
        m["alpha"] = 1.0 / beta
        return m
