"""UniSurf (counterpart of ``sdfstudio_tpu/models/unisurf.py``): the
surface-guided sampler, occupancy as alpha, the normal-smoothness loss in
place of the eikonal term, and the sampler's interval schedule
(``unisurf_delta``, a function of the step)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModel, SurfaceModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.density import unisurf_occupancy
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform
from sdfstudio_tpu_torch.samplers.unisurf import unisurf_interval_delta, unisurf_sampler

NOISE_SEED = 0  # the smoothness loss's noise without an rng (JAX: PRNGKey(0), unisurf.py:94)


@dataclasses.dataclass(frozen=True)
class UniSurfModelConfig(SurfaceModelConfig):
    """unisurf.py:23-29."""

    eikonal_loss_mult: float = 0.0  # UniSurf has no eikonal term
    smooth_loss_multi: float = 0.005
    num_samples_interval: int = 64
    num_samples_importance: int = 32
    num_marching_steps: int = 256
    perturb: bool = True


class UniSurfModel(SurfaceModel):
    """unisurf.py:32-110."""

    def __init__(self, config: UniSurfModelConfig, scene_box, num_train_data: int):
        if config.eikonal_loss_mult != 0.0:
            raise ValueError("UniSurf takes no eikonal loss (eikonal_loss_mult must be 0)")
        super().__init__(config, scene_box, num_train_data)

    def schedules(self, step: float) -> Dict[str, float]:
        sched = super().schedules(step)
        sched["unisurf_delta"] = unisurf_interval_delta(step)
        return sched

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        """unisurf.py:44-82; jitter only in training (``perturb``)."""
        cfg = self.config
        with record_function("sst/unisurf_sampler"):
            ray_samples, surface = unisurf_sampler(
                ray_bundle, unisurf_occupancy, self.sdf_at_starts, delta=sched["unisurf_delta"],
                rng=rng if (train and cfg.perturb) else None,
                num_samples_interval=cfg.num_samples_interval,
                num_samples_outside=cfg.num_samples_outside,
                num_samples_importance=cfg.num_samples_importance,
                num_marching_steps=cfg.num_marching_steps,
            )
        field_outputs = self.field.get_outputs(ray_samples, return_occupancy=True, train=train)
        weights, transmittance = R.weights_and_transmittance_from_alphas(field_outputs["occupancy"])
        return {
            "ray_samples": ray_samples,
            "surface_points": surface.points,
            "surface_points_mask": surface.mask,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1:],
        }

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """unisurf.py:84-106: the base losses without the eikonal term, and
        the smoothness of the normals between each ray's surface point and
        a neighbour within +-0.005, over the rays that found a surface."""
        loss_dict = super().get_loss_dict(outputs, batch, sched, rng)
        loss_dict.pop("eikonal_loss", None)
        if self.config.smooth_loss_multi > 0.0 and "surface_points" in outputs:
            pts = outputs["surface_points"]
            mask = outputs["surface_points_mask"].to(pts.dtype)
            if rng is None:
                rng = torch.Generator(device=pts.device).manual_seed(NOISE_SEED)
            neig = pts + (uniform(rng, pts.shape, pts.device) - 0.5) * 0.01
            grad = self.field.gradient(torch.cat([pts, neig], 0))
            normals = grad / torch.sqrt(torch.sum(grad**2, -1, keepdim=True) + 1e-12)
            n = pts.shape[0]
            # eps inside the sqrt: the norm's gradient is NaN at 0
            diff_norm = torch.sqrt(torch.sum((normals[:n] - normals[n:]) ** 2, -1) + 1e-12)
            loss_dict["normal_smoothness_loss"] = (
                torch.sum(diff_norm * mask) / torch.clamp(torch.sum(mask), min=1.0)
            ) * self.config.smooth_loss_multi
        return loss_dict
