"""NeuS (counterpart of ``sdfstudio_tpu/models/neus.py``): the NeuS sampler,
the SDF field with NeuS alpha and compositing, the cos-anneal schedule
(neus.py:28-38) and the s_val / inv_s metrics (neus.py:77-83)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModel, SurfaceModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.neus import neus_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class NeuSModelConfig(SurfaceModelConfig):
    """neus.py:21-26."""

    num_samples: int = 64
    num_samples_importance: int = 64
    num_up_sample_steps: int = 4
    base_variance: float = 64.0
    perturb: bool = True


class NeuSModel(SurfaceModel):
    anneal_end: int = 50000  # neus.py:31

    def schedules(self, step: float) -> Dict[str, float]:
        sched = super().schedules(step)
        if self.anneal_end > 0:
            sched["cos_anneal_ratio"] = min(1.0, float(step) / self.anneal_end)
        return sched

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        """neus.py:40-75; jitter only in training (``perturb``). The step's
        ``hash_mask`` reaches the sampler's SDF and the field, and its
        ``numerical_delta`` the field (neus.py:42, 59-64); methods without
        them pass None."""
        cfg = self.config
        hash_mask = sched.get("hash_mask")
        with record_function("sst/neus_sampler"):
            ray_samples = neus_sampler(
                ray_bundle, lambda s: self.sdf_at_starts(s, hash_mask),
                rng=rng if (train and cfg.perturb) else None,
                num_samples=cfg.num_samples, num_samples_importance=cfg.num_samples_importance,
                num_upsample_steps=cfg.num_up_sample_steps, base_variance=cfg.base_variance,
            )
        field_outputs = self.field.get_outputs(
            ray_samples, cos_anneal_ratio=sched["cos_anneal_ratio"], return_alphas=True, train=train,
            hash_mask=hash_mask, numerical_delta=sched.get("numerical_delta"),
        )
        weights, transmittance = R.weights_and_transmittance_from_alphas(field_outputs["alpha"])
        return {
            "ray_samples": ray_samples,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1:],
        }

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        m = super().get_metrics_dict(outputs, batch)
        inv_s = self.field.get_inv_s()[0]
        m["s_val"] = inv_s
        m["inv_s"] = 1.0 / inv_s
        return m
