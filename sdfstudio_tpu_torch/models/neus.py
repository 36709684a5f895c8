"""NeuS model schedules and metrics (counterpart of ``sdfstudio_tpu/models/neus.py``).

The cos-anneal schedule (neus.py:28-38) and the s_val / inv_s metrics
(neus.py:77-83); the NeuS sampler path (``neus_sampler``) is a later slice."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModel, SurfaceModelConfig


@dataclasses.dataclass(frozen=True)
class NeuSModelConfig(SurfaceModelConfig):
    perturb: bool = True


class NeuSModel(SurfaceModel):
    anneal_end: int = 50000  # neus.py:31

    def schedules(self, step: float) -> Dict[str, float]:
        sched = super().schedules(step)
        if self.anneal_end > 0:
            sched["cos_anneal_ratio"] = min(1.0, float(step) / self.anneal_end)
        return sched

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        m = super().get_metrics_dict(outputs, batch)
        inv_s = self.field.get_inv_s()[0]
        m["s_val"] = inv_s
        m["inv_s"] = 1.0 / inv_s
        return m
