"""BakedAngelo (counterpart of ``sdfstudio_tpu/models/bakedangelo.py``):
BakedSDF with Neuralangelo's schedules -- the numerical-gradient delta
(scaled by 4 for the field's ``(x + 2) / 4`` input), the progressive hash
mask and the curvature factor -- and the curvature loss on the numerical
gradient's taps (bakedangelo.py:18-81). The schedules are
``neus-facto-angelo``'s formulas (``models/neus_facto.py::angelo_grid_schedules``)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.models.bakedsdf import BakedSDFFactoModel, BakedSDFModelConfig
from sdfstudio_tpu_torch.models.neus_facto import angelo_grid_schedules
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class BakedAngeloModelConfig(BakedSDFModelConfig):
    """bakedangelo.py:18-27."""

    enable_progressive_hash_encoding: bool = True
    enable_numerical_gradients_schedule: bool = True
    enable_curvature_loss_schedule: bool = True
    curvature_loss_multi: float = 5e-4
    curvature_loss_warmup_steps: int = 5000
    level_init: int = 4
    steps_per_level: int = 5000


class BakedAngeloModel(BakedSDFFactoModel):
    """bakedangelo.py:30-81."""

    def schedules(self, step: float) -> Dict:
        """BakedSDF's schedules and Neuralangelo's (bakedangelo.py:33-67),
        in float32."""
        sched = super().schedules(step)
        sched.update(angelo_grid_schedules(self.config, self.field.config, np.float32(step),
                                           self.field.laplace_beta.device))
        return sched

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """BakedSDF's losses and, with ``curvature_loss_multi > 0`` and the
        numerical taps, the curvature term times the scheduled factor
        (bakedangelo.py:69-81)."""
        loss_dict = super().get_loss_dict(outputs, batch, sched, rng)
        cfg = self.config
        fo = outputs["field_outputs"]
        if cfg.curvature_loss_multi > 0.0 and "sampled_sdf" in fo:
            delta = sched.get("numerical_delta", 1e-4)
            loss_dict["curvature_loss"] = (L.curvature_loss(fo["sampled_sdf"], fo["sdf"], delta)
                                           * cfg.curvature_loss_multi * sched["curvature_factor"])
        return loss_dict
