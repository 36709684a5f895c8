"""Neuralangelo (counterpart of ``sdfstudio_tpu/models/neuralangelo.py``):
the NeuS sampler and field with numerical gradients, the progressive hash
mask, the numerical-gradient step that shrinks with it, and the curvature
loss on the taps (neuralangelo.py:20-84)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class NeuralangeloModelConfig(NeuSModelConfig):
    """neuralangelo.py:20-28."""

    enable_progressive_hash_encoding: bool = True
    enable_numerical_gradients_schedule: bool = True
    enable_curvature_loss_schedule: bool = True
    curvature_loss_multi: float = 5e-4
    curvature_loss_warmup_steps: int = 5000
    level_init: int = 4
    steps_per_level: int = 5000


class NeuralangeloModel(NeuSModel):
    """neuralangelo.py:31-84."""

    def schedules(self, step: float) -> Dict:
        """neuralangelo.py:34-69, in float32 as JAX evaluates them at a
        traced step: ``numerical_delta = 2 max(1 / max_res, 1 / (base_res
        growth^(step / spl)))``, the ``hash_mask`` [L*F] of the first
        ``max(floor(step / spl) + 1, level_init)`` levels, and the curvature
        factor, ``step / warmup`` during the warmup and the shrinking
        delta's ratio to ``1 / base_res`` after it."""
        cfg, fcfg = self.config, self.field.config
        sched = super().schedules(step)
        growth = (math.exp((math.log(fcfg.max_res) - math.log(fcfg.base_res)) / (fcfg.num_levels - 1))
                  if fcfg.num_levels > 1 else 1.0)
        f32 = np.float32
        s, spl, g = f32(step), f32(cfg.steps_per_level), f32(growth)
        with np.errstate(over="ignore"):  # far past the last level growth^k is inf, as in JAX
            sched.update(self._grid_schedules(s, spl, g))
        return sched

    def _grid_schedules(self, s, spl, g) -> Dict:
        cfg, fcfg = self.config, self.field.config
        f32 = np.float32
        sched = {}
        floor_delta = f32(1.0 / fcfg.max_res)
        if cfg.enable_numerical_gradients_schedule:
            delta = f32(1.0) / (f32(fcfg.base_res) * g ** (s / spl))
            sched["numerical_delta"] = float(max(floor_delta, delta) * f32(2.0))
        if cfg.enable_progressive_hash_encoding:
            level = max(int(np.floor(s / spl)) + 1, cfg.level_init)
            F = fcfg.hash_features_per_level
            feat_level = torch.arange(fcfg.num_levels * F) // F
            device = self.field.laplace_beta.device
            sched["hash_mask"] = (feat_level < level).to(torch.float32).to(device)
        if cfg.enable_curvature_loss_schedule:
            w = cfg.curvature_loss_warmup_steps
            if s < f32(w):
                sched["curvature_factor"] = float(s / f32(w))
            else:
                decay = f32(1.0) / (f32(fcfg.base_res) * g ** ((s - f32(w)) / spl))
                init_delta = f32(1.0 / fcfg.base_res)
                sched["curvature_factor"] = float(max(floor_delta, decay) / init_delta)
        else:
            sched["curvature_factor"] = 1.0
        return sched

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """The surface losses plus the curvature term on the taps
        (neuralangelo.py:71-84), times its multiplier and the scheduled
        factor."""
        loss_dict = super().get_loss_dict(outputs, batch, sched, rng)
        cfg = self.config
        fo = outputs["field_outputs"]
        if cfg.curvature_loss_multi > 0.0 and "sampled_sdf" in fo:
            delta = sched.get("numerical_delta", 1e-4)
            loss_dict["curvature_loss"] = (L.curvature_loss(fo["sampled_sdf"], fo["sdf"], delta)
                                           * cfg.curvature_loss_multi * sched["curvature_factor"])
        return loss_dict
