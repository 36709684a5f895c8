"""NeuS model schedules (counterpart of ``sdfstudio_tpu/models/neus.py``).

Only the cos-anneal schedule (neus.py:28-38) is on this slice; the NeuS
sampler path (``neus_sampler``) is a later slice."""
from __future__ import annotations

import dataclasses
from typing import Dict

from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModel, SurfaceModelConfig


@dataclasses.dataclass(frozen=True)
class NeuSModelConfig(SurfaceModelConfig):
    pass


class NeuSModel(SurfaceModel):
    anneal_end: int = 50000  # neus.py:31

    def schedules(self, step: float) -> Dict[str, float]:
        sched = super().schedules(step)
        if self.anneal_end > 0:
            sched["cos_anneal_ratio"] = min(1.0, float(step) / self.anneal_end)
        return sched
