"""DtoO, ``dto`` (counterpart of ``sdfstudio_tpu/models/dto.py``): the
reference's shipped configuration (``use_nerfacto=False``,
``method="neus"``), a NeuS SDF trained inside the coarse and fine occupancy
grids with the same voxel- and surface-guided sampling as ``neusW``
(``models/neuralreconW.py``) and the ``"grid"`` background behind the
surface at 4 samples a ray.

What differs from ``neusW`` (dto.py:76-150): the coarse grid lies over
``[-1, 1]^3`` whatever the scene's aabb, a missing coarse grid masks
nothing in the refresh, the fine grid's resolution is
``fine_grid_resolution``, the sphere collider's radius is 1 and the cosine
anneal ends at step 20,000.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdfstudio_tpu_torch.components.colliders import sphere_collider
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.neuralreconW import NeuralReconWModel
from sdfstudio_tpu_torch.models.neus import NeuSModelConfig

_UNIT_AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


@dataclasses.dataclass(frozen=True)
class DtoOModelConfig(NeuSModelConfig):
    """dto.py:48-72."""

    num_samples: int = 8
    num_samples_importance: int = 16
    num_up_sample_steps: int = 2
    base_variance: float = 512.0
    num_voxel_samples: int = 10
    background_model: str = "grid"
    num_samples_outside: int = 4
    eikonal_loss_mult: float = 1e-4
    fg_mask_loss_mult: float = 0.01
    coarse_probe_steps: int = 64
    fine_grid_resolution: int = 256
    fine_grid_update_every: int = 5000
    fine_grid_warmup: int = 5000
    fine_shell_margin: float = 0.03
    # read by nothing, as in the reference; kept so that JAX's argv and config tree parse
    smooth_loss_multi: float = 0.005


class DtoOModel(NeuralReconWModel):
    """dto.py:75-183."""

    anneal_end: int = 20000  # dto.py:144

    @property
    def fine_resolution(self) -> int:
        return self.config.fine_grid_resolution

    def coarse_grid_aabb(self) -> np.ndarray:
        return _UNIT_AABB

    def coarse_mask_at(self, res: int) -> torch.Tensor:
        """dto.py:103-111: all ones without a parser's coarse grid."""
        if self.scene_box.coarse_binary_grid is None:
            return torch.ones((res,) * 3, dtype=torch.bool, device=self.coarse_binary_grid.device)
        return super().coarse_mask_at(res)

    def apply_collider(self, ray_bundle: RayBundle, train: bool = False) -> RayBundle:
        """SphereCollider(radius=1.0) (dto.py:139, 185)."""
        return sphere_collider(ray_bundle, radius=1.0, soft_intersection=True)
