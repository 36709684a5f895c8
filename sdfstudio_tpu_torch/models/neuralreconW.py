"""NeuralReconW, ``neusW`` (counterpart of ``sdfstudio_tpu/models/neuralreconW.py``):
NeuS rendering with voxel- and surface-guided sampling
(``samplers/surface_guided.py``) between two occupancy grids.

- The COARSE grid is the heritage parser's binary occupancy from the
  sparse cloud (``scene_box.coarse_binary_grid``; all ones at 32^3 without
  one) over the scene's aabb. It tightens each ray's bounds and holds the
  10 uniform samples.
- The FINE grid is the model state. It starts disarmed (empty). Every
  ``fine_grid_update_every`` steps (step 0 included) it is refreshed from
  ``sdf <= 0`` at the voxel centres inside coarse-occupied cells, in chunks
  of 65,536 points, and from ``fine_grid_warmup`` on it is armed: the NeuS
  bounds then collapse to a +-0.03 shell around a ray's first fine hit.

The sphere collider replaces the scene's (neuralreconW.py:111-116), and the
``"grid"`` background takes each ray beyond its far bound (4 samples).
The refresh runs under the profiler range ``sst/model_state_update``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.components.colliders import sphere_collider
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.grid import OccupancyGrid
from sdfstudio_tpu_torch.samplers.spaced import Rng
from sdfstudio_tpu_torch.samplers.surface_guided import voxel_surface_guided_samples

REFRESH_CHUNK = 1 << 16  # the fine grid's refresh evaluates the SDF in chunks of this many points


@dataclasses.dataclass(frozen=True)
class NeuralReconWModelConfig(NeuSModelConfig):
    """neuralreconW.py:38-52."""

    num_samples: int = 8
    num_samples_importance: int = 16
    num_up_sample_steps: int = 2
    base_variance: float = 512.0
    num_voxel_samples: int = 10
    coarse_probe_steps: int = 64
    fine_shell_margin: float = 0.03
    grid_resolution: int = 256
    fine_grid_update_every: int = 5000
    fine_grid_warmup: int = 5000
    background_model: str = "grid"
    num_samples_outside: int = 4
    eikonal_loss_mult: float = 1e-4


class NeuralReconWModel(NeuSModel):
    """neuralreconW.py:55-162."""

    has_model_state = True

    def __init__(self, config, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        coarse = self.coarse_binary()
        self.register_buffer("coarse_binary_grid", torch.as_tensor(coarse), persistent=False)
        self.register_buffer("coarse_aabb", torch.as_tensor(self.coarse_grid_aabb()),
                             persistent=False)

    @property
    def model_state_update_every(self) -> int:
        return self.config.fine_grid_update_every

    @property
    def fine_resolution(self) -> int:
        return self.config.grid_resolution

    # -- grids ----------------------------------------------------------
    def coarse_binary(self) -> np.ndarray:
        """The parser's coarse grid as [c, c, c] bool, or all ones at 32^3
        (neuralreconW.py:63-69)."""
        coarse = self.scene_box.coarse_binary_grid
        if coarse is None:
            return np.ones((32, 32, 32), bool)
        coarse = np.asarray(coarse, bool)
        cres = round(coarse.size ** (1 / 3))
        return coarse.reshape(cres, cres, cres)

    def coarse_grid_aabb(self) -> np.ndarray:
        return np.asarray(self.scene_box.aabb, np.float32)

    def coarse_grid(self) -> OccupancyGrid:
        grid = OccupancyGrid.create(self.coarse_aabb, resolution=self.coarse_binary_grid.shape[0])
        return grid.replace(binary=self.coarse_binary_grid)

    def coarse_mask_at(self, res: int) -> torch.Tensor:
        """The coarse grid repeated to ``res``^3 (neuralreconW.py:77-80)."""
        rep = res // self.coarse_binary_grid.shape[0]
        c = self.coarse_binary_grid
        return c.repeat_interleave(rep, 0).repeat_interleave(rep, 1).repeat_interleave(rep, 2)

    def init_model_state(self) -> OccupancyGrid:
        """The fine grid, disarmed: all empty (neuralreconW.py:82-89)."""
        res = self.fine_resolution
        grid = OccupancyGrid.create(self.coarse_aabb, resolution=res)
        return grid.replace(binary=torch.zeros((res,) * 3, dtype=torch.bool,
                                               device=self.coarse_aabb.device))

    @torch.no_grad()
    def update_model_state(self, model_state: OccupancyGrid, step: int, rng: Rng = None):
        """The fine grid refreshed from ``sdf <= 0`` at the voxel centres
        inside coarse-occupied cells, armed from ``fine_grid_warmup`` on
        (neuralreconW.py:91-107); the model's own parameters, no hash mask,
        and no jitter (``rng`` is unused)."""
        with record_function("sst/model_state_update"):
            res = model_state.resolution
            positions = model_state.cell_positions(None)
            sdf = torch.cat([self.field.sdf(p) for p in torch.split(positions, REFRESH_CHUNK)])
            inside = (sdf <= 0.0).reshape(res, res, res)
            armed = int(step) >= self.config.fine_grid_warmup
            return model_state.replace(binary=inside & self.coarse_mask_at(res) & armed)

    # -- forward --------------------------------------------------------
    def apply_collider(self, ray_bundle: RayBundle, train: bool = False) -> RayBundle:
        """The sphere collider (neuralreconW.py:111-116)."""
        return sphere_collider(ray_bundle, radius=self.scene_box.radius or 1.0,
                               soft_intersection=True)

    def sample_and_forward_field(self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None,
                                 train: bool = False,
                                 model_state: Optional[OccupancyGrid] = None) -> Dict:
        """neuralreconW.py:118-162; jitter only in training (``perturb``)."""
        cfg = self.config
        fine = model_state if model_state is not None else self.init_model_state()
        hash_mask = sched.get("hash_mask")
        ray_samples = voxel_surface_guided_samples(
            ray_bundle, self.coarse_grid(), fine, lambda s: self.sdf_at_starts(s, hash_mask),
            rng=rng if (train and cfg.perturb) else None,
            num_voxel_samples=cfg.num_voxel_samples, num_samples=cfg.num_samples,
            num_samples_importance=cfg.num_samples_importance,
            num_upsample_steps=cfg.num_up_sample_steps, base_variance=cfg.base_variance,
            coarse_probe_steps=cfg.coarse_probe_steps, fine_shell_margin=cfg.fine_shell_margin,
        )
        field_outputs = self.field.get_outputs(
            ray_samples, cos_anneal_ratio=sched["cos_anneal_ratio"], return_alphas=True,
            train=train, hash_mask=hash_mask, numerical_delta=sched.get("numerical_delta"),
        )
        weights, transmittance = R.weights_and_transmittance_from_alphas(field_outputs["alpha"])
        return {
            "ray_samples": ray_samples,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1:],
        }
