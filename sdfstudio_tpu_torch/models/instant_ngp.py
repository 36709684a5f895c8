"""Instant-NGP (counterpart of ``sdfstudio_tpu/models/instant_ngp.py``):
a NeRF on the nerfacto field over the scene's aabb (no contraction), with
occupancy-grid empty-space skipping.

The model state is a 128^3 grid over the aabb, fully occupied at first.
Every 16 steps (step 0 included) the trainer refreshes it with the EMA of
each cell's one-step opacity, ``1 - exp(-density * render_step_size)`` at
its jittered centre (``samplers/grid.py::update_occupancy_grid``). A ray
is clipped to the aabb (``aabb_box_collider``, near 0.05 in training)
and marched in ``max_num_samples_per_ray`` steps of ``render_step_size``
from its near; every sample is evaluated and the density of those outside
occupied cells (or past the far bound) is masked to 0, as JAX does with
static shapes. In training the rays composite over a random colour a ray
(``background_color="random"``), at eval over black. ``num_samples_per_ray``
counts the valid samples; its sum over the batch, ``num_samples_per_batch``,
drives the trainer's dynamic batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.components.colliders import aabb_box_collider
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField
from sdfstudio_tpu_torch.models.base_model import Model, ModelConfig
from sdfstudio_tpu_torch.models.neuralreconW import REFRESH_CHUNK
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.grid import (OccupancyGrid, occupancy_grid_sampler,
                                               update_occupancy_grid)
from sdfstudio_tpu_torch.samplers.spaced import Rng, uniform


@dataclasses.dataclass(frozen=True)
class InstantNGPModelConfig(ModelConfig):
    """instant_ngp.py:31-44."""

    enable_collider: bool = False
    grid_resolution: int = 128
    max_num_samples_per_ray: int = 256
    cone_angle: float = 0.0
    render_step_size: float = 0.01
    near_plane: float = 0.05
    far_plane: float = 1000.0
    alpha_thre: float = 1e-2
    background_color: str = "random"
    randomize_background: bool = True
    eval_num_rays_per_chunk: int = 8192
    contraction_type: str = "aabb"  # aabb | inf


class NGPModel(Model):
    """instant_ngp.py:47-129."""

    has_model_state = True
    model_state_update_every = 16

    def __init__(self, config: InstantNGPModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        if config.contraction_type not in ("aabb", "inf"):
            raise ValueError(f"contraction_type={config.contraction_type!r}: one of aabb, inf")
        self.field = NerfactoField(
            aabb=scene_box.aabb,
            spatial_distortion=None if config.contraction_type == "aabb" else "inf",
            num_images=num_train_data, use_appearance_embedding=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)

    def init_model_state(self) -> OccupancyGrid:
        return OccupancyGrid.create(self.scene_box.aabb, resolution=self.config.grid_resolution,
                                    device=self.field.aabb.device)

    @torch.no_grad()
    def update_model_state(self, model_state: OccupancyGrid, step: int, rng: Rng = None):
        """The grid's EMA refresh at the field's densities, the cell centres
        jittered within their cells by ``rng`` (instant_ngp.py:69-77)."""
        with record_function("sst/model_state_update"):
            def density_fn(positions):
                return torch.cat([self.field.density_fn(p)
                                  for p in torch.split(positions, REFRESH_CHUNK)])

            return update_occupancy_grid(model_state, density_fn, rng,
                                         occ_threshold=self.config.alpha_thre,
                                         render_step_size=self.config.render_step_size)

    def apply_collider(self, ray_bundle: RayBundle, train: bool = False) -> RayBundle:
        """instant_ngp.py:79-85."""
        aabb = torch.as_tensor(self.scene_box.aabb, dtype=ray_bundle.origins.dtype,
                               device=ray_bundle.origins.device)
        return aabb_box_collider(ray_bundle, aabb, near_plane=self.config.near_plane, training=train)

    def _outputs(self, ray_bundle: RayBundle, sched, train: bool, rng: Rng,
                 model_state: Optional[OccupancyGrid] = None) -> Dict:
        """instant_ngp.py:87-121: the sampler's jitter and the random
        background are the ``rng``'s first and second draws."""
        cfg = self.config
        ray_bundle = self.apply_collider(ray_bundle, train)
        grid = model_state if model_state is not None else self.init_model_state()
        ray_samples, valid = occupancy_grid_sampler(
            ray_bundle, grid, num_samples=cfg.max_num_samples_per_ray, rng=rng,
            render_step_size=cfg.render_step_size)
        field_outputs = self.field.get_outputs(ray_samples, train=train)
        density = field_outputs["density"] * valid
        weights = R.weights_from_densities(ray_samples.deltas, density)
        if cfg.background_color == "random" and train and rng is not None:
            bg = uniform(rng, (ray_bundle.num_rays, 3), weights.device).to(weights.dtype)
            rgb = R.render_rgb(field_outputs["rgb"], weights, background_rgb=bg)
        else:
            bgc = cfg.background_color if cfg.background_color != "random" else "black"
            rgb = R.render_rgb(field_outputs["rgb"], weights, background_color=bgc)
        return {
            "rgb": rgb,
            "accumulation": R.render_accumulation(weights),
            "depth": R.render_depth_expected(weights, ray_samples.starts, ray_samples.ends),
            "num_samples_per_ray": torch.sum(valid, dim=-1),
        }

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """The rgb MSE (instant_ngp.py:123-124)."""
        return {"rgb_loss": torch.mean((batch["image"] - outputs["rgb"]) ** 2)}

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        """PSNR and the batch's valid samples (instant_ngp.py:126-129)."""
        m = super().get_metrics_dict(outputs, batch)
        m["num_samples_per_batch"] = torch.sum(outputs["num_samples_per_ray"])
        return m
