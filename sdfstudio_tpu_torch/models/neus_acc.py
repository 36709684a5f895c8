"""NeuS-acc, ``neus-acc`` (counterpart of ``sdfstudio_tpu/models/neus_acc.py``):
NeuS with occupancy-grid empty-space skipping.

The model state is a 128^3 grid over the scene's aabb, fully occupied at
first (the reference's bootstrap with dense sampling). Every 16 steps (step
0 included) it is pruned by the NeuS opacity of a straight crossing at each
(jittered) cell centre, with the step size adapted to ``inv_s``
(``14 / inv_s / 16``): a cell stays occupied where that opacity exceeds
``alpha_sample_thre``. A ray takes 128 fixed samples over its bounds and
every one is evaluated; ``alpha *= valid`` masks those outside occupied
cells, as JAX does with static shapes (nerfacc packed the valid ones in the
reference). The background stays ``"mlp"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.neuralreconW import REFRESH_CHUNK
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.grid import OccupancyGrid, occupancy_grid_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class NeuSAccModelConfig(NeuSModelConfig):
    """neus_acc.py:26-30."""

    grid_resolution: int = 128
    grid_update_every: int = 16
    num_samples_acc: int = 128
    alpha_sample_thre: float = 1e-3


class NeuSAccModel(NeuSModel):
    """neus_acc.py:33-92."""

    has_model_state = True

    @property
    def model_state_update_every(self) -> int:
        return self.config.grid_update_every

    def init_model_state(self) -> OccupancyGrid:
        return OccupancyGrid.create(self.scene_box.aabb, resolution=self.config.grid_resolution,
                                    device=self.field.laplace_beta.device)

    @torch.no_grad()
    def update_model_state(self, model_state: OccupancyGrid, step: int, rng: Rng = None):
        """The grid pruned by ``alpha(sdf, inv_s)`` at the cell centres,
        jittered within their cells by ``rng`` (neus_acc.py:45-60)."""
        with record_function("sst/model_state_update"):
            inv_s = self.field.get_inv_s()[0]
            step_size = 14.0 / inv_s / 16.0
            positions = model_state.cell_positions(rng)
            sdf = torch.cat([self.field.sdf(p) for p in torch.split(positions, REFRESH_CHUNK)])
            prev_cdf = torch.sigmoid((sdf + step_size * 0.5) * inv_s)
            next_cdf = torch.sigmoid((sdf - step_size * 0.5) * inv_s)
            alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
            res = model_state.resolution
            binary = (alpha > self.config.alpha_sample_thre).reshape(res, res, res)
            return model_state.replace(occs=alpha, binary=binary)

    def sample_and_forward_field(self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None,
                                 train: bool = False,
                                 model_state: Optional[OccupancyGrid] = None) -> Dict:
        """neus_acc.py:62-92; jitter only in training (``perturb``)."""
        grid = model_state if model_state is not None else self.init_model_state()
        ray_samples, valid = occupancy_grid_sampler(
            ray_bundle, grid, num_samples=self.config.num_samples_acc,
            rng=rng if (train and self.config.perturb) else None)
        field_outputs = dict(self.field.get_outputs(
            ray_samples, cos_anneal_ratio=sched["cos_anneal_ratio"], return_alphas=True,
            train=train, hash_mask=sched.get("hash_mask"),
            numerical_delta=sched.get("numerical_delta"),
        ))
        field_outputs["alpha"] = field_outputs["alpha"] * valid
        weights, transmittance = R.weights_and_transmittance_from_alphas(field_outputs["alpha"])
        return {
            "ray_samples": ray_samples,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1:],
            "valid_samples": valid,
            "num_samples_per_ray": torch.sum(valid, dim=-1),
        }
