"""Density model base (counterpart of ``sdfstudio_tpu/models/base_model.py``):
the configuration and the machinery that the density methods share
(``nerfacto``, ``phototourism``, ``instant-ngp``, ``vanilla-nerf``,
``mipnerf``, ``dnerf``, ``tensorf`` and ``semantic-nerfw``).

As with the surface models, a model is an ``nn.Module`` whose
schedule-driven state arrives as a ``sched`` dict computed from ``step``;
``get_outputs`` runs under ``no_grad`` at eval (``train=False``) and keeps
the graph in training. A model with ``has_model_state`` (``instant-ngp``'s
occupancy grid) takes the trainer's state in ``get_outputs``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sdfstudio_tpu_torch.components.colliders import near_far_collider
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """base_model.py:20-32: the near / far collider (which ``nerfacto`` and
    ``instant-ngp`` replace with their own), and the coefficients that
    ``scale_losses`` puts on the NeRF models' two rgb losses."""

    enable_collider: bool = True
    collider_near: float = 2.0
    collider_far: float = 6.0
    loss_coefficients: Tuple[Tuple[str, float], ...] = (
        ("rgb_loss_coarse", 1.0),
        ("rgb_loss_fine", 1.0),
    )
    eval_num_rays_per_chunk: int = 4096


class Model(nn.Module):
    """base_model.py:35-65."""

    has_model_state = False  # a model with one adds init_model_state / update_model_state

    def __init__(self, config: ModelConfig, scene_box: SceneBox, num_train_data: int):
        super().__init__()
        self.config = config
        self.scene_box = scene_box
        self.num_train_data = num_train_data

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def schedules(self, step: float) -> Dict:
        return {}

    def apply_collider(self, ray_bundle: RayBundle, train: bool = False) -> RayBundle:
        """Constant near and far planes when ``enable_collider`` (base_model.py:50-55)."""
        if self.config.enable_collider:
            return near_far_collider(ray_bundle, self.config.collider_near, self.config.collider_far)
        return ray_bundle

    def scale_losses(self, loss_dict: Dict) -> Dict:
        """Each loss times its ``loss_coefficients`` entry, 1 without one (base_model.py:67-69)."""
        coeffs = dict(self.config.loss_coefficients)
        return {k: v * coeffs.get(k, 1.0) for k, v in loss_dict.items()}

    def get_outputs(self, ray_bundle: RayBundle, sched: Optional[Dict] = None, train: bool = False,
                    rng: Rng = None, model_state=None) -> Dict[str, torch.Tensor]:
        """The forward; under ``no_grad`` at eval."""
        if not train:
            with torch.no_grad():
                return self._outputs(ray_bundle, sched, False, None, model_state)
        return self._outputs(ray_bundle, sched, True, rng, model_state)

    def _outputs(self, ray_bundle: RayBundle, sched: Optional[Dict], train: bool, rng: Rng,
                 model_state=None) -> Dict:
        raise NotImplementedError

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        """PSNR of the batch, its MSE floored at 1e-12 (base_model.py:62-65)."""
        mse = torch.mean((outputs["rgb"] - batch["image"]) ** 2)
        return {"psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12))}
