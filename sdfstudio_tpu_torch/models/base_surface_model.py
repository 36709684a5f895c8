"""Base surface model, eval forward (counterpart of
``sdfstudio_tpu/models/base_surface_model.py``).

Models are ``nn.Module``s; the schedule-driven state arrives as a ``sched``
dict computed from ``step`` (base_surface_model.py:1-9), as in JAX.
Training (losses, ``train=True``) and background fields are later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from sdfstudio_tpu_torch.components.colliders import apply_collider
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.fields.sdf_field import SDFField, SDFFieldConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.contraction import contract


@dataclasses.dataclass(frozen=True)
class SurfaceModelConfig:
    """The fields of ``SurfaceModelConfig`` (base_surface_model.py:29-69) this slice reads."""

    near_plane: float = 0.05
    far_plane: float = 4.0
    background_color: str = "black"
    sdf_field: SDFFieldConfig = SDFFieldConfig()
    background_model: str = "mlp"
    overwrite_near_far_plane: bool = False
    scene_contraction_norm: str = "inf"
    eval_num_rays_per_chunk: int = 1024


class SurfaceModel(nn.Module):
    """Shared machinery of the surface methods (base_surface_model.py:72-260)."""

    def __init__(self, config: SurfaceModelConfig, scene_box: SceneBox, num_train_data: int):
        super().__init__()
        if config.background_model != "none":
            raise NotImplementedError("background fields are not ported yet (background_model='none')")
        self.config = config
        self.scene_box = scene_box
        self.num_train_data = num_train_data
        self.field = SDFField(
            config.sdf_field, num_images=num_train_data,
            spatial_distortion=config.scene_contraction_norm,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)

    def schedules(self, step: float) -> Dict[str, float]:
        return {"cos_anneal_ratio": 1.0}

    def apply_collider(self, ray_bundle: RayBundle, train: bool = False) -> RayBundle:
        """base_surface_model.py:114-129."""
        sb = self.scene_box
        if self.config.overwrite_near_far_plane:
            return apply_collider(ray_bundle, sb, "near_far", self.config.near_plane,
                                  self.config.far_plane)
        return apply_collider(
            ray_bundle, sb, sb.collider_type, near_plane=sb.near, far_plane=sb.far,
            radius=sb.radius, soft_intersection=True, training=train,
        )

    def contract(self, x: torch.Tensor) -> torch.Tensor:
        return contract(x, order=math.inf if self.config.scene_contraction_norm == "inf" else None)

    def sample_and_forward_field(self, ray_bundle: RayBundle, sched: Dict) -> Dict:
        raise NotImplementedError

    @torch.no_grad()
    def get_outputs(
        self, ray_bundle: RayBundle, sched: Optional[Dict] = None, train: bool = False
    ) -> Dict[str, torch.Tensor]:
        """Eval forward (base_surface_model.py:164-260 with ``train=False``)."""
        if train:
            raise NotImplementedError("the training forward is the next slice's work")
        sched = sched or self.schedules(1_000_000)
        ray_bundle = self.apply_collider(ray_bundle, train=False)
        s = self.sample_and_forward_field(ray_bundle, sched)
        field_outputs, ray_samples, weights = s["field_outputs"], s["ray_samples"], s["weights"]

        rgb = R.render_rgb(field_outputs["rgb"], weights, background_color=self.config.background_color)
        depth = R.render_depth_expected(weights, ray_samples.starts, ray_samples.ends)
        if ray_bundle.directions_norm is not None:
            depth = depth / ray_bundle.directions_norm
        normal = R.render_semantics(field_outputs["normal"], weights)
        outputs = {
            "rgb": rgb,
            "accumulation": R.render_accumulation(weights),
            "depth": depth,
            "normal": normal,
            "weights": weights,
            "ray_points": self.contract(ray_samples.get_start_positions()),
            "directions_norm": ray_bundle.directions_norm,
            "normal_vis": (normal + 1.0) / 2.0,
        }
        for i in range(len(s.get("weights_list", [])) - 1):
            rs = s["ray_samples_list"][i]
            outputs[f"prop_depth_{i}"] = R.render_depth_expected(
                s["weights_list"][i], rs.starts, rs.ends
            )
        return outputs
