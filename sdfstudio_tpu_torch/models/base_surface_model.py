"""Base surface model (counterpart of ``sdfstudio_tpu/models/base_surface_model.py``):
the forward, the training losses and the metrics.

Models are ``nn.Module``s; the schedule-driven state arrives as a ``sched``
dict computed from ``step`` (base_surface_model.py:1-9), as in JAX.
Background fields are a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.components.colliders import apply_collider
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.fields.sdf_field import SDFField, SDFFieldConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class SurfaceModelConfig:
    """The fields of ``SurfaceModelConfig`` (base_surface_model.py:29-69) this slice reads."""

    near_plane: float = 0.05
    far_plane: float = 4.0
    background_color: str = "black"
    eikonal_loss_mult: float = 0.1
    fg_mask_loss_mult: float = 0.01
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

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        raise NotImplementedError

    def get_outputs(
        self,
        ray_bundle: RayBundle,
        sched: Optional[Dict] = None,
        train: bool = False,
        rng: Rng = None,
    ) -> Dict[str, torch.Tensor]:
        """The forward (base_surface_model.py:164-260). At eval
        (``train=False``) it runs under ``no_grad``; in training it keeps
        the graph and adds the per-sample gradients, the sample sets and the
        weights the losses read (base_surface_model.py:229-232)."""
        if not train:
            with torch.no_grad():
                return self._outputs(ray_bundle, sched, False, None)
        return self._outputs(ray_bundle, sched, True, rng)

    def _outputs(self, ray_bundle: RayBundle, sched: Optional[Dict], train: bool, rng: Rng) -> Dict:
        sched = sched or self.schedules(1_000_000)
        ray_bundle = self.apply_collider(ray_bundle, train=train)
        s = self.sample_and_forward_field(ray_bundle, sched, rng=rng, train=train)
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
        if train:
            outputs["eik_grad"] = field_outputs["gradient"]
            outputs["points_norm"] = field_outputs["points_norm"]
            outputs.update(s)
        for i in range(len(s.get("weights_list", [])) - 1):
            rs = s["ray_samples_list"][i]
            outputs[f"prop_depth_{i}"] = R.render_depth_expected(
                s["weights_list"][i], rs.starts, rs.ends
            )
        return outputs

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict) -> Dict[str, torch.Tensor]:
        """rgb L1 + eikonal (+ fg-mask BCE when the batch carries masks)
        (base_surface_model.py:280-318); the other terms of the JAX method
        are off in every configuration this port registers."""
        cfg = self.config
        loss_dict = {
            "rgb_loss": L.l1_loss(batch["image"], outputs["rgb"]),
            "eikonal_loss": L.eikonal_loss(outputs["eik_grad"]) * cfg.eikonal_loss_mult,
        }
        if "fg_mask" in batch and cfg.fg_mask_loss_mult > 0.0:
            fg_label = batch["fg_mask"].to(torch.float32)
            weights_sum = torch.clamp(torch.sum(outputs["weights"], dim=-1, keepdim=True), 1e-3, 1 - 1e-3)
            loss_dict["fg_mask_loss"] = L.binary_cross_entropy(weights_sum, fg_label) * cfg.fg_mask_loss_mult
        return loss_dict

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        """PSNR of the batch (base_surface_model.py:396-399)."""
        mse = torch.mean((outputs["rgb"] - batch["image"]) ** 2)
        return {"psnr": -10.0 * torch.log10(mse)}
