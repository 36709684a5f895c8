"""Base surface model (counterpart of ``sdfstudio_tpu/models/base_surface_model.py``):
the forward, the training losses and the metrics.

Models are ``nn.Module``s; the schedule-driven state arrives as a ``sched``
dict computed from ``step`` (base_surface_model.py:1-9), as in JAX.
The background, the NeRF field (``"mlp"``) or the nerfacto grid field
(``"grid"``), is evaluated on each ray beyond its far bound and blended by
the foreground's last transmittance. A model with a ``model_state`` (the
occupancy grids of ``neusW``, ``dto`` and ``neus-acc``; ``has_model_state``)
takes it in ``get_outputs`` and hands it to its sampler.
``get_outputs_flexible`` adds Geo-NeuS's warped patches from the source
views (under the profiler range ``sst/patch_warping``), and
``get_loss_dict`` takes every term of JAX's but the periodic encoding's TV
(ROADMAP queue 1 item 3): the monocular normal and depth cues, the sensor
depth, the patch NCC, the SfM points' SDF and S3IM (``sst/cue_losses``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.components.colliders import apply_collider
from sdfstudio_tpu_torch.components.patch_warping import patch_warping
from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField
from sdfstudio_tpu_torch.fields.sdf_field import SDFField, SDFFieldConfig
from sdfstudio_tpu_torch.fields.vanilla_nerf_field import NeRFField
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.contraction import contract
from sdfstudio_tpu_torch.samplers.spaced import Rng, linear_disparity_sampler


@dataclasses.dataclass(frozen=True)
class SurfaceModelConfig:
    """The fields of ``SurfaceModelConfig`` (base_surface_model.py:29-69)
    the port reads, with JAX's defaults. ``periodic_tvl_mult > 0`` raises:
    it needs the periodic encoding (ROADMAP queue 1 item 3)."""

    near_plane: float = 0.05
    far_plane: float = 4.0
    far_plane_bg: float = 1000.0
    background_color: str = "black"
    use_average_appearance_embedding: bool = False
    eikonal_loss_mult: float = 0.1
    fg_mask_loss_mult: float = 0.01
    mono_normal_loss_mult: float = 0.0
    mono_depth_loss_mult: float = 0.0
    patch_warp_loss_mult: float = 0.0
    patch_size: int = 11
    patch_warp_angle_thres: float = 0.3
    min_patch_variance: float = 0.01
    topk: int = 4
    sensor_depth_truncation: float = 0.015
    sensor_depth_l1_loss_mult: float = 0.0
    sensor_depth_freespace_loss_mult: float = 0.0
    sensor_depth_sdf_loss_mult: float = 0.0
    sparse_points_sdf_loss_mult: float = 0.0
    s3im_loss_mult: float = 0.0
    s3im_kernel_size: int = 4
    s3im_stride: int = 4
    s3im_repeat_time: int = 10
    s3im_patch_height: int = 32
    sdf_field: SDFFieldConfig = SDFFieldConfig()
    background_model: str = "mlp"  # grid | mlp | none
    num_samples_outside: int = 32
    periodic_tvl_mult: float = 0.0
    overwrite_near_far_plane: bool = False
    scene_contraction_norm: str = "inf"
    eval_num_rays_per_chunk: int = 1024


class SurfaceModel(nn.Module):
    """Shared machinery of the surface methods (base_surface_model.py:72-260)."""

    has_model_state = False  # a model with one adds init_model_state / update_model_state

    def __init__(self, config: SurfaceModelConfig, scene_box: SceneBox, num_train_data: int):
        super().__init__()
        if config.background_model not in ("grid", "mlp", "none"):
            raise ValueError(f"background_model={config.background_model!r}: one of grid, mlp, none")
        if config.periodic_tvl_mult > 0.0:
            raise NotImplementedError("periodic_tvl_mult > 0 needs the periodic encoding, which is "
                                      "not ported yet (ROADMAP queue 1 item 3)")
        self.config = config
        self.scene_box = scene_box
        self.num_train_data = num_train_data
        self.field = SDFField(
            config.sdf_field, num_images=num_train_data,
            spatial_distortion=config.scene_contraction_norm,
            use_average_appearance_embedding=config.use_average_appearance_embedding,
        )
        # base_surface_model.py:85-96; without one JAX keeps a placeholder
        # group ``field_background.dummy`` that no loss reaches
        self.field_background = None
        if config.background_model == "grid":
            self.field_background = NerfactoField(
                spatial_distortion=config.scene_contraction_norm, num_images=num_train_data,
                use_average_appearance_embedding=config.use_average_appearance_embedding)
        elif config.background_model == "mlp":
            self.field_background = NeRFField(spatial_distortion=config.scene_contraction_norm)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)
        if self.field_background is not None:
            self.field_background.reset_parameters(generator)

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

    def sdf_at_starts(self, samples: RaySamples,
                      hash_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The SDF at the bin starts, [R, S], without a gradient: the
        samplers' ``sdf_fn`` (neus.py:42-47, volsdf.py:32-37, unisurf.py:46-51),
        under the step's ``hash_mask`` where there is one (neus.py:42)."""
        return self.field.sdf(samples.get_start_positions().reshape(-1, 3),
                              hash_mask).reshape(samples.starts.shape)

    def get_foreground_mask(self, ray_samples: RaySamples) -> torch.Tensor:
        """1 where a sample starts inside the unit sphere, [R, S] (base_surface_model.py:134-137)."""
        return (torch.linalg.vector_norm(ray_samples.get_start_positions(), dim=-1) < 1.0).to(
            ray_samples.starts.dtype)

    def forward_background_field_and_merge(self, ray_samples: RaySamples, field_outputs: Dict,
                                           train: bool = False) -> Dict:
        """The foreground's alpha and rgb inside the unit sphere, the
        background field's outside it (base_surface_model.py:140-156)."""
        inside = self.get_foreground_mask(ray_samples)
        bg = self.field_background.get_outputs(ray_samples, train=train)
        bg_alpha = R.alphas_from_densities(ray_samples.deltas, bg["density"])
        field_outputs = dict(field_outputs)
        field_outputs["alpha"] = field_outputs["alpha"] * inside + (1.0 - inside) * bg_alpha
        field_outputs["rgb"] = (field_outputs["rgb"] * inside[..., None]
                                + (1.0 - inside[..., None]) * bg["rgb"])
        return field_outputs

    def render_background(self, ray_bundle: RayBundle, rng: Rng = None,
                          train: bool = False) -> torch.Tensor:
        """The background's colour of each ray, [R, 3]: the background field
        at ``num_samples_outside`` samples linear in disparity from the
        ray's far bound to ``far_plane_bg`` (base_surface_model.py:200-218)."""
        bg_bundle = ray_bundle.replace(nears=ray_bundle.fars,
                                       fars=torch.full_like(ray_bundle.fars, self.config.far_plane_bg))
        bg_samples = linear_disparity_sampler(bg_bundle, self.config.num_samples_outside, rng=rng)
        with record_function("sst/background_field"):
            bg_out = self.field_background.get_outputs(bg_samples, train=train)
        bg_weights = R.weights_from_densities(bg_samples.deltas, bg_out["density"])
        return R.render_rgb(bg_out["rgb"], bg_weights, background_color=self.config.background_color)

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
        model_state=None,
    ) -> Dict[str, torch.Tensor]:
        """The forward (base_surface_model.py:164-260). At eval
        (``train=False``) it runs under ``no_grad``; in training it keeps
        the graph and adds the per-sample gradients, the sample sets and the
        weights the losses read (base_surface_model.py:229-232). A model
        with ``has_model_state`` hands ``model_state`` to its sampler (its
        ``init_model_state()`` when None, as JAX's models do)."""
        if not train:
            with torch.no_grad():
                return self._outputs(ray_bundle, sched, False, None, model_state)
        return self._outputs(ray_bundle, sched, True, rng, model_state)

    def _outputs(self, ray_bundle: RayBundle, sched: Optional[Dict], train: bool, rng: Rng,
                 model_state=None) -> Dict:
        sched = sched or self.schedules(1_000_000)
        ray_bundle = self.apply_collider(ray_bundle, train=train)
        kw = {"model_state": model_state} if self.has_model_state else {}
        s = self.sample_and_forward_field(ray_bundle, sched, rng=rng, train=train, **kw)
        field_outputs, ray_samples, weights = s["field_outputs"], s["ray_samples"], s["weights"]

        rgb = R.render_rgb(field_outputs["rgb"], weights, background_color=self.config.background_color)
        depth = R.render_depth_expected(weights, ray_samples.starts, ray_samples.ends)
        if ray_bundle.directions_norm is not None:
            depth = depth / ray_bundle.directions_norm
        normal = R.render_semantics(field_outputs["normal"], weights)
        if self.field_background is not None and "bg_transmittance" in s:
            rgb = rgb + s["bg_transmittance"] * self.render_background(ray_bundle, rng, train)
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
        elif "num_samples_per_ray" in s:  # grid models report their occupancy at eval too
            outputs["num_samples_per_ray"] = s["num_samples_per_ray"]
        for i in range(len(s.get("weights_list", [])) - 1):
            rs = s["ray_samples_list"][i]
            outputs[f"prop_depth_{i}"] = R.render_depth_expected(
                s["weights_list"][i], rs.starts, rs.ends
            )
        return outputs

    def get_outputs_flexible(
        self,
        ray_bundle: RayBundle,
        additional_inputs: Dict,
        sched: Optional[Dict] = None,
        train: bool = False,
        rng: Rng = None,
        model_state=None,
    ) -> Dict[str, torch.Tensor]:
        """``get_outputs`` and, in training with a patch loss, each ray's
        patch warped from the reference view into its source views
        (base_surface_model.py:247-277): ``additional_inputs`` holds ``uv``
        (the rays' pixels), ``src_imgs`` and ``src_cameras`` (the reference
        first), as ``FlexibleDataManager`` hands them over."""
        outputs = self.get_outputs(ray_bundle, sched=sched, train=train, rng=rng,
                                   model_state=model_state)
        if self.config.patch_warp_loss_mult > 0 and "field_outputs" in outputs:
            with record_function("sst/patch_warping"):
                patches, valid = patch_warping(
                    outputs["ray_samples"], outputs["field_outputs"]["sdf"],
                    outputs["field_outputs"]["normal"], additional_inputs["src_cameras"],
                    additional_inputs["src_imgs"], additional_inputs["uv"],
                    patch_size=self.config.patch_size,
                    valid_angle_thres=self.config.patch_warp_angle_thres,
                )
            outputs["patches"] = patches
            outputs["patches_valid_mask"] = valid
        return outputs

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """rgb L1 and eikonal, and each term whose multiplier is above 0
        and whose input the batch or the outputs carry
        (base_surface_model.py:280-393): S3IM (with an ``rng``), the
        foreground mask's BCE, the monocular normal and depth losses, the
        three sensor-depth terms, the patch NCC and the SfM points' SDF.
        ``rng`` is the noise of the losses that draw any (S3IM's shuffles,
        UniSurf's neighbours)."""
        cfg = self.config
        image = batch["image"]
        loss_dict = {
            "rgb_loss": L.l1_loss(image, outputs["rgb"]),
            "eikonal_loss": L.eikonal_loss(outputs["eik_grad"]) * cfg.eikonal_loss_mult,
        }
        with record_function("sst/cue_losses"):
            if cfg.s3im_loss_mult > 0 and rng is not None:
                loss_dict["s3im_loss"] = L.s3im_loss(
                    outputs["rgb"], image, rng, kernel_size=cfg.s3im_kernel_size,
                    stride=cfg.s3im_stride, repeat_time=cfg.s3im_repeat_time,
                    patch_height=cfg.s3im_patch_height) * cfg.s3im_loss_mult
            if "fg_mask" in batch and cfg.fg_mask_loss_mult > 0.0:
                fg_label = batch["fg_mask"].to(image.dtype)
                weights_sum = torch.clamp(torch.sum(outputs["weights"], dim=-1, keepdim=True),
                                          1e-3, 1 - 1e-3)
                loss_dict["fg_mask_loss"] = (L.binary_cross_entropy(weights_sum, fg_label)
                                             * cfg.fg_mask_loss_mult)
            if "normal" in batch and cfg.mono_normal_loss_mult > 0.0:
                loss_dict["normal_loss"] = (L.monosdf_normal_loss(outputs["normal"], batch["normal"])
                                            * cfg.mono_normal_loss_mult)
            if "depth" in batch and cfg.mono_depth_loss_mult > 0.0:
                loss_dict["depth_loss"] = self.mono_depth_loss(outputs["depth"], batch["depth"])
            if "sensor_depth" in batch and (cfg.sensor_depth_l1_loss_mult > 0.0
                                            or cfg.sensor_depth_freespace_loss_mult > 0.0
                                            or cfg.sensor_depth_sdf_loss_mult > 0.0):
                l1, free_space, sdf_l = L.sensor_depth_loss(
                    outputs["depth"], batch["sensor_depth"][..., None],
                    outputs["ray_samples"].starts, outputs["field_outputs"]["sdf"],
                    outputs["directions_norm"], truncation=cfg.sensor_depth_truncation)
                loss_dict["sensor_l1_loss"] = l1 * cfg.sensor_depth_l1_loss_mult
                loss_dict["sensor_freespace_loss"] = free_space * cfg.sensor_depth_freespace_loss_mult
                loss_dict["sensor_sdf_loss"] = sdf_l * cfg.sensor_depth_sdf_loss_mult
            if "patches" in outputs and cfg.patch_warp_loss_mult > 0.0:
                loss_dict["patch_loss"] = L.multi_view_loss(
                    outputs["patches"], outputs["patches_valid_mask"], patch_size=cfg.patch_size,
                    topk=cfg.topk, min_patch_variance=cfg.min_patch_variance,
                ) * cfg.patch_warp_loss_mult
            if "sparse_sfm_points" in batch and cfg.sparse_points_sdf_loss_mult > 0.0:
                sdf = self.field.geonetwork(batch["sparse_sfm_points"], sched.get("hash_mask"))[..., 0]
                loss_dict["sparse_sfm_points_sdf_loss"] = (torch.mean(torch.abs(sdf))
                                                           * cfg.sparse_points_sdf_loss_mult)
        return loss_dict

    def mono_depth_loss(self, depth: torch.Tensor, depth_cue: torch.Tensor) -> torch.Tensor:
        """The monocular depth term (base_surface_model.py:325-349): the cue
        scaled by 50 and shifted by 0.5, the rays in batch order laid out as
        a (1, 32, -1) image padded with masked zeros, and the
        scale-and-shift-invariant loss with one scale of gradient matching,
        whose neighbour differences run along that layout."""
        depth_gt = depth_cue.reshape(-1) * 50 + 0.5
        depth_pred = depth.reshape(-1)
        n = depth_pred.shape[0]
        rows = 32 if n >= 32 else n
        pad = (-n) % rows
        mask = F.pad(torch.ones_like(depth_pred), (0, pad))
        depth_gt, depth_pred = F.pad(depth_gt, (0, pad)), F.pad(depth_pred, (0, pad))
        return L.scale_and_shift_invariant_loss(
            depth_pred.reshape(1, rows, -1), depth_gt.reshape(1, rows, -1),
            mask.reshape(1, rows, -1), alpha=0.5, scales=1) * self.config.mono_depth_loss_mult

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        """PSNR of the batch (base_surface_model.py:396-399)."""
        mse = torch.mean((outputs["rgb"] - batch["image"]) ** 2)
        return {"psnr": -10.0 * torch.log10(mse)}
