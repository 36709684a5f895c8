"""Nerfacto (counterpart of ``sdfstudio_tpu/models/nerfacto.py``): the
density baseline of ``nerfacto`` and ``phototourism``.

Two hash proposal fields (L5, 2^17 rows, max_res 64 and 256, [10 -> 16 ->
1] each) resample a ray 256 then 96 times, and the nerfacto field
(``fields/nerfacto_field.py``, L16 x F2 at 2^19 rows) renders 48 samples
composited over the last sample's colour. The proposals train on the
first 10 steps and then on a cadence that widens from every 2nd to every
6th step over the warmup; their weights are annealed in during the first
1000 steps. The losses are the rgb MSE, mip-NeRF 360's interlevel and
distortion losses, and with ``predict_normals`` ref-NeRF's orientation and
predicted-normal losses on the density normals, ``-grad density /
|grad density|``, taken through the hash encode's gradient in ``x`` (a
plain ``mlp_base`` for the double backward, the kernels for the encode).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.components.colliders import near_far_collider
from sdfstudio_tpu_torch.core.math import safe_normalize
from sdfstudio_tpu_torch.core.rays import RayBundle, RaySamples
from sdfstudio_tpu_torch.fields.nerfacto_field import NerfactoField
from sdfstudio_tpu_torch.models.base_model import Model, ModelConfig
from sdfstudio_tpu_torch.models.neus_facto import proposal_density_fns, proposal_networks
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.ops.density import trunc_exp
from sdfstudio_tpu_torch.samplers.proposal import proposal_network_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class NerfactoModelConfig(ModelConfig):
    """nerfacto.py:24-51."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    num_levels: int = 16
    max_res: int = 1024
    log2_hashmap_size: int = 19
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple[Dict, ...] = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 64},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
    )
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    orientation_loss_mult: float = 1e-4
    pred_normal_loss_mult: float = 1e-3
    use_proposal_weight_anneal: bool = True
    use_average_appearance_embedding: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    predict_normals: bool = False
    eval_num_rays_per_chunk: int = 4096


class NerfactoModel(Model):
    """nerfacto.py:54-223. A subclass with ``keep_field_outputs`` also gets
    the field's raw outputs and the final ray samples in the outputs
    (``field_outputs``, ``ray_samples``; nerfacto.py:194-198), which
    ``semantic-nerfw`` renders its heads from."""

    keep_field_outputs = False

    def __init__(self, config: NerfactoModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        self.field = NerfactoField(
            spatial_distortion="inf", num_images=num_train_data,
            use_average_appearance_embedding=config.use_average_appearance_embedding,
            num_levels=config.num_levels, max_res=config.max_res,
            log2_hashmap_size=config.log2_hashmap_size, use_pred_normals=config.predict_normals)
        self.proposal_networks = proposal_networks(config, scene_box, spatial_distortion="inf")

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.field.reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    def schedules(self, step: float) -> Dict:
        """nerfacto.py:90-111: the proposal-weight anneal and the proposal
        update cadence, as in ``neus-facto`` (the threshold ramps from 1 to
        ``proposal_update_every`` over ``proposal_warmup`` steps; the nets
        train on the first 10 steps and then every ``floor(thr) + 1``-th)."""
        cfg = self.config
        step = float(step)
        sched = {}
        if cfg.use_proposal_weight_anneal:
            N, b = cfg.proposal_weights_anneal_max_num_iters, cfg.proposal_weights_anneal_slope
            x = min(max(step / N, 0.0), 1.0)
            sched["proposal_anneal"] = (b * x) / ((b - 1) * x + 1)
        else:
            sched["proposal_anneal"] = 1.0
        thr = min(max(step * cfg.proposal_update_every / max(cfg.proposal_warmup, 1), 1.0),
                  float(cfg.proposal_update_every))
        period = math.floor(thr) + 1.0
        sched["train_proposal"] = step < 10.0 or math.fmod(math.floor(step), period) < 0.5
        return sched

    def apply_collider(self, ray_bundle: RayBundle, train: bool = False) -> RayBundle:
        """nerfacto.py:113-116."""
        return near_far_collider(ray_bundle, self.config.near_plane, self.config.far_plane)

    def density_normals(self, ray_samples: RaySamples, train: bool) -> torch.Tensor:
        """``-safe_normalize(d sum(density) / d positions)`` [R, S, 3]
        (nerfacto.py:147-160), the positions' own gradient kept (the
        camera optimizer's), and in training a graph for the losses on
        the normals."""
        with torch.enable_grad(), record_function("sst/density_normals"):
            pts = ray_samples.get_positions().reshape(-1, 3)
            if not pts.requires_grad:
                pts = pts.detach().requires_grad_(True)
            raw, _ = self.field.density_raw(self.field.normalize(pts), plain=train)
            (grads,) = torch.autograd.grad(trunc_exp(raw).sum(), pts, create_graph=train)
        return -safe_normalize(grads).reshape(*ray_samples.starts.shape, 3)

    def _outputs(self, ray_bundle: RayBundle, sched, train: bool, rng: Rng, model_state=None) -> Dict:
        """nerfacto.py:118-199."""
        cfg = self.config
        sched = sched or self.schedules(1e9)
        ray_bundle = self.apply_collider(ray_bundle, train)
        with record_function("sst/proposal_sampler"):
            ray_samples, weights_list, ray_samples_list = proposal_network_sampler(
                ray_bundle,
                proposal_density_fns(self.proposal_networks, cfg.num_proposal_iterations),
                rng=rng if train else None,
                num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
                num_nerf_samples_per_ray=cfg.num_nerf_samples_per_ray,
                num_proposal_network_iterations=cfg.num_proposal_iterations,
                single_jitter=cfg.use_single_jitter,
                anneal=sched["proposal_anneal"],
                train_proposal=bool(sched["train_proposal"]) if train else False,
            )
        field_outputs = self.field.get_outputs(ray_samples, train=train)
        if cfg.predict_normals:
            field_outputs["normals"] = self.density_normals(ray_samples, train)
        weights = R.weights_from_densities(ray_samples.deltas, field_outputs["density"])
        weights_list = list(weights_list) + [weights]
        ray_samples_list = list(ray_samples_list) + [ray_samples]
        outputs = {
            "rgb": R.render_rgb(field_outputs["rgb"], weights, cfg.background_color),
            "accumulation": R.render_accumulation(weights),
            "depth": R.render_depth_median(weights, ray_samples.starts, ray_samples.ends),
            "weights_list": weights_list,
            "ray_samples_list": ray_samples_list,
        }
        if cfg.predict_normals:
            outputs["normals"] = R.render_normals(field_outputs["normals"], weights, normalize=True)
            outputs["pred_normals"] = R.render_normals(field_outputs["pred_normals"], weights,
                                                       normalize=True)
            if train:
                wd = weights.detach()
                outputs["rendered_orientation_loss"] = L.orientation_loss(
                    wd, field_outputs["normals"], ray_bundle.directions)
                outputs["rendered_pred_normal_loss"] = L.pred_normal_loss(
                    wd, field_outputs["normals"].detach(), field_outputs["pred_normals"])
        for i in range(cfg.num_proposal_iterations):
            outputs[f"prop_depth_{i}"] = R.render_depth_median(
                weights_list[i], ray_samples_list[i].starts, ray_samples_list[i].ends)
        if self.keep_field_outputs:
            outputs["field_outputs"] = field_outputs
            outputs["ray_samples"] = ray_samples
        return outputs

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """nerfacto.py:201-218."""
        cfg = self.config
        loss_dict = {"rgb_loss": torch.mean((batch["image"] - outputs["rgb"]) ** 2)}
        loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"])
        loss_dict["distortion_loss"] = cfg.distortion_loss_mult * L.distortion_loss(
            outputs["weights_list"], outputs["ray_samples_list"])
        if cfg.predict_normals:
            loss_dict["orientation_loss"] = cfg.orientation_loss_mult * torch.mean(
                outputs["rendered_orientation_loss"])
            loss_dict["pred_normal_loss"] = cfg.pred_normal_loss_mult * torch.mean(
                outputs["rendered_pred_normal_loss"])
        return loss_dict

    @torch.no_grad()
    def get_metrics_dict(self, outputs: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        """PSNR and the distortion (nerfacto.py:219-223)."""
        m = super().get_metrics_dict(outputs, batch)
        m["distortion"] = L.distortion_loss(outputs["weights_list"], outputs["ray_samples_list"])
        return m
