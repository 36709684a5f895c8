"""BakedSDF (counterpart of ``sdfstudio_tpu/models/bakedsdf.py``): VolSDF's
Laplace density on the proposal sampler's samples, with the proposal-weight
anneal, the annealed beta that takes the learned one's place, the annealed
or spatially varying eikonal weight, and mip-NeRF 360's interlevel loss
(bakedsdf.py:22-196).

JAX's schedules carry no ``train_proposal`` for this model, and its sampler
takes ``train_proposal=train`` (bakedsdf.py:117-130): the proposal nets
train on every step, whatever ``proposal_update_every`` and
``proposal_warmup`` say. The port does the same."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.models.neus_facto import (annealed_beta, proposal_density_fns,
                                                    proposal_networks)
from sdfstudio_tpu_torch.models.volsdf import VolSDFModel, VolSDFModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.proposal import proposal_network_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class BakedSDFModelConfig(VolSDFModelConfig):
    """bakedsdf.py:22-47."""

    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_neus_samples_per_ray: int = 48
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple[Dict, ...] = (
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 64},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 256},
    )
    interlevel_loss_mult: float = 1.0
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    use_anneal_beta: bool = True
    beta_anneal_max_num_iters: int = 250000
    beta_anneal_init: float = 0.1
    beta_anneal_end: float = 0.001
    use_anneal_eikonal_weight: bool = False
    eikonal_anneal_max_num_iters: int = 250000
    use_spatial_varying_eikonal_loss: bool = False
    eikonal_loss_mult_start: float = 0.01
    eikonal_loss_mult_end: float = 0.1
    eikonal_loss_mult_slop: float = 2.0


def _pow10(x: np.float32) -> np.float32:
    """x^10 as XLA's ``integer_pow`` multiplies it out: x^2 * x^8."""
    x2 = x * x
    x4 = x2 * x2
    return x2 * (x4 * x4)


def spatial_eikonal_loss(grad_theta: torch.Tensor, points_norm: torch.Tensor, w0: float, w1: float,
                         slop: float) -> torch.Tensor:
    """The spatially varying eikonal loss (bakedsdf.py:182-191): each
    sample's ``(|grad| - 1)^2`` weighted by ``w1 / (1 + (w1 - w0) / w0 (2 -
    p)^slop)``, ``p`` the contracted point's norm, or 1 inside the unit
    ball (weight ``w0`` there, rising towards ``w1`` at ``p = 2``)."""
    pw = torch.where(points_norm <= 1, torch.ones_like(points_norm), points_norm)
    pw = w1 / (1 + (w1 - w0) / w0 * ((2.0 - pw) ** slop))
    eik = (torch.linalg.vector_norm(grad_theta, dim=-1) - 1) ** 2
    return torch.mean(eik * pw)


class BakedSDFFactoModel(VolSDFModel):
    """bakedsdf.py:50-196."""

    def __init__(self, config: BakedSDFModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        self.proposal_networks = proposal_networks(config, scene_box)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    def schedules(self, step: float) -> Dict:
        """bakedsdf.py:80-111 in float32, as JAX evaluates them at a traced
        step: ``proposal_anneal = b x / ((b - 1) x + 1)``, ``x = min(step /
        N, 1)``; ``beta_override`` (``annealed_beta``); and with
        ``use_anneal_eikonal_weight`` the eikonal weight ``w1 / (1 + (w1 -
        w0) / w0 (1 - t)^10)`` with JAX's fixed ``w0 = 0.01``, ``w1 = 0.1``."""
        cfg = self.config
        f32 = np.float32
        sched = super().schedules(step)
        s = f32(step)
        if cfg.use_proposal_weight_anneal:
            b = f32(cfg.proposal_weights_anneal_slope)
            x = min(max(s / f32(cfg.proposal_weights_anneal_max_num_iters), f32(0.0)), f32(1.0))
            sched["proposal_anneal"] = float((b * x) / ((b - f32(1.0)) * x + f32(1.0)))
        else:
            sched["proposal_anneal"] = 1.0
        if cfg.use_anneal_beta:
            sched["beta_override"] = float(annealed_beta(
                cfg.beta_anneal_init, cfg.beta_anneal_end, cfg.beta_anneal_max_num_iters, s))
        if cfg.use_anneal_eikonal_weight:
            w0, w1 = 0.01, 0.1
            t = min(max(s / f32(cfg.eikonal_anneal_max_num_iters), f32(0.0)), f32(1.0))
            sched["eikonal_mult"] = float(f32(w1) / (f32(1.0) + f32((w1 - w0) / w0)
                                                     * _pow10(f32(1.0) - t)))
        return sched

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        """bakedsdf.py:113-166: the proposal sampler (jittered in training),
        the field at the scheduled beta, alphas from the Laplace densities,
        and the background's outside the unit sphere when there is one."""
        cfg = self.config
        with record_function("sst/proposal_sampler"):
            ray_samples, weights_list, ray_samples_list = proposal_network_sampler(
                ray_bundle,
                proposal_density_fns(self.proposal_networks, cfg.num_proposal_iterations),
                rng=rng if train else None,
                num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
                num_nerf_samples_per_ray=cfg.num_neus_samples_per_ray,
                num_proposal_network_iterations=cfg.num_proposal_iterations,
                single_jitter=cfg.use_single_jitter,
                anneal=sched["proposal_anneal"],
                train_proposal=train,
            )
        field_outputs = self.field.get_outputs(
            ray_samples, train=train, hash_mask=sched.get("hash_mask"),
            numerical_delta=sched.get("numerical_delta"), beta_override=sched.get("beta_override"),
        )
        field_outputs["alpha"] = R.alphas_from_densities(ray_samples.deltas, field_outputs["density"])
        if cfg.background_model != "none":
            field_outputs = self.forward_background_field_and_merge(ray_samples, field_outputs,
                                                                    train)
        weights, transmittance = R.weights_and_transmittance_from_alphas(field_outputs["alpha"])
        return {
            "ray_samples": ray_samples,
            "field_outputs": field_outputs,
            "weights": weights,
            "bg_transmittance": transmittance[:, -1:],
            "weights_list": list(weights_list) + [weights],
            "ray_samples_list": list(ray_samples_list) + [ray_samples],
        }

    def get_loss_dict(self, outputs: Dict, batch: Dict, sched: Dict,
                      rng: Rng = None) -> Dict[str, torch.Tensor]:
        """bakedsdf.py:169-196, in place of the base model's terms: rgb L1,
        S3IM (multiplier above 0 and an ``rng``), the eikonal loss
        (``spatial_eikonal_loss``, or the mean one times the scheduled or
        configured multiplier) and the interlevel loss."""
        cfg = self.config
        image = batch["image"]
        loss_dict = {"rgb_loss": L.l1_loss(image, outputs["rgb"])}
        grad_theta = outputs["eik_grad"]
        if cfg.s3im_loss_mult > 0 and rng is not None:
            with record_function("sst/cue_losses"):
                loss_dict["s3im_loss"] = L.s3im_loss(
                    outputs["rgb"], image, rng, kernel_size=cfg.s3im_kernel_size,
                    stride=cfg.s3im_stride, repeat_time=cfg.s3im_repeat_time,
                    patch_height=cfg.s3im_patch_height) * cfg.s3im_loss_mult
        if cfg.use_spatial_varying_eikonal_loss:
            loss_dict["eikonal_loss"] = spatial_eikonal_loss(
                grad_theta, outputs["points_norm"], cfg.eikonal_loss_mult_start,
                cfg.eikonal_loss_mult_end, cfg.eikonal_loss_mult_slop)
        else:
            loss_dict["eikonal_loss"] = (L.eikonal_loss(grad_theta)
                                         * sched.get("eikonal_mult", cfg.eikonal_loss_mult))
        loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss(
            outputs["weights_list"], outputs["ray_samples_list"])
        return loss_dict
