"""NeuS-facto (counterpart of ``sdfstudio_tpu/models/neus_facto.py``):
proposal-network sampling, then the SDF field and NeuS compositing, the
proposal-update cadence and the interlevel loss, and the Neuralangelo
schedules that ``neus-facto-angelo`` turns on (neus_facto.py:125-167): the
annealed beta (``inv_s_override``), the numerical-gradient delta, the
progressive hash mask and the curvature factor, with the curvature loss
(:245-250). These are JAX's ``neus_facto.py`` formulas, not
``models/neuralangelo.py``'s: the delta floors at ``1 / (4 max_res)`` and is
scaled by 4 for the field's ``(x + 2) / 4`` input, the curvature factor's
floor is ``1 / (10 max_res)``."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.components import losses as L
from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.fields.density_field import HashMLPDensityField
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.proposal import proposal_network_sampler
from sdfstudio_tpu_torch.samplers.spaced import Rng


@dataclasses.dataclass(frozen=True)
class NeuSFactoModelConfig(NeuSModelConfig):
    """neus_facto.py:26-55, the fields this port reads."""

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
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    interlevel_loss_mult: float = 1.0
    use_single_jitter: bool = True
    use_anneal_beta: bool = False
    beta_anneal_max_num_iters: int = 1000_000
    beta_anneal_init: float = 0.05
    beta_anneal_end: float = 0.0002
    enable_progressive_hash_encoding: bool = False
    enable_numerical_gradients_schedule: bool = False
    enable_curvature_loss_schedule: bool = False
    curvature_loss_multi: float = 0.0
    curvature_loss_warmup_steps: int = 20_000
    level_init: int = 4
    steps_per_level: int = 10_000


def proposal_networks(config, scene_box, spatial_distortion: Optional[str] = None) -> nn.ModuleList:
    """The proposal fields of ``proposal_net_args_list`` with the scene
    contraction (``config.scene_contraction_norm`` unless given), each by
    its ``field_type`` (hash unless the args say ``"mlp"``;
    neus_facto.py:62-80, bakedsdf.py:54-69, nerfacto.py:70-88). With
    ``use_same_proposal_network`` one field, of the first args, serves every
    iteration (:func:`proposal_density_fns`), its parameters
    ``proposal_networks.0`` as in JAX's tree."""
    args = config.proposal_net_args_list
    n = 1 if config.use_same_proposal_network else config.num_proposal_iterations
    dist = config.scene_contraction_norm if spatial_distortion is None else spatial_distortion
    return nn.ModuleList(
        HashMLPDensityField(aabb=scene_box.aabb, spatial_distortion=dist,
                            **args[min(i, len(args) - 1)])
        for i in range(n))


def proposal_density_fns(nets: nn.ModuleList, num_iterations: int) -> List[nn.Module]:
    """The density function of each proposal iteration: the shared field
    for every one when ``nets`` holds one."""
    return [nets[min(i, len(nets) - 1)] for i in range(num_iterations)]


def annealed_beta(b0: float, b1: float, max_num_iters: int, s: np.float32) -> np.float32:
    """BakedSDF's beta schedule (neus_facto.py:185-190, bakedsdf.py:95-102)
    in float32 at step ``s``: ``b0 / (1 + (b0 - b1) / b1 t^0.8)``, ``t =
    min(s / M, 1)``."""
    f32 = np.float32
    t = min(max(s / f32(max_num_iters), f32(0.0)), f32(1.0))
    # (b0 - b1) / b1 is a Python constant in JAX too: rounded to f32 once
    return f32(b0) / (f32(1.0) + f32((b0 - b1) / b1) * (t ** f32(0.8)))


def angelo_grid_schedules(cfg, fcfg, s: np.float32, device) -> Dict:
    """The Neuralangelo schedules of ``neus-facto-angelo`` and
    ``bakedangelo`` (neus_facto.py:206-276, bakedangelo.py:30-65) in
    float32 at step ``s``, each where its flag is on: ``numerical_delta =
    4 max(1 / (4 max_res), 1 / (base_res growth^(s / spl)))``; the
    ``hash_mask`` [L*F] of the first ``max(floor(s / spl) + 1,
    level_init)`` levels; and the curvature factor, ``s / warmup`` during
    the warmup, then ``max(1 / (10 max_res), 1 / (base_res growth^((s -
    warmup) / spl))) * base_res`` (1 when off). These are not
    ``models/neuralangelo.py``'s formulas: the delta floors at ``1 / (4
    max_res)`` and is scaled by 4 for the field's ``(x + 2) / 4`` input,
    the curvature factor's floor is ``1 / (10 max_res)``."""
    f32 = np.float32
    sched = {}
    growth = (math.exp((math.log(fcfg.max_res) - math.log(fcfg.base_res)) / (fcfg.num_levels - 1))
              if fcfg.num_levels > 1 else 1.0)
    g, spl = f32(growth), f32(cfg.steps_per_level)
    with np.errstate(over="ignore"):  # far past the last level growth^k is inf, as in JAX
        if cfg.enable_numerical_gradients_schedule:
            delta = f32(1.0) / (f32(fcfg.base_res) * g ** (s / spl))
            sched["numerical_delta"] = float(max(f32(1.0 / (4.0 * fcfg.max_res)), delta) * f32(4.0))
        if cfg.enable_progressive_hash_encoding:
            level = max(int(np.floor(s / spl)) + 1, cfg.level_init)
            F = fcfg.hash_features_per_level
            feat_level = torch.arange(fcfg.num_levels * F) // F
            sched["hash_mask"] = (feat_level < level).to(torch.float32).to(device)
        if cfg.enable_curvature_loss_schedule:
            w = f32(cfg.curvature_loss_warmup_steps)
            if s < w:
                sched["curvature_factor"] = float(s / w)
            else:
                decay = f32(1.0) / (f32(fcfg.base_res) * g ** ((s - w) / spl))
                decay = max(f32(1.0 / (fcfg.max_res * 10.0)), decay)
                sched["curvature_factor"] = float(decay / f32(1.0 / fcfg.base_res))
        else:
            sched["curvature_factor"] = 1.0
    return sched


class NeuSFactoModel(NeuSModel):
    """neus_facto.py:58-235."""

    def __init__(self, config: NeuSFactoModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        self.proposal_networks = proposal_networks(config, scene_box)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        for net in self.proposal_networks:
            net.reset_parameters(generator)

    def schedules(self, step: float) -> Dict:
        """neus_facto.py:93-122: the proposal-weight anneal and the
        proposal-update cadence, pure functions of ``step``. The threshold
        ramps from 1 to ``proposal_update_every`` over ``proposal_warmup``
        steps; the proposal nets train on the first 10 steps and then every
        ``floor(thr) + 1``-th step."""
        cfg = self.config
        sched = super().schedules(step)
        step = float(step)
        if cfg.use_proposal_weight_anneal:
            N = cfg.proposal_weights_anneal_max_num_iters
            b = cfg.proposal_weights_anneal_slope
            x = min(max(step / N, 0.0), 1.0)
            sched["proposal_anneal"] = (b * x) / ((b - 1) * x + 1)
        else:
            sched["proposal_anneal"] = 1.0
        thr = min(max(step * cfg.proposal_update_every / max(cfg.proposal_warmup, 1), 1.0),
                  float(cfg.proposal_update_every))
        period = math.floor(thr) + 1.0
        sched["train_proposal"] = step < 10.0 or math.fmod(math.floor(step), period) < 0.5
        sched.update(self._angelo_schedules(step))
        return sched

    def _angelo_schedules(self, step: float) -> Dict:
        """neus_facto.py:125-167 in float32, as JAX evaluates them at a
        traced step: ``inv_s_override = 1 / beta`` (``annealed_beta``) and
        the grid's schedules (``angelo_grid_schedules``)."""
        cfg = self.config
        s = np.float32(step)
        sched = angelo_grid_schedules(cfg, self.field.config, s, self.field.laplace_beta.device)
        if cfg.use_anneal_beta:
            beta = annealed_beta(cfg.beta_anneal_init, cfg.beta_anneal_end,
                                 cfg.beta_anneal_max_num_iters, s)
            sched["inv_s_override"] = float(np.float32(1.0) / beta)
        return sched

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        """neus_facto.py:169-235; jitter only in training (``perturb``). With
        a background field (``neus-facto-bigmlp``) the samples outside the
        unit sphere take its alpha and colour."""
        cfg = self.config
        with record_function("sst/proposal_sampler"):
            ray_samples, weights_list, ray_samples_list = proposal_network_sampler(
                ray_bundle,
                proposal_density_fns(self.proposal_networks, cfg.num_proposal_iterations),
                rng=rng if (train and cfg.perturb) else None,
                num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
                num_nerf_samples_per_ray=cfg.num_neus_samples_per_ray,
                num_proposal_network_iterations=cfg.num_proposal_iterations,
                single_jitter=cfg.use_single_jitter,
                anneal=sched["proposal_anneal"],
                train_proposal=bool(sched["train_proposal"]) if train else False,
            )
        field_outputs = self.field.get_outputs(
            ray_samples, cos_anneal_ratio=sched["cos_anneal_ratio"], return_alphas=True,
            train=train, hash_mask=sched.get("hash_mask"),
            numerical_delta=sched.get("numerical_delta"),
            inv_s_override=sched.get("inv_s_override"),
        )
        if cfg.background_model != "none":
            # the background field's alpha and colour outside the unit sphere (neus_facto.py:216-219)
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
        """neus_facto.py:237-257: the surface losses plus the interlevel loss,
        and with ``curvature_loss_multi > 0`` and the numerical taps the
        curvature term times the scheduled factor (:245-250)."""
        loss_dict = super().get_loss_dict(outputs, batch, sched, rng)
        cfg = self.config
        loss_dict["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss_zip(
            outputs["weights_list"], outputs["ray_samples_list"]
        )
        fo = outputs["field_outputs"]
        if cfg.curvature_loss_multi > 0.0 and "sampled_sdf" in fo:
            delta = sched.get("numerical_delta", 1e-4)
            loss_dict["curvature_loss"] = (L.curvature_loss(fo["sampled_sdf"], fo["sdf"], delta)
                                           * cfg.curvature_loss_multi * sched["curvature_factor"])
        return loss_dict
