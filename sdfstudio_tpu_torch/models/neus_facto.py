"""NeuS-facto (counterpart of ``sdfstudio_tpu/models/neus_facto.py``):
proposal-network sampling, then the SDF field and NeuS compositing, the
proposal-update cadence and the interlevel loss."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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


class NeuSFactoModel(NeuSModel):
    """neus_facto.py:58-235."""

    def __init__(self, config: NeuSFactoModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        if config.use_same_proposal_network:
            raise NotImplementedError("use_same_proposal_network is not ported yet")
        args = config.proposal_net_args_list
        # each proposal field by its field_type (hash unless the args say "mlp")
        self.proposal_networks = nn.ModuleList(
            HashMLPDensityField(
                aabb=scene_box.aabb,
                spatial_distortion=config.scene_contraction_norm,
                **args[min(i, len(args) - 1)],
            )
            for i in range(config.num_proposal_iterations)
        )

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
        return sched

    def sample_and_forward_field(
        self, ray_bundle: RayBundle, sched: Dict, rng: Rng = None, train: bool = False
    ) -> Dict:
        """neus_facto.py:169-235; jitter only in training (``perturb``)."""
        cfg = self.config
        with record_function("sst/proposal_sampler"):
            ray_samples, weights_list, ray_samples_list = proposal_network_sampler(
                ray_bundle,
                list(self.proposal_networks),
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
            train=train,
        )
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
        """neus_facto.py:237-257: the surface losses plus the interlevel loss
        (neither ported method has a curvature term)."""
        loss_dict = super().get_loss_dict(outputs, batch, sched, rng)
        loss_dict["interlevel_loss"] = self.config.interlevel_loss_mult * L.interlevel_loss_zip(
            outputs["weights_list"], outputs["ray_samples_list"]
        )
        return loss_dict
