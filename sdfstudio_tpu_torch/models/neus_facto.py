"""NeuS-facto, eval path (counterpart of ``sdfstudio_tpu/models/neus_facto.py``):
proposal-network sampling, then the SDF field and NeuS compositing."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from sdfstudio_tpu_torch.core.rays import RayBundle
from sdfstudio_tpu_torch.fields.density_field import MLPDensityField
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.ops import render as R
from sdfstudio_tpu_torch.samplers.proposal import proposal_network_sampler


@dataclasses.dataclass(frozen=True)
class NeuSFactoModelConfig(NeuSModelConfig):
    """neus_facto.py:26-55, the fields this slice reads."""

    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_neus_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    use_same_proposal_network: bool = False
    proposal_net_args_list: Tuple[Dict, ...] = (
        {"field_type": "mlp", "hidden_dim": 128, "max_res": 64},
        {"field_type": "mlp", "hidden_dim": 128, "max_res": 256},
    )
    use_proposal_weight_anneal: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000


class NeuSFactoModel(NeuSModel):
    """neus_facto.py:58-235."""

    def __init__(self, config: NeuSFactoModelConfig, scene_box, num_train_data: int):
        super().__init__(config, scene_box, num_train_data)
        if config.use_same_proposal_network:
            raise NotImplementedError("use_same_proposal_network is not ported yet")
        args = config.proposal_net_args_list
        self.proposal_networks = nn.ModuleList(
            MLPDensityField(
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

    def schedules(self, step: float) -> Dict[str, float]:
        """neus_facto.py:93-106 (the anneal; the proposal-update cadence
        only matters for training)."""
        cfg = self.config
        sched = super().schedules(step)
        if cfg.use_proposal_weight_anneal:
            N = cfg.proposal_weights_anneal_max_num_iters
            b = cfg.proposal_weights_anneal_slope
            x = min(max(float(step) / N, 0.0), 1.0)
            sched["proposal_anneal"] = (b * x) / ((b - 1) * x + 1)
        else:
            sched["proposal_anneal"] = 1.0
        return sched

    def sample_and_forward_field(self, ray_bundle: RayBundle, sched: Dict) -> Dict:
        """neus_facto.py:172-235 at eval."""
        cfg = self.config
        with record_function("sst/proposal_sampler"):
            ray_samples, weights_list, ray_samples_list = proposal_network_sampler(
                ray_bundle,
                list(self.proposal_networks),
                num_proposal_samples_per_ray=cfg.num_proposal_samples_per_ray,
                num_nerf_samples_per_ray=cfg.num_neus_samples_per_ray,
                num_proposal_network_iterations=cfg.num_proposal_iterations,
                anneal=sched["proposal_anneal"],
            )
        field_outputs = self.field.get_outputs(
            ray_samples, cos_anneal_ratio=sched["cos_anneal_ratio"], return_alphas=True
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
