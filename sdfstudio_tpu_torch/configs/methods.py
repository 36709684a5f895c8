"""Method registry (counterpart of ``sdfstudio_tpu/configs/methods.py``).

Registers ``neus-facto`` (methods.py:216-240) and ``neus-facto-tpu-p8``
(methods.py:361-393) as Python dataclasses with their model, optimizer
groups, trainer and data-manager settings; nothing is read from YAML.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Union

import torch

from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig
from sdfstudio_tpu_torch.engine.optimizers import OptimizerConfig, OptimizerGroupConfig
from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig
from sdfstudio_tpu_torch.engine.trainer import TrainerConfig
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModel, NeuSFactoModelConfig
from sdfstudio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    method_name: str
    model_class: type
    model: NeuSFactoModelConfig
    optimizers: Dict[str, OptimizerGroupConfig] = dataclasses.field(default_factory=dict)
    trainer: TrainerConfig = TrainerConfig()
    datamanager: DataManagerConfig = DataManagerConfig()


def _adam(lr: float) -> OptimizerConfig:
    return OptimizerConfig(lr=lr, eps=1e-15)  # methods.py:62-63


def _optimizers() -> Dict[str, OptimizerGroupConfig]:
    """The optimizer groups both methods set (methods.py:234-238, 389-395).
    Neither has a background field, so the JAX "field_background" group (a
    placeholder) has no counterpart."""
    return {
        "proposal_networks": OptimizerGroupConfig(
            _adam(1e-2), SchedulerConfig(kind="multistep", max_steps=20000)),
        "field": OptimizerGroupConfig(
            _adam(5e-4), SchedulerConfig(kind="neus", warm_up_end=500,
                                         learning_rate_alpha=0.05, max_steps=20000)),
    }


method_configs = {
    "neus-facto": MethodConfig(
        "neus-facto",
        NeuSFactoModel,
        NeuSFactoModelConfig(
            sdf_field=SDFFieldConfig(
                use_grid_feature=True,
                num_layers=2,
                num_layers_color=2,
                hidden_dim=256,
                bias=0.5,
                beta_init=0.3,
                inside_outside=False,
            ),
            background_model="none",
            eval_num_rays_per_chunk=1024,
        ),
        optimizers=_optimizers(),
        trainer=TrainerConfig(max_num_iterations=20001),
        datamanager=DataManagerConfig(train_num_rays_per_batch=2048),
    ),
    "neus-facto-tpu-p8": MethodConfig(
        "neus-facto-tpu-p8",
        NeuSFactoModel,
        NeuSFactoModelConfig(
            sdf_field=SDFFieldConfig(
                use_grid_feature=True,
                num_layers=2,
                num_layers_color=2,
                hidden_dim=256,
                bias=0.5,
                beta_init=0.3,
                inside_outside=False,
                encoding_type="permuto",
                num_levels=8,
                hash_features_per_level=4,
                max_res=512,
            ),
            proposal_net_args_list=(
                {"field_type": "mlp", "hidden_dim": 128, "max_res": 64},
                {"field_type": "mlp", "hidden_dim": 128, "max_res": 256},
            ),
            background_model="none",
            eval_num_rays_per_chunk=1024,
        ),
        optimizers=_optimizers(),
        trainer=TrainerConfig(max_num_iterations=20001),
        datamanager=DataManagerConfig(train_num_rays_per_batch=2048),
    ),
}


def get_method_config(name: str) -> MethodConfig:
    if name not in method_configs:
        raise ValueError(f"unknown method '{name}'; available: {', '.join(sorted(method_configs))}")
    return copy.deepcopy(method_configs[name])


def build_model(
    config: Union[str, MethodConfig],
    scene_box: SceneBox,
    num_train_data: int = 1,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
):
    """The method's model with parameters from the seeded initialiser, on
    ``device`` (default ``cuda``; raises when CUDA is missing)."""
    dev = resolve_device(device)
    if isinstance(config, str):
        config = get_method_config(config)
    model = config.model_class(config.model, scene_box, num_train_data)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
