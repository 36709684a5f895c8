"""Method registry (counterpart of ``sdfstudio_tpu/configs/methods.py``).

Registers ``neus`` (methods.py:113-123), ``volsdf`` (:125-135), ``unisurf``
(:193-213), ``neus-facto`` (:216-240), ``neus-facto-tpu-p8`` (:361-393) and
``neuralangelo`` (:461-501) as Python dataclasses with their model, optimizer groups, trainer and
data-manager settings; nothing is read from YAML.
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
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModelConfig
from sdfstudio_tpu_torch.models.neuralangelo import NeuralangeloModel, NeuralangeloModelConfig
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModel, NeuSFactoModelConfig
from sdfstudio_tpu_torch.models.unisurf import UniSurfModel, UniSurfModelConfig
from sdfstudio_tpu_torch.models.volsdf import VolSDFModel, VolSDFModelConfig
from sdfstudio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    method_name: str
    model_class: type
    model: SurfaceModelConfig
    optimizers: Dict[str, OptimizerGroupConfig] = dataclasses.field(default_factory=dict)
    trainer: TrainerConfig = TrainerConfig()
    datamanager: DataManagerConfig = DataManagerConfig()


def _adam(lr: float, kind: str = "adam", weight_decay: float = 0.0) -> OptimizerConfig:
    return OptimizerConfig(lr=lr, eps=1e-15, kind=kind, weight_decay=weight_decay)  # methods.py:62-63


def _multistep_warmup(warm_up_end: int, milestones, gamma: float = 0.1) -> SchedulerConfig:
    """methods.py:74-77."""
    return SchedulerConfig(kind="multistep_warmup", warm_up_end=warm_up_end,
                           milestones=tuple(milestones), gamma=gamma)


def _optimizers() -> Dict[str, OptimizerGroupConfig]:
    """The optimizer groups both ``neus-facto`` methods set (methods.py:234-238,
    389-395). Neither has a background field, so the JAX "field_background"
    group (a placeholder) has no counterpart here; the classic methods train
    their NeRF background in a "field_background" group (``_surface``)."""
    return {
        "proposal_networks": OptimizerGroupConfig(
            _adam(1e-2), SchedulerConfig(kind="multistep", max_steps=20000)),
        "field": OptimizerGroupConfig(
            _adam(5e-4), SchedulerConfig(kind="neus", warm_up_end=500,
                                         learning_rate_alpha=0.05, max_steps=20000)),
    }


def _surface(name: str, model_class: type, model: SurfaceModelConfig,
             scheduler: SchedulerConfig) -> MethodConfig:
    """A classic surface method (``_surface_cfg``, methods.py:86-110): the
    field and its NeRF background each under Adam at 5e-4 with ``scheduler``,
    100,000 iterations, 1024 train rays and 1024-ray eval chunks."""
    group = OptimizerGroupConfig(_adam(5e-4), scheduler)
    return MethodConfig(
        name, model_class, model,
        optimizers={"field": group, "field_background": group},
        trainer=TrainerConfig(max_num_iterations=100000, steps_per_save=20000),
        datamanager=DataManagerConfig(train_num_rays_per_batch=1024),
    )


# methods.py:66-68: the NeuS warmup-cosine at its defaults
_NEUS_SCHED = SchedulerConfig(kind="neus", warm_up_end=5000, learning_rate_alpha=0.05,
                              max_steps=300000)

method_configs = {
    "neus": _surface("neus", NeuSModel, NeuSModelConfig(eval_num_rays_per_chunk=1024), _NEUS_SCHED),
    "volsdf": _surface("volsdf", VolSDFModel, VolSDFModelConfig(eval_num_rays_per_chunk=1024),
                       SchedulerConfig(kind="exponential", decay_rate=0.1, max_steps=100000)),
    "unisurf": _surface("unisurf", UniSurfModel, UniSurfModelConfig(eval_num_rays_per_chunk=1024),
                        _NEUS_SCHED),
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
    # methods.py:461-501: a 1-layer geometry MLP on a 16-level, 8-feature hash
    # grid of 2^22 rows a level (55,867,118 rows in all), numerical gradients,
    # the NeRF background, AdamW
    "neuralangelo": MethodConfig(
        "neuralangelo",
        NeuralangeloModel,
        NeuralangeloModelConfig(
            sdf_field=SDFFieldConfig(
                use_grid_feature=True,
                num_layers=1,
                num_layers_color=4,
                hidden_dim=256,
                hidden_dim_color=256,
                bias=0.5,
                beta_init=0.3,
                inside_outside=False,
                use_appearance_embedding=False,
                position_encoding_max_degree=6,
                use_numerical_gradients=True,
                base_res=64,
                max_res=4096,
                log2_hashmap_size=22,
                hash_features_per_level=8,
                hash_smoothstep=False,
                use_position_encoding=False,
            ),
            background_model="mlp",
            enable_progressive_hash_encoding=True,
            enable_curvature_loss_schedule=True,
            enable_numerical_gradients_schedule=True,
        ),
        optimizers={
            "field": OptimizerGroupConfig(_adam(1e-3, kind="adamw", weight_decay=0.01),
                                          _multistep_warmup(5000, [300000, 400000])),
            "field_background": OptimizerGroupConfig(_adam(1e-3, kind="adamw"),
                                                     _multistep_warmup(5000, [300000, 400000])),
        },
        trainer=TrainerConfig(max_num_iterations=500001, steps_per_save=20000),
        datamanager=DataManagerConfig(train_num_rays_per_batch=512),
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
