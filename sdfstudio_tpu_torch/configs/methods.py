"""Method registry (counterpart of ``sdfstudio_tpu/configs/methods.py``).

Registers ``neus`` (methods.py:113-123), ``volsdf`` (:125-135), ``unisurf``
(:193-213), the ``neus-facto`` family -- ``neus-facto`` (:216-240),
``neus-facto-tpu`` (:270-312), ``neus-facto-tpu-p4`` (:314-359),
``neus-facto-tpu-p8`` (:361-393) and ``neus-facto-bigmlp`` (:396-412) --
and ``neuralangelo`` (:461-501), each a ``Config`` (``configs/base.py``)
with JAX's model, optimizer groups, trainer (``_SURFACE_TRAINER`` and the
entry's own values) and data-manager settings, and the SDFStudio parser;
nothing is read from YAML. ``descriptions`` is JAX's help text (:33-59,
:867-874) for the registered methods.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Union

import torch

from sdfstudio_tpu_torch.configs.base import Config
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import SDFStudioDataParserConfig
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

descriptions = {
    "neus": "Implementation of NeuS.",
    "volsdf": "Implementation of VolSDF.",
    "unisurf": "Implementation of UniSurf.",
    "neus-facto": "NeuS with proposal-network sampling (recommended).",
    "neus-facto-tpu": "neus-facto with a TPU-optimized hash layout (8x4).",
    "neus-facto-tpu-p4": "neus-facto-tpu with a permutohedral L4xF4 encoding.",
    "neus-facto-tpu-p8": "neus-facto-tpu with a permutohedral L8xF4 encoding.",
    "neus-facto-bigmlp": "NeuS-facto with a big MLP (heritage-scale).",
    "neuralangelo": "Implementation of Neuralangelo.",
}


def MethodConfig(method_name: str, model_class: type, model: SurfaceModelConfig,
                 optimizers: Optional[Dict[str, OptimizerGroupConfig]] = None,
                 trainer: Optional[TrainerConfig] = None,
                 datamanager: Optional[DataManagerConfig] = None) -> Config:
    """A registry entry: a ``Config`` with the SDFStudio parser."""
    return Config(method_name=method_name, model_class=model_class, model=model,
                  optimizers=dict(optimizers or {}), trainer=trainer or TrainerConfig(),
                  datamanager=datamanager or DataManagerConfig(),
                  dataparser=SDFStudioDataParserConfig())


def _adam(lr: float, kind: str = "adam", weight_decay: float = 0.0) -> OptimizerConfig:
    return OptimizerConfig(lr=lr, eps=1e-15, kind=kind, weight_decay=weight_decay)  # methods.py:62-63


def _neus_sched(warm_up_end: int = 5000, alpha: float = 0.05, max_steps: int = 300000):
    """methods.py:66-69."""
    return SchedulerConfig(kind="neus", warm_up_end=warm_up_end, learning_rate_alpha=alpha,
                           max_steps=max_steps)


def _multistep(max_steps: int) -> SchedulerConfig:
    return SchedulerConfig(kind="multistep", max_steps=max_steps)  # methods.py:72-73


def _multistep_warmup(warm_up_end: int, milestones, gamma: float = 0.1) -> SchedulerConfig:
    """methods.py:76-79."""
    return SchedulerConfig(kind="multistep_warmup", warm_up_end=warm_up_end,
                           milestones=tuple(milestones), gamma=gamma)


# every surface method's trainer settings (methods.py:84-90)
_SURFACE_TRAINER = dict(
    steps_per_eval_image=500,
    steps_per_eval_batch=5000,
    steps_per_save=20000,
    steps_per_eval_all_images=1000000,
    mixed_precision=False,
)


def _surface_cfg(name: str, model_class: type, model: SurfaceModelConfig,
                 optimizers: Dict[str, OptimizerGroupConfig], trainer_kwargs: Dict,
                 rays_per_batch: int = 1024) -> Config:
    """``_surface_cfg`` (methods.py:93-110)."""
    return MethodConfig(name, model_class, model, optimizers,
                        TrainerConfig(**{**_SURFACE_TRAINER, **trainer_kwargs}),
                        DataManagerConfig(train_num_rays_per_batch=rays_per_batch))


def _facto_optimizers(max_steps: int = 20000) -> Dict[str, OptimizerGroupConfig]:
    """The groups of the ``neus-facto`` presets without a background
    (methods.py:234-238 and the presets'): JAX's ``field_background``
    group holds only a placeholder there and has no counterpart."""
    return {
        "proposal_networks": OptimizerGroupConfig(_adam(1e-2), _multistep(max_steps)),
        "field": OptimizerGroupConfig(_adam(5e-4), _neus_sched(500, 0.05, max_steps)),
    }


def _facto_field(**kw) -> SDFFieldConfig:
    """The ``neus-facto`` presets' SDF field (methods.py:219-228)."""
    return SDFFieldConfig(use_grid_feature=True, num_layers=2, num_layers_color=2, hidden_dim=256,
                          bias=0.5, beta_init=0.3, use_appearance_embedding=False,
                          inside_outside=False, **kw)


def _mlp_proposals(hidden_dim: int):
    """PE+MLP proposal fields (methods.py:292-295)."""
    return ({"field_type": "mlp", "hidden_dim": hidden_dim, "max_res": 64},
            {"field_type": "mlp", "hidden_dim": hidden_dim, "max_res": 256})


def _facto(name: str, sdf_field: SDFFieldConfig, trainer_kwargs: Dict, **model_kw) -> Config:
    return _surface_cfg(
        name, NeuSFactoModel,
        NeuSFactoModelConfig(sdf_field=sdf_field, background_model="none",
                             eval_num_rays_per_chunk=1024, **model_kw),
        _facto_optimizers(), trainer_kwargs, rays_per_batch=2048)


_CLASSIC = {"field": OptimizerGroupConfig(_adam(5e-4), _neus_sched()),
            "field_background": OptimizerGroupConfig(_adam(5e-4), _neus_sched())}
# steps_per_call=25 is the TPU's K-step scan (methods.py:309-311): taken, no effect here
_PRESET_TRAINER = dict(max_num_iterations=20001, steps_per_eval_image=5000, steps_per_call=25)

method_configs: Dict[str, Config] = {
    "neus": _surface_cfg("neus", NeuSModel, NeuSModelConfig(eval_num_rays_per_chunk=1024),
                         _CLASSIC, dict(max_num_iterations=100000)),
    "volsdf": _surface_cfg(
        "volsdf", VolSDFModel, VolSDFModelConfig(eval_num_rays_per_chunk=1024),
        {g: OptimizerGroupConfig(_adam(5e-4), SchedulerConfig(kind="exponential", decay_rate=0.1,
                                                              max_steps=100000))
         for g in ("field", "field_background")},
        dict(max_num_iterations=100000)),
    "unisurf": _surface_cfg("unisurf", UniSurfModel,
                            UniSurfModelConfig(eval_num_rays_per_chunk=1024), _CLASSIC,
                            dict(max_num_iterations=100000)),
    "neus-facto": _facto("neus-facto", _facto_field(),
                         dict(max_num_iterations=20001, steps_per_eval_image=5000)),
    # methods.py:270-312: hash L8xF4 at 2^19 rows, max_res 512, PE+MLP proposals at hidden 128
    "neus-facto-tpu": _facto(
        "neus-facto-tpu", _facto_field(num_levels=8, hash_features_per_level=4, max_res=512),
        _PRESET_TRAINER, proposal_net_args_list=_mlp_proposals(128)),
    # methods.py:314-359: permutohedral L4xF4 at max_res 512, PE+MLP proposals at hidden 64
    "neus-facto-tpu-p4": _facto(
        "neus-facto-tpu-p4",
        _facto_field(encoding_type="permuto", num_levels=4, hash_features_per_level=4, max_res=512),
        _PRESET_TRAINER, proposal_net_args_list=_mlp_proposals(64)),
    "neus-facto-tpu-p8": _facto(
        "neus-facto-tpu-p8",
        _facto_field(encoding_type="permuto", num_levels=8, hash_features_per_level=4, max_res=512),
        _PRESET_TRAINER, proposal_net_args_list=_mlp_proposals(128)),
    # methods.py:396-412: JAX's default field (no grid feature) at 8 x 512 with a 4-layer colour
    # net, hash proposals and the NeRF background
    "neus-facto-bigmlp": _surface_cfg(
        "neus-facto-bigmlp", NeuSFactoModel,
        NeuSFactoModelConfig(sdf_field=SDFFieldConfig(num_layers=8, hidden_dim=512,
                                                      num_layers_color=4),
                             eval_num_rays_per_chunk=1024),
        {
            "proposal_networks": OptimizerGroupConfig(_adam(1e-2), _multistep(100000)),
            "field": OptimizerGroupConfig(_adam(1e-3), _neus_sched(500, 0.05, 100000)),
            "field_background": OptimizerGroupConfig(_adam(1e-2), _neus_sched(500, 0.05, 100000)),
        },
        dict(max_num_iterations=100001, steps_per_eval_image=5000), rays_per_batch=2048),
    # methods.py:461-501: a 1-layer geometry MLP on a 16-level, 8-feature hash
    # grid of 2^22 rows a level (55,867,118 rows in all), numerical gradients,
    # the NeRF background, AdamW
    "neuralangelo": _surface_cfg(
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
        {
            "field": OptimizerGroupConfig(_adam(1e-3, kind="adamw", weight_decay=0.01),
                                          _multistep_warmup(5000, [300000, 400000])),
            "field_background": OptimizerGroupConfig(_adam(1e-3, kind="adamw"),
                                                     _multistep_warmup(5000, [300000, 400000])),
        },
        dict(max_num_iterations=500001, steps_per_eval_image=5000),
        rays_per_batch=512,
    ),
}


def get_method_config(name: str) -> Config:
    if name not in method_configs:
        raise ValueError(f"unknown method '{name}'; available: {', '.join(sorted(method_configs))}")
    return copy.deepcopy(method_configs[name])


def build_model(
    config: Union[str, Config],
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
