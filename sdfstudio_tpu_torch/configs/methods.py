"""Method registry (counterpart of ``sdfstudio_tpu/configs/methods.py``).

Slice 1 registers ``neus-facto-tpu-p8`` (methods.py:361-393) as a Python
dataclass; nothing is read from YAML.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Union

import torch

from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModel, NeuSFactoModelConfig
from sdfstudio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MethodConfig:
    method_name: str
    model_class: type
    model: NeuSFactoModelConfig


method_configs = {
    "neus-facto-tpu-p8": MethodConfig(
        "neus-facto-tpu-p8",
        NeuSFactoModel,
        NeuSFactoModelConfig(
            sdf_field=SDFFieldConfig(
                num_layers=2,
                num_layers_color=2,
                hidden_dim=256,
                bias=0.5,
                beta_init=0.3,
                inside_outside=False,
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
