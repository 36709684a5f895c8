"""Method registry (counterpart of ``sdfstudio_tpu/configs/methods.py``).

Registers ``neus`` (methods.py:113-123), ``volsdf`` (:125-135), ``unisurf``
(:193-213), the MonoSDF and Geo-NeuS variants of those three --
``monosdf`` (:137-149), ``mono-neus`` (:152-164), ``geo-neus`` (:167-179),
``geo-volsdf`` (:181-191), ``mono-unisurf`` and ``geo-unisurf`` (:194-213),
the geo entries with the flexible data manager (:876-882) -- the
``neus-facto`` family -- ``neus-facto`` (:216-240),
``neus-facto-tpu`` (:270-312), ``neus-facto-tpu-p4`` (:314-359),
``neus-facto-tpu-p8`` (:361-393), ``neus-facto-bigmlp`` (:396-412) and
``neus-facto-angelo`` (:413-458) -- ``neuralangelo`` (:461-501), the
BakedSDF family -- ``bakedsdf`` (:503-542), ``bakedsdf-mlp`` (:544-584) and
``bakedangelo`` (:586-636), all three on the SDFStudio parser as JAX
registers them (``mipnerf360-data`` on the command line) -- and the
occupancy-grid family -- ``neus-acc`` (:642-652), ``neusW`` (:788-805, with
the heritage parser) and ``dto`` (:808-823) -- and the density methods
-- ``instant-ngp`` (:658-684, the dynamic batch) and ``nerfacto``
(:739-757) on the Blender parser, ``phototourism`` (:849-865) on the
phototourism parser, the last two with the ``SO3xR3`` camera optimizer,
and the NeRF baselines -- ``vanilla-nerf`` (:697-710), ``dnerf``
(:712-725), ``mipnerf`` (:727-737) and ``tensorf`` (:763-781) on the
Blender parser and ``semantic-nerfw`` (:829-841) on the Friends parser --
each a ``Config``
(``configs/base.py``) with JAX's model, optimizer groups, trainer
(``_SURFACE_TRAINER`` and the entry's own values) and data-manager
settings, and the SDFStudio parser unless named; nothing is read from
YAML. ``descriptions`` is JAX's help text (:33-59,
:867-874) for the registered methods.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Union

import torch

from sdfstudio_tpu_torch.cameras.camera_optimizers import CameraOptimizerConfig
from sdfstudio_tpu_torch.configs.base import Config
from sdfstudio_tpu_torch.core.scene_box import SceneBox
from sdfstudio_tpu_torch.data.datamanager import DataManagerConfig
from sdfstudio_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig
from sdfstudio_tpu_torch.data.dataparsers.colmap_family import (HeritageDataParserConfig,
                                                                PhototourismDataParserConfig)
from sdfstudio_tpu_torch.data.dataparsers.misc_parsers import FriendsDataParserConfig
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import SDFStudioDataParserConfig
from sdfstudio_tpu_torch.engine.optimizers import OptimizerConfig, OptimizerGroupConfig
from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig
from sdfstudio_tpu_torch.engine.trainer import TrainerConfig
from sdfstudio_tpu_torch.fields.sdf_field import SDFFieldConfig
from sdfstudio_tpu_torch.models.bakedangelo import BakedAngeloModel, BakedAngeloModelConfig
from sdfstudio_tpu_torch.models.bakedsdf import BakedSDFFactoModel, BakedSDFModelConfig
from sdfstudio_tpu_torch.models.base_surface_model import SurfaceModelConfig
from sdfstudio_tpu_torch.models.dto import DtoOModel, DtoOModelConfig
from sdfstudio_tpu_torch.models.instant_ngp import InstantNGPModelConfig, NGPModel
from sdfstudio_tpu_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from sdfstudio_tpu_torch.models.neuralangelo import NeuralangeloModel, NeuralangeloModelConfig
from sdfstudio_tpu_torch.models.neuralreconW import NeuralReconWModel, NeuralReconWModelConfig
from sdfstudio_tpu_torch.models.neus import NeuSModel, NeuSModelConfig
from sdfstudio_tpu_torch.models.neus_acc import NeuSAccModel, NeuSAccModelConfig
from sdfstudio_tpu_torch.models.neus_facto import NeuSFactoModel, NeuSFactoModelConfig
from sdfstudio_tpu_torch.models.semantic_nerfw import SemanticNerfWModel, SemanticNerfWModelConfig
from sdfstudio_tpu_torch.models.tensorf import TensoRFModel, TensoRFModelConfig
from sdfstudio_tpu_torch.models.unisurf import UniSurfModel, UniSurfModelConfig
from sdfstudio_tpu_torch.models.vanilla_nerf import (MipNerfModel, MipNerfModelConfig, NeRFModel,
                                                     VanillaModelConfig)
from sdfstudio_tpu_torch.models.volsdf import VolSDFModel, VolSDFModelConfig
from sdfstudio_tpu_torch.utils.device import resolve_device

descriptions = {
    "neus": "Implementation of NeuS.",
    "volsdf": "Implementation of VolSDF.",
    "unisurf": "Implementation of UniSurf.",
    "monosdf": "Implementation of MonoSDF.",
    "mono-neus": "MonoSDF with NeuS rendering formulation.",
    "geo-neus": "Patch warping from Geo-NeuS with NeuS.",
    "geo-volsdf": "Patch warping from Geo-NeuS with VolSDF.",
    "mono-unisurf": "MonoSDF with unisurf rendering formulation.",
    "geo-unisurf": "Patch warping from Geo-NeuS with UniSurf.",
    "neus-facto": "NeuS with proposal-network sampling (recommended).",
    "neus-facto-tpu": "neus-facto with a TPU-optimized hash layout (8x4).",
    "neus-facto-tpu-p4": "neus-facto-tpu with a permutohedral L4xF4 encoding.",
    "neus-facto-tpu-p8": "neus-facto-tpu with a permutohedral L8xF4 encoding.",
    "neus-facto-bigmlp": "NeuS-facto with a big MLP (heritage-scale).",
    "neus-facto-angelo": "Neuralangelo hash field with neus-facto sampling.",
    "neuralangelo": "Implementation of Neuralangelo.",
    "bakedsdf": "BakedSDF with multi-res hash grids.",
    "bakedsdf-mlp": "BakedSDF with large MLPs.",
    "bakedangelo": "Neuralangelo with BakedSDF.",
    "neus-acc": "NeuS with empty-space skipping.",
    "neusW": "Neural reconstruction in the wild (heritage).",
    "dto": "Occupancy-grid-guided NeuS with density-field background.",
    "instant-ngp": "Occupancy-grid accelerated NeRF.",
    "nerfacto": "Recommended density model for real captures.",
    "phototourism": "Nerfacto on phototourism captures.",
    "vanilla-nerf": "Original NeRF.",
    "mipnerf": "Mip-NeRF (IPE) model.",
    "tensorf": "TensoRF model.",
    "semantic-nerfw": "Semantic segmentation + transient filtering.",
    "dnerf": "Dynamic NeRF with temporal deformation.",
}


def MethodConfig(method_name: str, model_class: type, model,
                 optimizers: Optional[Dict[str, OptimizerGroupConfig]] = None,
                 trainer: Optional[TrainerConfig] = None,
                 datamanager: Optional[DataManagerConfig] = None,
                 dataparser=None) -> Config:
    """A registry entry: a ``Config`` with the SDFStudio parser (at its
    defaults unless given)."""
    return Config(method_name=method_name, model_class=model_class, model=model,
                  optimizers=dict(optimizers or {}), trainer=trainer or TrainerConfig(),
                  datamanager=datamanager or DataManagerConfig(),
                  dataparser=dataparser or SDFStudioDataParserConfig())


def _adam(lr: float, kind: str = "adam", weight_decay: float = 0.0,
          eps: float = 1e-15) -> OptimizerConfig:
    return OptimizerConfig(lr=lr, eps=eps, kind=kind, weight_decay=weight_decay)  # methods.py:62-63


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
                 rays_per_batch: int = 1024, dataparser=None, kind: str = "vanilla") -> Config:
    """``_surface_cfg`` (methods.py:93-110)."""
    return MethodConfig(name, model_class, model, optimizers,
                        TrainerConfig(**{**_SURFACE_TRAINER, **trainer_kwargs}),
                        DataManagerConfig(train_num_rays_per_batch=rays_per_batch, kind=kind),
                        dataparser)


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


def _exp(max_steps: int) -> SchedulerConfig:
    return SchedulerConfig(kind="exponential", decay_rate=0.1, max_steps=max_steps)  # methods.py:82-83


_MONO = dict(mono_depth_loss_mult=0.1, mono_normal_loss_mult=0.05)  # methods.py:141, 156, 198
_MONO_PARSER = SDFStudioDataParserConfig(include_mono_prior=True)
_GEO_PARSER = SDFStudioDataParserConfig(load_pairs=True)
# steps_per_call=25 is the TPU's K-step scan (methods.py:309-311): taken, no effect here
_PRESET_TRAINER = dict(max_num_iterations=20001, steps_per_eval_image=5000, steps_per_call=25)


def _baked_field(**kw) -> SDFFieldConfig:
    """``bakedsdf``'s and ``bakedsdf-mlp``'s SDF field (methods.py:510-527,
    :551-568): the ref-NeRF colour head on a 2-layer 256-wide colour net,
    PE of degree 8 off-axis."""
    return SDFFieldConfig(num_layers_color=2, hidden_dim_color=256, bias=0.05, beta_init=0.1,
                          inside_outside=False, use_appearance_embedding=False,
                          position_encoding_max_degree=8, use_diffuse_color=True,
                          use_specular_tint=True, use_reflections=True, use_n_dot_v=True,
                          off_axis=True, **kw)


def _baked_optimizers(field_lr: float) -> Dict[str, OptimizerGroupConfig]:
    """methods.py:534-538, :576-580: JAX's ``field_background`` group holds
    only a placeholder there (no background) and has no counterpart."""
    return {
        "proposal_networks": OptimizerGroupConfig(_adam(1e-2), _multistep(250000)),
        "field": OptimizerGroupConfig(_adam(field_lr), _neus_sched(500, 0.05, 250000)),
    }


_BAKED_MODEL = dict(near_plane=0.2, far_plane=1000.0, overwrite_near_far_plane=True,
                    eikonal_loss_mult=0.01, background_model="none", use_anneal_beta=True,
                    eval_num_rays_per_chunk=1024)
_BAKED_TRAINER = dict(max_num_iterations=250001, steps_per_eval_image=5000)

method_configs: Dict[str, Config] = {
    "neus": _surface_cfg("neus", NeuSModel, NeuSModelConfig(eval_num_rays_per_chunk=1024),
                         _CLASSIC, dict(max_num_iterations=100000)),
    "volsdf": _surface_cfg(
        "volsdf", VolSDFModel, VolSDFModelConfig(eval_num_rays_per_chunk=1024),
        {g: OptimizerGroupConfig(_adam(5e-4), _exp(100000)) for g in ("field", "field_background")},
        dict(max_num_iterations=100000)),
    "unisurf": _surface_cfg("unisurf", UniSurfModel,
                            UniSurfModelConfig(eval_num_rays_per_chunk=1024), _CLASSIC,
                            dict(max_num_iterations=100000)),
    "monosdf": _surface_cfg(
        "monosdf", VolSDFModel, VolSDFModelConfig(eval_num_rays_per_chunk=1024, **_MONO),
        {g: OptimizerGroupConfig(_adam(5e-4), _exp(200000)) for g in ("field", "field_background")},
        dict(max_num_iterations=200000), dataparser=_MONO_PARSER),
    "mono-neus": _surface_cfg(
        "mono-neus", NeuSModel, NeuSModelConfig(eval_num_rays_per_chunk=1024, **_MONO), _CLASSIC,
        dict(max_num_iterations=100000), dataparser=_MONO_PARSER),
    "geo-neus": _surface_cfg(
        "geo-neus", NeuSModel,
        NeuSModelConfig(patch_warp_loss_mult=0.1, eval_num_rays_per_chunk=1024), _CLASSIC,
        dict(max_num_iterations=200000),
        dataparser=SDFStudioDataParserConfig(load_pairs=True, include_sfm_points=True),
        kind="flexible"),
    "geo-volsdf": _surface_cfg(
        "geo-volsdf", VolSDFModel,
        VolSDFModelConfig(patch_warp_loss_mult=0.1, eval_num_rays_per_chunk=1024),
        {"field": OptimizerGroupConfig(_adam(5e-4), _multistep(1000000)),
         "field_background": OptimizerGroupConfig(_adam(5e-4), _exp(200000))},
        dict(max_num_iterations=200001), dataparser=_GEO_PARSER, kind="flexible"),
    "mono-unisurf": _surface_cfg(
        "mono-unisurf", UniSurfModel, UniSurfModelConfig(eval_num_rays_per_chunk=1024, **_MONO),
        _CLASSIC, dict(max_num_iterations=100000), dataparser=_MONO_PARSER),
    "geo-unisurf": _surface_cfg(
        "geo-unisurf", UniSurfModel,
        UniSurfModelConfig(patch_warp_loss_mult=0.1, eval_num_rays_per_chunk=1024), _CLASSIC,
        dict(max_num_iterations=100000), dataparser=_GEO_PARSER, kind="flexible"),
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
    # methods.py:413-458: Neuralangelo's field (F = 8 over 2^22 rows a level, numerical
    # gradients, the appearance embedding) with the neus-facto sampler and schedules, and the
    # "grid" background under AdamW
    "neus-facto-angelo": _surface_cfg(
        "neus-facto-angelo",
        NeuSFactoModel,
        NeuSFactoModelConfig(
            near_plane=0.01,
            far_plane=1000.0,
            overwrite_near_far_plane=True,
            sdf_field=SDFFieldConfig(
                use_grid_feature=True,
                num_layers=1,
                num_layers_color=4,
                hidden_dim=256,
                hidden_dim_color=256,
                bias=0.5,
                beta_init=0.3,
                inside_outside=False,
                use_appearance_embedding=True,
                use_numerical_gradients=True,
                base_res=64,
                max_res=4096,
                log2_hashmap_size=22,
                hash_features_per_level=8,
                hash_smoothstep=False,
                use_position_encoding=False,
            ),
            background_model="grid",
            eval_num_rays_per_chunk=1024,
            level_init=8,
            eikonal_loss_mult=0.01,
            use_anneal_beta=True,
            enable_progressive_hash_encoding=True,
            enable_numerical_gradients_schedule=True,
            enable_curvature_loss_schedule=True,
            curvature_loss_multi=5e-4,
        ),
        {
            "proposal_networks": OptimizerGroupConfig(_adam(1e-2), _multistep(1000000)),
            "field": OptimizerGroupConfig(_adam(1e-3), _multistep_warmup(5000, [600000, 800000])),
            "field_background": OptimizerGroupConfig(_adam(1e-3, kind="adamw"),
                                                     _multistep_warmup(5000, [300000, 400000])),
        },
        dict(max_num_iterations=1000001, steps_per_eval_image=5000),
        rays_per_batch=2048,
    ),
    # methods.py:503-542: a 2-layer geometry MLP on the hash grid (L16 x F2 at 2^19), off-axis PE
    "bakedsdf": _surface_cfg(
        "bakedsdf", BakedSDFFactoModel,
        BakedSDFModelConfig(sdf_field=_baked_field(use_grid_feature=True, num_layers=2,
                                                   hidden_dim=256),
                            proposal_weights_anneal_max_num_iters=1000, **_BAKED_MODEL),
        _baked_optimizers(1e-2), _BAKED_TRAINER, rays_per_batch=8192),
    # methods.py:544-584: no grid feature, an 8 x 1024 geometry MLP, the spatially varying eikonal
    "bakedsdf-mlp": _surface_cfg(
        "bakedsdf-mlp", BakedSDFFactoModel,
        BakedSDFModelConfig(sdf_field=_baked_field(use_grid_feature=False, num_layers=8,
                                                   hidden_dim=1024),
                            proposal_weights_anneal_max_num_iters=20000,
                            use_spatial_varying_eikonal_loss=True, **_BAKED_MODEL),
        _baked_optimizers(2e-3), _BAKED_TRAINER, rays_per_batch=4096),
    # methods.py:586-636: neus-facto-angelo's field (F = 8 over 2^22 rows a level, numerical
    # gradients, the appearance embedding) with an inward init at bias 1.5, BakedSDF's sampler
    # and annealed beta, Neuralangelo's schedules, the "grid" background, AdamW
    "bakedangelo": _surface_cfg(
        "bakedangelo", BakedAngeloModel,
        BakedAngeloModelConfig(
            near_plane=0.01,
            far_plane=1000.0,
            overwrite_near_far_plane=True,
            sdf_field=SDFFieldConfig(
                use_grid_feature=True,
                num_layers=1,
                num_layers_color=4,
                hidden_dim=256,
                hidden_dim_color=256,
                bias=1.5,
                beta_init=0.1,
                inside_outside=True,
                use_appearance_embedding=True,
                use_numerical_gradients=True,
                base_res=64,
                max_res=4096,
                log2_hashmap_size=22,
                hash_features_per_level=8,
                hash_smoothstep=False,
                use_position_encoding=False,
            ),
            eikonal_loss_mult=0.01,
            background_model="grid",
            proposal_weights_anneal_max_num_iters=10000,
            use_anneal_beta=True,
            eval_num_rays_per_chunk=1024,
            use_spatial_varying_eikonal_loss=False,
            steps_per_level=10000,
            curvature_loss_warmup_steps=20000,
            beta_anneal_end=0.0002,
            beta_anneal_max_num_iters=1000000,
        ),
        {
            "proposal_networks": OptimizerGroupConfig(_adam(1e-2), _multistep(1000000)),
            "field": OptimizerGroupConfig(_adam(1e-3, kind="adamw", weight_decay=1e-2),
                                          _multistep_warmup(5000, [600000, 800000])),
            "field_background": OptimizerGroupConfig(_adam(1e-3, kind="adamw"),
                                                     _multistep_warmup(5000, [300000, 400000])),
        },
        dict(max_num_iterations=1000001, steps_per_eval_image=5000),
        rays_per_batch=8192,
    ),
    # methods.py:642-652: the 128^3 alpha-pruned grid, 128 masked samples, the NeRF background
    "neus-acc": _surface_cfg(
        "neus-acc", NeuSAccModel, NeuSAccModelConfig(eval_num_rays_per_chunk=1024),
        {g: OptimizerGroupConfig(_adam(5e-4), _neus_sched(500, 0.05, 20000))
         for g in ("field", "field_background")},
        dict(max_num_iterations=20000, steps_per_eval_image=5000), rays_per_batch=2048),
    # methods.py:788-805: the coarse and fine grids, the surface-guided sampler and the "grid"
    # background at 4 samples, on the heritage parser
    "neusW": _surface_cfg(
        "neusW", NeuralReconWModel,
        NeuralReconWModelConfig(background_model="grid", num_samples_outside=4,
                                eikonal_loss_mult=1e-4, eval_num_rays_per_chunk=1024),
        {"field": OptimizerGroupConfig(_adam(1e-3), _neus_sched(500, 0.05, 300000)),
         "field_background": OptimizerGroupConfig(_adam(1e-2), _multistep(300000))},
        dict(max_num_iterations=100000, steps_per_eval_image=5000, steps_per_save=5000),
        rays_per_batch=2048, dataparser=HeritageDataParserConfig()),
    # methods.py:808-823: neusW's grids and sampler with the "grid" background at 4 samples
    "dto": _surface_cfg(
        "dto", DtoOModel, DtoOModelConfig(eval_num_rays_per_chunk=1 << 10),
        {"field": OptimizerGroupConfig(_adam(5e-4), _neus_sched(500, 0.05, 300000)),
         "field_background": OptimizerGroupConfig(_adam(1e-2), _multistep(300000))},
        dict(max_num_iterations=100000, steps_per_eval_image=2000, steps_per_save=5000),
        rays_per_batch=2048),
}


def _density_datamanager() -> DataManagerConfig:
    """The density baselines' data manager (methods.py:745-749, :853-857)."""
    return DataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096,
                             camera_optimizer=CameraOptimizerConfig(mode="SO3xR3"))


method_configs.update({
    # methods.py:658-684: the dynamic batch at a 2^18-sample budget, the Blender parser
    "instant-ngp": MethodConfig(
        "instant-ngp", NGPModel,
        InstantNGPModelConfig(render_step_size=0.005, eval_num_rays_per_chunk=8192),
        {"field": OptimizerGroupConfig(_adam(1e-2), _multistep(20000))},
        TrainerConfig(steps_per_eval_batch=5000, steps_per_eval_image=5000, steps_per_save=20000,
                      max_num_iterations=20001, dynamic_batch=True, target_num_samples=1 << 18),
        DataManagerConfig(train_num_rays_per_batch=8192), BlenderDataParserConfig()),
    # methods.py:739-757
    "nerfacto": MethodConfig(
        "nerfacto", NerfactoModel, NerfactoModelConfig(eval_num_rays_per_chunk=1 << 15),
        {g: OptimizerGroupConfig(_adam(1e-2), _multistep(300000))
         for g in ("proposal_networks", "field")},
        TrainerConfig(steps_per_eval_batch=5000, steps_per_save=2000, max_num_iterations=30000),
        _density_datamanager(), BlenderDataParserConfig()),
    # methods.py:849-865: nerfacto's model, no schedules, the phototourism parser
    "phototourism": MethodConfig(
        "phototourism", NerfactoModel, NerfactoModelConfig(eval_num_rays_per_chunk=1 << 15),
        {g: OptimizerGroupConfig(_adam(1e-2)) for g in ("proposal_networks", "field")},
        TrainerConfig(steps_per_eval_batch=500, steps_per_save=2000, max_num_iterations=30000),
        _density_datamanager(), PhototourismDataParserConfig()),
})


def _nerf(name: str, model_class: type, model, optimizers: Dict[str, OptimizerGroupConfig],
          max_steps: int = 1000000) -> Config:
    """The NeRF baselines on the Blender parser at 1024 rays a step (methods.py:697-781)."""
    return MethodConfig(name, model_class, model, optimizers,
                        TrainerConfig(max_num_iterations=max_steps),
                        DataManagerConfig(train_num_rays_per_batch=1024), BlenderDataParserConfig())


def _radam() -> OptimizerGroupConfig:
    return OptimizerGroupConfig(_adam(5e-4, kind="radam", eps=1e-8))  # methods.py:707-708


def _decay(lr: float, lr_final: float) -> OptimizerGroupConfig:
    """tensorf's groups (methods.py:772-779)."""
    return OptimizerGroupConfig(_adam(lr, eps=1e-8), SchedulerConfig(
        kind="exponential_decay", lr_final=lr_final, max_steps=30000))


method_configs.update({
    # methods.py:697-710: JAX configures a temporal_distortion group, which holds nothing here
    "vanilla-nerf": _nerf("vanilla-nerf", NeRFModel, VanillaModelConfig(),
                          {"field": _radam(), "temporal_distortion": _radam()}),
    # methods.py:712-725
    "dnerf": _nerf("dnerf", NeRFModel, VanillaModelConfig(enable_temporal_distortion=True),
                   {"field": _radam(), "temporal_distortion": _radam()}),
    # methods.py:727-737
    "mipnerf": _nerf("mipnerf", MipNerfModel, MipNerfModelConfig(eval_num_rays_per_chunk=1024),
                     {"field": _radam()}),
    # methods.py:763-781
    "tensorf": _nerf("tensorf", TensoRFModel, TensoRFModelConfig(),
                     {"field": _decay(0.001, 0.0001), "encodings": _decay(0.02, 0.002)}, 30000),
    # methods.py:829-841
    "semantic-nerfw": MethodConfig(
        "semantic-nerfw", SemanticNerfWModel,
        SemanticNerfWModelConfig(eval_num_rays_per_chunk=1 << 16),
        {g: OptimizerGroupConfig(_adam(1e-2)) for g in ("proposal_networks", "field")},
        TrainerConfig(steps_per_eval_batch=500, steps_per_save=2000, max_num_iterations=30000),
        DataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096),
        FriendsDataParserConfig()),
})

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
