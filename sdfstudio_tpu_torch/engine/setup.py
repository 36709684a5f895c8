"""Building a run from its configuration (counterpart of
``sdfstudio_tpu/engine/setup.py``): dataparser -> data manager -> model ->
optimizers -> writer -> trainer (``setup_trainer``, setup.py:19-89), and
the rebuild of a finished run from its ``config.yml`` with its newest
complete checkpoint (``eval_setup``, setup.py:92-104).

The port's entry points run on ``cuda`` unless given ``device="cpu"``.
The model's parameters come from the port's seeded initialiser
(``MODEL_SEED``); ``Config.seed`` seeds the trainer's batch and jitter
generator. A data manager whose camera optimizer is on (the density
methods' ``SO3xR3``) hangs it on the model as ``model.camera_opt``, and its
``camera_opt`` group is added with JAX's settings unless the config names
one (Adam, lr 6e-4, eps 1e-8, ``weight_decay`` 1e-2, no schedule;
setup.py:57-64).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

from sdfstudio_tpu_torch.configs.base import Config
from sdfstudio_tpu_torch.configs.methods import build_model
from sdfstudio_tpu_torch.data.datamanager import FlexibleDataManager, VanillaDataManager
from sdfstudio_tpu_torch.data.dataparsers.blender import BlenderDataParserConfig, parse_blender
from sdfstudio_tpu_torch.data.dataparsers.colmap_family import (
    HeritageDataParserConfig, Mipnerf360DataParserConfig, PhototourismDataParserConfig,
    parse_heritage, parse_mipnerf360)
from sdfstudio_tpu_torch.data.dataparsers.misc_parsers import (
    DNeRFDataParserConfig, FriendsDataParserConfig, InstantNGPDataParserConfig,
    Record3DDataParserConfig, parse_dnerf, parse_friends, parse_instant_ngp, parse_record3d)
from sdfstudio_tpu_torch.data.dataparsers.monosdf import MonoSDFDataParserConfig, parse_monosdf
from sdfstudio_tpu_torch.data.dataparsers.nerfstudio_parser import (NerfstudioDataParserConfig,
                                                                    parse_nerfstudio)
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import SDFStudioDataParserConfig, parse_config
from sdfstudio_tpu_torch.engine.optimizers import OptimizerConfig, OptimizerGroupConfig
from sdfstudio_tpu_torch.engine.trainer import Trainer
from sdfstudio_tpu_torch.utils.device import resolve_device
from sdfstudio_tpu_torch.utils.writer import Writer

MODEL_SEED = 0
# each ported parser's config type and its parse function (split -> DataparserOutputs)
PARSERS = {SDFStudioDataParserConfig: parse_config, HeritageDataParserConfig: parse_heritage,
           Mipnerf360DataParserConfig: parse_mipnerf360,
           PhototourismDataParserConfig: parse_mipnerf360, BlenderDataParserConfig: parse_blender,
           DNeRFDataParserConfig: parse_dnerf, FriendsDataParserConfig: parse_friends,
           NerfstudioDataParserConfig: parse_nerfstudio, MonoSDFDataParserConfig: parse_monosdf,
           InstantNGPDataParserConfig: parse_instant_ngp, Record3DDataParserConfig: parse_record3d}
CAMERA_OPT_GROUP = OptimizerGroupConfig(OptimizerConfig(lr=6e-4, eps=1e-8, weight_decay=1e-2))


def optimizer_groups(config: Config) -> dict:
    """The run's optimizer groups: the config's, and ``camera_opt`` where
    the camera optimizer is on and the config names no such group."""
    groups = dict(config.optimizers)
    if config.datamanager.camera_optimizer.mode != "off" and "camera_opt" not in groups:
        groups["camera_opt"] = CAMERA_OPT_GROUP
    return groups


def setup_trainer(config: Config, test_mode: bool = False, device: Optional[str] = None,
                  checkpoints: bool = True) -> Trainer:
    """The run of ``config``, not yet set up (``Trainer.setup`` does that).
    Its directory is ``config.get_base_dir()``; with ``checkpoints`` False it
    has none (no checkpoints, no files). ``test_mode`` turns the writer's
    tensorboard and wandb backends off, as JAX's does."""
    dev = resolve_device(device)
    if config.model_class is None:
        raise ValueError("the config names no model class")
    parser = config.dataparser if config.dataparser is not None else SDFStudioDataParserConfig()
    if type(parser) not in PARSERS:
        raise NotImplementedError(f"dataparser {type(parser).__name__} is not ported (ROADMAP "
                                  "queue 1 item 14)")
    if config.data is not None:
        parser = dataclasses.replace(parser, data=Path(config.data))
    config.dataparser = parser  # as JAX's setup does, so that config.yml names the scene
    parse = PARSERS[type(parser)]
    train_outputs = parse(parser, "train")
    try:
        eval_outputs = parse(parser, "val")
    except FileNotFoundError:  # a Blender scene without transforms_val.json (setup.py:41-44)
        eval_outputs = None
    # setup.py:42-52: the Geo-NeuS methods' data manager draws from one reference image
    kinds = {"vanilla": VanillaDataManager, "flexible": FlexibleDataManager}
    if config.datamanager.kind not in kinds:
        raise ValueError(f"datamanager kind {config.datamanager.kind!r}: one of {sorted(kinds)}")
    datamanager = kinds[config.datamanager.kind](config.datamanager, train_outputs, eval_outputs,
                                                 device=dev)
    model = build_model(config, train_outputs.scene_box, num_train_data=datamanager.num_train_images,
                        seed=MODEL_SEED, device=dev).train()
    if config.datamanager.camera_optimizer.mode != "off":
        # its pose table is then one of the model's parameters (JAX's params["camera_opt"])
        model.camera_opt = datamanager.camera_optimizer
    run_dir = config.get_base_dir() if checkpoints else None
    writer = Writer(run_dir, use_tensorboard=config.vis == "tensorboard" and not test_mode,
                    use_wandb=config.vis == "wandb" and not test_mode,
                    experiment_name=f"{config.experiment_name}/{config.method_name}",
                    banner=f"[sdfstudio-tpu-torch] method={config.method_name} out={run_dir}")
    return Trainer(config.trainer, model, datamanager, optimizer_groups(config), run_dir,
                   method_name=config.method_name, writer=writer, seed=config.seed,
                   scene_dir=Path(parser.data))


def eval_setup(config_path: Path, test_mode: bool = True,
               device: Optional[str] = None) -> Tuple[Config, Trainer]:
    """The run saved at ``config_path`` rebuilt and set up from its newest
    complete checkpoint (a resumed run's ``load_step`` is usually pruned,
    so it is not read)."""
    config = Config.load_config(config_path)
    config.trainer = dataclasses.replace(config.trainer, load_dir=config.get_checkpoint_dir(),
                                         load_step=None)
    trainer = setup_trainer(config, test_mode=test_mode, device=device)
    trainer.setup()
    return config, trainer
