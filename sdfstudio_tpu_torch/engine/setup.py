"""Building a run from its configuration (counterpart of
``sdfstudio_tpu/engine/setup.py``): dataparser -> data manager -> model ->
optimizers -> writer -> trainer (``setup_trainer``, setup.py:19-89), and
the rebuild of a finished run from its ``config.yml`` with its newest
complete checkpoint (``eval_setup``, setup.py:92-104).

The port's entry points run on ``cuda`` unless given ``device="cpu"``.
The model's parameters come from the port's seeded initialiser
(``MODEL_SEED``); ``Config.seed`` seeds the trainer's batch and jitter
generator.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

from sdfstudio_tpu_torch.configs.base import Config
from sdfstudio_tpu_torch.configs.methods import build_model
from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import SDFStudioDataParserConfig, parse_config
from sdfstudio_tpu_torch.engine.trainer import Trainer
from sdfstudio_tpu_torch.utils.device import resolve_device
from sdfstudio_tpu_torch.utils.writer import Writer

MODEL_SEED = 0


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
    if not isinstance(parser, SDFStudioDataParserConfig):
        raise NotImplementedError(f"dataparser {type(parser).__name__} is not ported (ROADMAP "
                                  "queue 1 item 14)")
    if config.data is not None:
        parser = dataclasses.replace(parser, data=Path(config.data))
    config.dataparser = parser  # as JAX's setup does, so that config.yml names the scene
    train_outputs = parse_config(parser, "train")
    eval_outputs = parse_config(parser, "val")
    datamanager = VanillaDataManager(config.datamanager, train_outputs, eval_outputs, device=dev)
    model = build_model(config, train_outputs.scene_box, num_train_data=datamanager.num_train_images,
                        seed=MODEL_SEED, device=dev).train()
    run_dir = config.get_base_dir() if checkpoints else None
    writer = Writer(run_dir, use_tensorboard=config.vis == "tensorboard" and not test_mode,
                    use_wandb=config.vis == "wandb" and not test_mode,
                    experiment_name=f"{config.experiment_name}/{config.method_name}",
                    banner=f"[sdfstudio-tpu-torch] method={config.method_name} out={run_dir}")
    return Trainer(config.trainer, model, datamanager, dict(config.optimizers), run_dir,
                   method_name=config.method_name, writer=writer, seed=config.seed)


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
