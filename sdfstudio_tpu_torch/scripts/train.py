"""Train a method on an SDFStudio-format scene (counterpart of
``sdfstudio_tpu/scripts/train.py``):

    python -m sdfstudio_tpu_torch.scripts.train neus-facto-tpu-p8 --data <dir> \\
        [--trainer.max-num-iterations N] [--datamanager.train-num-rays-per-batch R] \\
        [--device cuda|cpu]

The flags are the JAX flag names that the parity protocol passes
(scripts/benchmarking/parity.py:135-167); no other option is taken. It runs
on ``cuda`` unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from sdfstudio_tpu_torch.configs.methods import build_model, get_method_config, method_configs
from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
from sdfstudio_tpu_torch.data.dataparsers.sdfstudio import parse
from sdfstudio_tpu_torch.engine.trainer import Trainer
from sdfstudio_tpu_torch.utils.device import resolve_device

MODEL_SEED = 0


def setup_trainer(
    method: str,
    data: Path,
    max_num_iterations: Optional[int] = None,
    num_rays: Optional[int] = None,
    device: Optional[str] = None,
) -> Trainer:
    """Parse the scene, put its images on the device, build the method's
    model from the seeded initialiser and a set-up trainer."""
    dev = resolve_device(device)
    cfg = get_method_config(method)
    if max_num_iterations is not None:
        cfg = dataclasses.replace(
            cfg, trainer=dataclasses.replace(cfg.trainer, max_num_iterations=max_num_iterations))
    if num_rays is not None:
        cfg = dataclasses.replace(
            cfg, datamanager=dataclasses.replace(cfg.datamanager, train_num_rays_per_batch=num_rays))
    outputs = parse(Path(data))
    dm = VanillaDataManager(cfg.datamanager, outputs, device=dev)
    model = build_model(cfg, outputs.scene_box, num_train_data=dm.num_train_images,
                        seed=MODEL_SEED, device=dev).train()
    trainer = Trainer(cfg.trainer, model, dm, cfg.optimizers)
    trainer.setup()
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdfstudio_tpu_torch.scripts.train")
    ap.add_argument("method", choices=sorted(method_configs))
    ap.add_argument("--data", type=Path, required=True)
    ap.add_argument("--trainer.max-num-iterations", dest="max_num_iterations", type=int)
    ap.add_argument("--datamanager.train-num-rays-per-batch", dest="num_rays", type=int)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    trainer = setup_trainer(args.method, args.data, args.max_num_iterations, args.num_rays,
                            args.device)
    trainer.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
