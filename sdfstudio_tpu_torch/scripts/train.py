"""Train a method on an SDFStudio-format scene (counterpart of
``sdfstudio_tpu/scripts/train.py``):

    python -m sdfstudio_tpu_torch.scripts.train neus-facto-tpu-p8 --data <dir> \\
        [--trainer.max-num-iterations N] [--datamanager.train-num-rays-per-batch R] \\
        [--output-dir DIR] [--trainer.steps-per-save N] \\
        [--trainer.load-dir DIR/sdfstudio_models] [--trainer.load-step N] \\
        [--trainer.final-eval-output FILE] [--trainer.final-eval-resolution 256] \\
        [--device cuda|cpu]

The flags are the JAX flag names that the parity protocol passes
(scripts/benchmarking/parity.py:135-176), and the ``--trainer.*`` ones may
drop their prefix; no other option is taken.
Checkpoints go to ``DIR/sdfstudio_models/step-XXXXXXXXX/`` (none without
``--output-dir``); ``--trainer.load-dir`` resumes from the newest one, or
from ``--trainer.load-step``, in the port's format or JAX's packed one. A
run that reaches ``max_num_iterations`` with ``--trainer.final-eval-output``
ends with the final evaluation (PSNR and SSIM over the eval split,
Chamfer-L1 of the extracted mesh) written there. It runs on ``cuda`` unless
given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path
from typing import Optional, Sequence

import torch

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
    output_dir: Optional[Path] = None,
    **trainer_fields,
) -> Trainer:
    """Parse the scene's train and eval splits, put their images on the
    device, build the method's model from the seeded initialiser and a
    set-up trainer (which resumes when ``load_dir`` is given).
    ``trainer_fields`` override fields of the method's ``TrainerConfig``."""
    dev = resolve_device(device)
    cfg = get_method_config(method)
    if max_num_iterations is not None:
        trainer_fields["max_num_iterations"] = max_num_iterations
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, **trainer_fields))
    if num_rays is not None:
        cfg = dataclasses.replace(
            cfg, datamanager=dataclasses.replace(cfg.datamanager, train_num_rays_per_batch=num_rays))
    outputs = parse(Path(data), "train")
    dm = VanillaDataManager(cfg.datamanager, outputs, parse(Path(data), "val"), device=dev)
    model = build_model(cfg, outputs.scene_box, num_train_data=dm.num_train_images,
                        seed=MODEL_SEED, device=dev).train()
    trainer = Trainer(cfg.trainer, model, dm, cfg.optimizers, base_dir=output_dir,
                      method_name=method)
    trainer.setup()
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sdfstudio_tpu_torch.scripts.train")
    ap.add_argument("method", choices=sorted(method_configs))
    ap.add_argument("--data", type=Path, required=True)
    ap.add_argument("--output-dir", type=Path, default=None,
                    help="the run's directory; checkpoints go to its sdfstudio_models/")
    ap.add_argument("--trainer.max-num-iterations", dest="max_num_iterations", type=int)
    ap.add_argument("--trainer.steps-per-save", "--steps-per-save", dest="steps_per_save", type=int)
    ap.add_argument("--trainer.load-dir", "--load-dir", dest="load_dir", type=Path)
    ap.add_argument("--trainer.load-step", "--load-step", dest="load_step", type=int)
    ap.add_argument("--trainer.final-eval-output", "--final-eval-output", dest="final_eval_output",
                    type=str)
    ap.add_argument("--trainer.final-eval-resolution", "--final-eval-resolution",
                    dest="final_eval_resolution", type=int)
    ap.add_argument("--datamanager.train-num-rays-per-batch", dest="num_rays", type=int)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--deterministic", action="store_true",
                    help="a step that repeats bit for bit: torch.use_deterministic_algorithms, "
                         "with cuBLAS's CUBLAS_WORKSPACE_CONFIG=:4096:8 unless already set")
    args = ap.parse_args(argv)
    if args.deterministic:
        # cuBLAS reads its workspace setting when it starts, before any CUDA work here
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    fields = {k: getattr(args, k) for k in ("steps_per_save", "load_dir", "load_step",
                                            "final_eval_output", "final_eval_resolution")
              if getattr(args, k) is not None}
    trainer = setup_trainer(args.method, args.data, args.max_num_iterations, args.num_rays,
                            args.device, args.output_dir, **fields)
    trainer.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
