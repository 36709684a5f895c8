"""Trainer (counterpart of ``sdfstudio_tpu/engine/trainer.py``): the training
step of ``_train_step_impl`` (trainer.py:309-436), the loop around it,
checkpoints and the final evaluation.

One step: the schedules at the step before it increments, a uniform pixel
batch from the device-resident image stack, rays, the model forward with
jitter from the trainer's ``torch.Generator``, the loss dict and its sum,
the gradient of every parameter group, and each group's Adam. On a frozen
proposal step (``train_proposal`` False) the proposal nets get zero
gradients, their Adam moments decay and count advances, and their
parameters stay as they are (trainer.py:403-418).

Metrics stay on the device, one vector per step, and are read back once per
log interval. Checkpoints (trainer.py:736-805) lie as JAX lays them out,
``<base_dir>/sdfstudio_models/step-{step:09d}/`` with ``step.txt`` written
last; the port's own format is one ``torch.save`` file holding the model's
``state_dict``, every group's Adam state, the step and the generator's
state, so a resumed run takes the same steps as a straight one. The loader
also reads a JAX packed checkpoint (``packed.npz``) through
``utils/convert.py::load_jax_checkpoint``; JAX's PRNG key has no
counterpart, so the generator then keeps its seed. A run that reaches
``max_num_iterations`` with ``final_eval_output`` set ends with the final
evaluation in the same process (trainer.py:632-647). Gradient accumulation
(``accumulate_grad_steps > 1``) is not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
from sdfstudio_tpu_torch.engine.final_eval import run_final_eval, set_fp32_precision
from sdfstudio_tpu_torch.engine.optimizers import GroupAdam, OptimizerGroupConfig, build_optimizers
from sdfstudio_tpu_torch.samplers.spaced import Rng
from sdfstudio_tpu_torch.utils.convert import load_jax_checkpoint

PROPOSAL_GROUP = "proposal_networks"
SEED = 42  # the batch and jitter generator's seed (trainer.py:162, PRNGKey(42))
STEPS_PER_LOG = 10  # trainer.py:45's default, which p8 keeps
CHECKPOINT_FILE = "checkpoint.pt"  # the port's format, in a step directory


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The fields of ``TrainerConfig`` (trainer.py:37-107) this port reads.
    The final evaluation judges the geometry against the DTU-like scene's
    analytic surface, the one judge ported (``final_eval_gt`` "dtu-like")."""

    steps_per_save: int = 1000
    max_num_iterations: int = 1000000
    save_only_latest_checkpoint: bool = True
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    accumulate_grad_steps: int = 1
    final_eval_output: str = ""
    final_eval_resolution: int = 256


def loss_and_metrics(
    model, ray_bundle, batch: Dict[str, torch.Tensor], sched: Dict, rng: Rng = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``loss_fn`` of trainer.py:352-364: (total loss, loss dict, metrics)."""
    outputs = model.get_outputs(ray_bundle, sched=sched, train=True, rng=rng)
    loss_dict = model.get_loss_dict(outputs, batch, sched)
    total = sum(loss_dict.values())
    return total, loss_dict, model.get_metrics_dict(outputs, batch)


def group_grads(
    total: torch.Tensor, optimizers: Dict[str, GroupAdam]
) -> Dict[str, List[Optional[torch.Tensor]]]:
    """d total / d params for every group; None where a parameter took no
    part (a frozen proposal step, the unused appearance embedding)."""
    names = list(optimizers)
    flat = [p for n in names for p in optimizers[n].params]
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    out, i = {}, 0
    for n in names:
        k = len(optimizers[n].params)
        out[n] = list(grads[i:i + k])
        i += k
    return out


def apply_grads(
    optimizers: Dict[str, GroupAdam], grads: Dict[str, List[Optional[torch.Tensor]]], sched: Dict
) -> None:
    """Every group's Adam step (trainer.py:403-418). A None gradient counts
    as zero; on a frozen proposal step (``train_proposal`` False) the
    proposal group's moments and count advance and its parameters stay."""
    frozen = not sched.get("train_proposal", True)
    for name, opt in optimizers.items():
        opt.step(grads[name], apply=not (frozen and name == PROPOSAL_GROUP))


class Trainer:
    """Owns the model's optimizers, the step count, the batch generator and
    the checkpoints under ``base_dir`` (none are written without one)."""

    def __init__(
        self,
        config: TrainerConfig,
        model: torch.nn.Module,
        datamanager: VanillaDataManager,
        optimizer_groups: Dict[str, OptimizerGroupConfig],
        base_dir: Optional[Path] = None,
        method_name: str = "",
    ):
        if config.accumulate_grad_steps != 1:
            raise NotImplementedError(
                "accumulate_grad_steps > 1 is not ported yet (ROADMAP queue 1 item 10)"
            )
        self.config = config
        self.model = model
        self.datamanager = datamanager
        self.optimizer_groups = optimizer_groups
        self.ckpt_dir = Path(base_dir) / "sdfstudio_models" if base_dir is not None else None
        self.method_name = method_name
        self.optimizers: Dict[str, GroupAdam] = {}
        self.step = 0
        self.generator: Optional[torch.Generator] = None
        self.metric_keys: Sequence[str] = ()

    def setup(self) -> None:
        set_fp32_precision()
        self.optimizers = build_optimizers(self.optimizer_groups, self.model)
        self.generator = torch.Generator(device=self.datamanager.device).manual_seed(SEED)
        self.step = 0
        if self.config.load_dir is not None:
            self.load_checkpoint(self.config.load_dir, self.config.load_step)

    def train_step(self) -> torch.Tensor:
        """One step; returns its metrics as one device vector (``metric_keys``)."""
        model, dm = self.model, self.datamanager
        sched = model.schedules(self.step)
        with record_function("sst/train_batch"):
            ray_indices, batch = dm.sample_train_batch(self.generator)
            ray_bundle = dm.generate_rays(ray_indices)
        with record_function("sst/train_forward"):
            total, loss_dict, metrics = loss_and_metrics(model, ray_bundle, batch, sched, self.generator)
        with record_function("sst/train_backward"):
            grads = group_grads(total, self.optimizers)
        with record_function("sst/train_optimizer"):
            apply_grads(self.optimizers, grads, sched)
        self.step += 1
        out = {"loss": total.detach(), **{k: v.detach() for k, v in loss_dict.items()}, **metrics}
        self.metric_keys = sorted(out)
        return torch.stack([out[k].reshape(()).to(torch.float32) for k in self.metric_keys])

    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        """Run to ``num_iterations`` (default ``max_num_iterations``) steps,
        reading the metrics back and printing them once per
        ``STEPS_PER_LOG`` and saving every ``steps_per_save`` steps and at
        the end; then, at ``max_num_iterations``, the final evaluation if
        ``final_eval_output`` is set (trainer.py:582-647). Returns the last
        metrics row."""
        cfg = self.config
        end = num_iterations or cfg.max_num_iterations
        history: List[torch.Tensor] = []
        last: Dict[str, float] = {}
        start, t0 = self.step, time.perf_counter()
        while self.step < end:
            history.append(self.train_step())
            if self.step % STEPS_PER_LOG == 0 or self.step == end:
                rows = torch.stack(history).cpu()  # one device->host read per interval
                history.clear()
                last = dict(zip(self.metric_keys, rows[-1].tolist()))
                rate = (self.step - start) / (time.perf_counter() - t0)
                print(f"step {self.step}/{end} " + " ".join(f"{k}={v:.5g}" for k, v in last.items())
                    + f" ({rate:.2f} steps/s)", flush=True)
            if self.ckpt_dir is not None and (self.step % cfg.steps_per_save == 0 or self.step == end):
                self.save_checkpoint(self.step)
        if cfg.final_eval_output and end >= cfg.max_num_iterations:
            run_final_eval(self, self.method_name, self.step, Path(cfg.final_eval_output),
                           cfg.final_eval_resolution)
        return last

    def save_checkpoint(self, step: int) -> Path:
        """Write ``step-{step:09d}/`` under ``ckpt_dir``, ``step.txt`` last;
        with ``save_only_latest_checkpoint`` the older step directories go
        (trainer.py:736-759)."""
        path = self.ckpt_dir / f"step-{step:09d}"
        path.mkdir(parents=True, exist_ok=True)
        torch.save({
            "step": step,
            "model": self.model.state_dict(),
            "optimizers": {name: opt.state() for name, opt in self.optimizers.items()},
            "generator": self.generator.get_state(),
        }, path / CHECKPOINT_FILE)
        (path / "step.txt").write_text(str(step))
        if self.config.save_only_latest_checkpoint:
            for p in sorted(self.ckpt_dir.glob("step-*")):
                if p != path:
                    shutil.rmtree(p)
        print(f"saved checkpoint {path}", flush=True)
        return path

    def load_checkpoint(self, load_dir, load_step: Optional[int] = None) -> None:
        """Resume from ``load_dir/step-{load_step:09d}/``, by default the
        newest step directory that has its ``step.txt`` (a directory without
        one is a save that did not finish; trainer.py:770-805). Reads the
        port's format or a JAX packed checkpoint."""
        load_dir = Path(load_dir)
        if load_step is None:
            steps = sorted(int(p.name.split("-")[1]) for p in load_dir.glob("step-*")
                           if (p / "step.txt").exists())
            if not steps:
                raise FileNotFoundError(f"no complete checkpoint under {load_dir}")
            load_step = steps[-1]
        path = load_dir / f"step-{load_step:09d}"
        if not (path / "step.txt").exists():
            raise FileNotFoundError(f"no complete checkpoint at {path}")
        if (path / "packed.npz").exists():
            step = load_jax_checkpoint(self.model, self.optimizers, path)
        else:
            ckpt = torch.load(path / CHECKPOINT_FILE, map_location="cpu", weights_only=True)
            if set(ckpt["optimizers"]) != set(self.optimizers):
                raise ValueError(f"{path}: optimizer groups {sorted(ckpt['optimizers'])}, "
                                 f"expected {sorted(self.optimizers)}")
            self.model.load_state_dict(ckpt["model"])
            for name, opt in self.optimizers.items():
                opt.load_state(**ckpt["optimizers"][name])
            self.generator.set_state(ckpt["generator"])
            step = ckpt["step"]
        if step != load_step:
            raise ValueError(f"{path} holds step {step}")
        self.step = step
        print(f"loaded checkpoint from {path} at step {step}", flush=True)
