"""Trainer (counterpart of ``sdfstudio_tpu/engine/trainer.py``): the training
step of ``_train_step_impl`` (trainer.py:309-436) and the loop around it.

One step: the schedules at the step before it increments, a uniform pixel
batch from the device-resident image stack, rays, the model forward with
jitter from the trainer's ``torch.Generator``, the loss dict and its sum,
the gradient of every parameter group, and each group's Adam. On a frozen
proposal step (``train_proposal`` False) the proposal nets get zero
gradients, their Adam moments decay and count advances, and their
parameters stay as they are (trainer.py:403-418).

Metrics stay on the device, one vector per step, and are read back once per
log interval. Gradient accumulation (``accumulate_grad_steps > 1``),
checkpoint save/load and the final evaluation are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from sdfstudio_tpu_torch.data.datamanager import VanillaDataManager
from sdfstudio_tpu_torch.engine.final_eval import set_fp32_precision
from sdfstudio_tpu_torch.engine.optimizers import GroupAdam, OptimizerGroupConfig, build_optimizers
from sdfstudio_tpu_torch.samplers.spaced import Rng

PROPOSAL_GROUP = "proposal_networks"
SEED = 42  # the batch and jitter generator's seed (trainer.py:162, PRNGKey(42))
STEPS_PER_LOG = 10  # trainer.py:45's default, which p8 keeps


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The fields of ``TrainerConfig`` (trainer.py:37-107) this port reads."""

    max_num_iterations: int = 1000000
    accumulate_grad_steps: int = 1


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
    """Owns the model's optimizers, the step count and the batch generator."""

    def __init__(
        self,
        config: TrainerConfig,
        model: torch.nn.Module,
        datamanager: VanillaDataManager,
        optimizer_groups: Dict[str, OptimizerGroupConfig],
    ):
        if config.accumulate_grad_steps != 1:
            raise NotImplementedError(
                "accumulate_grad_steps > 1 is not ported yet (ROADMAP queue 1 item 10)"
            )
        self.config = config
        self.model = model
        self.datamanager = datamanager
        self.optimizer_groups = optimizer_groups
        self.optimizers: Dict[str, GroupAdam] = {}
        self.step = 0
        self.generator: Optional[torch.Generator] = None
        self.metric_keys: Sequence[str] = ()

    def setup(self) -> None:
        set_fp32_precision()
        self.optimizers = build_optimizers(self.optimizer_groups, self.model)
        self.generator = torch.Generator(device=self.datamanager.device).manual_seed(SEED)
        self.step = 0

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

    def train(self) -> Dict[str, float]:
        """Run to ``max_num_iterations`` steps, reading the metrics back and
        printing them once per ``STEPS_PER_LOG``; returns the last row."""
        end = self.config.max_num_iterations
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
                    + f" ({rate:.2f} steps/s)")
        return last
