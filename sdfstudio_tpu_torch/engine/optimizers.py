"""Adam per named parameter group (counterpart of
``sdfstudio_tpu/engine/optimizers.py``: one optax ``adam`` with an injected
schedule per top-level group, combined by ``multi_transform``).

The update is a short functional Adam on tensors, written to follow optax
step for step rather than ``torch.optim.Adam``: optax evaluates the
learning-rate schedule at the count *before* it increments, while a
``LambdaLR`` stepped after the optimizer lags one step behind. A group that
receives no gradient gets zeros, as JAX's gradient of an unused parameter
is zero: the moments decay and the count advances. ``apply=False`` (a
frozen proposal step, trainer.py:403-418) keeps that moment update and
count but leaves the parameters as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig


B1, B2 = 0.9, 0.999  # optax.adam's defaults, which optimizers.py:33 keeps


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam's settings (optimizers.py:20-45); the other optimizer kinds are not ported."""

    lr: float
    eps: float


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    optimizer: OptimizerConfig
    scheduler: SchedulerConfig


class GroupAdam:
    """optax ``adam(lr * schedule(count), eps=eps)`` over one group's tensors."""

    def __init__(self, params: Sequence[torch.Tensor], names: Sequence[str],
                 config: OptimizerGroupConfig):
        opt = config.optimizer
        self.params = list(params)
        self.names = list(names)  # the parameters' names in the model
        self.lr, self.eps = opt.lr, opt.eps
        self.schedule = config.scheduler.build()
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_at(self, count: int) -> float:
        return self.lr * self.schedule(count)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]], apply: bool) -> None:
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        lr = self.lr_at(self.count)  # optax's schedule reads the count before the increment
        count = self.count + 1
        # the bias corrections in f32, as optax computes decay ** count
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - B2)
        self.count = count
        if not apply:
            return
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state(self) -> Dict:
        """The group's Adam state, ``{"count", "mu", "nu"}`` (``load_state``'s arguments)."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state(self, count: int, mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]) -> None:
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
                if dst.shape != src.shape:
                    raise ValueError(f"optimizer state shape {tuple(src.shape)} != {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(count)


def build_optimizers(
    group_configs: Dict[str, OptimizerGroupConfig], model: torch.nn.Module
) -> Dict[str, GroupAdam]:
    """One Adam per top-level parameter group of ``model`` (optimizers.py:56-77).
    A group without a configuration raises: the JAX package would freeze it
    silently."""
    groups: Dict[str, List] = {}
    for name, p in model.named_parameters():
        groups.setdefault(name.split(".")[0], []).append((name, p))
    missing = sorted(set(groups) - set(group_configs))
    if missing:
        raise ValueError(f"no optimizer configured for parameter groups {missing}")
    return {
        g: GroupAdam([p for _, p in named], [n for n, _ in named], group_configs[g])
        for g, named in groups.items()
    }
