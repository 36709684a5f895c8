"""Adam, AdamW and RAdam per named parameter group (counterpart of
``sdfstudio_tpu/engine/optimizers.py``: one optax ``adam``, ``adamw`` or
``radam`` with an injected schedule per top-level group, combined by
``multi_transform``).

The update is a short functional Adam on tensors, written to follow optax
step for step rather than ``torch.optim.Adam``: optax evaluates the
learning-rate schedule at the count *before* it increments, while a
``LambdaLR`` stepped after the optimizer lags one step behind. A group that
receives no gradient gets zeros, as JAX's gradient of an unused parameter
is zero: the moments decay and the count advances. ``apply=False`` (a
frozen proposal step, trainer.py:403-418) keeps that moment update and
count but leaves the parameters as they are.

``adamw`` is ``optax.adamw(lr * schedule, eps=eps, weight_decay=wd)``
(optimizers.py:37-38) with optax's ``mask=None``: the decay applies to every
parameter of the group, ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
``adam`` with a ``weight_decay`` is ``optax.chain(add_decayed_weights(wd),
adam(...))`` (optimizers.py:30-35, the camera optimizer's group): the decay
joins the gradient before the moments, ``g + wd * p``.
``radam`` is ``optax.radam(lr * schedule, eps=eps)`` (optimizers.py:38-39):
Adam's moments and bias corrections, and with ``rho_inf = 2 / (1 - b2) - 1``
and ``rho_t = rho_inf - 2 t b2^t / (1 - b2^t)`` (in float32, as optax
computes them) the update ``r_t m_hat / (sqrt(v_hat) + eps)`` with the
rectifier ``r_t = sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)
(rho_inf - 2) rho_t))`` where ``rho_t >= 5``, and the plain first moment
``m_hat`` below (the first five steps at b2 = 0.999). Its state is Adam's
(count, mu, nu), so JAX's packed checkpoints load into it.
A configured group that holds no parameters (``vanilla-nerf``'s
``temporal_distortion``) gets no optimizer, as ``multi_transform`` updates
nothing there.
The update runs as a few ``torch._foreach_*`` passes over the group: on
Neuralangelo's 447M-parameter hash table it is a memory-bound pass of
several GB a step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sdfstudio_tpu_torch.engine.schedulers import SchedulerConfig


B1, B2 = 0.9, 0.999  # optax.adam's defaults, which optimizers.py:33 keeps
RADAM_THRESHOLD = 5.0  # optax.radam's threshold of rho_t
KINDS = ("adam", "adamw", "radam")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam's, AdamW's and RAdam's settings (optimizers.py:20-45); ``sgd``,
    which no registered method sets, is not ported and raises."""

    lr: float
    eps: float
    kind: str = "adam"  # adam | adamw | radam
    weight_decay: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise NotImplementedError(f"optimizer kind {self.kind!r} is not ported; "
                                      f"{', '.join(KINDS)} are")


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    """A group's optimizer and schedule; without one the rate is constant
    (JAX's ``SchedulerConfig(kind="none")``, optimizers.py:66)."""

    optimizer: OptimizerConfig
    scheduler: Optional[SchedulerConfig] = None


def radam_rectifier(count: int) -> float:
    """optax's ``r_t`` at step ``count`` (1, 2, ...) in float32, or 0.0
    where ``rho_t`` is below the threshold and the update is the plain
    first moment (transform.py, ``scale_by_radam``)."""
    f32 = np.float32
    rho_inf = f32(2.0 / (1.0 - B2) - 1.0)
    b2t = f32(B2) ** f32(count)
    rho = rho_inf - f32(2 * count) * b2t / (f32(1.0) - b2t)
    if not rho >= f32(RADAM_THRESHOLD):
        return 0.0
    den = f32((2.0 / (1.0 - B2) - 1.0 - 4.0) * (2.0 / (1.0 - B2) - 1.0 - 2.0)) * rho
    return float(np.sqrt((rho - f32(4.0)) * (rho - f32(2.0)) * rho_inf / den))


class GroupAdam:
    """optax ``adam(lr * schedule(count), eps=eps)`` (after
    ``add_decayed_weights`` with a ``weight_decay``), ``adamw`` with the
    group's ``weight_decay``, or ``radam``, over one group's tensors."""

    def __init__(self, params: Sequence[torch.Tensor], names: Sequence[str],
                 config: OptimizerGroupConfig):
        opt = config.optimizer
        self.params = list(params)
        self.names = list(names)  # the parameters' names in the model
        self.lr, self.eps, self.kind = opt.lr, opt.eps, opt.kind
        self.weight_decay = opt.weight_decay if opt.kind == "adamw" else 0.0
        self.grad_decay = opt.weight_decay if opt.kind == "adam" else 0.0
        self.schedule = (config.scheduler or SchedulerConfig(kind="none")).build(opt.lr)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_at(self, count: int) -> float:
        return self.lr * self.schedule(count)

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]], apply: bool) -> None:
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        if self.grad_decay:  # optax.add_decayed_weights, before scale_by_adam
            grads = torch._foreach_add(grads, self.params, alpha=self.grad_decay)
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
        upd = torch._foreach_div(self.mu, bc1)
        r = radam_rectifier(count) if self.kind == "radam" else 1.0
        if r:  # Adam's step, RAdam's rectified one
            if self.kind == "radam":
                torch._foreach_mul_(upd, r)
            denom = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(upd, denom)
            del denom
        if self.weight_decay:  # optax.add_decayed_weights, after scale_by_adam
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
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
