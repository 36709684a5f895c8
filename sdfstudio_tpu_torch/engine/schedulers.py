"""Learning-rate multipliers as plain functions of the step (counterpart of
``sdfstudio_tpu/engine/schedulers.py``): the ``neus`` warmup-cosine, the
``multistep``, the ``multistep_warmup`` and the ``exponential`` schedules that
the registered methods use, and ``none`` (a constant 1, a group without a
scheduler)."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import numpy as np

Schedule = Callable[[float], float]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """The fields of ``SchedulerConfig`` (schedulers.py:19-58) these schedules read."""

    kind: str  # neus | multistep | multistep_warmup | exponential | none
    max_steps: int = 1000000
    warm_up_end: int = 5000
    learning_rate_alpha: float = 0.05
    milestones: Tuple[int, ...] = (300000, 400000, 500000)
    gamma: float = 0.33
    decay_rate: float = 0.1

    def build(self) -> Schedule:
        if self.kind == "neus":
            return neus_schedule(self.warm_up_end, self.learning_rate_alpha, self.max_steps)
        if self.kind == "multistep":
            ms = [self.max_steps // 2, self.max_steps * 3 // 4, self.max_steps * 9 // 10]
            return multistep_schedule(ms, 0.33)
        if self.kind == "multistep_warmup":
            return multistep_warmup_schedule(self.warm_up_end, self.milestones, self.gamma)
        if self.kind == "exponential":
            return exponential_schedule(self.decay_rate, self.max_steps)
        if self.kind == "none":
            return lambda step: 1.0
        raise NotImplementedError(f"scheduler kind {self.kind!r} is not ported (ROADMAP queue 1)")


def multistep_schedule(milestones: Sequence[int], gamma: float) -> Schedule:
    """gamma ** (number of milestones reached) (schedulers.py:99-105)."""
    def sched(step: float) -> float:
        return gamma ** sum(float(step) >= m for m in milestones)

    return sched


def neus_schedule(warm_up_end: int, learning_rate_alpha: float, max_steps: int) -> Schedule:
    """Linear warmup, then cosine decay to ``alpha`` (schedulers.py:108-119)."""
    def sched(step: float) -> float:
        step = float(step)
        if step < warm_up_end:
            return step / max(warm_up_end, 1)
        progress = (step - warm_up_end) / max(max_steps - warm_up_end, 1)
        alpha = learning_rate_alpha
        return (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha

    return sched


def multistep_warmup_schedule(warm_up_end: int, milestones: Sequence[int],
                              gamma: float) -> Schedule:
    """Linear warmup, then ``gamma ** (number of milestones reached)``
    (schedulers.py:122-131), in float32 as JAX computes it: the step and
    the milestones compared in f32, the warmup a f32 quotient, the power a
    f32 power of the f32 ``gamma``."""
    ms = np.asarray(milestones, np.float32)
    w, g = np.float32(max(warm_up_end, 1)), np.float32(gamma)

    def sched(step: float) -> float:
        s = np.float32(step)
        if s < np.float32(warm_up_end):
            return float(s / w)
        return float(g ** np.float32(np.sum(s >= ms)))

    return sched


def exponential_schedule(decay_rate: float, max_steps: int) -> Schedule:
    """``rate ** step`` with ``rate = decay_rate ** (1 / max_steps)``
    (schedulers.py:50-55). JAX raises the rate to the step in float32, so
    the rate is first rounded to float32 as it is there: at 0.1 over
    100,000 steps that rounding alone moves the multiplier by ~1e-4 at step
    5,000, which this keeps."""
    rate = float(np.float32(decay_rate ** (1.0 / max_steps)))

    def sched(step: float) -> float:
        return rate ** float(step)

    return sched
