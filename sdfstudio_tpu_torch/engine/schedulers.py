"""Learning-rate multipliers as plain functions of the step (counterpart of
``sdfstudio_tpu/engine/schedulers.py``): the ``neus`` warmup-cosine and the
``multistep`` schedules that ``neus-facto-tpu-p8`` uses."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

Schedule = Callable[[float], float]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """The fields of ``SchedulerConfig`` (schedulers.py:19-58) these schedules read."""

    kind: str  # neus | multistep
    max_steps: int = 1000000
    warm_up_end: int = 5000
    learning_rate_alpha: float = 0.05

    def build(self) -> Schedule:
        if self.kind == "neus":
            return neus_schedule(self.warm_up_end, self.learning_rate_alpha, self.max_steps)
        if self.kind == "multistep":
            ms = [self.max_steps // 2, self.max_steps * 3 // 4, self.max_steps * 9 // 10]
            return multistep_schedule(ms, 0.33)
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
