"""Learning-rate multipliers as plain functions of the step (counterpart of
``sdfstudio_tpu/engine/schedulers.py``): the ``neus`` warmup-cosine, the
``multistep``, the ``multistep_warmup``, the ``exponential``, the jaxnerf
``exponential_decay`` (``tensorf``'s) and the ``delayed_exponential``
schedules, and ``none`` (a constant 1, a group without a scheduler). A
multiplier is relative to the group's base rate ``lr_init``, which only the
two log-lerp schedules read."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

import numpy as np

Schedule = Callable[[float], float]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """The fields of ``SchedulerConfig`` (schedulers.py:19-58) these schedules read."""

    kind: str  # neus | multistep | multistep_warmup | exponential | exponential_decay |
    #            delayed_exponential | none
    lr_final: float = 5e-6
    max_steps: int = 1000000
    lr_delay_steps: int = 0
    lr_delay_mult: float = 1.0
    warm_up_end: int = 5000
    learning_rate_alpha: float = 0.05
    milestones: Tuple[int, ...] = (300000, 400000, 500000)
    gamma: float = 0.33
    decay_rate: float = 0.1

    def build(self, lr_init: float = 1.0) -> Schedule:
        if self.kind == "exponential_decay":
            return exponential_decay_schedule(lr_init, self.lr_final, self.max_steps,
                                              self.lr_delay_steps, self.lr_delay_mult)
        if self.kind == "delayed_exponential":
            return delayed_exponential_schedule(lr_init, self.lr_final, self.max_steps,
                                                self.warm_up_end)
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


def exponential_decay_schedule(lr_init: float, lr_final: float, max_steps: int,
                               lr_delay_steps: int = 0, lr_delay_mult: float = 1.0) -> Schedule:
    """jaxnerf's log-lerp from ``lr_init`` to ``lr_final`` over ``max_steps``,
    held at ``lr_final`` after, with an optional sine-eased delay over the
    first ``lr_delay_steps`` that starts at ``lr_delay_mult``, as a multiplier
    of ``lr_init`` (schedulers.py:75-96). In float32 as JAX computes it: the
    step, the fraction, the logs of the rates and the ``exp``."""
    f32 = np.float32
    log_init, log_final = f32(np.log(lr_init)), f32(np.log(lr_final))
    half_pi = f32(0.5 * np.pi)

    def sched(step: float) -> float:
        s = f32(step)
        if lr_delay_steps > 0:
            ramp = np.clip(s / f32(lr_delay_steps), f32(0), f32(1))
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(half_pi * ramp)
        else:
            delay_rate = f32(1.0)
        t = np.clip(s / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(log_init * (f32(1) - t) + log_final * t)
        return float(delay_rate * log_lerp / f32(lr_init))

    return sched


def delayed_exponential_schedule(lr_init: float, lr_final: float, max_steps: int,
                                 delay: int) -> Schedule:
    """0 up to ``delay``, then the log-lerp of ``exponential_decay_schedule``
    from the delay on (schedulers.py:39-46)."""
    base = exponential_decay_schedule(lr_init, lr_final, max_steps)

    def sched(step: float) -> float:
        s = np.float32(step)
        return base(max(s - np.float32(delay), np.float32(0))) if s > delay else 0.0

    return sched
