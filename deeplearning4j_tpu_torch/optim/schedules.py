"""Learning-rate schedules: counterpart of
``deeplearning4j_tpu/optim/schedules.py`` (the reference's ``ISchedule``
implementations). ``value_at(iteration)`` is a Python float: the updater's
step count is a Python int, so reading the schedule never waits on the
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

_SCHEDULES = {}


def _register(cls):
    _SCHEDULES[cls.__name__.lower()] = cls
    return cls


@dataclasses.dataclass
class Schedule:
    def value_at(self, iteration) -> float:
        raise NotImplementedError

    def __call__(self, step):
        return self.value_at(step)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@schedule"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _SCHEDULES[d.pop("@schedule").lower()]
        return cls(**d)


def _clip01(v):
    return min(max(v, 0.0), 1.0)


@_register
@dataclasses.dataclass
class FixedSchedule(Schedule):
    value: float = 1e-3

    def value_at(self, it):
        return self.value


@_register
@dataclasses.dataclass
class MapSchedule(Schedule):
    """values[i] applies from iteration i onward."""
    values: Dict[int, float] = dataclasses.field(default_factory=dict)

    def value_at(self, it):
        vals = {int(k): float(v) for k, v in self.values.items()}
        keys = sorted(vals)
        out = vals[keys[0]]
        for k in keys:
            if it >= k:
                out = vals[k]
        return out


@_register
@dataclasses.dataclass
class ExponentialSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.99

    def value_at(self, it):
        return self.initial_value * self.gamma ** it


@_register
@dataclasses.dataclass
class InverseSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.01
    power: float = 1.0

    def value_at(self, it):
        return self.initial_value / (1.0 + self.gamma * it) ** self.power


@_register
@dataclasses.dataclass
class PolySchedule(Schedule):
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def value_at(self, it):
        return self.initial_value * (1.0 - _clip01(it / self.max_iter)) ** self.power


@_register
@dataclasses.dataclass
class SigmoidSchedule(Schedule):
    initial_value: float = 1e-3
    gamma: float = 0.01
    step_size: int = 100

    def value_at(self, it):
        return self.initial_value / (1.0 + math.exp(self.gamma * (it - self.step_size)))


@_register
@dataclasses.dataclass
class StepSchedule(Schedule):
    initial_value: float = 1e-3
    decay_rate: float = 0.1
    step: int = 1000

    def value_at(self, it):
        return self.initial_value * self.decay_rate ** math.floor(it / self.step)


@_register
@dataclasses.dataclass
class CosineSchedule(Schedule):
    """Warmup-free cosine decay."""
    initial_value: float = 1e-3
    max_iter: int = 10000
    final_value: float = 0.0

    def value_at(self, it):
        frac = _clip01(it / self.max_iter)
        return self.final_value + 0.5 * (self.initial_value - self.final_value) * (1 + math.cos(math.pi * frac))


@_register
@dataclasses.dataclass
class WarmupSchedule(Schedule):
    """Linear warmup to a constant."""
    warmup_iters: int = 100
    then_value: float = 1e-3

    def value_at(self, it):
        if it < self.warmup_iters:
            return self.then_value * (it + 1) / max(1, self.warmup_iters)
        return self.then_value


def resolve(lr) -> Schedule:
    if isinstance(lr, Schedule):
        return lr
    if isinstance(lr, dict) and "@schedule" in lr:
        return Schedule.from_dict(lr)
    return FixedSchedule(float(lr))
