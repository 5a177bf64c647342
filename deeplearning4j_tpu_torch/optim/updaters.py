"""Updaters (optimizers): counterpart of ``deeplearning4j_tpu/optim/updaters.py``
(the reference's ``IUpdater`` configs: Sgd, Nesterovs, Adam, AdamW,
AdaMax, Nadam, AMSGrad, RmsProp, AdaGrad, AdaDelta, NoOp).

Each config lowers, by ``transform()``, to the chain of
``optim/transforms.py`` that reproduces its reference ``to_optax()``
chain, state layout included: ``Nesterovs`` is ``optax.sgd(lr, momentum,
nesterov=True)``, a ``trace`` then a scaled learning rate, so its
optimizer state carries across from the JAX package leaf for leaf
(``transforms.state_from_optax``). The learning rate is always a schedule
(a constant is a ``FixedSchedule``), as ``to_optax()`` always passes a
callable. ``to_dict`` / ``from_dict`` write the reference's JSON.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.optim import schedules as _sched
from deeplearning4j_tpu_torch.optim import transforms as T

_UPDATERS = {}


def _register(cls):
    _UPDATERS[cls.__name__.lower()] = cls
    return cls


@dataclasses.dataclass
class Updater:
    learning_rate: object = 1e-3

    def lr_schedule(self):
        return _sched.resolve(self.learning_rate).value_at

    def _lr(self):
        return T.ScaleBySchedule(self.lr_schedule())

    def transform(self) -> T.Transform:
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        if isinstance(self.learning_rate, _sched.Schedule):
            d["learning_rate"] = self.learning_rate.to_dict()
        d["@updater"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _UPDATERS[d.pop("@updater").lower()]
        if isinstance(d.get("learning_rate"), dict):
            d["learning_rate"] = _sched.Schedule.from_dict(d["learning_rate"])
        return cls(**d)


@_register
@dataclasses.dataclass
class Sgd(Updater):
    learning_rate: object = 0.1

    def transform(self):
        return T.Chain(T.Identity(), self._lr())


@_register
@dataclasses.dataclass
class Nesterovs(Updater):
    learning_rate: object = 0.1
    momentum: float = 0.9

    def transform(self):
        return T.Chain(T.Trace(self.momentum, nesterov=True), self._lr())


@_register
@dataclasses.dataclass
class Adam(Updater):
    learning_rate: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return T.Chain(T.ScaleByAdam(self.beta1, self.beta2, self.epsilon),
                       self._lr())


@_register
@dataclasses.dataclass
class AdamW(Updater):
    learning_rate: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.01

    def transform(self):
        return T.Chain(T.ScaleByAdam(self.beta1, self.beta2, self.epsilon),
                       T.AddDecayedWeights(self.weight_decay), self._lr())


@_register
@dataclasses.dataclass
class AdaMax(Updater):
    learning_rate: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return T.Chain(T.ScaleByAdamax(self.beta1, self.beta2, self.epsilon),
                       self._lr())


@_register
@dataclasses.dataclass
class Nadam(Updater):
    learning_rate: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return T.Chain(T.ScaleByAdam(self.beta1, self.beta2, self.epsilon,
                                     nesterov=True), self._lr())


@_register
@dataclasses.dataclass
class AMSGrad(Updater):
    learning_rate: object = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return T.Chain(T.ScaleByAmsgrad(self.beta1, self.beta2, self.epsilon),
                       self._lr())


@_register
@dataclasses.dataclass
class RmsProp(Updater):
    learning_rate: object = 1e-3
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def transform(self):
        return T.Chain(T.ScaleByRms(self.rms_decay, self.epsilon),
                       self._lr(), T.Identity())


@_register
@dataclasses.dataclass
class AdaGrad(Updater):
    learning_rate: object = 1e-1
    epsilon: float = 1e-6

    def transform(self):
        return T.Chain(T.ScaleByRss(0.1, self.epsilon), self._lr())


@_register
@dataclasses.dataclass
class AdaDelta(Updater):
    learning_rate: object = 1.0  # unused by the rule itself (ref parity)
    rho: float = 0.95
    epsilon: float = 1e-6

    def transform(self):
        # optax.adadelta(learning_rate=None): decay 0, the rule, identity
        return T.Chain(T.AddDecayedWeights(0.0),
                       T.ScaleByAdaDelta(self.rho, self.epsilon), T.Identity())


@_register
@dataclasses.dataclass
class NoOp(Updater):
    learning_rate: object = 0.0

    def transform(self):
        return T.SetToZero()


def resolve(u) -> Updater:
    if isinstance(u, Updater):
        return u
    if isinstance(u, dict) and "@updater" in u:
        return Updater.from_dict(u)
    raise TypeError(f"Cannot resolve updater from {u!r}")
