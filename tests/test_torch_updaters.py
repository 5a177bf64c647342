"""The port's updaters, schedules and gradient normalization against the
JAX package's optax chains, on the CPU.

The same params and the same three gradients go through the reference
updater's ``to_optax()`` and the port updater's ``transform()``: updates
and every state leaf atol 1e-6 (PERF.md: the same f32 elementwise
arithmetic, Python-double schedule values against optax's f32 ones). The
state layouts match leaf for leaf, and a reference state carried across
by ``state_from_optax`` continues the same way.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deeplearning4j_tpu.nn.conf.configuration import NeuralNetConfiguration \
    as JNNC
from deeplearning4j_tpu.nn.multilayer import _grad_transform as j_chain
from deeplearning4j_tpu.optim import schedules as JS
from deeplearning4j_tpu.optim import updaters as JU
from deeplearning4j_tpu_torch.nn._network import grad_transform as t_chain
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration as TNNC)
from deeplearning4j_tpu_torch.optim import schedules as TS
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.optim import updaters as TU

ATOL = 1e-6
SHAPES = {"0": {"W": (3, 4), "b": (4,)}, "1": {"beta": (2,), "gamma": (2,)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: {p: (rng.standard_normal(s) * scale).astype(np.float32)
                for p, s in layer.items()} for k, layer in SHAPES.items()}


def _leaves(tree):
    return [torch.from_numpy(tree[k][p].copy()) for k in sorted(tree)
            for p in sorted(tree[k])]


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _run_both(jtx, ttx, steps=3, grad_scale=1.0, carry_at=None):
    """Drive both transforms with the same params and grads; compare the
    updates and the state leaves after every step."""
    params = _tree(0)
    jp, tp = _jtree(params), _leaves(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    assert len(jax.tree.leaves(js)) == len(T.state_leaves(ts))
    for step in range(steps):
        g = _tree(10 + step, grad_scale)
        ju, js = jtx.update(_jtree(g), js, jp)
        tu, ts = ttx.update(_leaves(g), ts, tp)
        for a, b in zip(jax.tree.leaves(ju), tu):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
        for a, b in zip(jax.tree.leaves(js), T.state_leaves(ts)):
            if isinstance(b, int):
                assert b == int(a)
            else:
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=ATOL)
        jp = optax.apply_updates(jp, ju)
        tp = T.apply_updates(tp, tu)
        if carry_at == step:     # continue from the reference's state
            ts = T.state_from_optax(jax.tree.map(np.asarray, js))
    for a, b in zip(jax.tree.leaves(jp), tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


UPDATERS = [
    ("Sgd", dict(learning_rate=0.1)),
    ("Nesterovs", dict(learning_rate=0.1, momentum=0.9)),
    ("Adam", dict(learning_rate=1e-2)),
    ("AdamW", dict(learning_rate=1e-2, weight_decay=0.1)),
    ("AdaMax", dict(learning_rate=1e-2)),
    ("Nadam", dict(learning_rate=1e-2)),
    ("AMSGrad", dict(learning_rate=1e-2)),
    ("RmsProp", dict(learning_rate=1e-2)),
    ("AdaGrad", dict(learning_rate=0.1)),
    ("AdaDelta", dict()),
    ("NoOp", dict()),
]


@pytest.mark.parametrize("name,kw", UPDATERS, ids=lambda v: str(v))
def test_updater_matches_its_optax_chain(name, kw):
    j, t = getattr(JU, name)(**kw), getattr(TU, name)(**kw)
    _run_both(j.to_optax(), t.transform())
    assert TU.Updater.from_dict(j.to_dict()) == t
    assert JU.Updater.from_dict(t.to_dict()) == j


@pytest.mark.parametrize("name", ["Nesterovs", "Adam", "AMSGrad"])
def test_reference_state_carries_across(name):
    j, t = getattr(JU, name)(), getattr(TU, name)()
    _run_both(j.to_optax(), t.transform(), steps=3, carry_at=0)


SCHEDULES = [
    ("FixedSchedule", dict(value=0.05)),
    ("MapSchedule", dict(values={0: 0.1, 1: 0.05, 2: 0.01})),
    ("ExponentialSchedule", dict(initial_value=0.1, gamma=0.5)),
    ("InverseSchedule", dict(initial_value=0.1, gamma=0.5, power=2.0)),
    ("PolySchedule", dict(initial_value=0.1, power=2.0, max_iter=4)),
    ("SigmoidSchedule", dict(initial_value=0.1, gamma=0.7, step_size=1)),
    ("StepSchedule", dict(initial_value=0.1, decay_rate=0.5, step=2)),
    ("CosineSchedule", dict(initial_value=0.1, max_iter=4,
                            final_value=0.01)),
    ("WarmupSchedule", dict(warmup_iters=2, then_value=0.1)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=lambda v: str(v))
def test_schedule_matches_reference(name, kw):
    j, t = getattr(JS, name)(**kw), getattr(TS, name)(**kw)
    for it in range(6):
        np.testing.assert_allclose(t.value_at(it), float(j.value_at(it)),
                                   rtol=1e-6)
    # a scheduled updater: the count advances the schedule identically
    _run_both(JU.Sgd(learning_rate=j).to_optax(),
              TU.Sgd(learning_rate=t).transform())
    assert TS.Schedule.from_dict(j.to_dict()) == t


@pytest.mark.parametrize("mode", ["ClipElementWiseAbsoluteValue",
                                  "ClipL2PerLayer", "ClipL2PerParamType",
                                  "RenormalizeL2PerLayer", "ClipL2Global",
                                  None])
def test_gradient_normalization_matches_reference(mode):
    """The whole chain a network builds: normalization, then Nesterovs;
    gradients scaled up so every clip engages."""
    def conf(builder, upd):
        b = builder.builder().updater(upd.Nesterovs(0.1, 0.9))
        if mode:
            b = b.gradient_normalization(mode, 0.5)
        return b.list().build()
    _run_both(j_chain(conf(JNNC, JU)), t_chain(conf(TNNC, TU)),
              grad_scale=3.0)
