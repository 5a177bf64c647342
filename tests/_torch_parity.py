"""Shared harness of the layer parity tests (``test_torch_layers_rest``,
``test_torch_layers2``, ``test_torch_objdetect``,
``test_torch_variational``, ``test_torch_weightnoise``): one layer
config built on both sides, the same numpy params and input, and each
package's output and its gradients with respect to every param and the
input (``jax.vjp`` of the reference, autograd through the port) against a
seeded random cotangent.

Tolerances (PERF.md's tolerance table states them): f32 outputs relative
L2 1e-5 and gradients 1e-5, the norms floored at an rms of 1e-2 (the same
arithmetic, f32 sums in another order); f64 1e-12 and 1e-10; bf16 2e-2 and
5e-2 (both sides take bf16 operands and round every product and sum to
bf16 at their own points).
"""
import math

import numpy as np

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import objdetect as _j_objdetect  # noqa: F401
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT

TOL = {"float32": (1e-5, 1e-5), "float64": (1e-12, 1e-10),
       "bfloat16": (2e-2, 5e-2)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float64": jnp.float64}


def x64(dtype):
    return jax.enable_x64(dtype == "float64")


def pair(kind, it=None, defaults=None, **kw):
    """The same layer config on both sides, defaults and n_in applied
    (``it``: a JAX-side InputType, mirrored for the port)."""
    j, t = JL._LAYER_TYPES[kind](**kw), TL._LAYER_TYPES[kind](**kw)
    for layer, typ in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults(defaults or {})
        if it is not None:
            layer.set_n_in(typ(**it.__dict__))
    return j, t


def params_of(layer, seed=0, scale=None):
    """Seeded f64 numpy params: weights N(0, 1/fan-in), 1-D params
    N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in layer.param_shapes().items():
        sd = scale if scale is not None else (
            0.3 if len(s) == 1 else 1 / math.sqrt(math.prod(s[:-1])))
        out[k] = rng.standard_normal(s) * sd
    return out


def rel_l2(got, want, rms_floor=1e-2):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(
        np.linalg.norm(want), rms_floor * math.sqrt(max(want.size, 1))))


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, np.float64), JAX_DT[dtype])


def _t(a, dtype, grad=False):
    t = torch.tensor(np.asarray(a, np.float64)).to(getattr(torch, dtype))
    return t.requires_grad_(grad)


def run_both(j, t, params, x, dtype="float32", mask=None, grads=True,
             seed=9):
    """((output, {param: grad}, input grad) of the reference, the same of
    the port), every array f64 numpy; the input grad None for an integer
    input or ``grads=False`` (then no param grads either)."""
    f64 = jnp.float64
    kw_j = {} if mask is None else {"mask": jnp.asarray(mask)}
    kw_t = {} if mask is None else {"mask": torch.tensor(mask)}
    with x64(dtype):
        jp = {k: _jnp(v, dtype) for k, v in params.items()}
        jx = _jnp(x, dtype)
        if not grads:
            jo = j.apply(jp, jx, **kw_j)[0]
            ref = (np.asarray(jo.astype(f64)), {}, None)
        else:
            jo, vjp = jax.vjp(lambda p, xx: j.apply(p, xx, **kw_j)[0], jp, jx)
            gy = np.random.default_rng(seed).standard_normal(jo.shape)
            gp, gx = vjp(_jnp(gy, dtype))
            ref = (np.asarray(jo.astype(f64)),
                   {k: np.asarray(g.astype(f64)) for k, g in gp.items()},
                   np.asarray(gx.astype(f64)))
    tp = {k: _t(v, dtype, grads) for k, v in params.items()}
    tx = _t(x, dtype, grads)
    to, _ = t.apply(tp, tx, **kw_t)
    if not grads:
        return ref, (to.detach().double().numpy(), {}, None)
    gyt = _t(gy, dtype)
    leaves = list(tp.values()) + [tx]
    # an output cut off from every leaf (a FrozenLayer) has zero gradients
    g = (torch.autograd.grad(to, leaves, gyt, allow_unused=True)
         if to.requires_grad else [None] * len(leaves))
    g = [torch.zeros_like(a) if b is None else b for a, b in zip(leaves, g)]
    port = (to.detach().double().numpy(),
            {k: gi.double().numpy() for k, gi in zip(tp, g)},
            g[-1].double().numpy())
    return ref, port


def assert_close(ref, port, dtype="float32", out_tol=None, grad_tol=None):
    (jo, jp, jx), (to, tp, tx) = ref, port
    out_tol = TOL[dtype][0] if out_tol is None else out_tol
    grad_tol = TOL[dtype][1] if grad_tol is None else grad_tol
    assert to.shape == jo.shape, (to.shape, jo.shape)
    assert rel_l2(to, jo) <= out_tol, ("output", rel_l2(to, jo))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert rel_l2(tp[k], jp[k]) <= grad_tol, (k, rel_l2(tp[k], jp[k]))
    if jx is not None:
        assert rel_l2(tx, jx) <= grad_tol, ("input", rel_l2(tx, jx))


def check_layer(kind, it, x, dtype="float32", mask=None, seed=0,
                defaults=None, type_is_shape=True, **kw):
    """Build, run and hold one layer config to the reference; returns the
    pair (for further checks). The output types must agree, and with
    ``type_is_shape`` also give the output's shape (``False`` where the
    reference's own output type misstates it)."""
    j, t = pair(kind, it, defaults=defaults, **kw)
    assert list(t.param_shapes().items()) == list(j.param_shapes().items())
    ref, port = run_both(j, t, params_of(j, seed), x, dtype, mask)
    assert_close(ref, port, dtype)
    if it is not None:
        jt, tt = j.output_type(it), t.output_type(TIT(**it.__dict__))
        assert tt.to_dict() == jt.to_dict()
        same = tuple(port[0].shape[1:]) == tuple(jt.batch_shape()[1:])
        assert same == type_is_shape, (port[0].shape, jt)
    return j, t


def check_round_trip(j, t):
    """The config dicts equal, and each package revives the other's."""
    assert t.to_dict() == j.to_dict()
    back = TL.layer_from_dict(j.to_dict())
    assert type(back).__name__ == type(j).__name__
    assert back.to_dict() == t.to_dict()
    assert JL.layer_from_dict(t.to_dict()).to_dict() == j.to_dict()
