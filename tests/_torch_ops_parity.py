"""Shared harness of the op-module parity sweeps (``test_torch_ops_*``):
one case runs a registry op by name in both packages on the same seeded
numpy inputs and attributes, and holds each output's shape, dtype and
values against the reference's.

Tolerances (PERF.md's tolerance table states them): f32 elementwise
atol = rtol = 1e-6 (``EW``); reductions, products, convolutions and the
ops built on them 1e-5 (``RED``); iterative special functions and
decompositions whose f32 algorithms differ between the libraries
(betainc, polygamma, zeta, pinv, sqrtm, matrix powers) 1e-4 (``SPECIAL``);
integers, bools and indices exactly.
"""
import zlib

import numpy as np

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import registry as JR
import deeplearning4j_tpu.ops  # noqa: F401 (fills the reference registry)
from deeplearning4j_tpu_torch.ops import dtypes as TD
from deeplearning4j_tpu_torch.ops import registry as TR
import deeplearning4j_tpu_torch.ops  # noqa: F401 (fills the port's)

EW = dict(atol=1e-6, rtol=1e-6)
RED = dict(atol=1e-5, rtol=1e-5)
SPECIAL = dict(atol=1e-4, rtol=1e-4)


def u(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def n(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def ids(rng, hi, *shape, dtype=np.int32):
    return rng.integers(0, hi, shape).astype(dtype)


def spd(rng, k):
    a = n(rng, k, k)
    return (a @ a.T + k * np.eye(k)).astype(np.float32)


def rng_of(cid):
    return np.random.default_rng(zlib.crc32(cid.encode()))


def _to_jax(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(v) for v in x)
    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    return x


def _to_torch(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, np.ndarray):
        return TD.as_tensor(x)
    return x


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().resolve_conj().resolve_neg()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        return TD.name_of(x.dtype)
    return np.asarray(x).dtype.name


def run_both(name, inputs, attrs):
    """Each package's outputs (flattened leaves) of one op call."""
    j = JR.exec_op(name, *_to_jax(list(inputs)), **attrs)
    t = TR.exec_op(name, *_to_torch(list(inputs)), **attrs)
    return _leaves(j), _leaves(t)


def assert_same(cid, j_out, t_out, tol):
    assert len(j_out) == len(t_out), (cid, len(j_out), len(t_out))
    for a, b in zip(j_out, t_out):
        if isinstance(a, (int, float, bool)) and not isinstance(
                b, torch.Tensor):
            assert a == b, (cid, a, b)
            continue
        an, bn = _np(a), _np(b)
        assert an.shape == bn.shape, (cid, an.shape, bn.shape)
        assert _dtype_name(a) == _dtype_name(b), (cid, _dtype_name(a),
                                                  _dtype_name(b))
        if an.dtype == object:
            assert an.tolist() == bn.tolist(), cid
        elif np.issubdtype(an.dtype, np.inexact):
            np.testing.assert_allclose(bn, an, equal_nan=True, err_msg=cid,
                                       **tol)
        else:
            np.testing.assert_array_equal(bn, an, err_msg=cid)


def check_case(case):
    cid, name, make, attrs, tol = case
    inputs = make(rng_of(cid))
    j_out, t_out = run_both(name, inputs, attrs)
    assert_same(cid, j_out, t_out, tol)


def case_ids(cases):
    return [c[0] for c in cases]


def swept(cases):
    """The canonical op names a case list reaches."""
    return {TR.get(c[1]).name for c in cases}
