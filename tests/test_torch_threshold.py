"""The threshold codec K6 (``deeplearning4j_tpu_torch/kernels/threshold.py``)
against the JAX package's, on the CPU.

- The sparse wire format: ``threshold_encode``, ``threshold_decode``,
  ``sparse_from_dense`` and ``dense_from_sparse`` (the plain versions that
  a CPU tensor takes) against ``deeplearning4j_tpu/kernels/threshold.py``
  at sizes 1, 33 and 4099 (past one 4096-element chunk of K6s-enc) and at
  the edges: no hits, every hit, a capacity below the hits, t = 0, NaN,
  ±inf, −0.0, and malformed buffers (duplicates, indices out of range, a
  count past the capacity or below 0). Exact: the same integers and the
  same f32 values (residuals compared bit for bit).
- The dense form of the compressed exchange (``encode_dense`` and
  ``decode_dense``, K6e and K6d's plain versions) against the reference's
  ``encode_dense`` and ``exchange_bucket`` at one replica: the signs
  exact, the scale, decoded and sent rtol 1e-5 (f32 sums in another
  order), the residual ``acc − sent`` atol 1e-5·scale (the scale's error)
  and Σ residual'² rtol 1e-4.
- No fallback: a tensor that is not on the CPU never takes a plain
  version; a build failure propagates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels import threshold as J
from deeplearning4j_tpu.parallel import compression as JC
from deeplearning4j_tpu_torch.kernels import threshold as K

RTOL = 1e-5


def _values(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 1e-3
    if kind == "specials" and n >= 8:
        x[:8] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 2e-3, -2e-3, 1e-3]
    return x


ENCODE_CASES = [
    # (id, kind, n, threshold, capacity)
    ("n1", "normal", 1, 5e-4, 1),
    ("n33", "normal", 33, 1e-3, 40),
    ("n4099", "normal", 4099, 1e-3, 5000),
    ("no_hits", "normal", 33, 1.0, 40),
    ("every_hit", "normal", 33, 0.0, 40),
    ("capacity_below_hits", "normal", 4099, 5e-4, 100),
    ("capacity_zero", "normal", 33, 5e-4, 0),
    ("t0_specials", "specials", 33, 0.0, 40),
    ("specials", "specials", 33, 1e-3, 40),
    ("inf_threshold", "specials", 33, np.inf, 40),
]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", ENCODE_CASES, ids=lambda c: c[0])
def test_threshold_encode_and_decode_match_reference(case):
    _, kind, n, t, cap = case
    x = _values(kind, n)
    j_enc, j_res = J.threshold_encode(jnp.asarray(x), t, cap)
    t_enc, t_res = K.threshold_encode(torch.as_tensor(x), t, cap)
    np.testing.assert_array_equal(t_enc.numpy(), np.asarray(j_enc))
    np.testing.assert_array_equal(_bits(t_res.numpy()), _bits(j_res))
    j_dec = J.threshold_decode(j_enc, t, (n,))
    t_dec = K.threshold_decode(t_enc, t, (n,))
    np.testing.assert_array_equal(_bits(t_dec.numpy()), _bits(j_dec))


@pytest.mark.parametrize("case", ENCODE_CASES, ids=lambda c: c[0])
def test_sparse_and_dense_masks_convert_as_reference(case):
    _, kind, n, t, cap = case
    x = _values(kind, n)
    signs = np.asarray(JC.encode_dense(jnp.asarray(x), t))
    j_enc = J.sparse_from_dense(jnp.asarray(signs), cap)
    t_enc = K.sparse_from_dense(torch.as_tensor(signs.copy()), cap)
    np.testing.assert_array_equal(t_enc.numpy(), np.asarray(j_enc))
    np.testing.assert_array_equal(
        K.dense_from_sparse(t_enc, n).numpy(),
        np.asarray(J.dense_from_sparse(j_enc, n)))


MALFORMED = [
    # (id, encoded, size): duplicates add, out-of-range indices drop, slot
    # 0's count bounds threshold_decode only
    ("duplicates", [5, 3, 3, -3, 1, 2], 4),
    ("out_of_range", [4, 9, -12, 2, 100000], 8),
    ("count_past_capacity", [50, 1, -2, 3], 4),
    ("negative_count", [-3, 1, 2, 3], 4),
    ("zero_entries", [3, 0, 2, 0], 4),
    ("int32_min", [2, -2 ** 31, 1], 4),
]


@pytest.mark.parametrize("case", MALFORMED, ids=lambda c: c[0])
def test_malformed_buffers_decode_as_reference(case):
    _, enc, size = case
    e = np.asarray(enc, np.int32)
    t = 0.25
    np.testing.assert_array_equal(
        _bits(K.threshold_decode(torch.as_tensor(e), t, (size,)).numpy()),
        _bits(J.threshold_decode(jnp.asarray(e), t, (size,))))
    np.testing.assert_array_equal(
        K.dense_from_sparse(torch.as_tensor(e), size).numpy(),
        np.asarray(J.dense_from_sparse(jnp.asarray(e), size)))


@pytest.mark.parametrize("kind,n,t", [("normal", 1, 5e-4),
                                      ("normal", 33, 1e-3),
                                      ("normal", 4099, 1e-3),
                                      ("specials", 33, 1e-3),
                                      ("specials", 33, 0.0),
                                      ("normal", 33, 1.0)])
def test_dense_encode_and_decode_match_reference(kind, n, t):
    g = _values(kind, n, seed=1)
    res = _values("normal", n, seed=2)
    acc = g + res
    signs, packed = K.encode_dense(torch.as_tensor(g), torch.as_tensor(res),
                                   torch.tensor(t, dtype=torch.float32))
    np.testing.assert_array_equal(
        signs.numpy(), np.asarray(JC.encode_dense(jnp.asarray(acc), t)))
    # one replica: the reference's exchange under vmap over an axis of 1
    dec, sent, fired, frac = jax.vmap(
        lambda a: JC.exchange_bucket(a, jnp.float32(t), "data", 1),
        axis_name="data")(jnp.asarray(acc)[None])
    wire = signs.clone()
    d, r, q = K.decode_dense(torch.as_tensor(g), torch.as_tensor(res), signs,
                             wire, packed, 1)
    np.testing.assert_array_equal(signs.numpy() != 0, np.asarray(fired[0]) > 0)
    assert float(packed[2]) == pytest.approx(float(frac[0]), rel=RTOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(dec[0]), rtol=RTOL)
    scale = packed[0] / torch.clamp_min(packed[1], 1.0)
    np.testing.assert_allclose((signs.float() * scale).numpy(),
                               np.asarray(sent[0]), rtol=RTOL)
    # residual' = acc - sent: its error is the scale's, absolute
    np.testing.assert_allclose(r.numpy(), np.asarray(acc - sent[0]),
                               rtol=0, atol=RTOL * abs(float(scale)))
    want_q = np.sum(np.square(np.asarray(acc - sent[0], np.float64)))
    assert float(q) == pytest.approx(want_q, rel=10 * RTOL, nan_ok=True)


def test_decode_writes_into_the_given_buffers_in_place():
    g = torch.as_tensor(_values("normal", 33, seed=3))
    res = torch.as_tensor(_values("normal", 33, seed=4))
    t = torch.tensor(1e-3)
    signs, packed = K.encode_dense(g, res, t)
    want = K.decode_dense(g, res, signs, signs.clone(), packed, 1)
    g2, res2 = g.clone(), res.clone()
    d, r, q = K.decode_dense(g2, res2, signs, signs.clone(), packed, 1,
                             decoded=g2, new_residual=res2)
    assert d is g2 and r is res2
    np.testing.assert_array_equal(d.numpy(), want[0].numpy())
    np.testing.assert_array_equal(r.numpy(), want[1].numpy())


def test_wire_dtype_follows_the_replica_count():
    from deeplearning4j_tpu_torch.parallel import compression as TC
    assert TC.wire_dtype(1) == TC.wire_dtype(127) == torch.int8
    assert TC.wire_dtype(128) == torch.int16
    assert JC.wire_dtype(127) == jnp.int8 and JC.wire_dtype(128) == jnp.int16


def test_no_plain_fallback_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel path: there it is
    checked (and refused), never handed to the plain version; a build
    failure propagates."""
    g = torch.empty(8, device="meta")
    t = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.encode_dense(g, g, t)
    with pytest.raises(ValueError, match="CUDA"):
        K.decode_dense(g, g, g.to(torch.int8), g.to(torch.int8), g, 1)

    def no_nvcc(*a, **kw):
        raise RuntimeError("nvcc not found")

    from deeplearning4j_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "bind", no_nvcc)
    monkeypatch.setattr(_build, "load", no_nvcc)
    monkeypatch.setattr(K, "_fns", {})
    monkeypatch.setattr(K, "_check_f32", lambda *a: None)
    monkeypatch.setattr(K, "_check_same", lambda *a: None)
    before = K.launches_encode
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.encode_dense(g, g, t)
    e = torch.empty(5, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.threshold_decode(e, 0.1, (4,))
    assert K.launches_encode == before
