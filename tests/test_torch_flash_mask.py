"""The flash kernels' key mask (K1/K2 with a (B, Tk) mask, one byte a key
shared by the heads), on the CPU through their plain versions, against
the JAX package's ``dot_product_attention`` op, which the attention layers
compute: f32 scores scaled by 1/sqrt(d), masked keys at the -1e30
sentinel, softmax, P·v.

- ``flash_attention_reference`` with the mask against the JAX op, and
  ``flash_attention_bwd_reference`` (fed the forward's lse) against
  ``jax.vjp`` of it, wherever every row keeps a key: masks with a
  trailing cut, an interior gap, a first tile (16 keys here) of masked
  keys, and one key kept. Tolerance f32 atol 1e-5 (o) and relative L2
  1e-5 (gradients, of size ~1 here, the norm floored at an rms of 1e-2:
  with one key kept dq is 0 in exact arithmetic and reads the f32
  rounding of dP − D, ~1e-7): the same function, f32 sums in another
  order (PERF.md).
- A batch element whose keys are all masked: the reference averages v
  and sends q and k no gradient; the plain backward's p = exp(s − lse)
  reads 1 there, since lse = −1e30 + log Tk rounds to −1e30 — the reason
  ``ops.standard.dot_product_attention`` hands the kernels such an
  element with every key kept and q zeroed (held in
  ``test_torch_attention_layers.py``).
- ``fa.FlashAttention`` on (B, H, T, d) views and on (B, T, C)
  projections with Tk ≠ Tq, the mask laid out once for both directions;
  ``fa.key_mask_rows``' layout; the CPU wrappers count no launch.

The kernels themselves run on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``'s attention phase).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops.standard import (
    dot_product_attention as j_attention)
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

B, H, TQ, TK, D = 3, 2, 9, 37, 16
ATOL, GRAD_RTOL = 1e-5, 1e-5


def _qkv(seed=0, t_q=TQ, t_k=TK, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, t_q, d), dtype=np.float32),
            rng.standard_normal((B, H, t_k, d), dtype=np.float32),
            rng.standard_normal((B, H, t_k, d), dtype=np.float32))


def _mask(kind, t_k=TK):
    """(B, Tk) bool masks whose every row keeps a key."""
    m = np.ones((B, t_k), bool)
    if kind == "tail":
        m[0, 20:] = False
        m[1, 5:] = False
    elif kind == "gap":
        m[0, 3:30] = False
        m[2, 10:12] = False
    elif kind == "first_tile":        # the first 16-key tile all masked
        m[:, :16] = False
        m[1, 16:30] = False
    elif kind == "one_key":
        m[:] = False
        m[:, -1] = True
        m[1, -1], m[1, 0] = False, True
    return m


def _rel_l2(got, want, rms_floor=1e-2):
    """Relative L2 error, the norm floored at an rms of ``rms_floor``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(
        np.linalg.norm(want), rms_floor * math.sqrt(want.size)))


def _jax_vjp(q, k, v, mask, do):
    jm = jnp.asarray(mask[:, None, None, :])
    o, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, mask=jm),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


MASKS = ["none", "tail", "gap", "first_tile", "one_key"]


@pytest.mark.parametrize("kind", MASKS)
def test_masked_plain_versions_match_the_reference_op(kind):
    q, k, v = _qkv()
    mask = _mask(kind)
    do = np.random.default_rng(1).standard_normal(q.shape, dtype=np.float32)
    jo, jg = _jax_vjp(q, k, v, mask, do)
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    km = None if kind == "none" else torch.tensor(mask)
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_attention_reference(tq, tk, tv, False, scale, km)
    np.testing.assert_allclose(o.numpy(), jo, atol=ATOL)
    grads = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, False,
                                             scale, km)
    for name, got, want in zip("qkv", grads, jg):
        assert _rel_l2(got.numpy(), want) <= GRAD_RTOL, name
    # a masked key takes no gradient
    dk, dv = grads[1].numpy(), grads[2].numpy()
    gone = ~mask[:, None, :, None]
    assert not np.any(np.where(gone, dk, 0)) and not np.any(
        np.where(gone, dv, 0))


def test_bf16_masked_plain_forward_within_the_k1_row():
    """bf16: the plain version rounds P (against the final max) before an
    f32-accumulated P·v, the reference rounds the normalized weights: the
    K1 bf16 row, atol 2e-2."""
    q, k, v = _qkv(2)
    mask = _mask("gap")
    jm = jnp.asarray(mask[:, None, None, :])
    jo = j_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     mask=jm)
    o, _ = fa.flash_attention_reference(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), False,
        1.0 / math.sqrt(D), torch.tensor(mask))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), atol=2e-2)


def test_a_row_that_keeps_no_key_is_not_the_plain_backward_s():
    """Element 1 keeps no key: the reference averages v and sends q and k
    nothing, dv = Σ_q dO / Tk. The plain forward agrees (uniform P), but
    its lse rounds to the sentinel, so the plain backward's P reads 1 and
    its dv is Tk times the reference's."""
    q, k, v = _qkv(3)
    mask = np.ones((B, TK), bool)
    mask[1] = False
    do = np.random.default_rng(4).standard_normal(q.shape, dtype=np.float32)
    jo, (jq, jk, jv) = _jax_vjp(q, k, v, mask, do)
    np.testing.assert_allclose(jo[1], np.broadcast_to(
        v[1].mean(axis=1, keepdims=True), jo[1].shape), atol=ATOL)
    assert not jq[1].any() and not jk[1].any()
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    km = torch.tensor(mask)
    o, lse = fa.flash_attention_reference(tq, tk, tv, False, None, km)
    np.testing.assert_allclose(o.numpy(), jo, atol=ATOL)
    assert float(lse[1].max()) == -1e30 * 1.0 or float(lse[1].max()) < -1e29
    _dq, _dk, dv = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                                    False, None, km)
    np.testing.assert_allclose(dv[1].numpy(), TK * jv[1], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dv[0].numpy(), jv[0], atol=1e-5)


@pytest.mark.parametrize("t_k,ld", [(1, 128), (37, 128), (128, 128),
                                    (129, 256), (1024, 1024)])
def test_key_mask_rows_are_padded_uint8(t_k, ld):
    mask = np.random.default_rng(t_k).random((2, t_k)) < 0.6
    rows = fa.key_mask_rows(torch.tensor(mask), t_k)
    assert rows.dtype == torch.uint8 and rows.shape == (2, ld)
    assert rows.is_contiguous()
    np.testing.assert_array_equal(rows[:, :t_k].numpy(), mask)
    assert not rows[:, t_k:].any()
    # the kernels' own layout passes through as it is
    assert fa.key_mask_rows(rows, t_k) is rows
    # an integer mask counts nonzero as kept
    ints = torch.tensor(mask.astype(np.int64) * 7)
    assert torch.equal(fa.key_mask_rows(ints, t_k), rows)


def test_key_mask_rows_refuse_another_length():
    with pytest.raises(ValueError, match="key mask must be"):
        fa.key_mask_rows(torch.ones((2, 36), dtype=torch.bool), 37)


def test_flash_attention_function_on_4d_views_with_a_key_mask():
    """``FlashAttention.apply(h, False, scale, q, k, v, kmask)`` on
    (B, H, T, d) views of (B, T, H·d) projections: o comes back as the
    (B, H, Tq, d) view of a (B, Tq, H, d) buffer, the gradients of q, k
    and v equal ``jax.vjp`` of the reference op, the mask takes none."""
    q, k, v = _qkv(5)
    mask = _mask("gap")
    do = np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)
    jo, jg = _jax_vjp(q, k, v, mask, do)

    def view(a):      # (B, H, T, d) view of a (B, T, H·d) projection
        t = torch.tensor(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
        return t.reshape(B, a.shape[2], H * D).requires_grad_()

    xs = [view(a) for a in (q, k, v)]
    heads = [x.view(B, x.shape[1], H, D).transpose(1, 2) for x in xs]
    km = torch.tensor(mask)
    o = fa.FlashAttention.apply(H, False, 1.0 / math.sqrt(D), *heads, km)
    assert o.shape == (B, H, TQ, D) and o.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(o.detach().numpy(), jo, atol=ATOL)
    o.backward(torch.tensor(do))
    for x, want in zip(xs, jg):
        got = x.grad.view(B, x.shape[1], H, D).transpose(1, 2).numpy()
        assert _rel_l2(got, want) <= GRAD_RTOL


def test_flash_attention_function_over_projections_of_another_length():
    """Three (B, T, C) projections, keys and values longer than the
    queries (cross attention), no mask: o (B, Tq, C) and its gradients."""
    q, k, v = _qkv(7)
    do = np.random.default_rng(8).standard_normal(q.shape, dtype=np.float32)
    jo, jg = _jax_vjp(q, k, v, np.ones((B, TK), bool), do)

    def proj(a):
        return torch.tensor(np.ascontiguousarray(
            a.transpose(0, 2, 1, 3)).reshape(B, a.shape[2], H * D)
        ).requires_grad_()

    xs = [proj(a) for a in (q, k, v)]
    o = fa.FlashAttention.apply(H, False, 1.0 / math.sqrt(D), *xs)
    assert o.shape == (B, TQ, H * D)
    np.testing.assert_allclose(
        o.detach().view(B, TQ, H, D).transpose(1, 2).numpy(), jo, atol=ATOL)
    o.backward(torch.tensor(np.ascontiguousarray(
        do.transpose(0, 2, 1, 3)).reshape(B, TQ, H * D)))
    for x, want in zip(xs, jg):
        got = x.grad.view(B, x.shape[1], H, D).transpose(1, 2).numpy()
        assert _rel_l2(got, want) <= GRAD_RTOL


def test_masked_cpu_wrappers_count_no_launch():
    before = (fa.launches_wgmma, fa.launches_simple, fa.launches_bwd,
              fa.launches_bwd_wgmma)
    q, k, v = (torch.tensor(a) for a in _qkv(9))
    km = torch.tensor(_mask("tail"))
    o, lse = fa.flash_attention_fwd(q, k, v, kmask=km)
    fa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o), kmask=km)
    assert (fa.launches_wgmma, fa.launches_simple, fa.launches_bwd,
            fa.launches_bwd_wgmma) == before
