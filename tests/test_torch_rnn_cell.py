"""K11's plain versions and the LSTM layer Function, on the CPU.

- The plain cell forward (``cell_fwd_reference``) against the reference's
  ``LSTM.step`` / ``GravesLSTM.step`` and the mask's ``where`` of its
  ``run``, one step, for every activation K11 takes; the plain cell
  backward (``cell_bwd_reference``) against autograd through the plain
  forward (dz, dc_prev, the passed-on dh, the peephole terms).
- ``LSTMLayer`` (the plain cell on the CPU) against ``jax.vjp`` of the
  reference ``run``, with and without peepholes and mask, for every K11
  activation: outputs, carries, and the gradients of every input.
- The bf16 promotion rule against the reference's bf16 layer run op by
  op (``jax.disable_jit``, as the networks' bf16 rows): only a bf16 input's X·W
  is a bf16 product (rounded before it is added); the recurrent product,
  z, c, h, the output and the carries are f32; a layer fed f32 with bf16
  params computes in f32. (The reference's compiled scan does not round
  that product: XLA folds the bf16 → f32 convert into the dot. It reads
  1.4e-3 from its own op-by-op run here.)

Tolerances (PERF.md states them): f32 atol 1e-5, gradients relative L2
≤ 1e-5 (the same arithmetic, sums in another order); bf16 as stated at
its test.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
from deeplearning4j_tpu_torch.nn.conf import layers as TL

N, T, C, H = 3, 7, 5, 6
ATOL, GRAD_RTOL = 1e-5, 1e-5
ACTS = ["tanh", "identity", "relu", "sigmoid", "hardtanh", "softsign"]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _mask():
    m = np.ones((N, T), np.float32)
    m[0, 4:] = 0
    m[1, 2:4] = 0
    m[2, :] = 0
    return m


def _layer(ns, peep, act):
    layer = (ns.GravesLSTM if peep else ns.LSTM)(n_in=C, n_out=H,
                                                 activation=act)
    layer.apply_global_defaults({})
    return layer


def _params(layer, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.7).astype(np.float32)
            for k, s in layer.param_shapes().items()}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_cell_is_the_reference_step(act, peep, masked):
    j = _layer(JL, peep, act)
    p = _params(j, 0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, C)).astype(np.float32)
    h0, c0 = (rng.standard_normal((N, H)).astype(np.float32)
              for _ in range(2))
    m = np.array([1.0, 0.0, 0.5], np.float32) if masked else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (jh, jc), jy = j.step(jp, (jnp.asarray(h0), jnp.asarray(c0)),
                          jnp.asarray(x))
    if masked:
        # the reference run's mask: carries where(m), output h·m
        mm = jnp.asarray(m)[:, None]
        jh, jc = jnp.where(mm, jh, h0), jnp.where(mm, jc, c0)
        jy = jy * mm
    z = torch.tensor(x) @ torch.tensor(p["W"]) + \
        torch.tensor(h0) @ torch.tensor(p["RW"])
    peep_t = (torch.stack([torch.tensor(p[k]) for k in ("pI", "pF", "pO")])
              if peep else None)
    y, h, c, gates = rc.cell_fwd_reference(
        z, torch.tensor(p["b"]), torch.tensor(c0), torch.tensor(h0), peep_t,
        None if m is None else torch.tensor(m), rc.ACTIVATIONS[act])
    for got, want in ((y, jy), (h, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert gates.shape == (N, 4 * H)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_cell_backward_is_autograd_of_the_forward(act, peep, masked):
    g = torch.Generator().manual_seed(2)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    z, c0, h0 = rnd(N, 4 * H), rnd(N, H), rnd(N, H)
    b = rnd(4 * H)
    peep_t = rnd(3, H) if peep else None
    m = torch.tensor([1.0, 0.0, 0.5], dtype=torch.float64) if masked \
        else None
    code = rc.ACTIVATIONS[act]
    leaves = [z, c0, h0] + ([peep_t] if peep else [])
    for t in leaves:
        t.requires_grad_(True)
    y, h, c, gates = rc.cell_fwd_reference(z, b, c0, h0, peep_t, m, code)
    dy, dh, dc = rnd(N, H), rnd(N, H), rnd(N, H)
    want = [torch.zeros_like(t) if w is None else w for t, w in zip(
        leaves, torch.autograd.grad((y, h, c), leaves, (dy, dh, dc),
                                    allow_unused=True))]
    dz, dcp, dh_pass, dpeep = rc.cell_bwd_reference(
        dy, dh, dc, gates.detach(), c.detach(), c0.detach(),
        None if peep_t is None else peep_t.detach(), m, code)
    torch.testing.assert_close(dz, want[0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(dcp, want[1], rtol=1e-10, atol=1e-10)
    # dh_prev = dh_pass + dz·RWᵀ; here z is given, so only dh_pass, which
    # is 0 with no mask and then not made
    if masked:
        torch.testing.assert_close(dh_pass, want[2], rtol=1e-10, atol=1e-10)
    else:
        assert dh_pass is None and not want[2].any()
    if peep:
        torch.testing.assert_close(dpeep.sum(1), want[3], rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("act", ACTS)
def test_layer_function_matches_reference_vjp(act, peep, masked):
    j, t = _layer(JL, peep, act), _layer(TL, peep, act)
    assert t.cell_route() == "k11_layer"
    p = _params(j, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    c0 = tuple(rng.standard_normal((N, H)).astype(np.float32)
               for _ in range(2))
    mask = _mask() if masked else None
    m_j = None if mask is None else jnp.asarray(mask)
    (jo, jc), vjp = jax.vjp(
        lambda pp, xx, cc: j.run(pp, xx, cc, mask=m_j),
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        tuple(map(jnp.asarray, c0)))
    gy = rng.standard_normal(jo.shape).astype(np.float32)
    gc = tuple(rng.standard_normal((N, H)).astype(np.float32)
               for _ in range(2))
    jp, jx, jc0 = vjp((jnp.asarray(gy), tuple(map(jnp.asarray, gc))))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    tc0 = tuple(torch.tensor(c, requires_grad=True) for c in c0)
    before = rc.launches_cell_fwd, rc.launches_cell_bwd
    to, tc = t.run(tp, tx, tc0,
                   mask=None if mask is None else torch.tensor(mask))
    ((to * torch.tensor(gy)).sum()
     + sum((a * torch.tensor(b)).sum() for a, b in zip(tc, gc))).backward()
    # the CPU takes the plain versions: no launch counted
    assert (rc.launches_cell_fwd, rc.launches_cell_bwd) == before
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL)
    for k in jp:
        assert _rel_l2(tp[k].grad.numpy(), jp[k]) <= GRAD_RTOL, k
    assert _rel_l2(tx.grad.numpy(), jx) <= GRAD_RTOL
    for a, b in zip(tc0, jc0):
        assert _rel_l2(a.grad.numpy(), b) <= GRAD_RTOL


def test_layer_function_is_one_autograd_node():
    t = _layer(TL, True, "tanh")
    p = {k: torch.zeros(s, requires_grad=True)
         for k, s in t.param_shapes().items()}
    y, (h, c) = t.run(p, torch.zeros(N, T, C),
                      t.initial_carry(N))
    assert type(y.grad_fn).__name__ == "LSTMLayerBackward" \
        or y.grad_fn.next_functions[0][0].__class__.__name__ \
        == "LSTMLayerBackward"
    assert y.dtype == h.dtype == c.dtype == torch.float32


#: bf16 against the reference's bf16 layer op by op: both round the first
#: layer's x·W to bf16, but may round an entry to the neighbouring bf16
#: value (2^-8 relative) where the two products sum in another order; the
#: rounding then moves through tanh and the gates: atol 1e-2 on outputs
#: of |h| < 1 (the readings are ~2e-7: no rounding differed here). A layer
#: fed f32 with bf16 params takes exact bf16 → f32 casts: the f32 rows.
TOL_BF16 = 1e-2


@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
def test_bf16_promotion_rule_matches_reference(peep):
    j, t = _layer(JL, peep, "tanh"), _layer(TL, peep, "tanh")
    p = _params(j, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16).requires_grad_()
          for k, v in p.items()}
    zero = np.zeros((N, H), np.float32)
    for x_dtype in ("bfloat16", "float32"):
        xj = jnp.asarray(x).astype(x_dtype)
        xt = torch.tensor(x).to(getattr(torch, x_dtype))
        with jax.disable_jit():
            (jo, jc), vjp = jax.vjp(lambda pp: j.run(pp, xj, (zero, zero)),
                                    jp)
        to, tc = t.run(tp, xt, (torch.zeros(N, H), torch.zeros(N, H)))
        assert jo.dtype == jnp.float32 and to.dtype == torch.float32
        assert all(c.dtype == torch.float32 for c in tc)
        tol = TOL_BF16 if x_dtype == "bfloat16" else ATOL
        for step in range(T):
            np.testing.assert_allclose(to[:, step].detach().numpy(),
                                       np.asarray(jo[:, step]), atol=tol,
                                       err_msg=f"{x_dtype} step {step}")
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=tol)
        gy = rng.standard_normal(jo.shape).astype(np.float32)
        with jax.disable_jit():
            (jg,) = vjp((jnp.asarray(gy), (zero, zero)))
        grads = torch.autograd.grad((to * torch.tensor(gy)).sum(),
                                    list(tp.values()))
        for (k, g) in zip(tp, grads):
            assert g.dtype == torch.bfloat16 and jg[k].dtype == jnp.bfloat16
            # bf16 gradients: each side rounds its dW once (the port) or
            # at every step of the scan (the reference): 5e-2 relative L2,
            # the networks' bf16 gradient row
            assert _rel_l2(g.float().numpy(),
                           np.asarray(jg[k], np.float32)) <= 5e-2, k


def test_bf16_input_product_rounds_to_bf16():
    """From below: a port that took the bf16 layer's x·W in f32 (no
    rounding to bf16) would read further from the reference (op by op)
    than the port does."""
    j, t = _layer(JL, False, "tanh"), _layer(TL, False, "tanh")
    p = _params(j, 7)
    x = np.random.default_rng(8).standard_normal((N, T, C)).astype(
        np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    zero = np.zeros((N, H), np.float32)
    with jax.disable_jit():
        jo, _ = j.run(jp, jnp.asarray(x).astype(jnp.bfloat16), (zero, zero))
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in p.items()}
    xb = torch.tensor(x).to(torch.bfloat16)
    good, _ = t.run(tp, xb, (torch.zeros(N, H), torch.zeros(N, H)))
    unrounded, _ = t.run({k: v.float() for k, v in tp.items()}, xb.float(),
                         (torch.zeros(N, H), torch.zeros(N, H)))
    err_good = np.abs(good.numpy() - np.asarray(jo)).max()
    err_f32 = np.abs(unrounded.numpy() - np.asarray(jo)).max()
    assert err_good < err_f32, (err_good, err_f32)


def test_wrappers_take_the_plain_version_on_the_cpu():
    g = torch.Generator().manual_seed(9)
    z, c0, h0 = (torch.randn(*s, generator=g)
                 for s in ((N, 4 * H), (N, H), (N, H)))
    before = rc.launches_cell_fwd, rc.launches_cell_bwd
    got = rc.lstm_cell_fwd(z, None, c0, h0, None, None, 0)
    want = rc.cell_fwd_reference(z, None, c0, h0, None, None, 0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    dz, dcp, dh_pass = rc.lstm_cell_bwd(None, c0, h0, got[3], got[2], c0,
                                        None, None, 0)
    ref = rc.cell_bwd_reference(None, c0, h0, got[3], got[2], c0, None,
                                None, 0)
    assert dh_pass is None and ref[2] is None
    for a, b in zip((dz, dcp), ref):
        torch.testing.assert_close(a, b)
    assert (rc.launches_cell_fwd, rc.launches_cell_bwd) == before
    assert rc.act_code("TanH") == 0 and rc.act_code("elu") is None
