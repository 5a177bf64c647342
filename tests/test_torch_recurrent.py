"""The port's recurrent and embedding layers against the JAX package's, on
the CPU at small sizes (N 3, T 7, n_in 5, H 6).

Each layer runs on both sides with the same numpy params, input and
initial carries: the outputs and final carries of ``run``, and the
gradients of a random projection of them with respect to every param, the
input and the initial carries (``jax.vjp`` of the reference's ``run``,
autograd through the port's layer Function). Masks: none, and one mask
whose rows end early (trailing zeros), have an interior gap, and are all
zero. On the CPU the LSTMs' fused cell (K11) runs its plain version.
Tolerances (PERF.md states them): outputs and carries atol 1e-5;
gradients relative L2 ≤ 1e-5 — the same f32 arithmetic, sums in another
order.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import graph_conf as j_gc
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT

N, T, C, H = 3, 7, 5, 6
ATOL, GRAD_RTOL = 1e-5, 1e-5


def _mask():
    """Row 0 ends after 4 steps, row 1 has a gap at steps 2-3, row 2 is all
    zero."""
    m = np.ones((N, T), np.float32)
    m[0, 4:] = 0
    m[1, 2:4] = 0
    m[2, :] = 0
    return m


def _pair(kind, **kw):
    j, t = getattr(JL, kind)(n_in=C, n_out=H, **kw), \
        getattr(TL, kind)(n_in=C, n_out=H, **kw)
    j.apply_global_defaults({})
    t.apply_global_defaults({})
    return j, t


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _inputs(j, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in j.param_shapes().items()}
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    carry0 = tuple(rng.standard_normal((N, H)).astype(np.float32)
                   for _ in j.initial_carry(N))
    return params, x, carry0


def _run_both(j, t, params, x, carry0, mask, seed=1):
    """((outputs, carries, grads) of the reference, the same of the
    port); grads = (params dict, dx, carry0 grads)."""
    m_j = None if mask is None else jnp.asarray(mask)
    (jo, jc), vjp = jax.vjp(
        lambda p, xx, c0: j.run(p, xx, c0, mask=m_j),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        tuple(jnp.asarray(c) for c in carry0))
    rng = np.random.default_rng(seed)
    gy = rng.standard_normal(jo.shape).astype(np.float32)
    gc = tuple(rng.standard_normal(c.shape).astype(np.float32) for c in jc)
    jp, jx, jc0 = vjp((jnp.asarray(gy), tuple(jnp.asarray(g) for g in gc)))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tc0 = tuple(torch.tensor(c, requires_grad=True) for c in carry0)
    to, tc = t.run(tp, tx, tc0,
                   mask=None if mask is None else torch.tensor(mask))
    proj = (to * torch.tensor(gy)).sum() + sum(
        (a * torch.tensor(b)).sum() for a, b in zip(tc, gc))
    proj.backward()
    ref = (np.asarray(jo), [np.asarray(c) for c in jc],
           ({k: np.asarray(v) for k, v in jp.items()}, np.asarray(jx),
            [np.asarray(c) for c in jc0]))
    port = (to.detach().numpy(), [c.detach().numpy() for c in tc],
            ({k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy(),
             [c.grad.numpy() for c in tc0]))
    return ref, port


def _assert_close(ref, port):
    (jo, jc, (jp, jx, jc0)), (to, tc, (tp, tx, tc0)) = ref, port
    np.testing.assert_allclose(to, jo, atol=ATOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a, b, atol=ATOL)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert _rel_l2(tp[k], jp[k]) <= GRAD_RTOL, k
    assert _rel_l2(tx, jx) <= GRAD_RTOL
    for a, b in zip(tc0, jc0):
        assert _rel_l2(a, b) <= GRAD_RTOL


LAYERS = [("LSTM", {}), ("GravesLSTM", {}), ("GRU", {}),
          ("GRU", {"recurrent_bias": True}), ("SimpleRnn", {}),
          ("LSTM", {"activation": "elu"}),
          ("GravesLSTM", {"activation": "softsign"}),
          ("SimpleRnn", {"activation": "relu"})]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind,kw", LAYERS,
                         ids=[f"{k}-{'-'.join(map(str, kw.values())) or 'tanh'}"
                              for k, kw in LAYERS])
def test_layer_run_matches_reference(kind, kw, masked):
    j, t = _pair(kind, **kw)
    params, x, carry0 = _inputs(j)
    ref, port = _run_both(j, t, params, x, carry0,
                          _mask() if masked else None)
    _assert_close(ref, port)
    if masked:
        # the all-zero row keeps its initial carries and outputs zeros
        assert not port[0][2].any()
        for got, c0 in zip(port[1], carry0):
            np.testing.assert_array_equal(got[2], c0[2])


@pytest.mark.parametrize("kind,act,route", [
    ("LSTM", "tanh", "k11"), ("GravesLSTM", "hardtanh", "k11"),
    ("LSTM", "identity", "k11"), ("LSTM", "elu", "step"),
    ("GravesLSTM", "swish", "step")])
def test_cell_route_follows_the_configured_activation(kind, act, route):
    """``route`` is the route past K11L's widest layer; within it an
    activation K11 takes runs the whole layer on K11L ("k11_layer")."""
    from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
    _, t = _pair(kind, activation=act)
    assert t.cell_route() == ("k11_layer" if route == "k11" else route)
    wide = getattr(TL, kind)(n_in=C, n_out=rc.MAX_LAYER_HIDDEN + 1,
                             activation=act)
    assert wide.cell_route() == route


def test_tanh_is_the_recurrent_default():
    for kind in ("LSTM", "GravesLSTM", "GRU", "SimpleRnn"):
        j, t = _pair(kind)
        assert t.activation == j.activation == "tanh"
        j, t = (getattr(m, kind)(n_in=C, n_out=H) for m in (JL, TL))
        j.apply_global_defaults({"activation": "relu"})
        t.apply_global_defaults({"activation": "relu"})
        assert t.activation == j.activation == "relu"
    d, _ = _pair("DenseLayer")
    assert d.activation == "identity"


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_bidirectional_matches_reference(mode, masked):
    j = JL.Bidirectional.wrap(JL.LSTM(n_in=C, n_out=H), mode=mode)
    t = TL.Bidirectional.wrap(TL.LSTM(n_in=C, n_out=H), mode=mode)
    for layer, it in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults({})
        layer.set_n_in(it.recurrent(C, T))
    assert t.param_shapes() == j.param_shapes()
    assert t.output_type(TIT.recurrent(C, T)).to_dict() == \
        j.output_type(JIT.recurrent(C, T)).to_dict()
    rng = np.random.default_rng(2)
    params = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in j.param_shapes().items()}
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    mask = _mask() if masked else None
    m_j = None if mask is None else jnp.asarray(mask)
    jy, vjp = jax.vjp(lambda p, xx: j.apply(p, xx, mask=m_j)[0],
                      {k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x))
    gy = rng.standard_normal(jy.shape).astype(np.float32)
    jp, jx = vjp(jnp.asarray(gy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, _ = t.apply(tp, tx, mask=None if mask is None else torch.tensor(mask))
    (ty * torch.tensor(gy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL)
    for k in jp:
        assert _rel_l2(tp[k].grad.numpy(), jp[k]) <= GRAD_RTOL, k
    assert _rel_l2(tx.grad.numpy(), jx) <= GRAD_RTOL


def test_rnn_output_layer_matches_reference():
    j, t = _pair("RnnOutputLayer", activation="softmax",
                 loss_function="mcxent")
    rng = np.random.default_rng(3)
    params = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in j.param_shapes().items()}
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    labels = np.eye(H, dtype=np.float32)[rng.integers(0, H, (N, T))]
    jpar = {k: jnp.asarray(v) for k, v in params.items()}
    tpar = {k: torch.tensor(v) for k, v in params.items()}
    np.testing.assert_allclose(
        t.apply(tpar, torch.tensor(x))[0].numpy(),
        np.asarray(j.apply(jpar, jnp.asarray(x))[0]), atol=ATOL)
    assert t.output_type(TIT.recurrent(C, T)).to_dict() == \
        j.output_type(JIT.recurrent(C, T)).to_dict()
    for mask in (None, _mask()):
        jl = j.loss(jpar, jnp.asarray(x), jnp.asarray(labels),
                    mask=None if mask is None else jnp.asarray(mask))
        tl = t.loss(tpar, torch.tensor(x), torch.tensor(labels),
                    mask=None if mask is None else torch.tensor(mask))
        assert abs(float(tl) - float(jl)) <= ATOL


def test_last_time_step_layer_matches_reference():
    j = JL.LastTimeStep.wrap(JL.LSTM(n_in=C, n_out=H))
    t = TL.LastTimeStep.wrap(TL.LSTM(n_in=C, n_out=H))
    for layer, it in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults({})
        layer.set_n_in(it.recurrent(C))
    params, x, _ = _inputs(j._inner_layer, seed=4)
    jpar = {k: jnp.asarray(v) for k, v in params.items()}
    tpar = {k: torch.tensor(v) for k, v in params.items()}
    for mask in (None, _mask()):
        jy, _ = j.apply(jpar, jnp.asarray(x),
                        mask=None if mask is None else jnp.asarray(mask))
        ty, _ = t.apply(tpar, torch.tensor(x),
                        mask=None if mask is None else torch.tensor(mask))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert t.to_dict() == j.to_dict()


def test_last_time_step_layer_and_vertex_disagree_on_an_interior_gap():
    """A fault of the JAX package, reproduced as it is (ROADMAP queue 3):
    on the mask [1, 0, 1, 0] the ``LastTimeStep`` layer takes index
    sum(mask) − 1 = 1, a masked step, while ``LastTimeStepVertex`` takes
    the last set index, 2. Each side's two ops give the reference's."""
    x = np.arange(1 * 4 * 2, dtype=np.float32).reshape(1, 4, 2)
    mask = np.array([[1, 0, 1, 0]], np.float32)
    ident = {"@layer": "ActivationLayer", "activation": "identity"}

    def layer_pick(ns, arr, m):
        lts = ns.LastTimeStep(inner=ident)
        lts._materialize()
        lts._inner_layer.apply = (lambda p, xx, *a, mask=None, **k:
                                  (xx, None))
        return lts.apply({}, arr, mask=m)[0]

    j_layer = np.asarray(layer_pick(JL, jnp.asarray(x), jnp.asarray(mask)))
    t_layer = layer_pick(TL, torch.tensor(x), torch.tensor(mask)).numpy()
    j_vertex = np.asarray(j_gc.LastTimeStepVertex().apply(
        [jnp.asarray(x)], mask=jnp.asarray(mask)))
    t_vertex = t_gc.LastTimeStepVertex().apply(
        [torch.tensor(x)], mask=torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(t_layer, j_layer)
    np.testing.assert_array_equal(t_vertex, j_vertex)
    np.testing.assert_array_equal(t_layer, x[:, 1])
    np.testing.assert_array_equal(t_vertex, x[:, 2])
    assert not np.array_equal(t_layer, t_vertex)


@pytest.mark.parametrize("kind,kw", [
    ("LSTM", {"forget_gate_bias_init": 0.5}), ("GravesLSTM", {}),
    ("GRU", {"recurrent_bias": True}), ("SimpleRnn", {"dropout": 0.8}),
    ("EmbeddingSequenceLayer", {"input_length": T, "has_bias": True})])
def test_layer_dict_round_trip(kind, kw):
    j, t = _pair(kind, **kw)
    assert t.to_dict() == j.to_dict()
    back = TL.layer_from_dict(j.to_dict())
    assert type(back) is type(t) and back.to_dict() == t.to_dict()
    assert back.param_shapes() == j.param_shapes()
    assert JL.layer_from_dict(t.to_dict()).to_dict() == j.to_dict()


@pytest.mark.parametrize("wrapper", ["Bidirectional", "LastTimeStep"])
def test_wrapper_dict_round_trip(wrapper):
    kw = {"mode": "mul"} if wrapper == "Bidirectional" else {}
    j = getattr(JL, wrapper).wrap(JL.GravesLSTM(n_out=H), **kw)
    t = getattr(TL, wrapper).wrap(TL.GravesLSTM(n_out=H), **kw)
    for layer, it in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults({})
        layer.set_n_in(it.recurrent(C))
    assert t.to_dict() == j.to_dict()
    back = TL.layer_from_dict(j.to_dict())
    back.apply_global_defaults({})
    assert back.to_dict() == t.to_dict()
    assert back.param_shapes() == t.param_shapes() == j.param_shapes()


def test_lstm_init_sets_the_forget_gate_bias():
    _, t = _pair("LSTM", forget_gate_bias_init=2.0)
    t.weight_init = "xavier"
    b = t.init_params(torch.Generator().manual_seed(0))["b"]
    np.testing.assert_array_equal(b[H:2 * H].numpy(), np.full(H, 2.0))
    assert not b[:H].any() and not b[2 * H:].any()
    _, g = _pair("GravesLSTM")
    g.weight_init = "xavier"
    p = g.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == g.param_shapes()


@pytest.mark.parametrize("kind,shape", [
    ("EmbeddingLayer", (N,)), ("EmbeddingLayer", (N, 1)),
    ("EmbeddingSequenceLayer", (N, T))])
@pytest.mark.parametrize("bias", [False, True])
def test_embedding_layers_match_reference(kind, shape, bias):
    vocab = 9
    j, t = (getattr(m, kind)(n_in=vocab, n_out=H, has_bias=bias,
                             activation="tanh") for m in (JL, TL))
    j.apply_global_defaults({})
    t.apply_global_defaults({})
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in j.param_shapes().items()}
    idx = rng.integers(0, vocab, shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda p: j.apply(p, jnp.asarray(idx))[0],
                      {k: jnp.asarray(v) for k, v in params.items()})
    gy = rng.standard_normal(jy.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(gy))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    ty, _ = t.apply(tp, torch.tensor(idx))
    (ty * torch.tensor(gy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL)
    for k in jg:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=ATOL)
    it = JIT.recurrent(1, T)
    assert t.output_type(TIT.recurrent(1, T)).to_dict() == \
        j.output_type(it).to_dict()
