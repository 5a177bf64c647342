"""The port's attention layers, attention vertices and the
``dot_product_attention`` op against the JAX package's, on the CPU at
small sizes (N 3, T 7, width 16, 2 heads of 8).

Every case runs both sides on the same numpy inputs and params (carried
with ``set_param_tree`` into the nets): the outputs, and the gradients of
a random projection of them with respect to every param and input
(``jax.vjp`` of the reference, autograd through the port). Masks: none, a
trailing cut, an interior gap, and one batch element with every key
masked (the reference averages v there and sends q and k nothing). The
op runs on the flash kernels' route (``fa.FlashAttention``, here through
their plain versions) in f32 and bf16, and on its plain version in f64
(the gradcheck harness's type) and wherever ``attention_route``'s rule
sends it. Tolerances (PERF.md states them): f32 outputs atol 1e-5 and
gradients relative L2 1e-5 (the norm floored at an rms of 1e-2): the
same function, f32 sums in another order; f64 1e-12 / 1e-10; bf16
outputs and gradients relative L2 2e-2 and 5e-2: both sides round q, k, v,
P and o to bf16, the reference P normalized, the kernels' plain version
P against the row max before the f32 division (the K1 bf16 row).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import graph_conf as j_gc
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.ops.standard import (
    dot_product_attention as j_attention)
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn._network import layer_flops
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.ops import standard as ops
from deeplearning4j_tpu_torch.optim import transforms as T
from deeplearning4j_tpu_torch.optim import updaters as t_upd

N, T_LEN, C, HEADS = 3, 7, 16, 2
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2),
       "float64": (1e-12, 1e-10)}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float64": jnp.float64}
MASKS = ["none", "tail", "gap", "empty_row"]


def _mask(kind, n=N, t=T_LEN):
    """(N, T) float masks: row 0 cut after 4 steps, row 1 with a gap at
    steps 2-4; "empty_row": row 2 all zero as well."""
    if kind == "none":
        return None
    m = np.ones((n, t), np.float32)
    if kind in ("tail", "empty_row"):
        m[0, 4:] = 0
    if kind in ("gap", "empty_row"):
        m[1, 2:5] = 0
    if kind == "empty_row":
        m[2] = 0
    return m


def _rel_l2(got, want, rms_floor=1e-2):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(
        np.linalg.norm(want), rms_floor * math.sqrt(max(want.size, 1))))


def _close(got, want, dtype, what):
    out_tol, grad_tol = TOL[dtype]
    if dtype == "bfloat16":
        assert _rel_l2(got, want) <= out_tol, what
    else:
        np.testing.assert_allclose(got, want, atol=out_tol, err_msg=what)


def _x64(dtype):
    """jax's f64 for an f64 case (a context: other files keep f32)."""
    return jax.enable_x64(dtype == "float64")


def _jnp(a, dtype):
    return jnp.asarray(a).astype(JAX_DT[dtype])


def _t(a, dtype, grad=False):
    t = torch.tensor(np.asarray(a, np.float64)).to(getattr(torch, dtype))
    return t.requires_grad_(grad)


# ----------------------------------------------------------------- the op
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_op_matches_the_reference(dtype, kind):
    """(N, H, Tq 5, d 8) queries over Tk 7 keys: o and the gradients of
    q, k and v; a fully masked element averages v with zero dq and dk."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((N, HEADS, 5, 8))
    k, v = (rng.standard_normal((N, HEADS, T_LEN, 8)) for _ in range(2))
    do = rng.standard_normal(q.shape)
    m = _mask(kind)
    with _x64(dtype):
        jm = None if m is None else jnp.asarray(m[:, None, None, :] != 0)
        jo, vjp = jax.vjp(lambda a, b, c: j_attention(a, b, c, mask=jm),
                          *(_jnp(a, dtype) for a in (q, k, v)))
        jg = [np.asarray(g.astype(jnp.float64 if dtype == "float64"
                                  else jnp.float32))
              for g in vjp(_jnp(do, dtype))]
        jo = np.asarray(jo.astype(jnp.float64 if dtype == "float64"
                                  else jnp.float32))
    tq, tk, tv = (_t(a, dtype, True) for a in (q, k, v))
    tm = None if m is None else torch.tensor(m != 0)[:, None, None, :]
    assert ops.attention_route(tq, tk, tv, tm) == (
        "plain" if dtype == "float64" else "kernel")
    o = ops.dot_product_attention(tq, tk, tv, mask=tm)
    assert o.dtype == tq.dtype and o.shape == tq.shape
    o.backward(_t(do, dtype))
    _close(o.detach().double().numpy(), jo, dtype, "o")
    grad_tol = TOL[dtype][1]
    for name, x, want in zip("qkv", (tq, tk, tv), jg):
        assert _rel_l2(x.grad.double().numpy(), want) <= grad_tol, name
    if kind == "empty_row":
        np.testing.assert_allclose(
            o[2].detach().double().numpy(),
            np.broadcast_to(tv[2].detach().double().mean(dim=1, keepdim=True)
                            .numpy(), (HEADS, 5, 8)),
            atol=TOL[dtype][0] if dtype != "bfloat16" else 2e-2)
        assert not tq.grad[2].any() and not tk.grad[2].any()


@pytest.mark.parametrize("case,route", [
    ("f32", "kernel"), ("bf16", "kernel"), ("f64", "plain"),
    ("head_dim_12", "plain"), ("head_dim_264", "plain"),
    ("mixed_dtypes", "plain"), ("query_mask", "plain"),
    ("broadcast_batch", "plain"), ("batch_1_key_mask", "kernel"),
    ("3d", "plain")])
def test_op_routes_by_its_stated_rule(case, route):
    q = torch.zeros((2, 2, 4, 8))
    k = v = torch.zeros((2, 2, 6, 8))
    mask = None
    if case == "bf16":
        q, k, v = (a.bfloat16() for a in (q, k, v))
    elif case == "f64":
        q, k, v = (a.double() for a in (q, k, v))
    elif case.startswith("head_dim"):
        d = int(case.rsplit("_", 1)[1])
        q, k = torch.zeros((2, 2, 4, d)), torch.zeros((2, 2, 6, d))
        v = k
    elif case == "mixed_dtypes":
        v = v.bfloat16()
    elif case == "query_mask":
        mask = torch.ones((2, 1, 4, 6), dtype=torch.bool)
    elif case == "broadcast_batch":
        k = v = torch.zeros((1, 2, 6, 8))
    elif case == "batch_1_key_mask":
        mask = torch.ones((1, 1, 1, 6), dtype=torch.bool)
    elif case == "3d":
        q, k, v = q[0], k[0], v[0]
    assert ops.attention_route(q, k, v, mask) == route


def test_the_plain_route_counts_only_on_the_card():
    """On the CPU the op's plain route, like every plain version, counts
    nothing (the count is of calls on the card)."""
    before = fa.plain_route_calls
    x = torch.ones((1, 1, 3, 12))
    ops.dot_product_attention(x, x, x)
    assert fa.plain_route_calls == before


# --------------------------------------------------------------- the layers
def _pair(kind, dtype="float32", **kw):
    j, t = getattr(JL, kind)(**kw), getattr(TL, kind)(**kw)
    for layer, it in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults({})
        if kind == "CrossAttentionLayer":
            types = [it.recurrent(C, T_LEN), it.recurrent(12, 9)]
            if kw.get("key_in"):
                types.append(it.recurrent(kw["key_in"], 9))
            layer.set_n_in_multi(types)
        else:
            layer.set_n_in(it.recurrent(C, T_LEN))
    return j, t


def _params(layer, seed=0):
    """Weights N(0, 1/fan_in) (outputs stay O(1)), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s) * (0.3 if len(s) == 1
                                         else 1 / math.sqrt(s[0]))
            for k, s in layer.param_shapes().items()}


def _layer_inputs(kind, key_in=None, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, T_LEN, C))
    if kind != "CrossAttentionLayer":
        return x
    xs = [x, rng.standard_normal((N, 9, 12))]
    if key_in:
        xs.append(rng.standard_normal((N, 9, key_in)))
    return xs


def _run_both(j, t, params, x, mask, dtype):
    """((output, param grads, input grads) of the reference, the same of
    the port), all f64 numpy."""
    multi = isinstance(x, list)
    f64 = jnp.float64 if dtype == "float64" else jnp.float32
    with _x64(dtype):
        jp = {k: _jnp(v, dtype) for k, v in params.items()}
        jx = [_jnp(a, dtype) for a in x] if multi else _jnp(x, dtype)
        jm = None if mask is None else jnp.asarray(mask)
        jo, vjp = jax.vjp(lambda p, xx: j.apply(p, xx, mask=jm)[0], jp, jx)
        gy = np.random.default_rng(9).standard_normal(jo.shape)
        gp, gx = vjp(_jnp(gy, dtype))
        ref = (np.asarray(jo.astype(f64)),
               {k: np.asarray(g.astype(f64)) for k, g in gp.items()},
               [np.asarray(g.astype(f64)) for g in (gx if multi else [gx])])
    tp = {k: _t(v, dtype, True) for k, v in params.items()}
    tx = [_t(a, dtype, True) for a in (x if multi else [x])]
    tm = None if mask is None else torch.tensor(mask)
    to, _ = t.apply(tp, tx if multi else tx[0], mask=tm)
    to.backward(_t(gy, dtype))
    port = (to.detach().double().numpy(),
            {k: v.grad.double().numpy() for k, v in tp.items()},
            [a.grad.double().numpy() for a in tx])
    return ref, port


def _assert_layer_close(ref, port, dtype):
    (jo, jp, jx), (to, tp, tx) = ref, port
    assert to.shape == jo.shape
    _close(to, jo, dtype, "output")
    assert sorted(tp) == sorted(jp)      # a jax dict's leaves are sorted
    grad_tol = TOL[dtype][1]
    for k in jp:
        if k == "bk":
            # softmax is shift-invariant along the keys, and q·bk shifts
            # every key of a query alike: bk's gradient is 0 in exact
            # arithmetic, so both sides read rounding (sums of O(1) terms)
            zero = 1e-5 if dtype != "bfloat16" else 0.1
            assert max(np.abs(tp[k]).max(), np.abs(jp[k]).max()) <= zero
            continue
        assert _rel_l2(tp[k], jp[k]) <= grad_tol, k
    for a, b in zip(tx, jx):
        assert _rel_l2(a, b) <= grad_tol, "input"


LAYERS = [
    ("SelfAttentionLayer", {"n_heads": HEADS}),
    ("SelfAttentionLayer", {"n_heads": HEADS, "qkv_bias": True}),
    ("SelfAttentionLayer", {"project_input": False}),
    ("LearnedSelfAttentionLayer", {"n_heads": HEADS, "n_queries": 3}),
    ("RecurrentAttentionLayer", {"n_heads": HEADS, "activation": "tanh"}),
]
LAYER_IDS = ["self", "self-qkv_bias", "self-no_projection", "learned",
             "recurrent"]


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("name,kw", LAYERS, ids=LAYER_IDS)
def test_layer_matches_the_reference(name, kw, kind):
    j, t = _pair(name, **kw)
    params = _params(j)
    ref, port = _run_both(j, t, params, _layer_inputs(name), _mask(kind),
                          "float32")
    _assert_layer_close(ref, port, "float32")


@pytest.mark.parametrize("dtype", ["bfloat16", "float64"])
@pytest.mark.parametrize("name,kw", LAYERS, ids=LAYER_IDS)
def test_layer_matches_the_reference_in_other_types(name, kw, dtype):
    j, t = _pair(name, **kw)
    ref, port = _run_both(j, t, _params(j, 2), _layer_inputs(name, seed=3),
                          _mask("empty_row"), dtype)
    _assert_layer_close(ref, port, dtype)


@pytest.mark.parametrize("key_in", [None, 10], ids=["value_keys", "key_input"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_the_reference(dtype, key_in):
    j, t = _pair("CrossAttentionLayer", n_heads=HEADS, key_in=key_in,
                 qkv_bias=True)
    assert t.param_shapes() == j.param_shapes()
    ref, port = _run_both(j, t, _params(j, 4),
                          _layer_inputs("CrossAttentionLayer", key_in),
                          None, dtype)
    _assert_layer_close(ref, port, dtype)


def test_cross_attention_refuses_a_mask_as_the_reference():
    j, t = _pair("CrossAttentionLayer", n_heads=HEADS)
    xs = _layer_inputs("CrossAttentionLayer")
    params = _params(j)
    with pytest.raises(ValueError) as want:
        j.apply({k: jnp.asarray(v, jnp.float32) for k, v in params.items()},
                [jnp.asarray(a, jnp.float32) for a in xs],
                mask=jnp.ones((N, T_LEN)))
    with pytest.raises(ValueError) as got:
        t.apply({k: torch.tensor(v).float() for k, v in params.items()},
                [torch.tensor(a).float() for a in xs],
                mask=torch.ones((N, T_LEN)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,kw", LAYERS + [
    ("CrossAttentionLayer", {"n_heads": HEADS, "key_in": 10})],
    ids=LAYER_IDS + ["cross"])
def test_layer_config_equals_the_reference(name, kw):
    """Param names, shapes and insertion order, output types and dict
    round trips."""
    j, t = _pair(name, **kw)
    assert list(t.param_shapes().items()) == list(j.param_shapes().items())
    assert t.to_dict() == j.to_dict()
    back = TL.layer_from_dict(j.to_dict())
    assert type(back) is type(t) and back.to_dict() == t.to_dict()
    assert JL.layer_from_dict(t.to_dict()).to_dict() == j.to_dict()
    it_j, it_t = JIT.recurrent(C, T_LEN), TIT.recurrent(C, T_LEN)
    jt, tt = j.output_type(it_j), t.output_type(it_t)
    assert (tt.kind, tt.size, tt.timeseries_length) == (
        jt.kind, jt.size, jt.timeseries_length)
    init = t.init_params(torch.Generator().manual_seed(0))
    assert list(init) == list(j.param_shapes())
    assert all(tuple(init[k].shape) == s for k, s in t.param_shapes().items())


def test_layers_take_the_kernel_route(monkeypatch):
    """Each layer's attention goes through ``fa.FlashAttention``: one
    forward call (a step of the recurrent layer: one each), one backward
    call each."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_attention_bwd", count("bwd", bwd))
    for (name, kw), want in zip(LAYERS, (1, 1, 1, 1, T_LEN)):
        calls.update(fwd=0, bwd=0)
        j, t = _pair(name, **kw)
        tp = {k: _t(v, "float32", True) for k, v in _params(j).items()}
        out, _ = t.apply(tp, _t(_layer_inputs(name), "float32", True),
                         mask=torch.tensor(_mask("gap")))
        out.sum().backward()
        assert calls == {"fwd": want, "bwd": want}, name


# -------------------------------------------------------------- the vertices
VERTICES = [
    ("DotVertex", {"axes": 2}, [(N, 5, 6), (N, 4, 6)]),
    ("DotVertex", {"axes": (1, 1), "normalize": True}, [(N, 5, 6), (N, 5, 3)]),
    ("DotVertex", {"axes": -1}, [(N, 6), (N, 6)]),
    ("DotProductAttentionVertex", {}, [(N, 5, 6), (N, 4, 6)]),
    ("DotProductAttentionVertex", {"causal": True},
     [(N, 4, 6), (N, 4, 3), (N, 4, 6)]),
    ("AdditiveAttentionVertex", {}, [(N, 5, 6), (N, 4, 6)]),
    ("AdditiveAttentionVertex", {"causal": True}, [(N, 4, 6), (N, 4, 6)]),
]
VERTEX_IDS = ["dot-features", "dot-time-normalized", "dot-rank2",
              "dpa", "dpa-causal-key", "additive", "additive-causal"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw,shapes", VERTICES, ids=VERTEX_IDS)
def test_vertex_matches_the_reference(name, kw, shapes, dtype):
    rng = np.random.default_rng(len(shapes))
    xs = [rng.standard_normal(s) for s in shapes]
    jv, tv = getattr(j_gc, name)(**kw), getattr(t_gc, name)(**kw)
    assert tv.to_dict() == jv.to_dict()
    assert t_gc.vertex_from_dict(jv.to_dict()).to_dict() == jv.to_dict()
    jo, vjp = jax.vjp(lambda *a: jv.apply(list(a)),
                      *(_jnp(a, dtype) for a in xs))
    gy = rng.standard_normal(jo.shape)
    jg = [np.asarray(g.astype(jnp.float32)) for g in vjp(_jnp(gy, dtype))]
    tx = [_t(a, dtype, True) for a in xs]
    to = tv.apply(tx)
    assert to.dtype == tx[0].dtype and tuple(to.shape) == jo.shape
    to.backward(_t(gy, dtype))
    _close(to.detach().double().numpy(),
           np.asarray(jo.astype(jnp.float32)), dtype, "output")
    for a, b in zip(tx, jg):
        assert _rel_l2(a.grad.double().numpy(), b) <= TOL[dtype][1]


def test_vertex_output_types_equal_the_reference():
    for name, kw, shapes in VERTICES:
        if len(shapes[0]) == 2:
            jt, tt = ([it.feed_forward(s[1]) for s in shapes]
                      for it in (JIT, TIT))
        else:
            jt, tt = ([it.recurrent(s[2], s[1]) for s in shapes]
                      for it in (JIT, TIT))
        a = getattr(j_gc, name)(**kw).output_type(jt)
        b = getattr(t_gc, name)(**kw).output_type(tt)
        assert (b.kind, b.size, b.timeseries_length) == (
            a.kind, a.size, getattr(a, "timeseries_length", None)), name


# --------------------------------------------------------------- the nets
J = dict(cfg=j_cfg, L=JL, IT=JIT, U=j_upd, gc=j_gc,
         MLN=j_mln.MultiLayerNetwork, CG=j_graph.ComputationGraph)
P = dict(cfg=t_cfg, L=TL, IT=TIT, U=t_upd, gc=t_gc,
         MLN=t_mln.MultiLayerNetwork, CG=t_graph.ComputationGraph)
CLASSES = 4


def _np(a):
    return np.asarray(a.toNumpy() if hasattr(a, "toNumpy") else a,
                      np.float64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _builder(ns, dtype="float32"):
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(3)
            .updater(ns["U"].Adam(1e-2)).data_type(dtype)
            .weight_init("xavier"))


def _head(ns, layer, dtype="float32"):
    L = ns["L"]
    return (_builder(ns, dtype).list().layer(layer)
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=CLASSES, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].recurrent(C, T_LEN)).build())


def _pair_nets(conf_fn, kind="MLN"):
    ref = J[kind](conf_fn(J)).init()
    net = P[kind](conf_fn(P), device="cpu").init()
    net.set_param_tree(_np_tree(ref.param_tree()))
    net.set_updater_state_from_jax(_np_tree(ref._opt_state))
    return ref, net


def _x(seed=5, t=T_LEN):
    return np.random.default_rng(seed).standard_normal(
        (N, t, C)).astype(np.float32)


MLN_LAYERS = {
    "self": lambda L: L.SelfAttentionLayer(n_heads=HEADS),
    "learned": lambda L: L.LearnedSelfAttentionLayer(n_heads=HEADS,
                                                    n_queries=1),
    "recurrent": lambda L: L.RecurrentAttentionLayer(n_heads=HEADS,
                                                    activation="tanh"),
}


@pytest.mark.parametrize("which", sorted(MLN_LAYERS))
def test_multilayer_network_hands_each_attention_layer_the_mask(which):
    """The reference's ``_MASK_AWARE`` holds all three mask-aware attention
    layers: the masked output equals the reference's and differs from the
    unmasked one."""
    ref, net = _pair_nets(lambda ns: _head(ns, MLN_LAYERS[which](ns["L"])))
    x, m = _x(), _mask("gap")
    got = _np(net.output(x, mask=m))
    np.testing.assert_allclose(got, _np(ref.output(x, mask=m)), atol=1e-5)
    assert np.abs(got - _np(net.output(x))).max() > 1e-4
    assert isinstance(MLN_LAYERS[which](TL), t_mln._MASK_AWARE)


def _graph_conf(ns, which):
    L = ns["L"]
    return (_builder(ns).graph_builder().add_inputs("in")
            .set_input_types(ns["IT"].recurrent(C, T_LEN))
            .add_layer("att", MLN_LAYERS[which](L), "in")
            .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), "att")
            .add_layer("out", L.OutputLayer(n_out=CLASSES,
                                            activation="softmax",
                                            loss_function="mcxent"), "pool")
            .set_outputs("out").build())


@pytest.mark.parametrize("which", sorted(MLN_LAYERS))
def test_graph_hands_the_mask_to_self_attention_only(which):
    """The reference graph's ``_MASK_AWARE`` holds ``SelfAttentionLayer``
    alone: the learned and recurrent layers run unmasked in a graph (the
    pooling after them still takes the mask)."""
    ref, net = _pair_nets(lambda ns: _graph_conf(ns, which), "CG")
    x, m = _x(6), _mask("gap")
    got = _np(net.output(x, masks=[m]))
    np.testing.assert_allclose(got, _np(ref.output(x, masks=[m])), atol=1e-5)
    layer = MLN_LAYERS[which](TL)
    assert isinstance(layer, t_graph._MASK_AWARE) == (which == "self")
    # the attention layer's own output with and without the mask
    def att(masks):
        with torch.no_grad():
            acts, _, _ = net._forward(net._params, net._states,
                                      (torch.tensor(x),), False, None,
                                      masks=masks)
        return acts["att"]

    moved = float((att((torch.tensor(m),)) - att(None)).abs().max())
    assert (moved > 1e-4) == (which == "self")


def test_graph_cross_attention_refuses_the_mask_as_the_reference():
    def conf(ns):
        L = ns["L"]
        return (_builder(ns).graph_builder().add_inputs("q", "kv")
                .set_input_types(ns["IT"].recurrent(C, T_LEN),
                                 ns["IT"].recurrent(12, 9))
                .add_layer("att", L.CrossAttentionLayer(n_heads=HEADS),
                           "q", "kv")
                .add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"),
                           "att")
                .add_layer("out", L.OutputLayer(n_out=CLASSES,
                                                activation="softmax",
                                                loss_function="mcxent"),
                           "pool")
                .set_outputs("out").build())

    ref, net = _pair_nets(conf, "CG")
    rng = np.random.default_rng(7)
    xq = rng.standard_normal((N, T_LEN, C)).astype(np.float32)
    xkv = rng.standard_normal((N, 9, 12)).astype(np.float32)
    np.testing.assert_allclose(_np(net.output(xq, xkv)),
                               _np(ref.output(xq, xkv)), atol=1e-5)
    m = _mask("tail")
    with pytest.raises(ValueError, match="does not support sequence masks"):
        ref.output(xq, xkv, masks=[m])
    with pytest.raises(ValueError, match="does not support sequence masks"):
        net.output(xq, xkv, masks=[m])


def test_mask_after_learned_attention_is_the_reference_s():
    """The reference hands the input's (N, T) mask on after a
    ``LearnedSelfAttentionLayer`` has made the time axis n_queries long.
    With n_queries == T the pooling masks the queries by the input's mask
    (ROADMAP queue 3); the port does the same. With another n_queries (not
    1) the shapes do not broadcast and both sides raise."""
    def conf(nq):
        return lambda ns: _head(ns, ns["L"].LearnedSelfAttentionLayer(
            n_heads=HEADS, n_queries=nq))

    ref, net = _pair_nets(conf(T_LEN))
    x, m = _x(8), _mask("tail")
    got = _np(net.output(x, mask=m))
    np.testing.assert_allclose(got, _np(ref.output(x, mask=m)), atol=1e-5)
    ref, net = _pair_nets(conf(2))
    with pytest.raises(Exception):
        ref.output(x, mask=m)
    with pytest.raises(RuntimeError):
        net.output(x, mask=m)


# ------------------------------------------------- A1 in miniature, 3 fits
V_SMALL, T_A1, D_A1, N_A1 = 50, 32, 32, 4


def _a1_conf(ns, dtype):
    # Nesterov momentum (linear in the gradients): Adam would turn the f32
    # rounding of the keys' near-zero gradient directions (softmax is
    # shift-invariant along the keys) into moves of up to its lr
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(3)
            .updater(ns["U"].Nesterovs(0.1, 0.9)).data_type(dtype)
            .weight_init("xavier").list()
            .layer(L.EmbeddingSequenceLayer(n_in=V_SMALL, n_out=D_A1,
                                            input_length=T_A1))
            .layer(L.SelfAttentionLayer(n_heads=2))
            .layer(L.SelfAttentionLayer(n_heads=2))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=CLASSES, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].recurrent(1, T_A1)).build())


def _a1_data(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V_SMALL, (N_A1, T_A1)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, N_A1)]
    lengths = np.array([T_A1, 20, 9, 1])
    m = (np.arange(T_A1)[None] < lengths[:, None]).astype(np.float32)
    m[0, 5:12] = 0                      # an interior gap
    return x, y, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a1_sequence_classifier_fits_as_the_reference(dtype):
    """The chip's A1 in miniature (2 heads of 16, T 32, lengths 32 with an
    interior gap, 20, 9 and 1): the masked gradient of every param, then
    three masked fits, each step's loss, the params and updater state.
    f32 atol 1e-5 (gradients relative L2 1e-5); bf16 losses atol 2e-2,
    gradients relative L2 5e-2 and each leaf's displacement within
    relative L2 1e-1 (the networks' bf16 rows)."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDS
    from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
    ref, net = _pair_nets(lambda ns: _a1_conf(ns, dtype))
    assert ref.numParams() == net.numParams()
    x, y, m = _a1_data()
    j_score, j_grads = ref.computeGradientAndScore(x, y, mask=m)
    t_score, t_grads = net.computeGradientAndScore(x, y, mask=m)
    assert abs(t_score - j_score) <= (1e-5 if dtype == "float32" else 2e-2)
    grad_tol = 1e-5 if dtype == "float32" else 5e-2
    for k in j_grads:
        for p in j_grads[k]:
            if p == "bk":
                continue            # 0 in exact arithmetic (the layer test)
            assert _rel_l2(t_grads[k][p].numpy(),
                           np.asarray(j_grads[k][p])) <= grad_tol, (k, p)
    before = {k: {p: v.numpy().copy() for p, v in layer.items()}
              for k, layer in net.param_tree().items()}
    j_loss, t_loss = [], []
    for _ in range(3):
        ref.fit(JDS(x, y, m, None))
        net.fit(TDS(x, y, m, None))
        j_loss.append(ref.score())
        t_loss.append(net.score())
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(t_loss, j_loss, atol=tol)
    jp, tp = ref.param_tree(), net.param_tree()
    for k in jp:
        for p in jp[k]:
            got, want = tp[k][p].numpy(), np.asarray(jp[k][p])
            if dtype == "float32":
                np.testing.assert_allclose(got, want, atol=1e-5,
                                           err_msg=f"{k}/{p}")
            else:
                assert _rel_l2(got - before[k][p], want - before[k][p],
                               rms_floor=1e-6) <= 1e-1, (k, p)
    j_state = [a for a in jax.tree.leaves(ref._opt_state) if np.ndim(a)]
    t_state = [b for b in T.state_leaves(net.updater_state())
               if not isinstance(b, int)]
    assert len(j_state) == len(t_state)
    if dtype == "float32":
        for a, b in zip(j_state, t_state):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


# ------------------------------------------------------------------- FLOPs
def test_attention_layer_flops_by_hand():
    """Projections (2 a multiply-add) plus 4·N·H·Tq·Tk·hs."""
    n, t, c, h, hs = 2, 7, 16, 2, 8
    it = TIT.recurrent(c, t)

    def make(kind, **kw):
        layer = getattr(TL, kind)(n_heads=h, **kw)
        layer.apply_global_defaults({})
        layer.set_n_in(it)
        return layer

    self_ = make("SelfAttentionLayer")
    assert layer_flops(self_, it, n) == (2 * n * t * 3 * c * h * hs
                                         + 2 * n * t * h * hs * c
                                         + 4 * n * h * t * t * hs)
    one = getattr(TL, "SelfAttentionLayer")(project_input=False)
    one.apply_global_defaults({})
    one.set_n_in(it)
    assert layer_flops(one, it, n) == 4 * n * t * t * c
    learned = make("LearnedSelfAttentionLayer", n_queries=3)
    assert layer_flops(learned, it, n) == (2 * n * t * 2 * c * h * hs
                                           + 2 * n * 3 * h * hs * c
                                           + 4 * n * h * 3 * t * hs)
    rec = make("RecurrentAttentionLayer")
    assert layer_flops(rec, it, n) == (2 * n * t * c * c
                                       + 2 * n * t * 2 * c * h * hs
                                       + 2 * n * t * 2 * c * h * hs
                                       + 4 * n * h * t * t * hs)
    cross = getattr(TL, "CrossAttentionLayer")(n_heads=h, key_in=10)
    cross.apply_global_defaults({})
    kv = TIT.recurrent(12, 9)
    cross.set_n_in_multi([it, kv, TIT.recurrent(10, 9)])
    assert layer_flops(cross, it, n, kv_type=kv) == (
        2 * n * t * (c + c) * h * hs + 2 * n * 9 * (12 + 10) * h * hs
        + 4 * n * h * t * 9 * hs)
    # per step of a chunk: t given
    assert layer_flops(self_, it, n, t=3) == (2 * n * 3 * 4 * c * h * hs
                                              + 4 * n * h * 9 * hs)
    # a network's forward FLOPs add the layers' up
    net = t_mln.MultiLayerNetwork(_head(P, TL.SelfAttentionLayer(
        n_heads=HEADS)), device="cpu")
    assert net._forward_flops(n) == (layer_flops(self_, it, n)
                                     + 2 * n * c * CLASSES)
