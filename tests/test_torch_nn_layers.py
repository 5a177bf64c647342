"""The port's layers, activations, losses, dropout and weight init against
the JAX package's, on the CPU at small sizes.

Each layer's ``apply`` runs on both sides with the same numpy params and
input, in training and in inference. Tolerances (PERF.md states them):

- f32 layer outputs, activations and losses: atol 1e-5 (rtol 1e-5): the
  same arithmetic, f32 sums in another order;
- BatchNormalization on bf16 input: output within 2 bf16 ulps (rtol
  2^-7), running statistics atol 1e-6: both sides take f32 moments of the
  same bf16 values and round the output once;
- dropout: the kept share within 5σ of the retain probability p, every
  kept entry exactly x / p (threefry bits cannot be reproduced);
- weight init: mean within 5σ of 0 and std within 2 % of the scheme's.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import activations as j_act
from deeplearning4j_tpu.nn import losses as j_loss
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu_torch.nn import activations as t_act
from deeplearning4j_tpu_torch.nn import losses as t_loss
from deeplearning4j_tpu_torch.nn import weights as t_w
from deeplearning4j_tpu_torch.nn.conf import dropout as t_drop
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.ops import standard as t_ops

ATOL = 1e-5


def _pair(kind, it, **kw):
    """The same layer config on both sides, defaults and n_in applied."""
    j, t = getattr(JL, kind)(**kw), getattr(TL, kind)(**kw)
    for layer, typ in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults({})
        if it is not None:
            layer.set_n_in(typ(**it.__dict__))
    return j, t


def _params(layer, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) * 0.5
            for k, s in layer.param_shapes().items()}


def _run(j, t, x, params=None, state=None, training=False, **kw):
    params = params if params is not None else _params(j)
    jy, jst = j.apply({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x), training=training, rng=None,
                      state=None if state is None else
                      {k: jnp.asarray(v) for k, v in state.items()}, **kw)
    ty, tst = t.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x), training=training, gen=None,
                      state=None if state is None else
                      {k: torch.from_numpy(v) for k, v in state.items()},
                      **{k: torch.from_numpy(np.asarray(v))
                         for k, v in kw.items()})
    return jy, jst, ty, tst


def _close(t, j, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32),
                               atol=atol, rtol=rtol)


X_CNN = np.random.default_rng(1).standard_normal((2, 9, 10, 3)).astype(
    np.float32)
IT_CNN = JIT.convolutional(9, 10, 3)

CONV_CASES = [
    dict(kernel_size=(3, 3), stride=(1, 1), padding=1),
    dict(kernel_size=(3, 3), stride=(2, 2), padding=(1, 2)),
    dict(kernel_size=(3, 3), stride=(1, 1), padding="same"),
    dict(kernel_size=(3, 3), stride=(2, 2), padding="same"),
    dict(kernel_size=(4, 4), stride=(2, 2), padding="same"),
    dict(kernel_size=(3, 3), stride=(1, 1), padding=0, dilation=(2, 2)),
    dict(kernel_size=(3, 2), stride=(1, 2), padding="same", dilation=(2, 2)),
    dict(kernel_size=(7, 7), stride=(2, 2), padding=0, has_bias=False),
    dict(kernel_size=(1, 1), stride=(2, 2), padding=0, has_bias=False),
]


@pytest.mark.parametrize("kw", CONV_CASES, ids=lambda kw: str(kw))
def test_convolution_matches_reference(kw):
    j, t = _pair("ConvolutionLayer", IT_CNN, n_out=4, activation="relu", **kw)
    jy, _, ty, _ = _run(j, t, X_CNN)
    assert tuple(ty.shape) == jy.shape
    assert jy.shape[1:3] == (j.output_type(IT_CNN).height,
                             j.output_type(IT_CNN).width)
    _close(ty, jy)


POOL_CASES = [(kind, pad, k, s) for kind in ("max", "avg", "pnorm")
              for pad, k, s in ((0, 2, 2), (1, 3, 2), ("same", 3, 2),
                                ("same", 2, 2), ("same", 3, 1))]


@pytest.mark.parametrize("kind,pad,k,s", POOL_CASES,
                         ids=lambda v: str(v))
def test_pooling_matches_reference(kind, pad, k, s):
    j, t = _pair("SubsamplingLayer", IT_CNN, pooling_type=kind,
                 kernel_size=k, stride=s, padding=pad, pnorm=3)
    jy, _, ty, _ = _run(j, t, X_CNN, params={})
    assert tuple(ty.shape) == jy.shape
    out_t = j.output_type(IT_CNN)
    assert jy.shape[1:] == (out_t.height, out_t.width, out_t.channels)
    _close(ty, jy)


def test_same_pads_put_the_odd_row_at_the_end():
    assert t_ops.same_pads(9, 3, 2) == (1, 1)
    assert t_ops.same_pads(10, 3, 2) == (0, 1)
    assert t_ops.same_pads(10, 4, 2) == (1, 1)
    assert t_ops.same_pads(224, 7, 2) == (2, 3)


def test_zero_padding_matches_reference():
    for pad in (1, (1, 2), (0, 1, 2, 3)):
        j, t = _pair("ZeroPaddingLayer", IT_CNN, padding=pad)
        jy, _, ty, _ = _run(j, t, X_CNN, params={})
        _close(ty, jy, atol=0)


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_reference(kind):
    j, t = _pair("GlobalPoolingLayer", IT_CNN, pooling_type=kind)
    jy, _, ty, _ = _run(j, t, X_CNN, params={})
    _close(ty, jy)
    x3 = X_CNN.reshape(2, 90, 3)
    mask = (np.arange(90)[None, :] < np.array([[40], [90]])).astype(
        np.float32)
    jy, _, ty, _ = _run(j, t, x3, params={}, mask=mask)
    _close(ty, jy)


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_reference(training):
    j, t = _pair("BatchNormalization", IT_CNN)
    rng = np.random.default_rng(3)
    params = {"gamma": rng.standard_normal(3).astype(np.float32),
              "beta": rng.standard_normal(3).astype(np.float32)}
    state = {"mean": rng.standard_normal(3).astype(np.float32),
             "var": rng.uniform(0.5, 2, 3).astype(np.float32)}
    x = X_CNN * 3 + 1
    jy, jst, ty, tst = _run(j, t, x, params, state, training=training)
    _close(ty, jy)
    for k in ("mean", "var"):
        _close(tst[k], jst[k], atol=1e-6)
    if not training:       # inference leaves the running stats alone
        np.testing.assert_array_equal(tst["mean"].numpy(), state["mean"])


def test_batchnorm_bf16_input_matches_reference():
    j, t = _pair("BatchNormalization", IT_CNN)
    state = {"mean": np.zeros(3, np.float32), "var": np.ones(3, np.float32)}
    params = {"gamma": np.full(3, 1.5, np.float32),
              "beta": np.full(3, 0.25, np.float32)}
    xb = (X_CNN * 2 + 0.5).astype(jnp.bfloat16)
    jy, jst = j.apply({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(xb), training=True, rng=None,
                      state={k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = t.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                      training=True, gen=None,
                      state={k: torch.from_numpy(v) for k, v in state.items()})
    assert ty.dtype == torch.bfloat16 and tst["mean"].dtype == torch.float32
    _close(ty, np.asarray(jy, np.float32), atol=2 ** -7, rtol=2 ** -7)
    for k in ("mean", "var"):
        _close(tst[k], jst[k], atol=1e-6)


def test_lrn_matches_reference():
    j, t = _pair("LocalResponseNormalization", IT_CNN, n=3, k=1.0,
                 alpha=0.1, beta=0.75)
    jy, _, ty, _ = _run(j, t, X_CNN, params={})
    _close(ty, jy)


@pytest.mark.parametrize("act", ["relu", "softmax", "tanh", "identity"])
def test_dense_and_activation_layers_match_reference(act):
    it = JIT.feed_forward(6)
    x = np.random.default_rng(4).standard_normal((5, 6)).astype(np.float32)
    j, t = _pair("DenseLayer", it, n_out=4, activation=act)
    jy, _, ty, _ = _run(j, t, x)
    _close(ty, jy)
    j, t = _pair("ActivationLayer", it, activation=act)
    jy, _, ty, _ = _run(j, t, x, params={})
    _close(ty, jy)
    j, t = _pair("FlattenLayer", IT_CNN)
    jy, _, ty, _ = _run(j, t, X_CNN, params={})
    _close(ty, jy, atol=0)


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"),
                                      ("negativeloglikelihood", "softmax"),
                                      ("xent", "sigmoid"), ("mse", "identity"),
                                      ("mae", "tanh"), ("hinge", "identity")])
def test_output_and_loss_layers_match_reference(loss, act):
    it = JIT.convolutional(2, 3, 2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 2, 3, 2)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    mask = np.array([1, 0, 1, 1], np.float32)
    j, t = _pair("OutputLayer", it, n_out=3, activation=act,
                 loss_function=loss)
    p = _params(j)
    for m in (None, mask):
        jl = j.loss({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                    jnp.asarray(labels),
                    mask=None if m is None else jnp.asarray(m))
        tl = t.loss({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), torch.from_numpy(labels),
                    mask=None if m is None else torch.from_numpy(m))
        _close(tl, jl)
    x2 = rng.standard_normal((4, 3)).astype(np.float32)
    j, t = _pair("LossLayer", JIT.feed_forward(3), activation=act,
                 loss_function=loss)
    _close(t.loss({}, torch.from_numpy(x2), torch.from_numpy(labels)),
           j.loss({}, jnp.asarray(x2), jnp.asarray(labels)))


@pytest.mark.parametrize("name", j_act.names() + ["leakyrelu:0.2", "elu:0.5",
                                                   "thresholdedrelu:0.3"])
def test_every_activation_matches_reference(name):
    x = np.linspace(-3, 3, 60, dtype=np.float32).reshape(3, 20)
    _close(t_act.get(name)(torch.from_numpy(x)),
           j_act.get(name)(jnp.asarray(x)))


_LOSS_NAMES = sorted(j_loss._LOSSES)


@pytest.mark.parametrize("name", _LOSS_NAMES)
def test_every_loss_matches_reference(name):
    rng = np.random.default_rng(6)
    if name == "sparsemcxent":
        pred = rng.standard_normal((5, 4)).astype(np.float32)
        labels = rng.integers(0, 4, 5).astype(np.int32)
    else:
        pred = rng.uniform(0.05, 0.95, (5, 4)).astype(np.float32)
        labels = (rng.uniform(0.05, 0.95, (5, 4)).astype(np.float32)
                  if name not in ("hinge", "squaredhinge")
                  else np.sign(rng.standard_normal((5, 4))).astype(np.float32))
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    for m in (None, mask):
        jl = j_loss.get(name)(jnp.asarray(pred), jnp.asarray(labels),
                              None if m is None else jnp.asarray(m))
        tl = t_loss.get(name)(torch.from_numpy(pred),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        _close(tl, jl)
    for pair in t_loss._FUSED:
        assert pair in j_loss._FUSED


def test_dropout_keeps_its_share_and_scales_kept_entries():
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(200_000) + 0.5
    for p in (0.5, 0.8):
        y = t_ops.dropout_inverted(x, gen, p=p)
        kept = y != 0
        n = x.numel()
        assert abs(kept.float().mean().item() - p) <= 5 * math.sqrt(
            p * (1 - p) / n)
        assert torch.equal(y[kept], x[kept] / p)
    # the layer field and the IDropout object draw the same way
    layer = TL.DropoutLayer(dropout=0.7)
    y = layer.apply({}, x, training=True, gen=gen)[0]
    assert abs((y != 0).float().mean().item() - 0.7) < 5 * math.sqrt(
        0.21 / x.numel())
    assert torch.equal(layer.apply({}, x, training=False, gen=gen)[0], x)
    y = t_drop.Dropout(0.6).apply(x, gen, True)
    assert torch.equal(y[y != 0], x[y != 0] / 0.6)


INIT_CASES = [("xavier", math.sqrt(2 / (300 + 200))),
              ("relu", math.sqrt(2 / 300)),
              ("normal", 1 / math.sqrt(300)),
              ("uniform", 1 / math.sqrt(300) / math.sqrt(3)),
              ("xavier_uniform", math.sqrt(6 / 500) / math.sqrt(3)),
              ("relu_uniform", math.sqrt(6 / 300) / math.sqrt(3)),
              ("lecun_uniform", math.sqrt(3 / 300) / math.sqrt(3)),
              ("sigmoid_uniform", 4 * math.sqrt(6 / 500) / math.sqrt(3)),
              ("truncated_normal", None), ("var_scaling_normal_fan_avg", None),
              ("orthogonal", None)]


@pytest.mark.parametrize("name,std", INIT_CASES, ids=lambda v: str(v))
def test_weight_init_distributions(name, std):
    """Each scheme's mean and std match the JAX package's draw of the same
    scheme (and the formula where it is a plain normal or uniform)."""
    shape, fan_in, fan_out = (300, 200), 300, 200
    w = t_w.init(name, torch.Generator().manual_seed(1), shape, fan_in,
                 fan_out).numpy()
    from deeplearning4j_tpu.nn import weights as j_w
    ref = np.asarray(j_w.init(name, jax.random.key(1), shape, fan_in,
                              fan_out))
    want = std if std is not None else ref.std()
    assert w.shape == shape and w.dtype == np.float32
    assert abs(w.mean()) <= 5 * want / math.sqrt(w.size)
    assert abs(w.std() / want - 1) < 0.02
    assert abs(ref.std() / want - 1) < 0.02
    if name == "orthogonal":
        np.testing.assert_allclose(w.T @ w, np.eye(200), atol=1e-4)
    scale = {"truncated_normal": 1 / math.sqrt(fan_in),
             "var_scaling_normal_fan_avg": math.sqrt(2 / (fan_in + fan_out))}
    if name in scale:      # cut at two standard deviations of the normal
        assert np.abs(w).max() <= 2 * scale[name] * (1 + 1e-6)


def test_layer_json_round_trips_across_packages():
    for kind, kw in (("ConvolutionLayer", dict(kernel_size=(3, 3),
                                               padding="same", n_out=4)),
                     ("SubsamplingLayer", dict(padding=1)),
                     ("BatchNormalization", dict(decay=0.8)),
                     ("OutputLayer", dict(n_out=3)),
                     ("ZeroPaddingLayer", dict(padding=(1, 2, 3, 4)))):
        j, t = _pair(kind, IT_CNN, **kw)
        assert TL.layer_from_dict(j.to_dict()) == t
        assert JL.layer_from_dict(t.to_dict()) == j


from deeplearning4j_tpu.nn import graph_conf as j_gc  # noqa: E402
from deeplearning4j_tpu.nn.conf import preprocessors as j_pp  # noqa: E402
from deeplearning4j_tpu_torch.nn import graph_conf as t_gc  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import preprocessors as t_pp  # noqa: E402

VERTICES = [("MergeVertex", {}, 2), ("ElementWiseVertex", {"op": "add"}, 3),
            ("ElementWiseVertex", {"op": "subtract"}, 2),
            ("ElementWiseVertex", {"op": "product"}, 2),
            ("ElementWiseVertex", {"op": "average"}, 3),
            ("ElementWiseVertex", {"op": "max"}, 2),
            ("ElementWiseVertex", {"op": "min"}, 2),
            ("SubsetVertex", {"from_idx": 1, "to_idx": 2}, 1),
            ("L2NormalizeVertex", {}, 1), ("ScaleVertex", {"scale": 2.5}, 1),
            ("ShiftVertex", {"shift": -1.5}, 1), ("StackVertex", {}, 2),
            ("UnstackVertex", {"from_idx": 1, "stack_size": 2}, 1),
            ("ReshapeVertex", {"shape": (9, 10 * 3)}, 1),
            ("PoolHelperVertex", {}, 1), ("L2Vertex", {}, 2)]


@pytest.mark.parametrize("kind,kw,n", VERTICES, ids=lambda v: str(v))
def test_vertex_matches_reference(kind, kw, n):
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
          for _ in range(n)]
    j, t = getattr(j_gc, kind)(**kw), getattr(t_gc, kind)(**kw)
    _close(t.apply([torch.from_numpy(a) for a in xs]),
           j.apply([jnp.asarray(a) for a in xs]))
    assert t_gc.vertex_from_dict(j.to_dict()) == t
    assert j_gc.vertex_from_dict(t.to_dict()) == j


def test_preprocessors_and_their_vertex_match_reference():
    x = np.random.default_rng(9).standard_normal((6, 4, 5, 3)).astype(
        np.float32)
    cases = [("CnnToFeedForwardPreProcessor", (4, 5, 3), x, None),
             ("FeedForwardToCnnPreProcessor", (4, 5, 3), x.reshape(6, -1),
              None),
             ("RnnToFeedForwardPreProcessor", (), x.reshape(6, 20, 3), None),
             ("FeedForwardToRnnPreProcessor", (), x.reshape(30, 12), 6),
             ("RnnToCnnPreProcessor", (4, 5, 3), x.reshape(2, 3, 60), None),
             ("CnnToRnnPreProcessor", (4, 5, 3), x, 2)]
    for kind, args, a, batch in cases:
        j, t = getattr(j_pp, kind)(*args), getattr(t_pp, kind)(*args)
        _close(t.pre_process(torch.from_numpy(a), batch_size=batch),
               j.pre_process(jnp.asarray(a), batch_size=batch), atol=0)
        assert t_pp.preprocessor_from_dict(j.to_dict()).to_dict() == \
            j.to_dict()
    vj = j_gc.PreprocessorVertex.wrap(j_pp.CnnToFeedForwardPreProcessor())
    vt = t_gc.vertex_from_dict(vj.to_dict())
    _close(vt.apply([torch.from_numpy(x)]), vj.apply([jnp.asarray(x)]),
           atol=0)


def test_noise_dropouts_keep_their_moments():
    """GaussianDropout multiplies by N(1, rate/(1-rate)), GaussianNoise adds
    N(0, stddev), AlphaDropout keeps a standard input's mean and variance;
    each is the identity outside training (5σ bounds over 2^18 draws)."""
    gen = torch.Generator().manual_seed(3)
    n = 1 << 18
    ones = torch.ones(n)
    y = t_drop.GaussianDropout(rate=0.2).apply(ones, gen, True)
    sd = math.sqrt(0.2 / 0.8)
    assert abs(y.mean().item() - 1) < 5 * sd / math.sqrt(n)
    assert abs(y.std().item() / sd - 1) < 0.02
    y = t_drop.GaussianNoise(stddev=0.3).apply(torch.zeros(n), gen, True)
    assert abs(y.std().item() / 0.3 - 1) < 0.02
    x = torch.randn(n, generator=gen)
    y = t_drop.AlphaDropout(p=0.9).apply(x, gen, True)
    assert abs(y.mean().item()) < 0.02 and abs(y.var().item() - 1) < 0.03
    for d in (t_drop.GaussianDropout(0.2), t_drop.GaussianNoise(0.3),
              t_drop.AlphaDropout(0.9)):
        assert torch.equal(d.apply(x, gen, False), x)
        assert t_drop.dropout_from_dict(d.to_dict()) == d


def test_lambda_vertex_applies_its_function_and_refuses_json():
    x = torch.arange(6.0).reshape(2, 3)
    v = t_gc.LambdaVertex(lambda a, b: a * b)
    assert torch.equal(v.apply([x, x + 1]), x * (x + 1))
    with pytest.raises(TypeError):
        v.to_dict()
