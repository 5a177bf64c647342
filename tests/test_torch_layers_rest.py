"""The rest of ``nn/conf/layers.py`` in the port against the JAX package,
on the CPU at small sizes: ``SeparableConvolution2D``, ``Upsampling2D``,
``CenterLossOutputLayer``, ``SpatialDropoutLayer``, ``ReshapeLayer``,
``PermuteLayer``, ``RepeatVectorLayer``, ``Deconvolution2D``,
``Cropping2D``, ``Convolution1DLayer``, ``Convolution3D``,
``CnnLossLayer``, ``LayerNormalization`` and ``LambdaLayer``, plus the
ops they run on (``resize_bilinear``, ``conv_transpose``) and their
FLOP counts.

Each case holds the output and the gradients of every param and of the
input to the reference's (``jax.vjp``) in f32, and in f64 and bf16 where
the layer takes them, with ``tests/_torch_parity.py``'s tolerances; and
the config dicts round-trip across the packages.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.ops import standard as j_ops
from deeplearning4j_tpu_torch.nn._network import layer_flops
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.ops import standard as t_ops

from _torch_parity import (TOL, assert_close, check_layer, check_round_trip,
                           pair, params_of, rel_l2, run_both, x64)

RNG = np.random.default_rng(7)
X_CNN = RNG.standard_normal((2, 7, 8, 3))
IT_CNN = JIT.convolutional(7, 8, 3)
X_SEQ = RNG.standard_normal((2, 9, 3))
IT_SEQ = JIT.recurrent(3, 9)
X_3D = RNG.standard_normal((2, 5, 6, 4, 3))
IT_3D = JIT.convolutional3d(5, 6, 4, 3)
DTYPES = ["float32", "float64", "bfloat16"]


# ------------------------------------------------------- separable conv
SEP_CASES = [
    dict(kernel_size=(3, 3), padding="same", depth_multiplier=2),
    dict(kernel_size=(3, 3), stride=(2, 2), padding="same",
         depth_multiplier=2),
    dict(kernel_size=(3, 2), padding=(1, 0), depth_multiplier=1),
    dict(kernel_size=(3, 3), padding=0, dilation=(2, 2), depth_multiplier=3,
         has_bias=False),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", SEP_CASES, ids=lambda kw: str(kw))
def test_separable_conv2d_matches_reference(kw, dtype):
    """n_in 3 and n_out 5 with multiplier 2 and 3: a grouped weight whose
    channel c, multiplier j did not land on output channel c·m + j would
    show in the output and in dW's gradient."""
    check_layer("SeparableConvolution2D", IT_CNN, X_CNN, dtype, n_out=5,
                activation="relu", **kw)


def test_depthwise_order_is_channel_major():
    """The depthwise op's output channel c·m + j is input channel c's
    filter j: with dW zero but for (c = 1, j = 1) only channel 3 of 6
    moves, and it equals the 2-D conv of channel 1 alone."""
    x = torch.tensor(X_CNN, dtype=torch.float32)
    dw = torch.zeros(3, 3, 3, 2)
    dw[:, :, 1, 1] = torch.randn(3, 3, generator=torch.Generator()
                                 .manual_seed(0))
    out = t_ops.depthwise_conv2d(x, dw, padding="SAME")
    moved = [c for c in range(6) if out[..., c].abs().max() > 0]
    assert moved == [3]
    alone = t_ops.conv2d(x[..., 1:2], dw[:, :, 1:2, 1:2], padding="SAME")
    torch.testing.assert_close(out[..., 3:4], alone)


# ---------------------------------------------------------- upsampling
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("interp,size", [("nearest", (2, 3)),
                                         ("bilinear", (2, 2)),
                                         ("bilinear", (3, 1))])
def test_upsampling2d_matches_reference(interp, size, dtype):
    check_layer("Upsampling2D", IT_CNN, X_CNN, dtype, size=size,
                interpolation=interp)


@pytest.mark.parametrize("out", [(14, 16), (4, 5), (11, 9)],
                         ids=["2x_up", "3/5_down", "odd"])
def test_resize_bilinear_matches_jax_image_resize(out):
    x = RNG.standard_normal((2, 7, 8, 3)).astype(np.float32)
    want = np.asarray(j_ops.resize_bilinear(jnp.asarray(x), out))
    got = t_ops.resize_bilinear(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("pad", [(1, 1), "SAME", ((0, 1), (1, 1))])
def test_padded_average_pooling_gradient_matches_reference(pad):
    """Padding not counted, forward and gradient (``jax.vjp``)."""
    x = RNG.standard_normal((2, 9, 10, 5)).astype(np.float32)
    jo, vjp = jax.vjp(lambda a: j_ops.avgpool2d(a, (3, 3), (1, 1), pad),
                      jnp.asarray(x))
    gy = RNG.standard_normal(jo.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(gy))
    tx = torch.tensor(x, requires_grad=True)
    to = t_ops.avgpool2d(tx, (3, 3), (1, 1), pad)
    (tg,) = torch.autograd.grad(to, tx, torch.tensor(gy))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)


# ------------------------------------------------------- deconvolution
DECONV_CASES = [
    dict(kernel_size=(3, 3), stride=(1, 1), padding="same"),
    dict(kernel_size=(3, 3), stride=(2, 2), padding="same"),
    dict(kernel_size=(4, 4), stride=(2, 2), padding="same"),
    dict(kernel_size=(2, 2), stride=(3, 3), padding="same"),
    dict(kernel_size=(3, 2), stride=(2, 3), padding="valid"),
    dict(kernel_size=(3, 3), stride=(2, 2), padding=1),
    dict(kernel_size=(4, 3), stride=(3, 2), padding=(1, 0)),
    dict(kernel_size=(3, 3), stride=(1, 1), padding=0, dilation=(2, 2)),
    dict(kernel_size=(3, 3), stride=(2, 2), padding="same",
         dilation=(2, 2)),
    dict(kernel_size=(3, 3), stride=(2, 2), padding="same",
         output_padding=(1, 1)),
    dict(kernel_size=(4, 4), stride=(3, 3), padding="same",
         output_padding=(2, 1)),
    dict(kernel_size=(3, 3), stride=(2, 2), padding=1,
         output_padding=(1, 0), has_bias=False),
    dict(kernel_size=(5, 4), stride=(2, 2), padding="valid",
         output_padding=(1, 1)),
]


@pytest.mark.parametrize("kw", DECONV_CASES, ids=lambda kw: str(kw))
def test_deconvolution2d_matches_reference(kw):
    """Odd and even kernels, strides 1-3, dilation 2, output_padding; the
    string paddings of a plain layer take lax's own rule, every other one
    the reference's explicit asymmetric pairs."""
    # the reference's output_type of a plain "valid" layer with a stride
    # above its kernel says (in − 1)·s + k where its apply, under lax's
    # VALID rule, gives in·s (ROADMAP queue 3)
    misstated = (kw["padding"] == "valid" and "output_padding" not in kw
                 and any(s > k for s, k in zip(kw["stride"],
                                               kw["kernel_size"])))
    check_layer("Deconvolution2D", IT_CNN, X_CNN, n_out=4,
                activation="tanh", type_is_shape=not misstated, **kw)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_deconvolution2d_other_types(dtype):
    check_layer("Deconvolution2D", IT_CNN, X_CNN, dtype, n_out=4,
                kernel_size=(3, 3), stride=(2, 2), padding="same",
                output_padding=(1, 1))


def test_deconv_pad_pairs_equal_reference():
    for kw in DECONV_CASES:
        args = (kw["kernel_size"], kw["stride"], kw.get("dilation", (1, 1)),
                kw["padding"] if isinstance(kw["padding"], str)
                else ((kw["padding"],) * 2 if isinstance(kw["padding"], int)
                      else kw["padding"]), kw.get("output_padding"))
        assert TL.deconv_pad_pairs(*args) == JL.deconv_pad_pairs(*args)


# ----------------------------------------------- structural, 1-D and 3-D
@pytest.mark.parametrize("kw", [dict(cropping=(1, 2, 0, 1)),
                                dict(cropping=1), dict(cropping=(2, 1))])
def test_cropping2d_matches_reference(kw):
    check_layer("Cropping2D", IT_CNN, X_CNN, **kw)


CONV1D_CASES = [dict(kernel_size=3, padding=0),
                dict(kernel_size=3, padding="same", stride=2),
                dict(kernel_size=2, padding="causal", dilation=2),
                dict(kernel_size=4, padding=1, stride=3, has_bias=False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", CONV1D_CASES, ids=lambda kw: str(kw))
def test_convolution1d_matches_reference(kw, dtype):
    check_layer("Convolution1DLayer", IT_SEQ, X_SEQ, dtype, n_out=4,
                activation="relu", **kw)


CONV3D_CASES = [dict(kernel_size=(3, 3, 2), padding="same"),
                dict(kernel_size=(2, 3, 3), stride=(2, 1, 2), padding="same"),
                dict(kernel_size=2, padding=1, dilation=(1, 2, 1)),
                dict(kernel_size=(3, 2, 2), padding=0, has_bias=False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", CONV3D_CASES, ids=lambda kw: str(kw))
def test_convolution3d_matches_reference(kw, dtype):
    check_layer("Convolution3D", IT_3D, X_3D, dtype, n_out=4, **kw)


def test_reshape_permute_repeat_match_reference():
    check_layer("ReshapeLayer", JIT.feed_forward(12),
                RNG.standard_normal((3, 12)), target_shape=(-1, 4))
    check_layer("ReshapeLayer", IT_CNN, X_CNN, target_shape=(56, 3))
    check_layer("PermuteLayer", JIT.recurrent(4, 5),
                RNG.standard_normal((3, 5, 4)), dims=(2, 1))
    check_layer("PermuteLayer", IT_CNN, X_CNN, dims=(3, 1, 2))
    check_layer("RepeatVectorLayer", JIT.feed_forward(4),
                RNG.standard_normal((3, 4)), n=3)


def test_permute_refuses_a_variable_length_as_reference():
    for mod, typ in ((JL, JIT), (TL, TIT)):
        with pytest.raises(ValueError, match="variable-length"):
            mod.PermuteLayer(dims=(2, 1)).output_type(typ.recurrent(4, -1))


# -------------------------------------------- layer norm and loss layers
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("it,x", [(IT_SEQ, X_SEQ), (IT_CNN, X_CNN)],
                         ids=["rnn", "cnn"])
def test_layer_normalization_matches_reference(it, x, dtype):
    """Inputs offset by 3 over 3 features: both sides' one-pass variance
    E[x²] − E[x]² cancels, which multiplies f32's rounding by about
    1 + mean²/var = 10, so the f32 rows are 10× the harness's."""
    j, t = pair("LayerNormalization", it, eps=1e-3)
    ref, port = run_both(j, t, params_of(j), x + 3.0, dtype)
    scale = 10 if dtype == "float32" else 1
    assert_close(ref, port, dtype, out_tol=scale * TOL[dtype][0],
                 grad_tol=scale * TOL[dtype][1])


def _loss_both(j, t, params, x, labels, mask=None, dtype="float32"):
    """(loss, param grads, input grad) of both sides' ``loss``, f64 numpy."""
    jl, tl = jnp.asarray, torch.tensor
    with x64(dtype):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        jp = {k: jnp.asarray(v, dt) for k, v in params.items()}
        m = None if mask is None else jl(mask, dt)
        val, (gp, gx) = jax.value_and_grad(
            lambda p, xx: j.loss(p, xx, jl(labels, dt), mask=m),
            argnums=(0, 1))(jp, jnp.asarray(x, dt))
        ref = (float(val), {k: np.asarray(g, np.float64)
                            for k, g in gp.items()}, np.asarray(gx))
    tdt = torch.float64 if dtype == "float64" else torch.float32
    tp = {k: tl(v, dtype=tdt, requires_grad=True) for k, v in params.items()}
    tx = tl(x, dtype=tdt, requires_grad=True)
    loss = t.loss(tp, tx, tl(labels, dtype=tdt),
                  mask=None if mask is None else tl(mask, dtype=tdt))
    g = torch.autograd.grad(loss, list(tp.values()) + [tx])
    return ref, (float(loss), {k: gi.double().numpy()
                               for k, gi in zip(tp, g)}, g[-1].double().numpy())


def _assert_loss_close(ref, port, dtype="float32"):
    tol = TOL[dtype]
    assert abs(port[0] - ref[0]) <= tol[0] * max(1.0, abs(ref[0]))
    for k in ref[1]:
        assert rel_l2(port[1][k], ref[1][k]) <= tol[1], k
    assert rel_l2(port[2], ref[2]) <= tol[1]


@pytest.mark.parametrize("loss,act,masked", [("mcxent", "softmax", False),
                                             ("mcxent", "softmax", True),
                                             ("mse", "identity", True),
                                             ("xent", "sigmoid", False)])
def test_cnn_loss_layer_matches_reference(loss, act, masked):
    j, t = pair("CnnLossLayer", IT_CNN, loss_function=loss, activation=act)
    x = RNG.standard_normal((2, 4, 5, 3))
    if loss == "mcxent":
        labels = np.eye(3)[RNG.integers(0, 3, (2, 4, 5))]
    else:
        labels = RNG.uniform(0, 1, (2, 4, 5, 3))
    mask = (RNG.uniform(size=(2, 4, 5, 1)) > 0.3).astype(np.float64) \
        if masked else None
    _assert_loss_close(*_loss_both(j, t, {}, x, labels, mask))
    ref, port = run_both(j, t, {}, x)
    assert_close(ref, port)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["split", "gradient_check", "masked"])
def test_center_loss_output_layer_matches_reference(mode, dtype):
    """The pull term with the centers detached, the update term with the
    features detached (or neither, under ``gradient_check``): the loss and
    the gradients of W, b, the centers and the input."""
    j, t = pair("CenterLossOutputLayer", JIT.feed_forward(6), n_out=4,
                activation="softmax", loss_function="mcxent", alpha=0.3,
                lambda_=0.2, gradient_check=(mode == "gradient_check"))
    params = params_of(j, 3)
    params["centers"] = RNG.standard_normal((4, 6))
    x = RNG.standard_normal((5, 6))
    labels = np.eye(4)[RNG.integers(0, 4, 5)]
    mask = np.array([1, 0, 1, 1, 0.0]) if mode == "masked" else None
    _assert_loss_close(*_loss_both(j, t, params, x, labels, mask, dtype),
                       dtype)


def test_center_loss_centers_are_no_weights():
    from deeplearning4j_tpu_torch.nn.weightnoise import is_weight_param
    layer = TL.CenterLossOutputLayer(n_in=6, n_out=4)
    layer.apply_global_defaults({})
    assert list(layer.param_shapes()) == ["W", "b", "centers"]
    assert not is_weight_param("centers", torch.zeros(4, 6), layer)
    assert is_weight_param("W", torch.zeros(6, 4), layer)
    p = layer.init_params(torch.Generator().manual_seed(0))
    assert bool((p["centers"] == 0).all())


def test_center_loss_net_excludes_the_centers_from_l2():
    """A net with l2 on its CenterLossOutputLayer: the penalty is W's
    alone, as in the reference."""
    from deeplearning4j_tpu.nn import graph as j_graph
    from deeplearning4j_tpu.nn.conf import configuration as j_cfg
    from deeplearning4j_tpu_torch.nn import graph as t_graph
    from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
    nets = []
    for cfg, mod, L in ((j_cfg, j_graph, JL), (t_cfg, t_graph, TL)):
        g = (cfg.NeuralNetConfiguration.builder().seed(1).graph_builder()
             .add_inputs("in").set_input_types(
                 (JIT if L is JL else TIT).feed_forward(6)))
        g.add_layer("out", L.CenterLossOutputLayer(
            n_out=4, activation="softmax", l2=0.5), "in")
        nets.append(g.set_outputs("out").build())
    params = {"out": params_of(TL.CenterLossOutputLayer(n_in=6, n_out=4), 5)}
    tnet = t_graph.ComputationGraph(nets[1], device="cpu").init()
    tnet.set_param_tree(params)
    pen = tnet._regularization_penalty(tnet.param_tree(),
                                       tnet._param_layers())
    assert float(pen) == pytest.approx(
        0.25 * float(np.sum(params["out"]["W"] ** 2)), rel=1e-6)


# ----------------------------------------------------- dropout, lambda
def test_spatial_dropout_drops_whole_maps():
    """In training each (example, channel) map is kept whole (scaled by
    1/p) or zeroed, at a share within 5σ of p; in inference the identity,
    as the reference."""
    layer = TL.SpatialDropoutLayer(dropout=0.6)
    x = torch.ones(64, 4, 5, 16)
    gen = torch.Generator().manual_seed(0)
    y, _ = layer.apply({}, x, training=True, gen=gen)
    per_map = y.permute(0, 3, 1, 2).reshape(64 * 16, -1)
    kept = per_map[:, 0] != 0
    assert bool((per_map[kept] == 1 / 0.6).all())
    assert bool((per_map[~kept] == 0).all())
    share, n = float(kept.float().mean()), kept.numel()
    assert abs(share - 0.6) <= 5 * math.sqrt(0.6 * 0.4 / n)
    j, t = pair("SpatialDropoutLayer", IT_CNN, dropout=0.6)
    ref, port = run_both(j, t, {}, X_CNN)
    assert_close(ref, port)
    from deeplearning4j_tpu_torch.nn.conf.dropout import GaussianDropout
    with pytest.raises(ValueError, match="channel-wise"):
        TL.SpatialDropoutLayer(dropout=GaussianDropout(0.5)).apply(
            {}, x, training=True, gen=gen)


def test_lambda_layer_revives_by_name():
    name = "double_it"
    TL.LAMBDA_REGISTRY.pop(name, None)
    layer = TL.LambdaLayer(name=name, fn=lambda a: 2 * a)
    assert TL.LAMBDA_REGISTRY[name][0] is layer.fn
    d = layer.to_dict()
    assert d == {"@layer": "LambdaLayer", "name": name}
    back = TL.layer_from_dict(d)
    x = torch.ones(2, 3)
    assert bool((back.apply({}, x)[0] == 2).all())
    with pytest.raises(ValueError, match="not registered"):
        TL.layer_from_dict({"@layer": "LambdaLayer", "name": "no_such_body"})
    JL.LAMBDA_REGISTRY.setdefault(name, (lambda a: 2 * a, None))
    j, t = JL.layer_from_dict(d), back
    ref, port = run_both(j, t, {}, X_SEQ)
    assert_close(ref, port)


# ------------------------------------------------------ configs, FLOPs
CONFIGS = [
    ("SeparableConvolution2D", IT_CNN, dict(n_out=5, depth_multiplier=2,
                                            padding="same")),
    ("Upsampling2D", IT_CNN, dict(size=2, interpolation="bilinear")),
    ("CenterLossOutputLayer", JIT.feed_forward(6), dict(n_out=3, alpha=0.1)),
    ("SpatialDropoutLayer", IT_CNN, dict(dropout=0.5)),
    ("ReshapeLayer", JIT.feed_forward(12), dict(target_shape=(3, 4))),
    ("PermuteLayer", IT_CNN, dict(dims=(2, 1, 3))),
    ("RepeatVectorLayer", JIT.feed_forward(4), dict(n=2)),
    ("Deconvolution2D", IT_CNN, dict(n_out=4, stride=2, padding="same",
                                     output_padding=(1, 1))),
    ("Cropping2D", IT_CNN, dict(cropping=(1, 0, 2, 1))),
    ("Convolution1DLayer", IT_SEQ, dict(n_out=4, padding="causal")),
    ("Convolution3D", IT_3D, dict(n_out=4, kernel_size=2)),
    ("CnnLossLayer", IT_CNN, dict(loss_function="mse")),
    ("LayerNormalization", IT_SEQ, dict(eps=1e-5)),
]


@pytest.mark.parametrize("kind,it,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_config_round_trips(kind, it, kw):
    j, t = pair(kind, it, **kw)
    assert list(t.param_shapes().items()) == list(j.param_shapes().items())
    check_round_trip(j, t)
    t.weight_noise = None
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
    t.weight_noise = DropConnect(0.7)
    back = TL.layer_from_dict(t.to_dict())
    assert back.weight_noise == DropConnect(0.7)
    assert JL.layer_from_dict(t.to_dict()).weight_noise.to_dict() == \
        t.weight_noise.to_dict()


def test_conv_like_layer_flops():
    """2 a multiply-add: a separable layer its depthwise and 1×1 products,
    a transposed one each input point's window, the 1-D and 3-D
    convolutions each output point's window."""
    it = TIT.convolutional(8, 8, 3)
    sep = TL.SeparableConvolution2D(n_in=3, n_out=5, depth_multiplier=2,
                                    padding="same", stride=(2, 2))
    assert layer_flops(sep, it, 2) == 2 * 2 * 4 * 4 * (9 * 6 + 6 * 5)
    de = TL.Deconvolution2D(n_in=3, n_out=4, kernel_size=(3, 3),
                            stride=(2, 2), padding="same")
    assert layer_flops(de, it, 2) == 2 * 2 * 8 * 8 * 9 * 3 * 4
    c1 = TL.Convolution1DLayer(n_in=3, n_out=4, kernel_size=3, padding=0)
    assert layer_flops(c1, TIT.recurrent(3, 9), 2) == 2 * 2 * 7 * 3 * 3 * 4
    c3 = TL.Convolution3D(n_in=3, n_out=4, kernel_size=2, padding=0)
    assert layer_flops(c3, TIT.convolutional3d(5, 6, 4, 3), 2) == \
        2 * 2 * 4 * 5 * 3 * 8 * 3 * 4
    conv = TL.ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 3),
                               padding="same")
    assert layer_flops(conv, it, 2) == 2 * 2 * 64 * 9 * 3 * 4
