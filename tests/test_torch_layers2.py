"""The port's ``nn/conf/layers2.py`` (all 22 classes) against the JAX
package's, on the CPU at small sizes: the convolutions (depthwise, locally
connected 1-D/2-D, transposed 3-D, separable 1-D), the 1-D/3-D cropping,
padding, upsampling and pooling layers, PReLU, the masking pair, the
freeze pair, the capsule trio and ConvLSTM2D.

Each case holds the output and the gradients of every param and of the
input to the reference's with ``tests/_torch_parity.py``'s tolerances, in
f32 and, where the layer takes them, f64 and bf16; masks where the layer
takes one; the config dicts round-trip across the packages. A
``FrozenLayer``'s params stay bit-equal through a network's step.
"""
import numpy as np
import pytest

import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu_torch.nn._network import layer_flops
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT

from _torch_parity import (assert_close, check_layer, check_round_trip, pair,
                           params_of, run_both)

RNG = np.random.default_rng(11)
X_CNN = RNG.standard_normal((2, 7, 8, 3))
IT_CNN = JIT.convolutional(7, 8, 3)
X_SEQ = RNG.standard_normal((2, 9, 3))
IT_SEQ = JIT.recurrent(3, 9)
X_3D = RNG.standard_normal((2, 5, 6, 4, 3))
IT_3D = JIT.convolutional3d(5, 6, 4, 3)
X_CONVSEQ = RNG.standard_normal((2, 4, 6, 5, 3))      # (N, T, H, W, C)
DTYPES = ["float32", "float64", "bfloat16"]

CASES = [
    ("DepthwiseConvolution2D", IT_CNN, X_CNN,
     dict(depth_multiplier=2, padding="same")),
    ("DepthwiseConvolution2D", IT_CNN, X_CNN,
     dict(depth_multiplier=3, kernel_size=(2, 3), stride=(2, 1), padding=1,
          has_bias=False)),
    ("LocallyConnected2D", IT_CNN, X_CNN,
     dict(n_out=4, kernel_size=(2, 3))),
    ("LocallyConnected2D", IT_CNN, X_CNN,
     dict(n_out=4, kernel_size=(3, 3), stride=(2, 2), activation="tanh")),
    ("LocallyConnected1D", IT_SEQ, X_SEQ, dict(n_out=4, kernel_size=3)),
    ("LocallyConnected1D", IT_SEQ, X_SEQ,
     dict(n_out=4, kernel_size=2, stride=2, has_bias=False)),
    ("Deconvolution3D", IT_3D, X_3D,
     dict(n_out=4, kernel_size=(3, 2, 3), stride=(2, 1, 2),
          padding="same")),
    ("Deconvolution3D", IT_3D, X_3D,
     dict(n_out=4, kernel_size=2, stride=2, padding=0,
          output_padding=(1, 0, 1))),
    ("Deconvolution3D", IT_3D, X_3D,
     dict(n_out=2, kernel_size=3, stride=1, padding="same",
          dilation=(2, 1, 1))),
    ("SeparableConvolution1D", IT_SEQ, X_SEQ,
     dict(n_out=5, kernel_size=3, padding="same", depth_multiplier=2)),
    ("SeparableConvolution1D", IT_SEQ, X_SEQ,
     dict(n_out=4, kernel_size=2, padding="causal", dilation=2)),
    ("SeparableConvolution1D", IT_SEQ, X_SEQ,
     dict(n_out=4, kernel_size=3, padding=1, stride=2)),
    ("PReLULayer", IT_CNN, X_CNN, dict()),
    ("PReLULayer", JIT.feed_forward(5), RNG.standard_normal((4, 5)),
     dict(alpha_init=0.2)),
    ("Cropping1D", IT_SEQ, X_SEQ, dict(cropping=(2, 1))),
    ("Cropping3D", IT_3D, X_3D, dict(cropping=(1, 0, 2, 1, 0, 1))),
    ("ZeroPadding1DLayer", IT_SEQ, X_SEQ, dict(padding=(1, 2))),
    ("ZeroPadding3DLayer", IT_3D, X_3D, dict(padding=(1, 0, 0, 2, 1, 1))),
    ("Upsampling1D", IT_SEQ, X_SEQ, dict(size=3)),
    ("Upsampling3D", IT_3D, X_3D, dict(size=(2, 1, 3))),
    ("Subsampling1DLayer", IT_SEQ, X_SEQ,
     dict(pooling_type="max", kernel_size=3, stride=2)),
    ("Subsampling1DLayer", IT_SEQ, X_SEQ,
     dict(pooling_type="avg", kernel_size=2, stride=2, padding="same")),
    ("Subsampling3DLayer", IT_3D, X_3D,
     dict(pooling_type="max", kernel_size=2, stride=(2, 2, 1),
          padding="same")),
    ("Subsampling3DLayer", IT_3D, X_3D,
     dict(pooling_type="avg", kernel_size=(2, 3, 2), stride=2,
          padding="same")),
    ("PrimaryCapsules", IT_CNN, X_CNN,
     dict(capsule_dimensions=4, channels=2, kernel_size=3, stride=2)),
    ("CapsuleLayer", JIT.recurrent(4, 6), RNG.standard_normal((2, 6, 4)),
     dict(capsules=3, capsule_dimensions=5, routings=3)),
    ("CapsuleStrengthLayer", JIT.recurrent(4, 6),
     RNG.standard_normal((2, 6, 4)), dict()),
    ("ConvLSTM2D", JIT.convolutional3d(4, 6, 5, 3), X_CONVSEQ,
     dict(n_out=2, padding="same")),
    ("ConvLSTM2D", JIT.convolutional3d(4, 6, 5, 3), X_CONVSEQ,
     dict(n_out=2, padding="valid", return_sequences=True,
          recurrent_activation="hard_sigmoid")),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


@pytest.mark.parametrize("kind,it,x,kw", CASES, ids=IDS)
def test_layer_matches_reference(kind, it, x, kw):
    check_layer(kind, it, x, **kw)


# the layers with products (and a 1-D/3-D pooling each) in f64 and bf16
TYPED = [c for c in CASES if c[0] in (
    "DepthwiseConvolution2D", "LocallyConnected2D", "Deconvolution3D",
    "SeparableConvolution1D", "Subsampling3DLayer", "CapsuleLayer",
    "ConvLSTM2D")]
TYPED = [c for i, c in enumerate(TYPED)
         if c[0] != TYPED[i - 1][0] or i == 0]


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("kind,it,x,kw", TYPED, ids=[c[0] for c in TYPED])
def test_layer_matches_reference_in_other_types(kind, it, x, kw, dtype):
    check_layer(kind, it, x, dtype, **kw)


@pytest.mark.parametrize("kind,it,x,kw", CASES, ids=IDS)
def test_config_round_trips(kind, it, x, kw):
    j, t = pair(kind, it, **kw)
    check_round_trip(j, t)


# ------------------------------------------------------------- masks
MASK = np.array([[1, 1, 1, 0, 0, 1, 1, 1, 1],
                 [1, 1, 1, 1, 1, 1, 0, 0, 0]], np.float64)


def test_mask_layer_matches_reference():
    check_layer("MaskLayer", IT_SEQ, X_SEQ, mask=MASK)
    check_layer("MaskLayer", IT_SEQ, X_SEQ)


@pytest.mark.parametrize("inner", ["SimpleRnn", "LSTM", "DenseLayer"])
def test_mask_zero_layer_matches_reference(inner):
    """Steps whose features are all the mask value (0) are masked for the
    wrapped layer (a recurrent one freezes its carry there); a layer that
    takes no mask is handed none."""
    from deeplearning4j_tpu.nn.conf import layers as JL
    x = X_SEQ.copy()
    x[0, 3:5] = 0.0
    x[1, 6:] = 0.0
    kw = dict(n_in=3, n_out=4, activation="tanh")
    j = JL.MaskZeroLayer.wrap(getattr(JL, inner)(**kw))
    t = TL.MaskZeroLayer.wrap(getattr(TL, inner)(**kw))
    for layer, typ in ((j, JIT), (t, TIT)):
        layer.apply_global_defaults({})
        layer.set_n_in(typ.recurrent(3, 9))
    ref, port = run_both(j, t, params_of(j, 2), x)
    assert_close(ref, port)
    ref, port = run_both(j, t, params_of(j, 2), x, mask=MASK)
    assert_close(ref, port)
    check_round_trip(j, t)


# ------------------------------------------------------------ freezing
@pytest.mark.parametrize("kind", ["FrozenLayer", "FrozenLayerWithBackprop"])
def test_frozen_layers_match_reference(kind):
    """The param gradients are zero on both sides; the input's too for a
    FrozenLayer, the inner layer's for a FrozenLayerWithBackprop."""
    from deeplearning4j_tpu.nn.conf import layers as JL
    j = getattr(JL, kind).wrap(JL.DenseLayer(n_in=3, n_out=4,
                                             activation="relu"))
    t = getattr(TL, kind).wrap(TL.DenseLayer(n_in=3, n_out=4,
                                             activation="relu"))
    for layer in (j, t):
        layer.apply_global_defaults({})
    x = RNG.standard_normal((5, 3))
    ref, port = run_both(j, t, params_of(j, 4), x)
    assert_close(ref, port)
    assert all(not g.any() for g in port[1].values())
    assert (not port[2].any()) == (kind == "FrozenLayer")
    check_round_trip(j, t)


def _frozen_net(cls):
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
            .list()
            .layer(TL.DenseLayer(n_out=8, activation="tanh"))
            .layer(cls.wrap(TL.DenseLayer(n_in=8, n_out=6, activation="relu")))
            .layer(TL.OutputLayer(n_out=4, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(TIT.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("cls", [TL.FrozenLayer, TL.FrozenLayerWithBackprop])
def test_frozen_params_stay_bit_equal_through_fit(cls):
    """Three Adam steps: the frozen layer's params are bit-equal to
    init, the layer after it moves, and the layer before it moves only
    when the gradient passes through (FrozenLayerWithBackprop)."""
    net = _frozen_net(cls)
    before = {k: {p: v.clone() for p, v in d.items()}
              for k, d in net.param_tree().items()}
    x = RNG.standard_normal((6, 5)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[RNG.integers(0, 4, 6)]
    for _ in range(3):
        net.fit(x, y)
    after = net.param_tree()
    for p in before["1"]:
        assert torch.equal(after["1"][p], before["1"][p])
    assert not torch.equal(after["2"]["W"], before["2"]["W"])
    moved = not torch.equal(after["0"]["W"], before["0"]["W"])
    assert moved == (cls is TL.FrozenLayerWithBackprop)


def test_capsule_and_conv_lstm_flops():
    caps = TL.CapsuleLayer(capsules=3, capsule_dimensions=5, routings=3,
                           input_capsules=6, input_capsule_dimensions=4)
    assert layer_flops(caps, TIT.recurrent(4, 6), 2) == \
        2 * 2 * 6 * 3 * 5 * (4 + 2 * 3 - 1)
    cl = TL.ConvLSTM2D(n_in=3, n_out=2, padding="same")
    assert layer_flops(cl, TIT.convolutional3d(4, 6, 5, 3), 2) == \
        2 * 2 * 4 * 6 * 5 * 9 * (3 + 2) * 4 * 2
    dw = TL.DepthwiseConvolution2D(n_in=3, depth_multiplier=2,
                                   padding="same")
    dw.set_n_in(TIT.convolutional(8, 8, 3))
    assert layer_flops(dw, TIT.convolutional(8, 8, 3), 1) == \
        2 * 64 * 9 * 6
    frozen = TL.FrozenLayer.wrap(TL.DenseLayer(n_in=8, n_out=6))
    assert layer_flops(frozen, TIT.feed_forward(8), 2) == 2 * 2 * 8 * 6
