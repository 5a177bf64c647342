"""The last layers of the port on the card against the same calls on the
CPU: ``SeparableConvolution2D`` (cuDNN's grouped convolution, then a 1x1
one), ``Deconvolution2D`` (``F.conv_transpose2d`` cropped to the
reference's asymmetric pads) and the YOLOv2 loss, each with its
gradients; and a ``FrozenLayer``'s params bit-equal after a step on the
card.

Marked ``gpu``: without CUDA every test here skips. This file imports
neither JAX nor the JAX package (the CPU tests hold the CPU side to the
reference)::

    python -m pytest --noconftest -m gpu tests/test_torch_layers_gpu.py

Tolerances: f32 relative L2 1e-5 (cuDNN's and the CPU's f32 sums in
another order; TF32 is off), bf16 2e-2 for outputs and 5e-2 for
gradients (the parity harness's bf16 rows).
"""
import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 5e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layers' cuDNN routes run on "
                    "the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _both(layer, params, x, dtype):
    """(output, grads of params and input) on the card and on the CPU."""
    gen = torch.Generator().manual_seed(1)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev, dtype).requires_grad_(True)
             for k, v in params.items()}
        xx = x.to(dev, dtype).requires_grad_(True)
        y, _ = layer.apply(p, xx)
        gy = torch.randn(y.shape, generator=gen).to(dev, dtype)
        gen.manual_seed(1)
        g = torch.autograd.grad(y, list(p.values()) + [xx], gy)
        out[dev] = (y.detach(), g)
    return out


def _layer(kind, it, **kw):
    layer = getattr(TL, kind)(**kw)
    layer.apply_global_defaults({})
    layer.set_n_in(it)
    return layer


def _params(layer):
    gen = torch.Generator().manual_seed(0)
    return {k: torch.randn(s, generator=gen) / math.sqrt(max(
        math.prod(s[:-1]), 1)) for k, s in layer.param_shapes().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_separable_conv2d_card_vs_cpu(cuda, dtype, stride):
    it = InputType.convolutional(38, 38, 32)
    layer = _layer("SeparableConvolution2D", it, n_out=48,
                   depth_multiplier=2, kernel_size=(3, 3),
                   stride=(stride, stride), padding="same",
                   activation="relu")
    x = torch.randn(4, 38, 38, 32, generator=torch.Generator().manual_seed(2))
    r = _both(layer, _params(layer), x, dtype)
    out_tol, grad_tol = TOL[dtype]
    assert _rel(r["cuda"][0], r["cpu"][0]) <= out_tol
    for a, b in zip(r["cuda"][1], r["cpu"][1]):
        assert _rel(a, b) <= grad_tol


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(kernel_size=(3, 3), stride=(2, 2), padding="same",
         output_padding=(1, 1)),
    dict(kernel_size=(4, 4), stride=(2, 2), padding="same"),
    dict(kernel_size=(3, 2), stride=(3, 2), padding="valid"),
    dict(kernel_size=(3, 3), stride=(2, 2), padding=1, dilation=(2, 2))],
    ids=lambda kw: str(kw))
def test_deconvolution2d_card_vs_cpu(cuda, kw):
    it = InputType.convolutional(17, 20, 24)
    layer = _layer("Deconvolution2D", it, n_out=16, activation="tanh", **kw)
    x = torch.randn(4, 17, 20, 24, generator=torch.Generator().manual_seed(3))
    r = _both(layer, _params(layer), x, torch.float32)
    assert r["cuda"][0].shape == r["cpu"][0].shape
    assert _rel(r["cuda"][0], r["cpu"][0]) <= 1e-5
    for a, b in zip(r["cuda"][1], r["cpu"][1]):
        assert _rel(a, b) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kw", [
    ("SubsamplingLayer", dict(pooling_type="avg", kernel_size=(3, 3),
                              stride=(1, 1), padding=1)),
    ("SubsamplingLayer", dict(pooling_type="avg", kernel_size=(3, 3),
                              stride=(2, 2), padding="same")),
    ("SubsamplingLayer", dict(pooling_type="max", kernel_size=(3, 3),
                              stride=(2, 2), padding=1)),
    ("Subsampling3DLayer", dict(pooling_type="avg", kernel_size=(2, 3, 3),
                                stride=(1, 2, 1), padding="same"))],
    ids=["avg_3x3_s1_p1", "avg_same_s2", "max_3x3_s2_p1", "avg3d_same"])
def test_padded_pooling_card_vs_cpu(cuda, kind, kw):
    """A padded pooling's gradient on the card is the CPU's (NASNet's
    3x3/1 average pools: ``F.avg_pool2d(count_include_pad=False)``'s
    backward over a channels-last input read 104 % off it)."""
    three = kind == "Subsampling3DLayer"
    shape = (4, 6, 28, 28, 44) if three else (4, 56, 56, 44)
    it = (InputType.convolutional3d(*shape[1:]) if three
          else InputType.convolutional(*shape[1:]))
    layer = _layer(kind, it, **kw)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    r = _both(layer, {}, x, torch.float32)
    assert _rel(r["cuda"][0], r["cpu"][0]) <= 1e-6
    assert _rel(r["cuda"][1][-1], r["cpu"][1][-1]) <= 1e-6


def _yolo_labels(n, g, c, seed=4):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, g, g, 4 + c), np.float32)
    for ex in range(n):
        for cell in rng.choice(g * g, 3, replace=False):
            i, j = divmod(int(cell), g)
            cx, cy = j + rng.uniform(), i + rng.uniform()
            w, h = rng.uniform(0.5, 6, 2)
            y[ex, i, j, :4] = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
            y[ex, i, j, 4 + rng.integers(0, c)] = 1.0
    return torch.tensor(y)


@pytest.mark.gpu
def test_yolo_loss_card_vs_cpu(cuda):
    """YOLO2's head at 13 × 13, 5 priors, 20 classes, batch 16: the loss
    and its gradient."""
    from deeplearning4j_tpu_torch.models.zoo.darknet import _YOLO2_PRIORS
    layer = Yolo2OutputLayer(boxes=_YOLO2_PRIORS)
    x = torch.randn(16, 13, 13, 125, generator=torch.Generator()
                    .manual_seed(5))
    y = _yolo_labels(16, 13, 20)
    out = {}
    for dev in ("cuda", "cpu"):
        xx = x.to(dev).requires_grad_(True)
        loss = layer.loss({}, xx, y.to(dev))
        (g,) = torch.autograd.grad(loss, xx)
        out[dev] = (float(loss), g)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    assert _rel(out["cuda"][1], out["cpu"][1]) <= 1e-5


@pytest.mark.gpu
def test_frozen_layer_params_bit_equal_after_a_step(cuda):
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optim.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
            .list()
            .layer(TL.DenseLayer(n_out=64, activation="relu"))
            .layer(TL.FrozenLayer.wrap(TL.DenseLayer(n_in=64, n_out=32,
                                                     activation="relu")))
            .layer(TL.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(InputType.feed_forward(100)).build())
    net = MultiLayerNetwork(conf).init()
    assert net.param_tree()["1"]["W"].is_cuda
    frozen = {k: v.clone() for k, v in net.param_tree()["1"].items()}
    first = net.param_tree()["0"]["W"].clone()
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(32, 100, generator=gen)
    y = torch.eye(10)[torch.randint(0, 10, (32,), generator=gen)]
    for _ in range(2):
        net.fit(x, y)
    for k, v in net.param_tree()["1"].items():
        assert torch.equal(v, frozen[k])
    assert torch.equal(net.param_tree()["0"]["W"], first)
    assert not torch.equal(net.param_tree()["2"]["W"].cpu(),
                           torch.zeros_like(net.param_tree()["2"]["W"].cpu()))
