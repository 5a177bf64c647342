"""The port's YOLOv2 head (``nn/conf/objdetect.py``) against the JAX
package's, on the CPU at small sizes: the box IoUs, the decode, the loss
and its gradient (random activations and labels, and a planted tie at
every max and min and at the anchors' argmax), detections and NMS on the
same activations, the config, and a TinyYOLO in miniature (32², 2
classes) through three Adam fits against the JAX net.

Tolerances: f32 loss relative 1e-5, gradients relative L2 1e-5 (rms
floor 1e-2); f64 1e-12 / 1e-10: the same arithmetic, sums in another
order. Detections: the same objects, coordinates and confidences within
1e-5. The miniature fit: each step's loss relative 1e-4, the init
gradients' worst leaf relative L2 1e-2, every leaf's displacement 1e-2
(PERF.md's tolerance table): its last BatchNormalization layers normalize
a 1x1 grid over a batch of 4, which turns f32 rounding into ~1e-3 of the
worst gradient leaf (CPU reading 2.0e-3 over the three steps); at SGD
1e-5 three steps stay where a displacement is proportional to its
gradient, where at 1e-3 (SGD or the zoo's Adam) the loss jumps from 8 to
38-189 and two f32 runs part.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf import objdetect as J
from deeplearning4j_tpu.nn.conf.layers import layer_from_dict as j_from_dict
from deeplearning4j_tpu_torch.nn.conf import objdetect as T
from deeplearning4j_tpu_torch.nn.conf.layers import (
    layer_from_dict as t_from_dict)

from _torch_parity import rel_l2, x64

PRIORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38))
N, H, W, C = 3, 4, 5, 4
TOL = {"float32": (1e-5, 1e-5), "float64": (1e-12, 1e-10)}


def _labels(rng, n=N, h=H, w=W, c=C, share=0.4):
    """(N, H, W, 4 + C): in a share of the cells a box of 0.3-4 cells
    around a point in the cell, its class one-hot; zero elsewhere."""
    lab = np.zeros((n, h, w, 4 + c))
    for ex in range(n):
        for i in range(h):
            for j in range(w):
                if rng.uniform() > share:
                    continue
                cx, cy = j + rng.uniform(), i + rng.uniform()
                bw, bh = rng.uniform(0.3, 4.0, 2)
                lab[ex, i, j, :4] = (cx - bw / 2, cy - bh / 2,
                                     cx + bw / 2, cy + bh / 2)
                lab[ex, i, j, 4 + rng.integers(0, c)] = 1.0
    return lab


def _layers(priors=PRIORS, **kw):
    return J.Yolo2OutputLayer(boxes=priors, **kw), \
        T.Yolo2OutputLayer(boxes=priors, **kw)


def _loss_both(j, t, x, labels, dtype):
    with x64(dtype):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        val, g = jax.jit(jax.value_and_grad(
            lambda a, lab: j.loss({}, a, lab)))(jnp.asarray(x, dt),
                                                jnp.asarray(labels, dt))
        ref = (float(val), np.asarray(g, np.float64))
    tdt = getattr(torch, dtype)
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    loss = t.loss({}, tx, torch.tensor(labels, dtype=tdt))
    (g,) = torch.autograd.grad(loss, tx)
    return ref, (float(loss), g.double().numpy())


def _assert_loss(ref, port, dtype):
    tol = TOL[dtype]
    assert abs(port[0] - ref[0]) <= tol[0] * abs(ref[0]), (port[0], ref[0])
    assert rel_l2(port[1], ref[1]) <= tol[1], rel_l2(port[1], ref[1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_match_reference(seed, dtype):
    rng = np.random.default_rng(seed)
    j, t = _layers(lambda_coord=5.0, lambda_no_obj=0.5)
    x = rng.standard_normal((N, H, W, len(PRIORS) * (5 + C)))
    _assert_loss(*_loss_both(j, t, x, _labels(rng), dtype), dtype)


def test_loss_of_other_weights_matches_reference():
    rng = np.random.default_rng(4)
    j, t = _layers(lambda_coord=1.0, lambda_no_obj=2.0)
    x = 2 * rng.standard_normal((N, H, W, len(PRIORS) * (5 + C)))
    _assert_loss(*_loss_both(j, t, x, _labels(rng, share=0.8), "float32"),
                 "float32")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_planted_ties_take_the_reference_gradient(dtype):
    """Anchor 0 of size 1e-9 with tw = th = 0 predicts a box of exactly
    1e-9, where sqrt(max(wh, 1e-9)) ties; zero-area labels make every
    prior's IoU 0, so argmax ties and takes anchor 0; and their overlap
    with the predicted box is max(0, 0). At each tie ``jnp.maximum`` sends
    half the gradient each way and so must the port (a ``clamp`` would
    send all of it one way)."""
    priors = ((1e-9, 1e-9),) + PRIORS
    j, t = _layers(priors)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, H, W, len(priors), 5 + C))
    labels = _labels(rng, share=0.6)
    obj = labels[..., 4:].sum(-1) > 0
    zero_area = obj & (rng.uniform(size=obj.shape) < 0.5)
    centre = 0.5 * (labels[..., 0:2] + labels[..., 2:4])
    labels[..., 0:2] = np.where(zero_area[..., None], centre, labels[..., 0:2])
    labels[..., 2:4] = np.where(zero_area[..., None], centre, labels[..., 2:4])
    x[..., 0, 2:4] = 0.0                       # tw = th = 0 on anchor 0
    x = x.reshape(N, H, W, -1)
    with torch.no_grad():
        _, wh, _, _ = t.activate_detections(torch.tensor(x, dtype=getattr(
            torch, dtype)))
    assert bool((wh[..., 0, :] == torch.tensor(1e-9, dtype=wh.dtype)).all())
    ref, port = _loss_both(j, t, x, labels, dtype)
    _assert_loss(ref, port, dtype)
    # the tw gradient of anchor 0 at a zero-area object cell is the tied
    # maximum's half: nonzero on both sides
    g = port[1].reshape(N, H, W, len(priors), 5 + C)[..., 0, 2]
    assert np.abs(g[zero_area]).max() > 0


def test_box_ious_match_reference():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 4, (50, 4))
    b = rng.uniform(0, 4, (50, 4))
    a[:10, 2:] = a[:10, :2]                     # zero-area boxes
    b[10:20] = a[10:20]                          # identical boxes
    got = T.box_iou_xyxy(torch.tensor(a), torch.tensor(b)).numpy()
    with x64("float64"):
        want = np.asarray(J.box_iou_xyxy(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    wh1, wh2 = rng.uniform(0, 3, (20, 2)), rng.uniform(0, 3, (20, 2))
    with x64("float64"):
        want = np.asarray(J._box_iou_wh(jnp.asarray(wh1), jnp.asarray(wh2)))
    got = T._box_iou_wh(torch.tensor(wh1), torch.tensor(wh2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_decode_matches_reference():
    rng = np.random.default_rng(6)
    j, t = _layers()
    x = rng.standard_normal((N, H, W, len(PRIORS) * (5 + C))).astype(
        np.float32)
    want = j.activate_detections(jnp.asarray(x))
    got = t.activate_detections(torch.tensor(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_detections_and_nms_match_reference(threshold):
    """The same activations give the same objects, in the same order, and
    NMS keeps the same ones."""
    rng = np.random.default_rng(7)
    j, t = _layers()
    x = (1.5 * rng.standard_normal((N, H, W, len(PRIORS) * (5 + C)))
         ).astype(np.float32)
    want = J.get_predicted_objects(j, x, threshold=threshold)
    got = T.get_predicted_objects(t, torch.tensor(x), threshold=threshold)
    assert len(got) == len(want) > 0

    def fields(o):
        return (o.example, o.predicted_class)

    def values(o):
        return (o.center_x, o.center_y, o.width, o.height, o.confidence)

    assert [fields(o) for o in got] == [fields(o) for o in want]
    np.testing.assert_allclose([values(o) for o in got],
                               [values(o) for o in want], rtol=1e-5,
                               atol=1e-5)
    for iou in (0.2, 0.45):
        kept_j = J.non_max_suppression(want, iou)
        kept_t = T.non_max_suppression(got, iou)
        assert len(kept_t) == len(kept_j)
        np.testing.assert_allclose([values(o) for o in kept_t],
                                   [values(o) for o in kept_j], rtol=1e-5,
                                   atol=1e-5)
        assert len(kept_t) < len(got) or iou == 0.45
    obj = got[0]
    assert obj.top_left() == (obj.center_x - obj.width / 2,
                              obj.center_y - obj.height / 2)


def test_config_round_trips():
    j, t = _layers(lambda_coord=2.0)
    assert t.to_dict() == j.to_dict()
    assert t_from_dict(j.to_dict()).to_dict() == t.to_dict()
    assert j_from_dict(t.to_dict()).to_dict() == j.to_dict()
    assert t_from_dict(j.to_dict()).boxes == tuple(
        tuple(float(v) for v in b) for b in PRIORS)


# --------------------------------------------------- TinyYOLO in miniature
def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_tiny_yolo_in_miniature_fits_as_the_reference():
    """TinyYOLO at 32² (a 1x1 grid), 2 classes, batch 4, SGD(1e-5): the
    loss and gradients at init, then three fits on one batch, each step's
    loss and every leaf's displacement, and the BN running statistics."""
    from deeplearning4j_tpu.models import zoo as j_zoo
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JG
    from deeplearning4j_tpu_torch.models import zoo as t_zoo
    from deeplearning4j_tpu_torch.nn.params import tree_to_numpy
    from deeplearning4j_tpu.optim.updaters import Sgd as JSgd
    from deeplearning4j_tpu_torch.optim.updaters import Sgd as TSgd
    kw = dict(num_classes=2, input_shape=(32, 32, 3))
    ref = JG(j_zoo.TinyYOLO(updater=JSgd(1e-5), **kw).conf()).init()
    net = t_zoo.TinyYOLO(updater=TSgd(1e-5), **kw).init_model(device="cpu")
    net.set_param_tree(_np_tree(ref.param_tree()))
    net.set_state_tree(_np_tree(ref.state_tree()))
    assert net.numParams() == ref.numParams()
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = _labels(rng, n=4, h=1, w=1, c=2, share=1.0).astype(np.float32)
    (j_score, _), j_grads = jax.jit(jax.value_and_grad(
        ref._loss_fn, has_aux=True), static_argnums=(4, 5, 6))(
        ref.param_tree(), ref.state_tree(), (jnp.asarray(x),),
        (jnp.asarray(y),), None, None, None)
    j_score = float(j_score)
    t_score, t_grads = net.computeGradientAndScore(x, y)
    assert abs(t_score - j_score) <= 1e-5 * abs(j_score)
    t_grads = tree_to_numpy(t_grads)
    worst = max(rel_l2(t_grads[k][p], np.asarray(j_grads[k][p]))
                for k in j_grads for p in j_grads[k])
    assert worst <= 1e-2, worst
    before = tree_to_numpy(net.param_tree())
    j_loss, t_loss = [], []
    for _ in range(3):
        ref.fit(x, y)
        net.fit(x, y)
        j_loss.append(ref.score())
        t_loss.append(net.score())
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    jp, tp = _np_tree(ref.param_tree()), tree_to_numpy(net.param_tree())
    for k in jp:
        for p in jp[k]:
            assert rel_l2(tp[k][p] - before[k][p], jp[k][p] - before[k][p],
                          rms_floor=1e-6) <= 1e-2, (k, p)
    js, ts = _np_tree(ref.state_tree()), tree_to_numpy(net.state_tree())
    for k in js:
        for p in js[k]:
            np.testing.assert_allclose(ts[k][p], js[k][p], rtol=1e-4,
                                       atol=1e-5)
    assert math.isfinite(t_loss[-1]) and t_loss[-1] < t_loss[0]
