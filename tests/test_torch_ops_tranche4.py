"""The port's ``ops/tranche4.py`` against the JAX package's, on the CPU:
its morphology, quantization, updater, index-reduce, t-SNE and straggler
ops (``test_torch_ops_tranche4_bp`` holds the ``_bp`` ops and the
derivative transforms). One parametrised sweep runs each op in both
registries on the same seeded numpy inputs (``_torch_ops_parity`` states
the tolerances); the drawing ops are held by their support, moments and
seed reproducibility; ``nonzero_coords``, whose shape depends on the
data, exactly as the reference returns it.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from _torch_ops_parity import EW, RED, case_ids, check_case, ids, n, u
from deeplearning4j_tpu.ops import registry as JR
from deeplearning4j_tpu_torch.ops import registry as TR


CASES = [
    ("erosion2d", "Erosion2D", lambda r: [n(r, 1, 6, 6, 2), n(r, 3, 2, 2)],
     {"strides": (2, 1)}, EW),
    ("quantize", "quantize_v2", lambda r: [
        n(r, 10) * 2], {"min_range": -2.0, "max_range": 3.0}, EW),
    ("quantize_narrow", "Quantize", lambda r: [n(r, 10) * 2],
     {"min_range": -2.0, "max_range": 3.0, "num_bits": 4,
      "narrow_range": True}, EW),
    ("dequantize", "Dequantize", lambda r: [ids(r, 255, 10)],
     {"min_range": -2.0, "max_range": 3.0}, EW),
    ("bucketize", "Bucketize", lambda r: [n(r, 3, 4)],
     {"boundaries": [-1.0, 0.0, 0.5, 2.0]}, EW),
    ("encode_bitmap", "EncodeBitmap", lambda r: [n(r, 12) * 1e-3],
     {"threshold": 1e-3}, EW),
    ("decode_bitmap", "DecodeBitmap", lambda r: [
        (r.integers(-1, 2, 12)).astype(np.int8)], {"threshold": 0.5}, EW),
    ("sgd_updater", "sgd_updater", lambda r: [n(r, 5)], {"lr": 0.1}, EW),
    ("nesterovs_updater", "nesterovs_updater", lambda r: [n(r, 5), n(r, 5)],
     {}, EW),
    ("adam_updater", "adam_updater", lambda r: [
        n(r, 5), n(r, 5) * 0.1, u(r, 5, lo=0, hi=0.1)], {"iteration": 3},
     RED),
    ("ada_max_updater", "ada_max_updater", lambda r: [
        n(r, 5), n(r, 5) * 0.1, u(r, 5, lo=0, hi=0.1)], {"iteration": 2},
     RED),
    ("nadam_updater", "nadam_updater", lambda r: [
        n(r, 5), n(r, 5) * 0.1, u(r, 5, lo=0, hi=0.1)], {"iteration": 4},
     RED),
    ("ams_grad_updater", "ams_grad_updater", lambda r: [
        n(r, 5), n(r, 5) * 0.1, u(r, 5, lo=0, hi=0.1),
        u(r, 5, lo=0, hi=0.1)], {}, RED),
    ("ada_grad_updater", "ada_grad_updater", lambda r: [
        n(r, 5), u(r, 5, lo=0, hi=1)], {}, RED),
    ("ada_delta_updater", "ada_delta_updater", lambda r: [
        n(r, 5), u(r, 5, lo=0, hi=1), u(r, 5, lo=0, hi=1)], {}, RED),
    ("rms_prop_updater", "rms_prop_updater", lambda r: [
        n(r, 5), u(r, 5, lo=0, hi=1)], {}, RED),
    ("biasadd_bp", "BiasAddGrad", lambda r: [n(r, 2, 3, 4), n(r, 4),
                                             n(r, 2, 3, 4)], {}, RED),
    ("batchnorm_bp", "batchnorm_bp", lambda r: [
        n(r, 2, 3, 4), n(r, 4), u(r, 4, lo=0.5, hi=2), n(r, 4), n(r, 4),
        n(r, 2, 3, 4)], {"epsilon": 1e-3}, RED),
    ("dropout_bp", "dropout_bp", lambda r: [
        (n(r, 3, 4) > 0).astype(np.float32), n(r, 3, 4)], {"p": 0.7}, EW),
] + [
    ("first_index", "first_index", lambda r: [n(r, 3, 4)],
     {"condition": "gt", "value": 0.5}, EW),
    ("first_index_none", "first_index", lambda r: [n(r, 3, 4)],
     {"condition": "gt", "value": 9.0}, EW),
    ("last_index", "last_index", lambda r: [n(r, 3, 4)],
     {"condition": "abs_lt", "value": 0.5}, EW),
    ("iamax", "IMax", lambda r: [n(r, 3, 4)], {"axis": 1}, EW),
    ("iamin", "IMin", lambda r: [n(r, 3, 4)], {}, EW),
    ("match_condition", "MatchCondition", lambda r: [n(r, 3, 4)],
     {"condition": "lte", "value": 0.0}, EW),
    ("match_condition_transform", "MatchConditionTransform", lambda r: [
        n(r, 3, 4)], {"condition": "neq", "value": 0.0}, EW),
    ("barnes_gains", "barnes_gains", lambda r: [
        u(r, 6, lo=0, hi=1), n(r, 6), n(r, 6)], {}, EW),
    ("barnes_symmetrized", "barnes_symmetrized", lambda r: [
        np.array([0, 1, 2, 0], np.int32), np.array([1, 2, 0, 1], np.int32),
        u(r, 4, lo=0, hi=1)], {"n": 3}, EW),
    ("barnes_edge_forces", "barnes_edge_forces", lambda r: [
        np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32),
        u(r, 3, lo=0, hi=1), 3, n(r, 3, 2)], {}, RED),
    ("cell_contains", "cell_contains", lambda r: [
        np.zeros(2, np.float32), np.ones(2, np.float32),
        np.array([0.5, -0.9], np.float32)], {}, EW),
    ("select", "select", lambda r: [n(r, 4) > 0, n(r, 4), n(r, 4)], {}, EW),
    ("check_numerics", "CheckNumerics", lambda r: [n(r, 4)], {}, EW),
    ("is_numeric_tensor", "IsNumericTensor", lambda r: [ids(r, 3, 4)], {},
     EW),
    ("is_numeric_tensor_bool", "is_numeric_tensor", lambda r: [
        n(r, 4) > 0], {}, EW),
    ("assert_op", "Assert", lambda r: [np.array(True), n(r, 2)], {}, EW),
    ("zeros_as", "zerosAs", lambda r: [ids(r, 3, 4)], {}, EW),
    ("ones_as", "onesAs", lambda r: [n(r, 2, 3)], {}, EW),
    ("broadcast_dynamic_shape", "BroadcastDynamicShape", lambda r: [
        np.array([3, 1, 5], np.int32), np.array([4, 1], np.int32)], {}, EW),
    ("broadcastgradientargs", "BroadcastGradientArgs", lambda r: [
        np.array([3, 1, 5], np.int32), np.array([4, 1], np.int32)], {}, EW),
    ("knn_mindistance", "knn_mindistance", lambda r: [
        n(r, 3), -np.ones(3, np.float32) * 0.2,
        np.ones(3, np.float32) * 0.3], {}, EW),
    ("hashcode", "HashCode", lambda r: [n(r, 3, 5)], {}, EW),
    ("hashcode_int", "hashcode", lambda r: [ids(r, 1000, 40)], {}, EW),
    ("lstm_block_cell", "LSTMBlockCell", lambda r: [
        n(r, 2, 3), n(r, 2, 4), n(r, 2, 4), n(r, 7, 16) * 0.3, n(r, 16)],
     {"forget_bias": 0.5}, RED),
    ("image_resize_bilinear", "ImageResize", lambda r: [n(r, 1, 4, 6, 2)],
     {"size": (7, 3)}, RED),
    ("image_resize_bilinear_aa", "image_resize", lambda r: [
        n(r, 1, 8, 9, 2)], {"size": (3, 4), "antialias": True}, RED),
    ("image_resize_bicubic", "image_resize", lambda r: [n(r, 2, 5, 6, 2)],
     {"size": (9, 4), "method": "bicubic"}, RED),
    ("image_resize_bicubic_aa", "image_resize", lambda r: [
        n(r, 1, 9, 8, 2)], {"size": (4, 3), "method": "bicubic",
                            "antialias": True}, RED),
    ("image_resize_nearest", "image_resize", lambda r: [n(r, 1, 5, 6, 2)],
     {"size": (8, 4), "method": "nearest"}, EW),
    ("image_resize_area_int", "image_resize", lambda r: [n(r, 1, 6, 8, 2)],
     {"size": (3, 4), "method": "area"}, RED),
    ("image_resize_area", "image_resize", lambda r: [n(r, 1, 7, 8, 2)],
     {"size": (3, 5), "method": "area"}, RED),
    ("dynamic_bidirectional_rnn", "DynamicBidirectionalRNN", lambda r: [
        n(r, 2, 4, 3), n(r, 2, 5), n(r, 2, 5), n(r, 8, 20) * 0.3, n(r, 20),
        n(r, 2, 5), n(r, 2, 5), n(r, 8, 20) * 0.3, n(r, 20)], {}, RED),
    ("gather_elements", "GatherElements", lambda r: [
        n(r, 3, 4), np.array([[0, 2], [1, -1], [3, 0]], np.int32)],
     {"axis": 1}, EW),
    ("nonzero_coords", "NonZero", lambda r: [
        np.array([[0, 1, 0], [2, 0, 3]], np.float32)], {}, EW),
    ("fill_dynamic", "fill_dynamic", lambda r: [
        np.array([2, 3], np.int32), np.float32(1.5)], {}, EW),
    ("fill_template", "fill_template", lambda r: [
        np.float32(2.0), n(r, 4, 5)], {"template": [("shape", 0, 1), 3]},
     EW),
    ("eig_symmetric", "eig", lambda r: [np.diag([3.0, 1.0, 2.0]).astype(
        np.float32)], {}, RED),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_op_matches_reference(case):
    check_case(case)


def test_eig_holds_what_is_defined():
    x = np.random.default_rng(2).standard_normal((4, 4)).astype(np.float32)
    w, v = TR.exec_op("eig", torch.as_tensor(x))
    jw, _ = JR.exec_op("eig", jnp.asarray(x))
    assert w.dtype == torch.complex64 and np.asarray(jw).dtype == np.complex64
    key = lambda z: (round(z.real, 4), round(z.imag, 4))  # noqa: E731
    np.testing.assert_allclose(sorted(w.numpy(), key=key),
                               sorted(np.asarray(jw), key=key), atol=1e-4)
    xc = torch.as_tensor(x).to(torch.complex64)
    np.testing.assert_allclose((xc @ v).numpy(), (v * w).numpy(), atol=1e-4)


def test_check_numerics_and_assert_raise():
    with pytest.raises(FloatingPointError):
        TR.exec_op("check_numerics", torch.tensor([1.0, float("nan")]))
    with pytest.raises(AssertionError):
        TR.exec_op("Assert", torch.tensor(False), torch.zeros(2))


@pytest.mark.parametrize("name, args, check", [
    ("random_multinomial", [np.log(np.array([[0.1, 0.9], [0.8, 0.2]],
                                            np.float32))],
     lambda out: np.allclose((out == 1).mean(axis=1), [0.9, 0.2], atol=0.03)),
    ("bernoulli_sample", [np.array([0.1, 0.5, 0.9] * 1000, np.float32)],
     lambda out: np.allclose(out.reshape(-1, 3).mean(0), [0.1, 0.5, 0.9],
                             atol=0.04)),
])
def test_drawing_ops_hold_their_distribution(name, args, check):
    attrs = {"num_samples": 3000} if name == "random_multinomial" else {}
    t = TR.exec_op(name, *map(torch.as_tensor, args), seed=4, **attrs)
    j = JR.exec_op(name, *map(jnp.asarray, args), seed=4, **attrs)
    assert tuple(t.shape) == np.asarray(j).shape
    assert TR.get(name) is not None and str(t.dtype).split(".")[-1] == \
        np.asarray(j).dtype.name
    assert check(t.numpy()) and check(np.asarray(j))
    again = TR.exec_op(name, *map(torch.as_tensor, args), seed=4, **attrs)
    np.testing.assert_array_equal(again.numpy(), t.numpy())
    gen = torch.Generator().manual_seed(9)
    one = TR.exec_op(name, *map(torch.as_tensor, args), generator=gen,
                     **attrs)
    assert check(one.numpy())
